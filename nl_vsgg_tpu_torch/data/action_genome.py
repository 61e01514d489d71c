"""Action Genome dataset readers: the train split's pseudo-labels and the
test split's GT (port of nl_vsgg_tpu/data/action_genome.py).

Mirrors dataloader/wk_action_genome.py's AG_Train (:17-170) and AG_Test
(:172-318) over the same pickle artifacts, with the JAX package's quirks:

  * AGTrain: joins `final_ag_data_w_neg.pkl` (per-frame pseudo annotations)
    with `triplets_LLM4SGG.pkl` (frame lists) and `ag_img_info_train.pkl`
    ([H, W, scale] per video); videos absent from the frame-list file are
    skipped (:118). Dict insertion order is kept: it is the epoch order.
    `remove_one_frame_video` honors the config flag (the reference's live
    AG_Train ignores it: pass False for byte-exact dataset parity).
  * AGTest: real GT from `person_bbox.pkl` + `object_bbox_and_relationship
    (_filtersmall).pkl`; frames without a person box are dropped and only
    videos with >= 3 remaining frames kept, with the reference's counter
    quirk that 2-frame videos land in the "non person" tally (:296-302).
    xywh -> xyxy and name -> index mapping as :283-291; relationship
    indices are numpy arrays.

Both expose `video_list`, `gt_annotations`, `img_info`, `video_ids` and
iterate one video at a time; batching happens later, on padded Entries.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator

import numpy as np

from . import schema


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _norm_img_info(v):
    """Normalize one video's im_info to [h, w, scale] floats.

    The reference artifact stores a (1, 3) float32 torch tensor
    (NL-VSGG/data_preprocess/extract_ag_img_info.py:32-34); our preprocess
    CLI writes the same, and older repo pickles held a plain list — accept
    tensor / ndarray / list so reference-produced files are drop-in."""
    if v is None:
        return None
    if hasattr(v, "numpy"):  # a torch tensor
        v = v.numpy()
    a = np.asarray(v, np.float32).reshape(-1)
    return [float(a[0]), float(a[1]), float(a[2])]


# The reference wgets these from its HF dataset when absent
# (dataloader/wk_action_genome.py:13-15,92-106).
HF_DATA_URL = "https://huggingface.co/datasets/kb-kim/NL-VSGG/resolve/main"
TRAIN_ARTIFACTS = ("ag_img_info_train.pkl", "triplets_LLM4SGG.pkl",
                   "final_ag_data_w_neg.pkl")


def maybe_download(path: str, file_name: str, enabled: bool,
                   fetch_fn=None, sha256: str | None = None,
                   logger=None) -> None:
    """Fetch a missing training artifact from the NL-VSGG HF dataset.

    Off by default (cfg.auto_download) and offline-safe: a failed fetch
    leaves the caller to raise its usual FileNotFoundError. `fetch_fn(url,
    dest)` is injectable for tests; the default streams via urllib to a temp
    file and renames atomically. An optional sha256 guards corrupt downloads.
    """
    if not enabled or os.path.isfile(path):
        return
    url = f"{HF_DATA_URL}/{file_name}"
    tmp = path + ".part"
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if fetch_fn is not None:
            fetch_fn(url, tmp)
        else:
            import urllib.request
            with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
        if sha256 is not None:
            import hashlib
            h = hashlib.sha256()
            with open(tmp, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest() != sha256:
                raise IOError(f"checksum mismatch for {file_name}: "
                              f"{h.hexdigest()} != {sha256}")
        os.replace(tmp, path)
        if logger is not None:
            logger.info(f"downloaded {file_name} -> {path}")
    except Exception as e:  # offline fallback: caller reports the missing file
        if os.path.isfile(tmp):
            os.remove(tmp)
        if logger is not None:
            logger.warning(f"auto-download of {file_name} failed ({e!r}); "
                           f"place it at {path} manually")


class AGTrain:
    """Weakly-supervised train split (AG_Train, wk_action_genome.py:17-170)."""

    def __init__(self, data_path: str, pseudo_label_path: str | None = None,
                 img_info_path: str | None = None, frame_list_path: str | None = None,
                 assets_dir: str | None = None, remove_one_frame_video: bool = True,
                 auto_download: bool = False, fetch_fn=None, logger=None,
                 save_path: str | None = None):
        tax = schema.load_taxonomy(assets_dir)
        self.object_classes = list(tax.object_classes)
        self.relationship_classes = list(tax.relationship_classes)
        self.relationship_classes_gt = list(tax.relationship_classes_gt)

        paths = (img_info_path or os.path.join(data_path, "ag_img_info_train.pkl"),
                 frame_list_path or os.path.join(data_path, "triplets_LLM4SGG.pkl"),
                 pseudo_label_path or os.path.join(data_path, "final_ag_data_w_neg.pkl"))
        for path, name in zip(paths, TRAIN_ARTIFACTS):
            maybe_download(path, name, auto_download, fetch_fn=fetch_fn,
                           logger=logger)
        img_info, frame_list_info, pseudo = map(_load_pickle, paths)

        self.video_list: list[list[str]] = []
        self.gt_annotations: list = []
        self.img_info: list = []
        self.video_ids: list[str] = []
        self.triplet_count = 0
        self.total_frames = 0
        self.action_count = {name: 0 for name in self.relationship_classes_gt}

        for video_index, wk_ag_data in pseudo.items():
            if video_index not in frame_list_info:  # :118
                continue
            frames = [f"{video_index}/{fid}"
                      for fid in frame_list_info[video_index]["frame_list"]]
            if remove_one_frame_video and len(frames) <= 1:
                continue
            self.video_ids.append(video_index)
            self.video_list.append(frames)
            self.gt_annotations.append(wk_ag_data)
            self.img_info.append(_norm_img_info(img_info.get(video_index)))
            self.total_frames += len(frames)
            for frame_info in wk_ag_data:  # stats (:126-141)
                for t in frame_info:
                    if "class" not in t:
                        continue
                    for a in np.asarray(t["attention_relationship"]).reshape(-1):
                        self.action_count[self.relationship_classes_gt[int(a)]] += 1
                        self.triplet_count += 1
                    for a in np.asarray(t["spatial_relationship"]).reshape(-1):
                        self.action_count[self.relationship_classes_gt[int(a) + 3]] += 1
                        self.triplet_count += 1
                    for a in np.asarray(t["contacting_relationship"]).reshape(-1):
                        self.action_count[self.relationship_classes_gt[int(a) + 9]] += 1
                        self.triplet_count += 1

        if logger is not None:  # startup stats (wk_action_genome.py:145-152)
            logger.info("x" * 60)
            logger.info(f"The number of total frame is {self.total_frames}.")
            logger.info(f"The number of valid tripelt is {self.triplet_count}")
            top = sorted(self.action_count.items(), key=lambda kv: -kv[1])[:10]
            logger.info("action distribution (top 10): "
                        + ", ".join(f"{k}={v}" for k, v in top))
            logger.info("x" * 60)
        if save_path is not None:  # startup bar chart (:152-160)
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                counts = dict(sorted(self.action_count.items(),
                                     key=lambda kv: -kv[1]))
                plt.figure(figsize=(10, 5))
                xs = np.arange(len(counts))
                plt.bar(xs, list(counts.values()), color="black", alpha=0.5)
                plt.xticks(xs, list(counts.keys()), rotation=90, fontsize=15)
                plt.yticks(fontsize=15)
                out = os.path.join(save_path, "action_dist.png")
                plt.savefig(out, bbox_inches="tight")
                plt.close()
                if logger is not None:
                    logger.info(f"saved action distribution chart -> {out}")
            except Exception as e:  # chart is cosmetic; never block training
                if logger is not None:
                    logger.warning(f"action_dist.png not saved: {e!r}")

    def __len__(self) -> int:
        return len(self.video_list)

    def __getitem__(self, index: int):
        return self.img_info[index], index

    def __iter__(self) -> Iterator[tuple]:
        for i in range(len(self)):
            yield self[i]


class AGTest:
    """GT test split (AG_Test, wk_action_genome.py:172-318)."""

    def __init__(self, data_path: str, mode: str = "test",
                 img_info_path: str | None = None, assets_dir: str | None = None,
                 filter_nonperson_box_frame: bool = True,
                 filter_small_box: bool = True):
        tax = schema.load_taxonomy(assets_dir)
        # the REAL AG pickles store the reference's canonicalized spellings
        # ('closet/cabinet', 'looking_at', ... — wk_action_genome.py:181-214
        # fixes the raw txt and indexes the pickle values against that list),
        # i.e. our DISPLAY variants. The space-spelled *_gt variants are the
        # LLM-pipeline lexicon and never appear in the dataset pickles.
        self.object_classes = list(tax.object_classes)
        self.attention_relationships = list(tax.attention_relationships)
        self.spatial_relationships = list(tax.spatial_relationships)
        self.contacting_relationships = list(tax.contacting_relationships)

        img_info = {}
        p = img_info_path or os.path.join(data_path, "..", "ag_img_info_test.pkl")
        if os.path.isfile(p):
            img_info = _load_pickle(p)
        person_bbox = _load_pickle(os.path.join(data_path, "person_bbox.pkl"))
        obj_name = ("object_bbox_and_relationship_filtersmall.pkl" if filter_small_box
                    else "object_bbox_and_relationship.pkl")
        object_bbox = _load_pickle(os.path.join(data_path, obj_name))

        # collect valid frames per video (:239-252)
        video_dict: dict[str, list[str]] = {}
        for key in person_bbox.keys():
            if object_bbox[key][0]["metadata"]["set"] != mode:
                continue
            if any(o["visible"] for o in object_bbox[key]):
                video_name = key.split("/")[0]
                video_dict.setdefault(video_name, []).append(key)

        self.video_list: list[list[str]] = []
        self.video_size: list = []
        self.img_info: list = []
        self.gt_annotations: list = []
        self.video_ids: list[str] = []
        self.non_gt_human_nums = 0
        self.non_person_video = 0
        self.one_frame_video = 0
        self.valid_nums = 0

        for vid, keys in video_dict.items():
            video, gt_video = [], []
            for key in keys:
                if filter_nonperson_box_frame and person_bbox[key]["bbox"].shape[0] == 0:
                    self.non_gt_human_nums += 1
                    continue
                video.append(key)
                self.valid_nums += 1
                frame_gt = [{"person_bbox": person_bbox[key]["bbox"]}]
                for k in object_bbox[key]:
                    if not k["visible"]:
                        continue
                    assert k["bbox"] is not None, \
                        "warning! The object is visible without bbox"
                    x, y, w, h = k["bbox"]
                    frame_gt.append({
                        "class": self.object_classes.index(k["class"]),
                        "bbox": np.array([x, y, x + w, y + h]),
                        "attention_relationship": np.array(
                            [self.attention_relationships.index(r)
                             for r in k["attention_relationship"]], np.int64),
                        "spatial_relationship": np.array(
                            [self.spatial_relationships.index(r)
                             for r in k["spatial_relationship"]], np.int64),
                        "contacting_relationship": np.array(
                            [self.contacting_relationships.index(r)
                             for r in k["contacting_relationship"]], np.int64),
                        "metadata": k.get("metadata"),
                        "visible": k["visible"],
                    })
                gt_video.append(frame_gt)

            if len(video) > 2:  # keep >=3-frame videos (:296)
                self.video_ids.append(vid)
                self.video_list.append(video)
                self.video_size.append(person_bbox[keys[-1]]["bbox_size"])
                self.img_info.append(_norm_img_info(img_info.get(vid)))
                self.gt_annotations.append(gt_video)
            elif len(video) == 1:
                self.one_frame_video += 1
            else:  # 0 or 2 frames both land here — reference quirk (:299-302)
                self.non_person_video += 1

    def __len__(self) -> int:
        return len(self.video_list)

    def __getitem__(self, index: int):
        return self.img_info[index], index

    def __iter__(self) -> Iterator[tuple]:
        for i in range(len(self)):
            yield self[i]
