"""Offline preprocessing CLI, the port of tools/preprocess.py: the NL-VSGG/ +
data_preprocess/ script family as one multi-command tool.

    python -m nl_vsgg_tpu_torch.tools.preprocess <subcommand> [options]

Subcommands (artifact schemas identical to the JAX tool's, so files interop):

  img-info    — per-video [H, W, scale] after the 600 rescale
                (extract_ag_img_info.py) -> ag_img_info_{split}.pkl
  features    — the port's VinVL detector over all frames of each video
                (extract_bbox_features_ag.py) -> dets.npy, dets_f32.npy and
                feat.npy per frame; --checkpoint takes an .npz (either
                package's) or a VinVL .pth; --device (default: the GPU)
  dets-cache  — dets_f32.npy sidecars for an existing dets.npy tree
  dump-frames — ffmpeg frame extraction per Action Genome frame_list.txt
                (data_preprocess/dump_frames.py)
  tcs         — caption segmentation via an OpenAI-compatible endpoint
                (TCS.py) -> split_action_dict.pkl
  triplets    — LLM triplet parsing (extract_triplet.py) -> triplets_LLM4SGG.pkl
  adv         — caption-frame alignment from precomputed CLIP embeddings
                (ADV.py; `pipelines.clip.encode_for_adv` makes them)
                -> semi_final_ag_data.pkl + final_ag_data.pkl
  negatives   — motion-cue negative labels (Assign_negative_classes.py)
                -> final_ag_data_w_neg.pkl

`main(argv, read_image=None, llm=None)`: `read_image(path)` gives a BGR
uint8 frame (by default cv2.imread: cv2 is imported when the reader is
built, and a missing cv2 raises naming it); `llm(prompt) -> str` replaces
the OpenAI endpoint of `tcs` and `triplets`.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import subprocess
import urllib.request
from functools import lru_cache, partial

import numpy as np
import torch

from ..data import schema
from ..data.grounding import DETS_F32, dets_to_f32
from ..detector.attr_rcnn import AttrRCNNTorch
from ..detector.convert import load_checkpoint
from ..device import resolve_device
from ..pipelines import adv
from ..pipelines.negatives import assign_negative_classes_video, frame_person_object_giou
from ..pipelines.tcs import run_tcs, save_split_action_dict
from ..pipelines.triplets import run_triplet_extraction, save_triplets


def cv2_image_reader():
    """read_image(path) -> a BGR uint8 (H, W, 3) frame, by cv2.imread. cv2
    is imported here, when the reader is built: without it this raises,
    naming it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading frame images needs cv2 (opencv-python), which is not installed; "
            "install it or pass read_image= (a function path -> BGR uint8 frame)") from e

    def read_image(path: str) -> np.ndarray:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(f"cannot read the frame image {path}")
        return img

    return read_image


def _video_dirs(root: str):
    """(video id, its directory, its sorted frame names) for each video
    directory under `root`, in sorted order."""
    for vid in sorted(os.listdir(root)):
        vdir = os.path.join(root, vid)
        if os.path.isdir(vdir):
            yield vid, vdir, sorted(os.listdir(vdir))


def cmd_img_info(args, read_image, llm):
    """ag_img_info_{train,test}.pkl in the reference's artifact schema:
    {video: (1, 3) float32 torch tensor [blob_h, blob_w, scale]} with
    scale = 600 / min(h, w) UNCAPPED — prep_im_for_blob's max_size branch is
    commented out in the reference (fasterRCNN/lib/model/utils/blob.py:46-47,
    extract_ag_img_info.py:27,32-34). NB this artifact's scale intentionally
    differs from the VinVL feature-extraction scale (the capped 600/1000
    resize): the reference carries the same inconsistency, and the only
    live consumer divides h, w by scale to recover the original size (ref
    tools/train_DSG_DETR.py:134)."""
    read_image = read_image or cv2_image_reader()
    out = {}
    for vid, vdir, frames in _video_dirs(args.frames):
        if not frames:
            continue
        h, w = read_image(os.path.join(vdir, frames[0])).shape[:2]
        scale = 600.0 / min(h, w)
        # blob dims = cv2.resize's rounded output size (all frames of an AG
        # video share a size, so the blob max == the first frame's dims)
        out[vid] = torch.from_numpy(np.array([[round(h * scale), round(w * scale), scale]],
                                             np.float32))
    with open(args.output, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {len(out)} videos -> {args.output}")


def cmd_features(args, read_image, llm):
    read_image = read_image or cv2_image_reader()
    dev = resolve_device(args.device)
    dt = args.dtype if args.dtype != "float32" else None
    if args.checkpoint:
        det = AttrRCNNTorch(load_checkpoint(args.checkpoint), compute_dtype=dt, device=dev)
    else:
        print("WARNING: no --checkpoint; random weights (pipeline test only)")
        det = AttrRCNNTorch.create(compute_dtype=dt, device=dev)
    n = 0
    for vid, vdir, frames in _video_dirs(args.frames):
        imgs = [read_image(os.path.join(vdir, f)) for f in frames]
        # whole video in one device pass (vs the reference's batch-4 loop)
        for frame, dets in zip(frames, det.detect_video(imgs)):
            valid = dets["valid"]
            per_img = [{"class": int(c), "conf": np.float32(s), "rect": r}
                       for c, s, r in zip(dets["labels"][valid], dets["scores"][valid],
                                          dets["boxes"][valid])]
            odir = os.path.join(args.output, vid, frame)
            os.makedirs(odir, exist_ok=True)
            np.save(os.path.join(odir, "dets.npy"), np.asarray(per_img, object),
                    allow_pickle=True)
            # plain-float sidecar: training streams the det table through
            # the native reader instead of unpickling per frame
            np.save(os.path.join(odir, DETS_F32), dets_to_f32(per_img))
            np.save(os.path.join(odir, "feat.npy"), dets["features"][valid].astype(np.float32))
            n += 1
    print(f"extracted features for {n} frames -> {args.output}")


def cmd_dets_cache(args, read_image, llm):
    """Generate dets_f32.npy sidecars for an existing dets.npy tree so the
    grounding path can skip pickle parsing (one-time, idempotent)."""
    n = 0
    for root, _, files in os.walk(args.frame_features):
        if "dets.npy" not in files:
            continue
        dst = os.path.join(root, DETS_F32)
        if os.path.isfile(dst) and not args.force:
            continue
        dets = np.load(os.path.join(root, "dets.npy"), allow_pickle=True).tolist()
        np.save(dst, dets_to_f32(dets))
        n += 1
    print(f"wrote {n} sidecars under {args.frame_features}")


def cmd_dump_frames(args, read_image, llm):
    """ffmpeg all-frame dump + keep only listed frames (dump_frames.py:28-44)."""
    with open(args.frame_list) as f:
        wanted = [line.strip() for line in f if line.strip()]
    by_video: dict[str, set[str]] = {}
    for item in wanted:
        vid, frame = item.split("/")
        by_video.setdefault(vid, set()).add(frame)
    for vid, frames in by_video.items():
        vdir = os.path.join(args.output, vid)
        os.makedirs(vdir, exist_ok=True)
        subprocess.run(["ffmpeg", "-loglevel", "panic", "-i", os.path.join(args.videos, vid),
                        "-qscale:v", "4", os.path.join(vdir, "%06d.png")], check=True)
        if not args.all_frames:
            for f in os.listdir(vdir):
                if f not in frames:
                    os.remove(os.path.join(vdir, f))
    print(f"dumped {len(by_video)} videos")


def _openai_llm(model: str, api_key: str):
    """llm(prompt) -> the chat completion of an OpenAI endpoint at
    temperature 0 (the reference's GPT-3.5 calls)."""

    def llm(prompt: str) -> str:
        req = urllib.request.Request(
            "https://api.openai.com/v1/chat/completions",
            data=json.dumps({"model": model, "temperature": 0,
                             "messages": [{"role": "user", "content": prompt}]}).encode(),
            headers={"Authorization": f"Bearer {api_key}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            return json.load(r)["choices"][0]["message"]["content"]

    return llm


def _load_captions(csv_path):
    caption_dict = {}
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            caption_dict[row["id"] + ".mp4"] = row["descriptions"]
    return caption_dict


def cmd_tcs(args, read_image, llm):
    captions = _load_captions(args.captions)
    with open(args.frame_ids, "rb") as f:
        video_frame_dict = pickle.load(f)
    out = run_tcs(captions, list(video_frame_dict.keys()),
                  llm or _openai_llm(args.model, args.api_key))
    save_split_action_dict(out, args.output)
    print(f"wrote {len(out)} videos -> {args.output}")


def cmd_triplets(args, read_image, llm):
    with open(args.split_actions, "rb") as f:
        split = pickle.load(f)
    with open(args.frame_ids, "rb") as f:
        video_frame_dict = pickle.load(f)
    out = run_triplet_extraction(split, video_frame_dict,
                                 llm or _openai_llm(args.model, args.api_key))
    save_triplets(out, args.output)
    print(f"wrote {len(out)} videos -> {args.output}")


def cmd_adv(args, read_image, llm):
    tax = schema.load_taxonomy()
    with open(args.triplets, "rb") as f:
        data = pickle.load(f)
    with open(args.embeddings, "rb") as f:
        emb = pickle.load(f)  # {vid: {"text": [groups of (S,D)], "frames": (T,D)}}
    semi, final = {}, {}
    for vid, rec in data.items():
        if vid not in emb:
            continue
        mapped = adv.align_video(emb[vid]["text"], emb[vid]["frames"], beta=args.beta)
        tri = adv.filter_triplets(rec["triplets"])
        per_frame = adv.broadcast_triplets(tri, mapped, len(rec["frame_list"]))
        if per_frame is None:  # reference error_case: drop the video
            print(f"{vid}: sentence/frame alignment mismatch (video dropped)")
            continue
        semi[vid] = {"frame_list": rec["frame_list"],
                     "split_sentence": [s for g in rec["split_sentence"] for s in g],
                     "triplets": per_frame, "mapped_frame": mapped}
        frames = adv.build_final_video(per_frame, tax)
        if frames is not None:
            final[vid] = frames
    with open(args.semi_output, "wb") as f:
        pickle.dump(semi, f)
    with open(args.output, "wb") as f:
        pickle.dump(final, f)
    print(f"aligned {len(final)} videos -> {args.output}")


def cmd_negatives(args, read_image, llm):
    tax = schema.load_taxonomy()
    with open(args.final, "rb") as f:
        final = pickle.load(f)
    with open(args.semi, "rb") as f:
        semi = pickle.load(f)

    @lru_cache(maxsize=4096)  # several objects query the same frame; don't
    # re-unpickle dets.npy once per (object, frame) pair
    def load_dets(vid, frame):
        fdir = os.path.join(args.features, vid, frame)
        dets = np.load(os.path.join(fdir, "dets.npy"), allow_pickle=True).tolist()
        if not dets:
            return None
        return (np.asarray([d["class"] for d in dets]),
                np.asarray([d["rect"] for d in dets]))

    def giou_fn(vid, frame_list, f, obj):
        loaded = load_dets(vid, frame_list[f])
        if loaded is None:
            return None
        classes, rects = loaded
        return frame_person_object_giou(classes, rects, obj, tax)

    for vid, rec in semi.items():
        if vid not in final:
            continue
        assign_negative_classes_video(final[vid], rec["triplets"], rec["mapped_frame"],
                                      partial(giou_fn, vid, rec["frame_list"]), tax)
    with open(args.output, "wb") as f:
        pickle.dump(final, f)
    print(f"labeled {len(final)} videos -> {args.output}")


def main(argv=None, read_image=None, llm=None) -> None:
    """Run one subcommand. `read_image(path)` replaces the cv2 frame reader
    of img-info and features; `llm(prompt) -> str` replaces the OpenAI
    endpoint of tcs and triplets."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("img-info")
    s.add_argument("--frames", required=True)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_img_info)

    s = sub.add_parser("features")
    s.add_argument("--frames", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--checkpoint", default="", help="an .npz (either package's) or a VinVL .pth")
    s.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="backbone compute dtype (features shift ~1e-2 rel in bfloat16; "
                        "float32 is the parity default)")
    s.add_argument("--device", default=None,
                   help="torch device (default: the GPU, which raises without one)")
    s.set_defaults(fn=cmd_features)

    s = sub.add_parser("dets-cache")
    s.add_argument("--frame_features", required=True)
    s.add_argument("--force", action="store_true")
    s.set_defaults(fn=cmd_dets_cache)

    s = sub.add_parser("dump-frames")
    s.add_argument("--videos", required=True)
    s.add_argument("--frame_list", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--all_frames", action="store_true")
    s.set_defaults(fn=cmd_dump_frames)

    s = sub.add_parser("tcs")
    s.add_argument("--captions", required=True, help="Charades_vu17_train.csv")
    s.add_argument("--frame_ids", required=True, help="ag_train_id.pkl")
    s.add_argument("--output", required=True)
    s.add_argument("--model", default="gpt-3.5-turbo")
    s.add_argument("--api_key", default=os.environ.get("OPENAI_API_KEY", ""))
    s.set_defaults(fn=cmd_tcs)

    s = sub.add_parser("triplets")
    s.add_argument("--split_actions", required=True)
    s.add_argument("--frame_ids", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--model", default="gpt-3.5-turbo")
    s.add_argument("--api_key", default=os.environ.get("OPENAI_API_KEY", ""))
    s.set_defaults(fn=cmd_triplets)

    s = sub.add_parser("adv")
    s.add_argument("--triplets", required=True, help="triplets_LLM4SGG.pkl")
    s.add_argument("--embeddings", required=True,
                   help="pickle {vid: {'text': [(S,D)...], 'frames': (T,D)}}")
    s.add_argument("--semi_output", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--beta", type=int, default=4)
    s.set_defaults(fn=cmd_adv)

    s = sub.add_parser("negatives")
    s.add_argument("--final", required=True, help="final_ag_data.pkl")
    s.add_argument("--semi", required=True, help="semi_final_ag_data.pkl")
    s.add_argument("--features", required=True, help="frame_features dir")
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_negatives)

    args = p.parse_args(argv)
    args.fn(args, read_image, llm)


if __name__ == "__main__":
    main()
