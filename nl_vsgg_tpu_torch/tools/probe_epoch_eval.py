"""Epoch-eval scoring probe: what scoring one video costs on the host and on
the card, the cost that `DeviceEvalPromotion` trades after its burn-in.

    python -m nl_vsgg_tpu_torch.tools.probe_epoch_eval [--videos N] [--frames F]
        [--batch B] [--device cpu]

Port of tools/probe_epoch_eval.py. It draws Action-Genome-scale random
videos (32 frames, 3 objects a frame, about 96 relations) and times, over
the same (gt, pred) pairs, in ms per video of wall time:

  host     SceneGraphEvaluator.evaluate_scene_graph (what promotion removes
           for each video after the burn-in)
  video    eval/recall_device.device_eval_video: pack, upload, the three
           R@K variants and one fetch, per video
  batched  eval/recall_device.device_eval_batch over --batch videos: one
           upload per argument, one scorer call and one packed fetch per
           batch (the form evaluate_epoch uses)

Without `--device cpu` the device rows run on the GPU or raise; with it
they run the same torch code on the CPU, and their times are CPU times.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..data import schema
from ..device import resolve_device
from ..eval.recall import SceneGraphEvaluator
from ..eval.recall_device import device_eval_batch, device_eval_video


def random_video(rng: np.random.Generator, n_frames: int = 4, n_objs: int = 3,
                 flip_cls_prob: float = 0.3, jitter: float = 12.0):
    """GT annotations (AG_Test format) and a matching pred dict: per frame a
    person and `n_objs` objects at fixed places, prediction boxes jittered,
    classes sometimes wrong, random attention logits and sigmoided spatial
    and contacting scores (a copy of the JAX package's test builder)."""
    gt = []
    boxes, labels, scores, pair_idx, im_idx = [], [], [], [], []
    att_d, sp_d, con_d = [], [], []
    for f in range(n_frames):
        frame = [{"person_bbox": np.array([[10 + f, 10, 100 + f, 200]], np.float32)}]
        person_row = len(boxes)
        boxes.append([10 + f + rng.uniform(-2, 2), 10, 100 + f, 200])
        labels.append(1)
        scores.append(rng.uniform(0.8, 1.0))
        for m in range(n_objs):
            bb = np.array([30 + 40 * m, 50, 80 + 40 * m, 120], np.float32)
            cls = int(rng.integers(2, schema.NUM_OBJ_CLASSES))
            frame.append({
                "bbox": bb, "class": cls,
                "attention_relationship": torch.tensor([int(rng.integers(0, 3))]),
                "spatial_relationship": torch.tensor(
                    sorted(rng.choice(6, size=rng.integers(1, 3), replace=False).tolist())),
                "contacting_relationship": torch.tensor(
                    sorted(rng.choice(17, size=rng.integers(1, 3), replace=False).tolist())),
            })
            jb = bb + rng.uniform(-jitter, jitter, 4).astype(np.float32)
            boxes.append(jb.tolist())
            pred_cls = (cls if rng.uniform() > flip_cls_prob
                        else int(rng.integers(2, schema.NUM_OBJ_CLASSES)))
            labels.append(pred_cls)
            scores.append(rng.uniform(0.3, 1.0))
            pair_idx.append([person_row, len(boxes) - 1])
            im_idx.append(f)
            att_d.append(rng.standard_normal(3))       # logits
            sp_d.append(rng.uniform(0, 1, 6))          # sigmoided
            con_d.append(rng.uniform(0, 1, 17))
        gt.append(frame)
    pred = {
        "boxes": np.concatenate([np.zeros((len(boxes), 1)), np.asarray(boxes)], 1),
        "labels": np.asarray(labels, np.int64),
        "scores": np.asarray(scores, np.float32),
        "pred_labels": np.asarray(labels, np.int64),
        "pred_scores": np.asarray(scores, np.float32),
        "pair_idx": np.asarray(pair_idx, np.int64),
        "im_idx": np.asarray(im_idx, np.int64),
        "attention_distribution": np.asarray(att_d, np.float32),
        "spatial_distribution": np.asarray(sp_d, np.float32),
        "contacting_distribution": np.asarray(con_d, np.float32),
    }
    return gt, pred


class PredEntry:
    """The Entry fields the device scorers read, taken from a pred dict."""

    def __init__(self, pred: dict):
        self.pair_idx = np.asarray(pred["pair_idx"], np.int64)
        self.im_idx = np.asarray(pred["im_idx"], np.int64)
        self.rel_mask = np.ones(len(self.im_idx), bool)
        self.boxes = np.asarray(pred["boxes"])[:, 1:].astype(np.float32)


def run(videos: int = 24, frames: int = 32, batch: int = 12, device=None) -> dict:
    """Time the three rows; returns their ms per video and the device name."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    vids = [random_video(rng, n_frames=frames, n_objs=3) for _ in range(videos)]
    entries = [PredEntry(p) for _, p in vids]

    def host():
        ev = SceneGraphEvaluator(mode="sgdet")
        for gt, pred in vids:
            ev.evaluate_scene_graph(gt, pred)

    def per_video():
        ev = SceneGraphEvaluator(mode="sgdet")
        for (gt, pred), e in zip(vids, entries):
            device_eval_video(e, pred, gt, ev, f_bucket=frames, device=dev)

    def batched():
        ev = SceneGraphEvaluator(mode="sgdet")
        for s in range(0, videos, batch):
            chunk = slice(s, s + batch)
            device_eval_batch(entries[chunk], [p for _, p in vids[chunk]],
                              [g for g, _ in vids[chunk]], ev, f_bucket=frames, device=dev)

    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name, fn in (("host", host), ("video", per_video), ("batched", batched)):
        fn()                                        # warm-up (allocator, first launches)
        t0 = time.perf_counter()
        fn()
        out[name] = (time.perf_counter() - t0) / videos * 1e3
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--videos", type=int, default=24)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--batch", type=int, default=12)
    p.add_argument("--device", default=None, help="cpu to run the device rows on the CPU")
    args = p.parse_args(argv)
    r = run(args.videos, args.frames, args.batch, args.device)
    print(f"videos={args.videos} frames={args.frames} batch={args.batch} "
          f"device={r['device']}")
    print(f"host evaluate_scene_graph : {r['host']:8.3f} ms/video")
    print(f"device_eval_video (wall)  : {r['video']:8.3f} ms/video")
    print(f"device_eval_batch (wall)  : {r['batched']:8.3f} ms/video")
    return 0


if __name__ == "__main__":
    sys.exit(main())
