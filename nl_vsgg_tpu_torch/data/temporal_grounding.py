"""Temporal pseudo-grounding: propagate grounded boxes across frames (port
of nl_vsgg_tpu/data/temporal_grounding.py).

The propagation of the reference's temporal grounding family
(lib/assign_pseudo_label.py:224-891, temporal_pseudo_obj_grounded_out and
its people / _t variants): from the frames where a class is grounded, walk
forward (and backward) frame by frame; in each new frame the candidates
are the detections with IoU(previous box, candidate) > threshold (with
`force_ground`, at least the best-IoU one); the candidate of largest cosine
feature similarity wins, its confidence the source's decayed by the IoU.
The walk is order-dependent: the box grounded in a frame is the source for
the next (the reference mutates its detections as it goes), so it is a
sequential scan, not a parallel map.

None of the reference's entry points calls this family (its calls are
commented out or absent); it is here for `pseudo_way`-style experiments.
Host numpy over ragged detection lists.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .grounding import FrameDetections


@dataclass
class PropagatedBox:
    frame: int
    rect: np.ndarray
    conf: float
    feat: np.ndarray


def _iou_1_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one box against many, torchvision's convention (no +1)."""
    a1 = (box[2] - box[0]) * (box[3] - box[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    iw = (np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0])).clip(min=0)
    ih = (np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1])).clip(min=0)
    inter = iw * ih
    return inter / np.maximum(a1 + a2 - inter, 1e-12)


def _cosine_1_to_many(feat: np.ndarray, feats: np.ndarray) -> np.ndarray:
    return (feat @ feats.T) / (np.linalg.norm(feat)
                               * np.maximum(np.linalg.norm(feats, axis=1), 1e-12))


def propagate(frames: list[FrameDetections], seeds: dict[int, list[PropagatedBox]],
              frame_order: list[int], skip_frames: set[int],
              threshold: float = 0.5, force_ground: bool = False
              ) -> dict[int, list[PropagatedBox]]:
    """One directional pass. `seeds[f]` are the source boxes entering the
    walk at f; each visited frame (not in `skip_frames`) gets one box per
    live source, and those boxes are the next frame's sources. After every
    visited frame the sources become that frame's boxes (the reference's
    "Update", lib/assign_pseudo_label.py:267-268): a frame where the IoU
    gate admits nothing ends the chain. Returns {frame: [PropagatedBox]}
    of the newly grounded boxes."""
    out: dict[int, list[PropagatedBox]] = {}
    sources: list[PropagatedBox] = []
    for f in frame_order:
        if f in seeds:
            sources = seeds[f]
        if f in skip_frames:
            continue
        dets = frames[f]
        if not sources or len(dets.classes) == 0:
            sources = []
            continue
        for src in sources:
            ious = _iou_1_to_many(np.asarray(src.rect, np.float64),
                                  dets.rects.astype(np.float64))
            cand = ious > threshold
            if force_ground:
                cand[ious.argmax()] = True
            if not cand.any():
                continue
            sims = _cosine_1_to_many(np.asarray(src.feat, np.float64),
                                     dets.feats.astype(np.float64))
            local = np.where(cand)[0]
            pick = local[sims[local].argmax()]
            out.setdefault(f, []).append(PropagatedBox(
                frame=f, rect=dets.rects[pick].copy(), conf=float(src.conf) * float(ious[pick]),
                feat=dets.feats[pick].copy()))
        sources = out.get(f, [])
    return out


def temporal_pseudo_ground(frames: list[FrameDetections],
                           grounded_frames: dict[int, list[PropagatedBox]],
                           threshold: float = 0.5, force_ground: bool = False
                           ) -> dict[int, list[PropagatedBox]]:
    """Propagation both ways from the grounded span's edges (the forward
    and backward walks of temporal_pseudo_obj_grounded_out,
    lib/assign_pseudo_label.py:237-301)."""
    if not grounded_frames:
        return {}
    known = sorted(grounded_frames)
    lo, hi = known[0], known[-1]
    n = len(frames)
    fwd = propagate(frames, {hi + 1: grounded_frames[hi]}, list(range(hi + 1, n)),
                    set(grounded_frames), threshold, force_ground)
    bwd = propagate(frames, {lo - 1: grounded_frames[lo]}, list(range(lo - 1, -1, -1)),
                    set(grounded_frames), threshold, force_ground)
    out = dict(fwd)
    for f, boxes in bwd.items():
        out.setdefault(f, []).extend(boxes)
    return out
