"""Box geometry as broadcastable tensor math (port of nl_vsgg_tpu/ops/boxes.py).

  * Cython `bbox_overlaps` with the legacy +1-pixel convention
    -> `iou(..., plus_one=True)`
  * exact IoU / generalized IoU -> `iou`, `generalized_iou`
  * `center_size` with the +1 width convention (feeds the object
    classifier's position embedding, so the +1 must match the reference)

All functions take xyxy boxes with any leading batch axes. Degenerate
all-zero (padding) boxes give finite outputs: unions are clamped and
divisions guarded.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def box_area(boxes: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    off = 1.0 if plus_one else 0.0
    return (boxes[..., 2] - boxes[..., 0] + off) * (boxes[..., 3] - boxes[..., 1] + off)


def _pair_inter(boxes1, boxes2, off):
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + off).clamp(min=0.0)
    return wh[..., 0] * wh[..., 1]


def iou(boxes1: torch.Tensor, boxes2: torch.Tensor, plus_one: bool = False) -> torch.Tensor:
    """Pairwise IoU: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    off = 1.0 if plus_one else 0.0
    inter = _pair_inter(boxes1, boxes2, off)
    union = (box_area(boxes1, plus_one)[..., :, None]
             + box_area(boxes2, plus_one)[..., None, :] - inter)
    return inter / union.clamp(min=_EPS)


def intersection_ratio(boxes1: torch.Tensor, boxes2: torch.Tensor,
                       plus_one: bool = True) -> torch.Tensor:
    """Fraction of each boxes2 area covered by each boxes1 box: (N, M)
    (Cython `bbox_intersections`: normalized by the second argument's area)."""
    off = 1.0 if plus_one else 0.0
    inter = _pair_inter(boxes1, boxes2, off)
    return inter / box_area(boxes2, plus_one)[..., None, :].clamp(min=_EPS)


def generalized_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise gIoU, guarded for degenerate boxes."""
    i = iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    hull = wh[..., 0] * wh[..., 1]
    inter = _pair_inter(boxes1, boxes2, 0.0)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return i - (hull - union) / hull.clamp(min=_EPS)


def center_size(boxes: torch.Tensor) -> torch.Tensor:
    """xyxy -> (cx, cy, w, h) with the +1 size convention."""
    wh = boxes[..., 2:] - boxes[..., :2] + 1.0
    return torch.cat([boxes[..., :2] + 0.5 * wh, wh], dim=-1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    wh = boxes[..., 2:] - boxes[..., :2]
    return torch.cat([boxes[..., :2] + 0.5 * wh, wh], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    half = 0.5 * boxes[..., 2:]
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes[..., :2], boxes[..., 2:] - boxes[..., :2]], dim=-1)


def xywh_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    return torch.cat([boxes[..., :2] + 0.5 * boxes[..., 2:], boxes[..., 2:]], dim=-1)


def union_boxes(boxes: torch.Tensor, pair_idx: torch.Tensor) -> torch.Tensor:
    """Per-pair union boxes: boxes (N, 4) xyxy, pair_idx (R, 2) -> (R, 4)."""
    subj = boxes[pair_idx[..., 0].long()]
    obj = boxes[pair_idx[..., 1].long()]
    return torch.cat([torch.minimum(subj[..., :2], obj[..., :2]),
                      torch.maximum(subj[..., 2:], obj[..., 2:])], dim=-1)
