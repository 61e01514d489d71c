"""Region Proposal Network over the C4 map (single level), port of
nl_vsgg_tpu/detector/rpn.py, batched over frames.

maskrcnn_benchmark's RPNHead and proposal selection for the VinVL config
(models/vinvl/vinvl_x152c4.yaml: PRE_NMS_TOP_N_TEST 6000,
POST_NMS_TOP_N_TEST 300; NMS 0.7, MIN_SIZE 0, box-coder weights
(1, 1, 1, 1), BBOX_XFORM_CLIP log(1000/16)) with fixed shapes: a stable
top-k before NMS (ties keep the lower index first, as `lax.top_k`), then the
first `post_nms_top_n` greedy-NMS survivors per frame.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms_topk

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness and box-delta heads (15 anchors)."""

    def __init__(self, in_channels: int = 1024, num_anchors: int = 15):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, 1, 1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, fmap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """fmap (F, C, H, W) -> objectness logits (F, H*W*A) and deltas
        (F, H*W*A, 4), float32, in the (h, w, anchor) order of grid_anchors."""
        t = F.relu(self.conv(fmap))
        n = fmap.shape[0]
        logits = self.cls_logits(t).permute(0, 2, 3, 1).reshape(n, -1)
        deltas = self.bbox_pred(t).permute(0, 2, 3, 1).reshape(n, -1, 4)
        return logits.float(), deltas.float()


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """maskrcnn BoxCoder.decode: (dx, dy, dw, dh) on +1-convention boxes."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0] + 1.0
    heights = anchors[..., 3] - anchors[..., 1] + 1.0
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=BBOX_XFORM_CLIP)
    dh = (deltas[..., 3] / wh).clamp(max=BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w - 1.0, pred_ctr_y + 0.5 * pred_h - 1.0], dim=-1)


def clip_to_image(boxes: torch.Tensor, im_h, im_w) -> torch.Tensor:
    """Clamp xyxy into [0, w-1] x [0, h-1]; im_h / im_w broadcast against
    boxes[..., 0] (per-frame extents as (F, 1, ...) tensors)."""
    im_h = torch.as_tensor(im_h, dtype=boxes.dtype, device=boxes.device)
    im_w = torch.as_tensor(im_w, dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.minimum(torch.maximum(x1, zero), im_w - 1),
                        torch.minimum(torch.maximum(y1, zero), im_h - 1),
                        torch.minimum(torch.maximum(x2, zero), im_w - 1),
                        torch.minimum(torch.maximum(y2, zero), im_h - 1)], dim=-1)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather: x (F, N, ...), idx (F, k) -> (F, k, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of each row's k largest, ties in index order
    (`lax.top_k`'s order; CUDA's torch.topk is not stable)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_proposals(anchors: torch.Tensor, objectness: torch.Tensor, deltas: torch.Tensor,
                     im_hw: torch.Tensor, pre_nms_top_n: int = 6000,
                     post_nms_top_n: int = 300,
                     nms_thresh: float = 0.7) -> tuple[torch.Tensor, torch.Tensor]:
    """anchors (K, 4), objectness (F, K) logits, deltas (F, K, 4), im_hw
    (F, 2) -> proposals (F, P, 4) and their valid mask (F, P), P =
    min(post_nms_top_n, pre_nms_top_n, K)."""
    k = min(pre_nms_top_n, objectness.shape[1])
    _, top_idx = top_k_stable(objectness, k)
    scores = torch.sigmoid(take_rows(objectness, top_idx))
    boxes = decode_boxes(anchors[top_idx], take_rows(deltas, top_idx))
    boxes = clip_to_image(boxes, im_hw[:, 0, None], im_hw[:, 1, None])
    # remove_small_boxes(min_size=0): only degenerate (negative) boxes drop
    valid = ((boxes[..., 2] - boxes[..., 0] + 1 >= 0)
             & (boxes[..., 3] - boxes[..., 1] + 1 >= 0))
    out_idx, ok = nms_topk(boxes, scores, nms_thresh, min(post_nms_top_n, k), valid=valid,
                           plus_one=True)
    return take_rows(boxes, out_idx), ok
