"""Union-box spatial mask rasterization (port of nl_vsgg_tpu/ops/union_masks.py).

Each pixel of the reference's Cython `draw_union_boxes` mask is the product
of an x-ramp and a y-ramp,

    ramp(j; a, b) = clip(j + 1 - a, 0, 1) * clip(b - j, 0, 1)

so a (pair, channel) mask is an outer product of two P-vectors: two
(..., R, 2, P) ramp tensors and one broadcast multiply, on the device.
`draw_union_boxes_np` is the same closed form in numpy, for host grounding
on the prefetch workers (data/grounding.py).
"""

from __future__ import annotations

import numpy as np
import torch


def draw_union_boxes(pair_rois: torch.Tensor, pooling_size: int = 27,
                     as_nchw: bool = False) -> torch.Tensor:
    """pair_rois (..., R, 8) = [subj xyxy, obj xyxy] -> (..., R, P, P, 2)
    masks in union-box-normalized coordinates ((..., R, 2, P, P) if
    `as_nchw`). Degenerate (all-zero) pairs give finite outputs."""
    P = pooling_size
    boxes = pair_rois.reshape(*pair_rois.shape[:-1], 2, 4)  # (..., R, 2, 4)

    x1u = boxes[..., 0].amin(-1, keepdim=True)  # (..., R, 1)
    y1u = boxes[..., 1].amin(-1, keepdim=True)
    x2u = boxes[..., 2].amax(-1, keepdim=True)
    y2u = boxes[..., 3].amax(-1, keepdim=True)
    w = (x2u - x1u).clamp(min=1e-8)
    h = (y2u - y1u).clamp(min=1e-8)

    # box corners in [0, P] union-normalized coordinates, per channel
    x1 = (boxes[..., 0] - x1u) * P / w  # (..., R, 2)
    y1 = (boxes[..., 1] - y1u) * P / h
    x2 = (boxes[..., 2] - x1u) * P / w
    y2 = (boxes[..., 3] - y1u) * P / h

    grid = torch.arange(P, dtype=pair_rois.dtype, device=pair_rois.device)

    def ramps(lo, hi):  # (..., R, 2) -> (..., R, 2, P)
        return ((grid + 1.0 - lo[..., None]).clamp(0.0, 1.0)
                * (hi[..., None] - grid).clamp(0.0, 1.0))

    masks = ramps(y1, y2)[..., :, None] * ramps(x1, x2)[..., None, :]  # (..., R, 2, P, P)
    if as_nchw:
        return masks
    return masks.movedim(-3, -1)  # (..., R, P, P, 2)


def draw_union_boxes_np(pair_rois, pooling_size: int = 27, as_nchw: bool = False) -> np.ndarray:
    """Numpy twin of `draw_union_boxes` (float32), for the host data path."""
    pair_rois = np.asarray(pair_rois, np.float32)
    P = pooling_size
    boxes = pair_rois.reshape(*pair_rois.shape[:-1], 2, 4)

    x1u = boxes[..., 0].min(-1, keepdims=True)
    y1u = boxes[..., 1].min(-1, keepdims=True)
    x2u = boxes[..., 2].max(-1, keepdims=True)
    y2u = boxes[..., 3].max(-1, keepdims=True)
    w = np.maximum(x2u - x1u, 1e-8)
    h = np.maximum(y2u - y1u, 1e-8)

    x1 = (boxes[..., 0] - x1u) * P / w
    y1 = (boxes[..., 1] - y1u) * P / h
    x2 = (boxes[..., 2] - x1u) * P / w
    y2 = (boxes[..., 3] - y1u) * P / h

    grid = np.arange(P, dtype=np.float32)

    def ramps(lo, hi):
        g = grid.reshape((1,) * lo.ndim + (P,))
        return (np.clip(g + 1.0 - lo[..., None], 0.0, 1.0)
                * np.clip(hi[..., None] - g, 0.0, 1.0))

    masks = ramps(y1, y2)[..., :, None] * ramps(x1, x2)[..., None, :]
    if as_nchw:
        return masks
    return np.moveaxis(masks, -3, -1)
