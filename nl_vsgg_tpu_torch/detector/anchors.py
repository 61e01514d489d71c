"""Anchor generation for the single-level C4 RPN (a copy of
nl_vsgg_tpu/detector/anchors.py, numpy only; the port imports nothing of
the JAX package).

The classic Faster R-CNN `generate_anchors` math used by maskrcnn_benchmark
for CONV_BODY R-152-C4 (ANCHOR_STRIDE 16, ANCHOR_SIZES (32, 64, 128, 256,
512), ASPECT_RATIOS (0.5, 1.0, 2.0)): base 16x16 anchor -> ratio
enumeration (rounded) -> scale enumeration, then shifted over the feature
grid. 15 anchors per position.
"""

from __future__ import annotations

import numpy as np


def generate_base_anchors(stride: int = 16,
                          sizes=(32, 64, 128, 256, 512),
                          ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(A, 4) xyxy base anchors (the classic rounded formula)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float64)

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mkanchors(ws, hs, cx, cy):
        ws = ws[:, None]
        hs = hs[:, None]
        return np.hstack([cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                          cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)])

    w, h, cx, cy = whctrs(base)
    size = w * h
    size_ratios = size / np.asarray(ratios, np.float64)
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    ratio_anchors = mkanchors(ws, hs, cx, cy)

    anchors = []
    scales = np.asarray(sizes, np.float64) / stride
    for ra in ratio_anchors:
        w, h, cx, cy = whctrs(ra)
        anchors.append(mkanchors(w * scales, h * scales, cx, cy))
    return np.vstack(anchors).astype(np.float32)


def grid_anchors(feat_h: int, feat_w: int, stride: int = 16,
                 base: np.ndarray | None = None) -> np.ndarray:
    """(feat_h * feat_w * A, 4) anchors over the feature grid, row-major with
    the anchor index fastest (maskrcnn layout)."""
    base = generate_base_anchors(stride) if base is None else base
    sx = np.arange(feat_w, dtype=np.float32) * stride
    sy = np.arange(feat_h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(sx, sy)
    shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                       shift_x.ravel(), shift_y.ravel()], axis=1)
    all_anchors = shifts[:, None, :] + base[None, :, :]
    return all_anchors.reshape(-1, 4)
