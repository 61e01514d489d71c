"""Non-wks SGDET inference-time detection cleanup (lib/sttran.py:185-283);
own numpy copy of nl_vsgg_tpu/models/sgdet_infer.py.

Given raw detector boxes with 36-class soft distributions:

  1. `clean_class` for classes 5 (book->paper), 8 (chair->sofa), 17 —
     every box of those classes is *duplicated* with the class column zeroed
     and relabeled to its next-best class (lib/sttran.py:53-86), so near-
     duplicate annotations can match either class.
  2. per-frame per-class greedy NMS at IoU 0.6 over the class-argmax groups,
     keeping detections in score order.
  3. labels = argmax over columns 2.. (+2) of the 36-way distribution; each
     frame's strongest person-column box becomes the human; person->object
     pairs rebuilt.

Host-side numpy (data-dependent shapes); union features/masks are then
produced by the standard Entry-building ops.
"""

from __future__ import annotations

import numpy as np


def clean_class(boxes, box_frame, dist, feats, pred_labels, class_idx: int):
    """Duplicate boxes of `class_idx` with the class zeroed (:53-86).
    Appends the duplicates after each frame's boxes, like the reference's
    frame-interleaved concatenation."""
    out_b, out_f, out_d, out_ft, out_l = [], [], [], [], []
    for i in range(int(box_frame.max()) + 1 if len(box_frame) else 0):
        sel = box_frame == i
        sel_cls = sel & (pred_labels == class_idx)
        out_b.append(boxes[sel])
        out_f.append(box_frame[sel])
        out_d.append(dist[sel])
        out_ft.append(feats[sel])
        out_l.append(pred_labels[sel])
        if sel_cls.any():
            nd = dist[sel_cls].copy()
            nd[:, class_idx - 1] = 0
            out_b.append(boxes[sel_cls])
            out_f.append(box_frame[sel_cls])
            out_d.append(nd)
            out_ft.append(feats[sel_cls])
            out_l.append(nd.argmax(1) + 1)
    cat = np.concatenate
    return (cat(out_b), cat(out_f), cat(out_d), cat(out_ft), cat(out_l))


def _nms(boxes, scores, thresh):
    """Greedy NMS, +1-pixel convention (the CUDA _C.nms the reference calls)."""
    order = np.argsort(-scores, kind="stable")
    keep, suppressed = [], np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        iw = (np.minimum(boxes[i, 2], boxes[:, 2])
              - np.maximum(boxes[i, 0], boxes[:, 0]) + 1).clip(min=0)
        ih = (np.minimum(boxes[i, 3], boxes[:, 3])
              - np.maximum(boxes[i, 1], boxes[:, 1]) + 1).clip(min=0)
        iou = iw * ih / np.maximum(areas[i] + areas - iw * ih, 1e-9)
        suppressed |= iou > thresh
    return np.asarray(keep, np.int64)


def sgdet_assign(boxes, box_frame, dist, feats, nms_thresh: float = 0.6):
    """Full non-wks sgdet test-time pass -> cleaned detections + pairs.

    boxes (N, 4), box_frame (N,), dist (N, 36) softmax rows, feats (N, D).
    Returns dict with the deduped box table and pair construction.
    """
    pred_labels = dist[:, 1:].argmax(1) + 2
    b = int(box_frame.max()) + 1 if len(box_frame) else 0
    for cls in (5, 8, 17):  # :197-199
        boxes, box_frame, dist, feats, pred_labels = clean_class(
            boxes, box_frame, dist, feats, pred_labels, cls)

    # per-frame per-class NMS 0.6 over argmax groups (:202-233)
    fb, ff, fd, fft = [], [], [], []
    for i in range(b):
        sel = np.where(box_frame == i)[0]
        if len(sel) == 0:
            continue
        scores = dist[sel]
        argmaxes = scores.argmax(1)
        for j in np.unique(argmaxes):
            inds = sel[argmaxes == j]
            cls_scores = dist[inds, j]
            order = np.argsort(-cls_scores, kind="stable")
            keep = _nms(boxes[inds][order], cls_scores[order], nms_thresh)
            rows = inds[order][keep]
            fb.append(boxes[rows])
            ff.append(np.full(len(rows), i, box_frame.dtype))
            fd.append(dist[rows])
            fft.append(feats[rows])
    boxes = np.concatenate(fb)
    box_frame = np.concatenate(ff)
    dist = np.concatenate(fd)
    feats = np.concatenate(fft)

    pred_scores = dist[:, 1:].max(1)
    pred_labels = dist[:, 1:].argmax(1) + 2
    global_idx = np.arange(len(boxes))
    human_idx = np.zeros(b, np.int64)
    for i in range(b):
        rows = global_idx[box_frame == i]
        if len(rows):
            human_idx[i] = rows[dist[rows, 0].argmax()]
    pred_labels[human_idx] = 1
    pred_scores[human_idx] = dist[human_idx, 0]

    pair_idx, im_idx = [], []
    for j in range(b):
        for m in global_idx[box_frame == j][pred_labels[box_frame == j] != 1]:
            im_idx.append(j)
            pair_idx.append([int(human_idx[j]), int(m)])
    return {
        "boxes": boxes, "box_frame": box_frame, "distribution": dist,
        "features": feats, "pred_labels": pred_labels.astype(np.int64),
        "pred_scores": pred_scores.astype(np.float32), "human_idx": human_idx,
        "pair_idx": np.asarray(pair_idx, np.int64).reshape(len(pair_idx), 2),
        "im_idx": np.asarray(im_idx, np.int64),
    }
