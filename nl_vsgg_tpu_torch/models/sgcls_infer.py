"""SGCLS inference-time object assignment (lib/sttran.py:93-170); own numpy
copy of nl_vsgg_tpu/models/sgcls_infer.py.

At sgcls test time the object classifier's 37-way logits choose labels:
softmax over the non-background columns, per-frame max-human selection,
greedy duplicate-class resolution (all but the best-scoring duplicate are
reassigned to their next-best class), then person->object pairs are rebuilt
from the predicted labels.

The algorithm is sequential and data-dependent (each reassignment can create
new duplicates that the reference does NOT revisit — single pass per frame,
preserved here). It runs on host numpy between the device-side classifier
and relation head; the resulting pairs feed a fresh padded Entry.

Quirk preserved: `pred_labels = argmax(distribution[:, 1:]) + 2` where
`distribution` is already the softmax of the logits' non-background columns
(:107-110) — i.e. class 1 (person) can only be assigned via the explicit
human-selection step, and the argmax skips column 0 of the 36-way softmax.
"""

from __future__ import annotations

import numpy as np

from ..eval.recall import np_softmax as _softmax


def sgcls_assign(logits37: np.ndarray, box_frame: np.ndarray):
    """logits37 (N, 37), box_frame (N,) -> dict with distribution (N, 36),
    pred_labels, pred_scores, pair_idx, im_idx."""
    n = logits37.shape[0]
    dist = _softmax(logits37[:, 1:])          # (N, 36), col 0 = person
    pred_scores = dist[:, 1:].max(1)
    pred_labels = dist[:, 1:].argmax(1) + 2   # 2..36
    frames = np.asarray(box_frame, np.int64)
    b = int(frames.max()) + 1 if n else 0
    global_idx = np.arange(n)

    human_idx = np.zeros(b, np.int64)
    for i in range(b):
        rows = global_idx[frames == i]
        human_idx[i] = rows[dist[rows, 0].argmax()]
    pred_labels[human_idx] = 1
    pred_scores[human_idx] = dist[human_idx, 0]

    # duplicate resolution: one modal class per frame (:123-136)
    for i in range(b):
        present = frames == i
        vals, counts = np.unique(pred_labels[present], return_counts=True)
        # torch.mode returns the smallest among maximal-count values
        duplicate_class = int(vals[counts.argmax()])
        dup_pos = pred_labels[present] == duplicate_class
        if dup_pos.sum() > 0:
            rows = global_idx[present][dup_pos]
            order = np.argsort(dist[rows, duplicate_class - 1], kind="stable")[:-1]
            for j in order:
                r = rows[j]
                dist[r, duplicate_class - 1] = 0
                pred_labels[r] = dist[r].argmax() + 1
                pred_scores[r] = dist[r].max()

    pair_idx, im_idx = [], []
    for j in range(b):
        for m in global_idx[frames == j][pred_labels[frames == j] != 1]:
            im_idx.append(j)
            pair_idx.append([int(human_idx[j]), int(m)])
    return {
        "distribution": dist,
        "pred_labels": pred_labels.astype(np.int64),
        "pred_scores": pred_scores.astype(np.float32),
        "human_idx": human_idx,
        "pair_idx": np.asarray(pair_idx, np.int64).reshape(len(pair_idx), 2),
        "im_idx": np.asarray(im_idx, np.int64),
    }
