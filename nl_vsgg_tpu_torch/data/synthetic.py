"""Synthetic Entry generation — fixtures for tests, smoke runs and benches.

Copy of nl_vsgg_tpu/data/synthetic.py: the same numpy `rng` draws in the
same order, so both packages build bit-identical Entries from one seed.
Shapes and statistics follow Action Genome as the grounding engine produces
them: per frame one person box plus a handful of objects, one relation per
(person, object) pair, 2048-d RoI features, 7x7 union features, 27x27
two-channel spatial masks, multi-hot 3/6/17 relation pseudo-labels.

`make_synthetic_gt` (the port's own) draws evaluation GT in the AG_Test
format for such an Entry, so the evaluators have something to match.
"""

from __future__ import annotations

import numpy as np

from . import schema
from .entry import FEAT_DIM, MASK_P, POOL, Entry, pad_entry


def make_synthetic_entry(rng: np.random.Generator, n_frames: int = 16,
                         objs_per_frame: int = 3, bucket_boxes: int = 64,
                         bucket_rels: int = 64, feat_dim: int = FEAT_DIM,
                         im_size: tuple[int, int] = (600, 1000)) -> Entry:
    H, W = im_size
    boxes, box_frame, labels, scores, dists, feats = [], [], [], [], [], []
    pair_idx, im_idx = [], []
    att_gt, sp_gt, con_gt = [], [], []

    for f in range(n_frames):
        person_row = len(boxes)
        for j in range(objs_per_frame + 1):  # j==0 is the person
            x1, y1 = rng.uniform(0, W * 0.7), rng.uniform(0, H * 0.7)
            boxes.append([x1, y1, x1 + rng.uniform(20, W * 0.3),
                          y1 + rng.uniform(20, H * 0.3)])
            box_frame.append(f)
            label = 1 if j == 0 else int(rng.integers(2, schema.NUM_OBJ_CLASSES))
            labels.append(label)
            scores.append(float(rng.uniform(0.5, 1.0)))
            d = rng.uniform(0, 0.1, schema.NUM_OBJ_CLASSES - 1)
            d[label - 1] = rng.uniform(0.6, 1.0)
            dists.append(d / d.sum())
            feats.append(rng.standard_normal(feat_dim) * 0.1)
            if j > 0:
                pair_idx.append([person_row, len(boxes) - 1])
                im_idx.append(f)
                a = np.zeros(schema.NUM_ATTENTION)
                a[rng.integers(0, schema.NUM_ATTENTION)] = 1
                att_gt.append(a)
                s = np.zeros(schema.NUM_SPATIAL)
                s[rng.integers(0, schema.NUM_SPATIAL)] = 1
                sp_gt.append(s)
                c = np.zeros(schema.NUM_CONTACTING)
                c[rng.integers(0, schema.NUM_CONTACTING)] = 1
                con_gt.append(c)

    n_rels = len(pair_idx)
    e = Entry.from_numpy(dict(
        boxes=np.asarray(boxes, np.float32),
        box_frame=np.asarray(box_frame, np.int32),
        box_mask=np.ones(len(boxes), bool),
        labels=np.asarray(labels, np.int32),
        scores=np.asarray(scores, np.float32),
        distribution=np.asarray(dists, np.float32),
        features=np.asarray(feats, np.float32),
        pair_idx=np.asarray(pair_idx, np.int32),
        im_idx=np.asarray(im_idx, np.int32),
        rel_mask=np.ones(n_rels, bool),
        union_feat=rng.standard_normal((n_rels, POOL, POOL, feat_dim)).astype(np.float32) * 0.1,
        spatial_masks=rng.uniform(-0.5, 0.5, (n_rels, MASK_P, MASK_P, 2)).astype(np.float32),
        attention_gt=np.asarray(att_gt, np.float32).reshape(n_rels, schema.NUM_ATTENTION),
        spatial_gt=np.asarray(sp_gt, np.float32).reshape(n_rels, schema.NUM_SPATIAL),
        contacting_gt=np.asarray(con_gt, np.float32).reshape(n_rels, schema.NUM_CONTACTING),
        num_frames=np.int32(n_frames),
    ))
    return pad_entry(e, bucket_boxes, bucket_rels)


# GT boxes are the Entry's boxes moved by up to GT_JITTER pixels per
# coordinate, and an object's GT class is a random one with probability
# GT_FLIP_PROB, so predictions on the Entry match some GT and miss some.
GT_JITTER = 8.0
GT_FLIP_PROB = 0.2


def make_synthetic_gt(entry: Entry, rng: np.random.Generator) -> list[list[dict]]:
    """AG_Test-format GT for one synthetic Entry (padded or not): per
    frame its person box and its objects from the Entry's own box table,
    boxes jittered by GT_JITTER and classes flipped with GT_FLIP_PROB, and
    attention (one), spatial and contacting (one or two each) predicates
    drawn from `rng`."""
    boxes = entry.boxes.numpy()
    frames = entry.box_frame.numpy()
    labels = entry.labels.numpy()
    valid = entry.box_mask.numpy()
    gt = []
    for f in range(int(entry.num_frames)):
        rows = np.flatnonzero(valid & (frames == f))
        person = rows[labels[rows] == 1][0]
        frame = [{"person_bbox": (boxes[person] + rng.uniform(-GT_JITTER, GT_JITTER, 4))
                  .astype(np.float32)[None]}]
        for r in rows[labels[rows] != 1]:
            cls = (int(labels[r]) if rng.uniform() > GT_FLIP_PROB
                   else int(rng.integers(2, schema.NUM_OBJ_CLASSES)))
            frame.append({
                "bbox": (boxes[r] + rng.uniform(-GT_JITTER, GT_JITTER, 4)).astype(np.float32),
                "class": cls,
                "attention_relationship": np.array([rng.integers(0, schema.NUM_ATTENTION)]),
                "spatial_relationship": np.sort(rng.choice(
                    schema.NUM_SPATIAL, size=rng.integers(1, 3), replace=False)),
                "contacting_relationship": np.sort(rng.choice(
                    schema.NUM_CONTACTING, size=rng.integers(1, 3), replace=False)),
            })
        gt.append(frame)
    return gt
