"""Entry construction for the non-wks inference paths (port of
nl_vsgg_tpu/data/infer_entry.py).

Glues the host-side detection cleanups (models/sgdet_infer.sgdet_assign,
models/sgcls_infer.sgcls_assign) to the relation models: packs their box
tables and rebuilt person->object pairs into a padded Entry with union
boxes, spatial masks and (optionally) detector union features, the tail of
the reference's lib/sttran.py:236-283 / :142-170 inference branches.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import schema
from .entry import FEAT_DIM, MASK_P, POOL, Entry, pad_entry

# (frame index, (n, 4) union boxes) -> (n, POOL, POOL, feat_dim) union features
UnionFeatFn = Callable[[int, np.ndarray], np.ndarray]


def build_infer_entry(assign: dict, num_frames: int, bucket_boxes: int,
                      bucket_rels: int, union_feat_fn: UnionFeatFn | None = None,
                      feat_dim: int = FEAT_DIM,
                      compute_spatial_masks: bool = True) -> Entry | None:
    """`assign` is the dict from sgdet_assign / sgcls_assign (+ 'boxes',
    'box_frame', 'features' present for sgdet; sgcls passes them alongside).
    Returns a padded Entry (CPU tensors) whose labels are the *predicted*
    classes, or None when there are no pairs. `compute_spatial_masks=False`
    leaves the width-0 mask sentinel that the model rasterizes on the card
    (models/sttran.spatial_mask_input)."""
    boxes = np.asarray(assign["boxes"], np.float32)
    frames = np.asarray(assign["box_frame"], np.int32)
    feats = np.asarray(assign["features"], np.float32)
    dist = np.asarray(assign["distribution"], np.float32)
    labels = np.asarray(assign["pred_labels"], np.int64)
    scores = np.asarray(assign["pred_scores"], np.float32)
    pair = np.asarray(assign["pair_idx"], np.int64).reshape(-1, 2)
    im_idx = np.asarray(assign["im_idx"], np.int32)
    n_boxes, n_rels = len(boxes), len(pair)
    if n_rels == 0:
        return None

    union = np.concatenate([
        np.minimum(boxes[pair[:, 0], :2], boxes[pair[:, 1], :2]),
        np.maximum(boxes[pair[:, 0], 2:], boxes[pair[:, 1], 2:])], axis=1)
    uf = np.zeros((n_rels, POOL, POOL, feat_dim), np.float32)
    if union_feat_fn is not None:
        for f in np.unique(im_idx):
            sel = im_idx == f
            uf[sel] = union_feat_fn(int(f), union[sel])
    if compute_spatial_masks:
        from ..ops.union_masks import draw_union_boxes
        pair_rois = np.concatenate([boxes[pair[:, 0]], boxes[pair[:, 1]]], 1)
        masks = (draw_union_boxes(torch.from_numpy(pair_rois), MASK_P) - 0.5).numpy()
    else:  # compute-on-device sentinel (models/sttran.spatial_mask_input)
        masks = np.zeros((n_rels, MASK_P, MASK_P, 0), np.float32)

    e = Entry.from_numpy(dict(
        boxes=boxes, box_frame=frames, box_mask=np.ones(n_boxes, bool),
        labels=labels.astype(np.int32), scores=scores,
        # Entry.distribution is the 36-col no-bg form; sgdet/sgcls dists are
        # already 36-col
        distribution=dist[:, -(schema.NUM_OBJ_CLASSES - 1):],
        features=feats,
        pair_idx=pair.astype(np.int32), im_idx=im_idx,
        rel_mask=np.ones(n_rels, bool), union_feat=uf, spatial_masks=masks,
        attention_gt=np.zeros((n_rels, schema.NUM_ATTENTION), np.float32),
        spatial_gt=np.zeros((n_rels, schema.NUM_SPATIAL), np.float32),
        contacting_gt=np.zeros((n_rels, schema.NUM_CONTACTING), np.float32),
        num_frames=np.int32(num_frames),
    ))
    return pad_entry(e, bucket_boxes, bucket_rels)
