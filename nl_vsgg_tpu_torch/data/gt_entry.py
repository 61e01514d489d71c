"""GT-box Entries for PredCLS / SGCLS evaluation (port of
nl_vsgg_tpu/data/gt_entry.py).

Rebuilds the reference's non-wks detector path (lib/object_detector.py:53-171):
boxes come from the GT annotations (the person first in each frame), RoI
features from the VinVL backbone at the GT boxes, pairs person -> object for
every annotated object, with the relation GT attached.

Feature access is pluggable:
  * feature_fn(frame_idx, boxes_xyxy) -> (K, feat_dim) pooled RoI features
    (AttrRCNNTorch.extract_box_features(...).mean((-3, -2)), or precomputed);
  * union_feature_fn(frame_idx, boxes_xyxy) -> (K, 7, 7, feat_dim), predcls
    only;
  * classify_fn(features) -> (K, 1595) OpenImages logits, sgcls only: the
    reference takes the best non-background OI class of each box and draws
    one of its mapped AG classes at random for an AG soft distribution
    (create_dis_list, lib/assign_pseudo_label.py:941-958).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..eval.recall import np_softmax
from ..ops.union_masks import draw_union_boxes_np
from . import schema
from .entry import FEAT_DIM, MASK_P, POOL, Entry, pad_entry
from .grounding import create_dis


def build_gt_entry(gt_annotation, mode: str, bucket_boxes: int, bucket_rels: int,
                   feature_fn: Callable[[int, np.ndarray], np.ndarray],
                   union_feature_fn: Callable[[int, np.ndarray], np.ndarray] | None = None,
                   classify_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                   feat_dim: int = FEAT_DIM, assets_dir: str | None = None,
                   rng: np.random.Generator | None = None,
                   compute_spatial_masks: bool = True) -> Entry:
    """AGTest-style per-frame GT lists -> a padded Entry of CPU tensors."""
    if mode not in ("predcls", "sgcls"):
        raise ValueError(f"mode {mode!r}: GT-box entries are for predcls and sgcls")
    boxes, frames, labels = [], [], []
    pair_idx, im_idx = [], []
    a_rel, s_rel, c_rel = [], [], []
    human_row = {}

    for i, frame_gt in enumerate(gt_annotation):
        for m in frame_gt:
            row = len(boxes)
            if "person_bbox" in m:
                boxes.append(np.asarray(m["person_bbox"]).reshape(-1)[:4])
                labels.append(1)
                human_row[i] = row
            else:
                boxes.append(np.asarray(m["bbox"]).reshape(-1)[:4])
                labels.append(int(m["class"]))
                pair_idx.append([human_row[i], row])
                im_idx.append(i)
                a_rel.append(np.asarray(m["attention_relationship"]).reshape(-1))
                s_rel.append(np.asarray(m["spatial_relationship"]).reshape(-1))
                c_rel.append(np.asarray(m["contacting_relationship"]).reshape(-1))
            frames.append(i)

    n_boxes, n_rels = len(boxes), len(pair_idx)
    boxes = np.asarray(boxes, np.float32).reshape(n_boxes, 4)
    frames = np.asarray(frames, np.int32)
    labels = np.asarray(labels, np.int64)
    pair_np = np.asarray(pair_idx, np.int64).reshape(n_rels, 2)

    # features per frame at the GT boxes (lib/object_detector.py:99-106)
    feats = np.zeros((n_boxes, feat_dim), np.float32)
    for i in np.unique(frames):
        sel = frames == i
        feats[sel] = feature_fn(int(i), boxes[sel])

    uf = np.zeros((n_rels, POOL, POOL, feat_dim), np.float32)
    # sgcls stage-1 entries keep zero masks (the classifier does not read
    # them, and the eval flow rebuilds pairs and masks after reassignment);
    # compute_spatial_masks=False gives the compute-on-device sentinel
    masks = (np.zeros((n_rels, MASK_P, MASK_P, 2), np.float32)
             if compute_spatial_masks or mode == "sgcls"
             else np.zeros((n_rels, MASK_P, MASK_P, 0), np.float32))
    if mode == "predcls":
        union = np.concatenate([
            np.minimum(boxes[pair_np[:, 0], :2], boxes[pair_np[:, 1], :2]),
            np.maximum(boxes[pair_np[:, 0], 2:], boxes[pair_np[:, 1], 2:])], 1)
        if union_feature_fn is not None:
            im = np.asarray(im_idx)
            for i in np.unique(im):
                sel = im == i
                uf[sel] = union_feature_fn(int(i), union[sel])
        if compute_spatial_masks:
            pair_rois = np.concatenate([boxes[pair_np[:, 0]], boxes[pair_np[:, 1]]], 1)
            masks = (draw_union_boxes_np(pair_rois, MASK_P) - 0.5).astype(np.float32)
        scores = np.ones(n_boxes, np.float32)
        distribution = np.eye(schema.NUM_OBJ_CLASSES, dtype=np.float32)[labels][:, 1:]
    else:  # sgcls: VinVL-classified soft distributions (create_dis_list)
        if classify_fn is None:
            raise ValueError("sgcls GT entries need the detector's classifier (classify_fn)")
        rng = rng or np.random.default_rng(1000)
        oi_logits = np.asarray(classify_fn(feats))  # (N, 1595)
        oi_probs = np_softmax(oi_logits[:, 1:])
        oi_scores = oi_probs.max(1)
        oi_labels = oi_probs.argmax(1)
        oi_to_ag, _ = schema.load_oi_ag_maps(assets_dir)
        all_ag = list(range(2, 36))
        idx = np.empty(n_boxes, np.int64)
        for b in range(n_boxes):
            mapped = oi_to_ag.get(int(oi_labels[b]), [])
            idx[b] = (rng.choice(mapped) if mapped else rng.choice(all_ag)) - 1
        distribution = create_dis(oi_scores, idx)
        scores = distribution.max(1).astype(np.float32)

    def multi_hot(rels, num):
        m = np.zeros((n_rels, num), np.float32)
        for i, ids in enumerate(rels):
            m[i, np.asarray(ids, np.int64)] = 1.0
        return m

    e = Entry.from_numpy(dict(
        boxes=boxes, box_frame=frames, box_mask=np.ones(n_boxes, bool),
        labels=labels.astype(np.int32), scores=scores,
        distribution=distribution.astype(np.float32), features=feats,
        pair_idx=pair_np.astype(np.int32),
        im_idx=np.asarray(im_idx, np.int32).reshape(n_rels),
        rel_mask=np.ones(n_rels, bool), union_feat=uf, spatial_masks=masks,
        attention_gt=multi_hot(a_rel, schema.NUM_ATTENTION),
        spatial_gt=multi_hot(s_rel, schema.NUM_SPATIAL),
        contacting_gt=multi_hot(c_rel, schema.NUM_CONTACTING),
        num_frames=np.int32(len(gt_annotation)),
    ))
    return pad_entry(e, bucket_boxes, bucket_rels)
