"""GT matching (port of nl_vsgg_tpu/data/funcs.py, reference lib/funcs.py).

`assign_relations` matches detector boxes to GT boxes at IoU >= 0.5 and
splits each frame's GT into found and supplementary records: the label
source of the reference's non-wks training path (lib/funcs.py:6-77). The
IoU is the evaluator's +1-pixel `np_iou`, vectorized. Host numpy.
"""

from __future__ import annotations

import numpy as np

from ..eval.recall import np_iou


def assign_relations(prediction_boxes: np.ndarray, pred_frames: np.ndarray,
                     gt_annotations, assign_iou_threshold: float = 0.5):
    """Per frame, match each GT box to its best untaken prediction (IoU >=
    the threshold). Returns (detector_found_idx, gt_relations,
    supply_relations), lists by frame: the matched prediction rows, the
    (prediction row, GT record) pairs, and the GT records no prediction
    covered (to be supplied as extra boxes)."""
    detector_found_idx, gt_rel, supply = [], [], []
    for f, frame_gt in enumerate(gt_annotations):
        rows = np.where(pred_frames == f)[0]
        boxes = prediction_boxes[rows]
        records = list(frame_gt)
        gt_boxes = [np.asarray(rec["person_bbox"] if "person_bbox" in rec else rec["bbox"])
                    .reshape(-1)[:4] for rec in records]
        found, rels, miss = [], [], []
        if len(boxes) and len(gt_boxes):
            iou = np_iou(np.asarray(gt_boxes, np.float64), boxes)
            taken: set[int] = set()
            for g, rec in enumerate(records):
                hit = next((int(j) for j in np.argsort(-iou[g])
                            if iou[g, j] >= assign_iou_threshold and int(j) not in taken), None)
                if hit is None:
                    miss.append(rec)
                else:
                    taken.add(hit)
                    found.append(int(rows[hit]))
                    rels.append((int(rows[hit]), rec))
        else:
            miss = records
        detector_found_idx.append(found)
        gt_rel.append(rels)
        supply.append(miss)
    return detector_found_idx, gt_rel, supply
