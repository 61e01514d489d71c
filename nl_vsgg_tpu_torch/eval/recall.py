"""Scene-graph Recall@K / meanRecall@K evaluation on the host (port of
nl_vsgg_tpu/eval/recall.py).

Own numpy copy of the JAX package's host evaluator (the port imports
nothing of it: its `eval/__init__.py` pulls in JAX), with the taxonomy from
the port's `data/schema.py`. The code is the same line for line, so the two
evaluators give identical numbers; it is the source of truth that the
on-device scorers (`eval/recall_device.py`) are held against.

Semantics of lib/evaluation_recall.py (SceneGraphEvaluator and its five
metric collectors) with the python-loop core vectorized:

  * with-constraint recall (VSGRecall :190-236): per relation row the argmax
    predicate over the block-diagonal 26-col score layout.
  * no-graph-constraint recall (VSGNoGraphConstraintRecall :305-353):
    obj-score-weighted scores, global top-100 (row, predicate) pairs.
  * semi recall (VSGSemiRecall :241-302): argmax for attention rows,
    >0.5 multi-label for spatial/contacting rows, including the reference's
    block-detection quirk (a spatial/contacting row is recognized by its
    first two block columns being nonzero, :276-287).
  * mean recall variants (VSGMeanRecall/VSGNGMeanRecall :24-187): Neural-
    MOTIFS per-predicate collectors, including the reference's inherited
    quirk that predicate index 0's collector accumulates *every* GT relation
    (recall_count[0] += 1 per row, :82-85), so class 0 reports overall, not
    'looking at', recall. Preserved for number-for-number parity.

The triplet matcher (_compute_pred_matches :731-773) keeps the Cython
bbox_overlaps' +1-pixel IoU convention (lib/fpn/box_intersections_cpu/
bbox.pyx:21-61) and the descending sort by triplet score product with
numpy's (non-stable) argsort tie behavior (evaluate_recall :669-672).

Evaluation is host-side numpy: it consumes ragged GT lists (AG_Test
format; relationship fields may be numpy arrays or CPU torch tensors).
"""

from __future__ import annotations

from functools import reduce

import numpy as np

from ..data import schema


def np_softmax(x: np.ndarray) -> np.ndarray:
    """Stable softmax over the last axis (the one host-side definition:
    models/sgcls_infer imports it rather than re-implementing)."""
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def np_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU, +1-pixel convention (bbox.pyx:21-61)."""
    b1 = np.asarray(boxes1, np.float64)
    b2 = np.asarray(boxes2, np.float64)
    area2 = (b2[:, 2] - b2[:, 0] + 1) * (b2[:, 3] - b2[:, 1] + 1)
    area1 = (b1[:, 2] - b1[:, 0] + 1) * (b1[:, 3] - b1[:, 1] + 1)
    iw = (np.minimum(b1[:, None, 2], b2[None, :, 2])
          - np.maximum(b1[:, None, 0], b2[None, :, 0]) + 1).clip(min=0)
    ih = (np.minimum(b1[:, None, 3], b2[None, :, 3])
          - np.maximum(b1[:, None, 1], b2[None, :, 1]) + 1).clip(min=0)
    inter = iw * ih
    return inter / (area1[:, None] + area2[None, :] - inter)


def intersect_2d(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Row-equality matrix (lib/ults/pytorch_misc.py:233-248)."""
    return (x1[:, None] == x2[None]).all(-1)


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """(n, ndim) indices sorted by score desc (pytorch_misc.py:323-331)."""
    return np.column_stack(np.unravel_index(np.argsort(-scores.ravel()), scores.shape))


def _triplet(predicates, relations, classes, boxes,
             predicate_scores=None, class_scores=None):
    """Format (sub_cls, predicate, obj_cls) triplets (evaluation_recall.py:698-728)."""
    sub_ob = classes[relations[:, :2]]
    triplets = np.column_stack((sub_ob[:, 0], predicates, sub_ob[:, 1]))
    triplet_boxes = np.column_stack((boxes[relations[:, 0]], boxes[relations[:, 1]]))
    triplet_scores = None
    if predicate_scores is not None and class_scores is not None:
        triplet_scores = np.column_stack((class_scores[relations[:, 0]],
                                          class_scores[relations[:, 1]],
                                          predicate_scores))
    return triplets, triplet_boxes, triplet_scores


def _compute_pred_matches(gt_triplets, pred_triplets, gt_boxes, pred_boxes,
                          iou_thresh: float) -> list[list[int]]:
    """pred_to_gt lists (evaluation_recall.py:731-773), vectorized.

    A prediction matches GT i when the triplet labels are equal and both the
    subject and object boxes have IoU >= thresh with GT's.
    """
    keeps = intersect_2d(gt_triplets, pred_triplets)  # (G, P)
    P = pred_triplets.shape[0]
    pred_to_gt: list[list[int]] = [[] for _ in range(P)]
    if not keeps.any():
        return pred_to_gt
    sub_iou = np_iou(gt_boxes[:, :4], pred_boxes[:, :4])
    obj_iou = np_iou(gt_boxes[:, 4:], pred_boxes[:, 4:])
    ok = keeps & (sub_iou >= iou_thresh) & (obj_iou >= iou_thresh)
    gt_inds, pred_inds = np.where(ok)
    # reference appends gt indices in ascending gt order per prediction
    for g, p in zip(gt_inds, pred_inds):
        pred_to_gt[p].append(int(g))
    return pred_to_gt


def evaluate_recall(gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes,
                    pred_classes, rel_scores=None, cls_scores=None,
                    iou_thresh: float = 0.5):
    """Core matcher (evaluation_recall.py:630-695): sort triplets by score
    product desc, then match against GT."""
    if pred_rels.size == 0:
        return [[]], np.zeros((0, 5)), np.zeros(0)
    gt_triplets, gt_triplet_boxes, _ = _triplet(
        gt_rels[:, 2], gt_rels[:, :2], gt_classes, gt_boxes)
    pred_triplets, pred_triplet_boxes, relation_scores = _triplet(
        pred_rels[:, 2], pred_rels[:, :2], pred_classes, pred_boxes,
        rel_scores, cls_scores)
    order = relation_scores.prod(1).argsort()[::-1]
    pred_triplets = pred_triplets[order]
    pred_triplet_boxes = pred_triplet_boxes[order]
    relation_scores = relation_scores[order]
    pred_to_gt = _compute_pred_matches(gt_triplets, pred_triplets,
                                       gt_triplet_boxes, pred_triplet_boxes,
                                       iou_thresh)
    pred_5ples = np.column_stack((pred_rels[:, :2], pred_triplets[:, [0, 2, 1]]))
    return pred_to_gt, pred_5ples, relation_scores


def _recall_at_k(pred_to_gt: list[list[int]], num_gt: int, ks=(10, 20, 50)) -> dict[int, float]:
    out = {}
    for k in ks:
        match = reduce(np.union1d, pred_to_gt[:k]) if pred_to_gt else np.zeros(0)
        out[k] = float(len(match)) / float(num_gt)
    return out


class _MeanRecallCollector:
    """VSGMeanRecall/VSGNGMeanRecall (evaluation_recall.py:24-187)."""

    def __init__(self, num_rel: int, rel_names: list[str]):
        self.num_rel = num_rel
        self.rel_names = rel_names
        self.register()

    def register(self):
        self.collect = {k: [[] for _ in range(self.num_rel)] for k in (10, 20, 50)}
        self.mean_recall = {10: 0.0, 20: 0.0, 50: 0.0}
        self.recall_list = {10: [], 20: [], 50: []}

    def collect_items(self, pred_to_gt, gt_rels):
        for k in self.collect:
            match = reduce(np.union1d, pred_to_gt[:k]) if pred_to_gt else np.zeros(0)
            hit = np.zeros(self.num_rel, np.int64)
            count = np.zeros(self.num_rel, np.int64)
            labels = gt_rels[:, 2].astype(np.int64)
            np.add.at(count, labels, 1)
            count[0] += gt_rels.shape[0]  # reference quirk :82-85
            if len(match):
                mlabels = labels[np.asarray(match, np.int64)]
                np.add.at(hit, mlabels, 1)
                hit[0] += len(match)
            for n in range(self.num_rel):
                if count[n] > 0:
                    self.collect[k][n].append(float(hit[n] / count[n]))

    def calculate(self):
        for k in self.mean_recall:
            self.recall_list[k] = [float(np.mean(c)) if c else 0.0
                                   for c in self.collect[k]]
            self.mean_recall[k] = float(sum(self.recall_list[k])) / self.num_rel


class SceneGraphEvaluator:
    """lib/evaluation_recall.py:355-465 with the same public API.

    `evaluate_scene_graph(gt, pred)` consumes per-video GT annotation lists
    (the AG_Test format) and our model's padded outputs + Entry masks.
    """

    def __init__(self, mode: str, taxonomy=None, iou_threshold: float = 0.5):
        self.mode = mode
        self.iou_threshold = iou_threshold
        tax = taxonomy or schema.load_taxonomy()
        self.all_predicates = list(tax.relationship_classes)
        self.attention_predicates = list(tax.attention_relationships)
        self.spatial_predicates = list(tax.spatial_relationships)
        self.contacting_predicates = list(tax.contacting_relationships)
        self.subject_category = 1
        # contacting_range hardcoded at 9 in the reference (:196) — same here
        self.na, self.ns, self.nc = (len(self.attention_predicates),
                                     len(self.spatial_predicates),
                                     len(self.contacting_predicates))
        self.register_container()

    def register_container(self):
        self.recall = {10: [], 20: [], 50: []}
        self.recall_nogc = {10: [], 20: [], 50: []}
        self.semi_recall = {10: [], 20: [], 50: []}
        self.mean_recall = _MeanRecallCollector(len(self.all_predicates), self.all_predicates)
        self.ng_mean_recall = _MeanRecallCollector(len(self.all_predicates), self.all_predicates)

    # ---- GT graph building (evaluation_recall.py:402-425) ----
    def _gt_entry(self, frame_gt) -> dict:
        n = len(frame_gt)
        gt_boxes = np.zeros((n, 4))
        gt_classes = np.zeros(n)
        gt_classes[0] = self.subject_category
        gt_boxes[0] = np.asarray(frame_gt[0]["person_bbox"]).reshape(-1)[:4]
        rels = []
        for m, obj in enumerate(frame_gt[1:]):
            gt_boxes[m + 1] = np.asarray(obj["bbox"]).reshape(-1)[:4]
            gt_classes[m + 1] = obj["class"]
            att = np.asarray(obj["attention_relationship"]).reshape(-1)
            rels.append([0, m + 1, self.all_predicates.index(
                self.attention_predicates[int(att[0])])])
            for sp in np.asarray(obj["spatial_relationship"]).reshape(-1):
                rels.append([m + 1, 0, self.all_predicates.index(
                    self.spatial_predicates[int(sp)])])  # reversed (:418)
            for c in np.asarray(obj["contacting_relationship"]).reshape(-1):
                rels.append([0, m + 1, self.all_predicates.index(
                    self.contacting_predicates[int(c)])])
        return {"gt_classes": gt_classes, "gt_relations": np.asarray(rels),
                "gt_boxes": gt_boxes}

    # ---- prediction assembly (evaluation_recall.py:429-460) ----
    _softmax = staticmethod(np_softmax)

    def evaluate_scene_graph(self, gt, pred: dict) -> None:
        """gt: list over frames of annotation lists; pred: model output dict
        (+ 'boxes','pair_idx','im_idx' and optional masks) as numpy arrays or
        CPU torch tensors."""
        if not pred:  # grounding produced nothing (train_STTran.py:221-224)
            for frame_gt in gt:
                gt_entry = self._gt_entry(frame_gt)  # mean-recall collectors
                for k in self.recall:
                    self.recall[k].append(0.0)
                    self.recall_nogc[k].append(0.0)
                    self.semi_recall[k].append(0.0)
                self.mean_recall.collect_items([[]], gt_entry["gt_relations"])
                self.ng_mean_recall.collect_items([[]], gt_entry["gt_relations"])
            return

        np_ = lambda a: np.asarray(a)
        rel_mask = np_(pred.get("rel_mask", np.ones(len(np_(pred["im_idx"])), bool)))
        box_mask = np_(pred.get("box_mask", np.ones(len(np_(pred["boxes"])), bool)))
        boxes = np_(pred["boxes"])[:, -4:]  # accept (N,5) frame-prefixed or (N,4)
        pair_idx = np_(pred["pair_idx"])[rel_mask]
        im_idx = np_(pred["im_idx"])[rel_mask]
        att_dist = self._softmax(np_(pred["attention_distribution"]))[rel_mask]
        sp_dist = np_(pred["spatial_distribution"])[rel_mask]
        con_dist = np_(pred["contacting_distribution"])[rel_mask]
        if self.mode == "predcls":
            classes = np_(pred["labels"])
            obj_scores = np_(pred["scores"])
        else:
            classes = np_(pred["pred_labels"])
            obj_scores = np_(pred["pred_scores"])
        del box_mask  # boxes table stays global; padding rows are never referenced

        for idx, frame_gt in enumerate(gt):
            gt_entry = self._gt_entry(frame_gt)
            f = im_idx == idx
            pi = pair_idx[f]
            R = pi.shape[0]
            # 3x pair_idx with block-diagonal scores (:429-460)
            rels_i = np.concatenate((pi, pi[:, ::-1], pi), axis=0)
            z = np.zeros
            s1 = np.concatenate((att_dist[f], z((R, self.ns)), z((R, self.nc))), 1)
            s2 = np.concatenate((z((R, self.na)), sp_dist[f], z((R, self.nc))), 1)
            s3 = np.concatenate((z((R, self.na)), z((R, self.ns)), con_dist[f]), 1)
            rel_scores = np.concatenate((s1, s2, s3), axis=0)
            pred_entry = {"pred_boxes": boxes.astype(float), "pred_classes": classes,
                          "pred_rel_inds": rels_i, "obj_scores": obj_scores,
                          "rel_scores": rel_scores}
            p2g = self._calc_recall(gt_entry, pred_entry, self.recall)
            p2g_ng = self._calc_nogc(gt_entry, pred_entry)
            self._calc_semi(gt_entry, pred_entry)
            self.mean_recall.collect_items(p2g, gt_entry["gt_relations"])
            self.ng_mean_recall.collect_items(p2g_ng, gt_entry["gt_relations"])

    # ---- the three recall variants ----
    def _calc_recall(self, gt_entry, pred_entry, sink):
        """with-constraint (:209-236): argmax predicate per relation row."""
        rel_scores = pred_entry["rel_scores"]
        pred_rels = np.column_stack((pred_entry["pred_rel_inds"], rel_scores.argmax(1)))
        predicate_scores = rel_scores.max(1)
        p2g, _, _ = evaluate_recall(
            gt_entry["gt_relations"], gt_entry["gt_boxes"].astype(float),
            gt_entry["gt_classes"], pred_rels, pred_entry["pred_boxes"],
            pred_entry["pred_classes"], predicate_scores,
            pred_entry["obj_scores"], self.iou_threshold)
        for k, r in _recall_at_k(p2g, gt_entry["gt_relations"].shape[0]).items():
            sink[k].append(r)
        return p2g

    def _calc_nogc(self, gt_entry, pred_entry):
        """no-constraint (:321-353): top-100 of obj^2-weighted scores."""
        rel_scores = pred_entry["rel_scores"]
        inds = pred_entry["pred_rel_inds"]
        obj_per_rel = pred_entry["obj_scores"][inds].prod(1)
        overall = obj_per_rel[:, None] * rel_scores
        si = argsort_desc(overall)[:100]
        pred_rels = np.column_stack((inds[si[:, 0]], si[:, 1]))
        predicate_scores = rel_scores[si[:, 0], si[:, 1]]
        p2g, _, _ = evaluate_recall(
            gt_entry["gt_relations"], gt_entry["gt_boxes"].astype(float),
            gt_entry["gt_classes"], pred_rels, pred_entry["pred_boxes"],
            pred_entry["pred_classes"], predicate_scores,
            pred_entry["obj_scores"], self.iou_threshold)
        for k, r in _recall_at_k(p2g, gt_entry["gt_relations"].shape[0]).items():
            self.recall_nogc[k].append(r)
        return p2g

    def _calc_semi(self, gt_entry, pred_entry):
        """semi (:257-302): argmax attention, >0.5 multilabel spatial/contact,
        with the reference's first-two-column block detection."""
        rel_scores = pred_entry["rel_scores"]
        inds = pred_entry["pred_rel_inds"]
        pred_rels, predicate_scores = [], []
        for i, j in enumerate(inds):
            if rel_scores[i, 0] + rel_scores[i, 1] > 0:
                pred_rels.append(np.append(j, rel_scores[i].argmax()))
                predicate_scores.append(rel_scores[i].max())
            elif rel_scores[i, 3] + rel_scores[i, 4] > 0:
                for k in np.where(rel_scores[i] > 0.5)[0]:
                    pred_rels.append(np.append(j, k))
                    predicate_scores.append(rel_scores[i, k])
            elif rel_scores[i, 9] + rel_scores[i, 10] > 0:
                for k in np.where(rel_scores[i] > 0.5)[0]:
                    pred_rels.append(np.append(j, k))
                    predicate_scores.append(rel_scores[i, k])
        pred_rels = np.asarray(pred_rels)
        predicate_scores = np.asarray(predicate_scores)
        p2g, _, _ = evaluate_recall(
            gt_entry["gt_relations"], gt_entry["gt_boxes"].astype(float),
            gt_entry["gt_classes"], pred_rels, pred_entry["pred_boxes"],
            pred_entry["pred_classes"], predicate_scores,
            pred_entry["obj_scores"], self.iou_threshold)
        for k, r in _recall_at_k(p2g, gt_entry["gt_relations"].shape[0]).items():
            self.semi_recall[k].append(r)

    # ---- reporting ----
    def calculate_mean_recall(self):
        self.mean_recall.calculate()
        self.ng_mean_recall.calculate()

    def mean_score(self, k: int = 20) -> float:
        """Epoch score fed to the plateau scheduler (train_STTran.py:228)."""
        return float(np.mean(self.recall[k])) if self.recall[k] else 0.0

    def print_stats(self, logger=None, note: str = "") -> str:
        """Reference print format (lib/evaluation_recall.py:383-391). `note`
        annotates EVERY stats line (e.g. 'burn-in subset only' when the
        device-eval promotion skipped host scoring for most of the split) so
        a partial table copied into a report carries its own qualification."""
        tag = f" [{note}]" if note else ""
        lines = [f"======================{self.mode}============================"]
        for name, sink in (("Recall(Main)", self.recall),
                           ("No Graph Constraint Recall(Main)", self.recall_nogc),
                           ("Semi Recall", self.semi_recall)):
            s = "SGG eval: " + "".join(
                "  R @ %d: %.4f; " % (k, float(np.mean(v)) if v else 0.0)
                for k, v in sink.items())
            lines.append(s + f" for mode={self.mode}, type={name}.{tag}")
        for name, mr in (("Mean Recall", self.mean_recall),
                         ("NG Mean Recall", self.ng_mean_recall)):
            s = "SGG eval: " + "".join(
                " mR @ %d: %.4f; " % (k, v) for k, v in mr.mean_recall.items())
            lines.append(s + f" for mode={self.mode}, type={name}.{tag}")
        out = "\n".join(lines)
        if logger is not None:
            logger.info(out)
        return out
