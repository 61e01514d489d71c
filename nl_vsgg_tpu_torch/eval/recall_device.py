"""Batched Recall@K scoring on the card (port of nl_vsgg_tpu/eval/recall_jax.py).

The host evaluator (eval/recall.py) is the source of truth; these functions
compute the same with-constraint, no-constraint and semi R@K (and the
mean-recall hit counts) as torch ops over padded tensors with leading
(video, frame) axes, so one pass scores a whole eval batch.

Semantics (pinned by parity tests against recall_jax and eval/recall.py):
  * a frame's candidate triplets are ranked by sub_score * obj_score *
    predicate score, descending; equal scores keep the candidates' order of
    enumeration (`jnp.argsort` is stable and `lax.top_k` puts the lower
    index first, so both become one stable descending sort here);
  * a candidate matches a GT triplet when (sub_cls, predicate, obj_cls) are
    equal and both boxes have IoU >= 0.5 (+1-pixel convention);
  * R@k = |GT matched by any of the frame's first k candidates| / |GT|.

Layout. The JAX module builds each frame's candidates as explicit (C, 3)
triplets and (C, 8) box pairs and matches them against the frame's GT, a
(G, C) problem per frame. A candidate's classes and boxes depend only on its
relation row (and whether the block swaps subject and object), so here the
subject/object test is formed once per (GT, relation row), (B, F, G, R), and
each GT looks up the candidates that carry its own predicate: one per row.
With the 26 predicates of the no-constraint and semi variants that is 26x
less than matching every candidate, and the result is the same. Candidates
are ranked once per video by a stable sort; a frame's ranks are the running
count of its valid candidates in that order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..data.entry import to_numpy
from ..device import resolve_device
from ..ops.boxes import iou
from .recall import np_softmax

KS = (10, 20, 50)
IOU_THRESH = 0.5
NUM_PREDICATES = 26
_NOT_RANKED = 1 << 40   # rank of a candidate outside a frame's list


class Candidates(NamedTuple):
    """One variant's candidate triplets for every frame of a batch of
    videos, by reference to relation rows, in the JAX module's order of
    enumeration along C:

    row (C,) relation row of each candidate; rev (C,) subject and object
    swapped (the spatial block); pred (B, C) or (C,) predicate; score
    (B, C) ranking score; valid (B, F, C) candidate of frame f; slot
    (P, R) the candidate of predicate p on row r; top_n: only a frame's
    first top_n valid candidates count (None: all)."""
    row: torch.Tensor
    rev: torch.Tensor
    pred: torch.Tensor
    score: torch.Tensor
    valid: torch.Tensor
    slot: torch.Tensor
    top_n: int | None = None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-video gather: x (B, N, ...), idx (B, R) -> (B, R, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _blocks(att, sp, con):
    """(probs, first predicate, swapped) of the three predicate blocks."""
    na, ns = att.shape[-1], sp.shape[-1]
    return ((att, 0, False), (sp, na, True), (con, na + ns, False))


def _frame_sel(im_idx, rel_mask, num_frames: int) -> torch.Tensor:
    frames = torch.arange(num_frames, device=im_idx.device)
    return rel_mask[:, None, :] & (im_idx[:, None, :] == frames[None, :, None])  # (B, F, R)


def assemble_with_constraint(pair_idx, im_idx, rel_mask, att_probs, sp_probs, con_probs,
                             obj_scores, num_frames: int) -> Candidates:
    """Per relation row, each block's argmax predicate (eval/recall.py::
    _calc_recall): candidates [block 1 rows, block 2 rows, block 3 rows]."""
    sub, obj = pair_idx[..., 0], pair_idx[..., 1]
    w = _take(obj_scores, sub) * _take(obj_scores, obj)               # (B, R)
    R, dev = pair_idx.shape[1], pair_idx.device
    blocks = _blocks(att_probs, sp_probs, con_probs)
    pred = torch.cat([p.argmax(-1) + first for p, first, _ in blocks], -1)
    score = torch.cat([w * p.amax(-1) for p, _, _ in blocks], -1)
    rev = torch.tensor([r for _, _, r in blocks], device=dev).repeat_interleave(R)
    block_of = torch.cat([torch.full((p.shape[-1],), b, device=dev)
                          for b, (p, _, _) in enumerate(blocks)])
    slot = block_of[:, None] * R + torch.arange(R, device=dev)[None, :]
    sel = _frame_sel(im_idx, rel_mask, num_frames)
    return Candidates(torch.arange(R, device=dev).repeat(3), rev, pred, score,
                      sel.repeat(1, 1, 3), slot)


def _grid(pair_idx, im_idx, rel_mask, att_probs, sp_probs, con_probs, obj_scores,
          num_frames: int):
    """Every (relation row, predicate) of the three blocks, row-major
    inside a block (the JAX module's `reshape(R * width)`): row, rev, pred,
    score w * p, the frame selection (B, F, C) and the slot table."""
    sub, obj = pair_idx[..., 0], pair_idx[..., 1]
    w = _take(obj_scores, sub) * _take(obj_scores, obj)
    sel = _frame_sel(im_idx, rel_mask, num_frames)
    R, dev = pair_idx.shape[1], pair_idx.device
    rows, revs, preds, scores, sels, slot = [], [], [], [], [], []
    off = 0
    for probs, first, rev in _blocks(att_probs, sp_probs, con_probs):
        width = probs.shape[-1]
        rows.append(torch.arange(R, device=dev).repeat_interleave(width))
        revs.append(torch.full((R * width,), rev, device=dev))
        preds.append((torch.arange(width, device=dev) + first).repeat(R))
        scores.append((w[..., None] * probs).flatten(-2))
        sels.append(sel.repeat_interleave(width, -1))
        slot.append(off + torch.arange(R, device=dev)[None, :] * width
                    + torch.arange(width, device=dev)[:, None])
        off += R * width
    cat = torch.cat
    return (cat(rows), cat(revs), cat(preds), cat(scores, -1), cat(sels, -1), cat(slot))


def assemble_no_constraint(pair_idx, im_idx, rel_mask, att_probs, sp_probs, con_probs,
                           obj_scores, num_frames: int, top_n: int = 100) -> Candidates:
    """Every (relation row, predicate) scored by obj_sub * obj_obj *
    predicate, a frame's first `top_n` with a score above 0 ranked
    (eval/recall.py::_calc_nogc)."""
    row, rev, pred, score, sel, slot = _grid(pair_idx, im_idx, rel_mask, att_probs, sp_probs,
                                             con_probs, obj_scores, num_frames)
    return Candidates(row, rev, pred, score, sel & (score > 0)[:, None], slot, top_n)


def assemble_semi(pair_idx, im_idx, rel_mask, att_probs, sp_probs, con_probs,
                  obj_scores, num_frames: int) -> Candidates:
    """Attention rows give their argmax, spatial and contacting rows every
    predicate above 0.5 (eval/recall.py::_calc_semi). The host's
    block-detection quirk holds by construction: softmax attention is
    always positive and sigmoid blocks stay in their own columns."""
    row, rev, pred, score, sel, slot = _grid(pair_idx, im_idx, rel_mask, att_probs, sp_probs,
                                             con_probs, obj_scores, num_frames)
    att_hot = torch.nn.functional.one_hot(att_probs.argmax(-1), att_probs.shape[-1]).bool()
    chosen = torch.cat([att_hot.flatten(-2), (sp_probs > 0.5).flatten(-2),
                        (con_probs > 0.5).flatten(-2)], -1)                # (B, C)
    return Candidates(row, rev, pred, score, sel & chosen[:, None], slot)


def frame_ranks(score: torch.Tensor, valid: torch.Tensor, top_n: int | None = None
                ) -> torch.Tensor:
    """score (B, C), valid (B, F, C) -> (B, F, C) int64: each valid
    candidate's position among its frame's valid candidates by descending
    score, equal scores in order of C; `_NOT_RANKED` where not valid or at
    or past top_n. One stable sort per video serves every frame: a stable
    order restricted to a subset is that subset's stable order."""
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    idx = order[:, None, :].expand_as(valid)
    pos_sorted = valid.gather(-1, idx).long().cumsum(-1) - 1
    pos = torch.empty_like(pos_sorted).scatter_(-1, idx, pos_sorted)
    keep = valid if top_n is None else valid & (pos < top_n)
    return torch.where(keep, pos, _NOT_RANKED)


def pair_match(gt_trip, gt_boxes8, pair_idx, boxes, classes) -> tuple[torch.Tensor, torch.Tensor]:
    """Subject and object of each (GT, relation row): (B, F, G, R) bools,
    classes equal and both IoUs >= 0.5, for the row as it is (fwd) and with
    subject and object swapped (rev)."""
    sub, obj = pair_idx[..., 0], pair_idx[..., 1]
    sb, ob = _take(boxes, sub)[:, None], _take(boxes, obj)[:, None]    # (B, 1, R, 4)
    sc, oc = _take(classes, sub)[:, None, None], _take(classes, obj)[:, None, None]
    gs, go = gt_boxes8[..., :4], gt_boxes8[..., 4:]
    gcs, gco = gt_trip[..., 0, None], gt_trip[..., 2, None]

    def ok(iou_s, iou_o):
        return (iou_s >= IOU_THRESH) & (iou_o >= IOU_THRESH)

    fwd = (gcs == sc) & (gco == oc) & ok(iou(gs, sb, True), iou(go, ob, True))
    rev = (gcs == oc) & (gco == sc) & ok(iou(gs, ob, True), iou(go, sb, True))
    return fwd, rev


def best_rank(cands: Candidates, pos: torch.Tensor, gt_trip, gt_mask, fwd, rev
              ) -> torch.Tensor:
    """(B, F, G): the smallest rank of a candidate that matches each GT
    triplet (`_NOT_RANKED` if none): the candidates of the GT's predicate,
    one per relation row."""
    B, F_, G = gt_mask.shape
    R = cands.slot.shape[1]
    p = gt_trip[..., 1]
    slot = cands.slot[p]                                              # (B, F, G, R)
    flat = slot.reshape(B, F_, G * R)
    ranks = pos.gather(-1, flat).view(B, F_, G, R)
    pred = cands.pred.expand(B, -1).gather(-1, flat.reshape(B, -1)).view(B, F_, G, R)
    ok = torch.where(cands.rev[slot], rev, fwd) & (pred == p[..., None]) & gt_mask[..., None]
    return torch.where(ok, ranks, _NOT_RANKED).amin(-1)


def _recall(best, gt_mask, ks) -> torch.Tensor:
    n_gt = gt_mask.sum(-1).clamp(min=1)
    return torch.stack([((best < k) & gt_mask).sum(-1) / n_gt for k in ks], -1)


def recall_frame(gt_trip, gt_boxes8, gt_mask, pr_trip, pr_boxes8, pr_scores, pr_mask,
                 ks: Sequence[int] = KS) -> torch.Tensor:
    """R@k of explicit candidates: gt (..., G, 3|8), gt_mask (..., G), pr
    (..., P, 3|8), pr_scores and pr_mask (..., P) -> (..., len(ks))."""
    lead, P = pr_scores.shape[:-1], pr_scores.shape[-1]
    pos = frame_ranks(pr_scores.reshape(-1, P), pr_mask.reshape(-1, 1, P)).reshape(*lead, P)
    same = (gt_trip[..., :, None, :] == pr_trip[..., None, :, :]).all(-1)
    ok = (same & (iou(gt_boxes8[..., :4], pr_boxes8[..., :4], True) >= IOU_THRESH)
          & (iou(gt_boxes8[..., 4:], pr_boxes8[..., 4:], True) >= IOU_THRESH)
          & gt_mask[..., None])
    best = torch.where(ok, pos[..., None, :], _NOT_RANKED).amin(-1)
    return _recall(best, gt_mask, ks)


_ASSEMBLE = {"with": assemble_with_constraint, "no": assemble_no_constraint,
             "semi": assemble_semi}


def _video_best(kind: str, gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                att_probs, sp_probs, con_probs, boxes, classes, obj_scores, match=None):
    if match is None:
        match = pair_match(gt_trip, gt_boxes8, pair_idx, boxes, classes)
    cands = _ASSEMBLE[kind](pair_idx, im_idx, rel_mask, att_probs, sp_probs, con_probs,
                            obj_scores, gt_mask.shape[1])
    pos = frame_ranks(cands.score, cands.valid, cands.top_n)
    return best_rank(cands, pos, gt_trip, gt_mask, *match)


def _recall_video(kind, gt_trip, gt_boxes8, gt_mask, *rel, ks=KS):
    best = _video_best(kind, gt_trip, gt_boxes8, gt_mask, *rel)
    return _recall(best, gt_mask, ks), gt_mask.any(-1)


def recall_video_with_constraint(gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                                 att_probs, sp_probs, con_probs, boxes, classes, obj_scores,
                                 ks: Sequence[int] = KS):
    """Every frame of a batch of videos at once. gt_* are (B, F, G, ...);
    relation tensors (B, R, ...) with their frame in im_idx; boxes, classes
    and obj_scores (B, N, ...). Index tensors are int64. Returns (B, F,
    len(ks)) recalls and the (B, F) frame-has-GT mask."""
    return _recall_video("with", gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                         att_probs, sp_probs, con_probs, boxes, classes, obj_scores, ks=ks)


def recall_video_no_constraint(gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                               att_probs, sp_probs, con_probs, boxes, classes, obj_scores,
                               ks: Sequence[int] = KS):
    """As recall_video_with_constraint, the no-constraint candidates."""
    return _recall_video("no", gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                         att_probs, sp_probs, con_probs, boxes, classes, obj_scores, ks=ks)


def recall_video_semi(gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                      att_probs, sp_probs, con_probs, boxes, classes, obj_scores,
                      ks: Sequence[int] = KS):
    """As recall_video_with_constraint, the semi candidates."""
    return _recall_video("semi", gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                         att_probs, sp_probs, con_probs, boxes, classes, obj_scores, ks=ks)


def mean_recall_video(gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                      att_probs, sp_probs, con_probs, boxes, classes, obj_scores,
                      num_predicates: int = NUM_PREDICATES, ks: Sequence[int] = KS):
    """Per-frame, per-predicate (hit, count) of the with-constraint match
    for the mean-recall collectors, the host's class-0 overall accumulator
    included: hits (B, F, len(ks), P), counts (B, F, P), float32."""
    best = _video_best("with", gt_trip, gt_boxes8, gt_mask, pair_idx, im_idx, rel_mask,
                       att_probs, sp_probs, con_probs, boxes, classes, obj_scores)
    onehot = torch.nn.functional.one_hot(gt_trip[..., 1], num_predicates).float()
    onehot = onehot * gt_mask[..., None]
    counts = onehot.sum(-2)
    counts[..., 0] += gt_mask.sum(-1)                     # class-0 quirk (:82-85)
    hits = []
    for k in ks:
        hit = (best < k) & gt_mask
        h = (onehot * hit[..., None]).sum(-2)
        h[..., 0] += hit.sum(-1)
        hits.append(h)
    return torch.stack(hits, -2), counts


def _recall_batch_all(gt_trip, gt_boxes8, gt_mask, *rel, ks: Sequence[int] = KS):
    """All three R@K variants of a (B, ...) batch: (rc, ng, sm) each (B, F,
    len(ks)) and has (B, F). The subject/object match is formed once."""
    match = pair_match(gt_trip, gt_boxes8, rel[0], rel[6], rel[7])
    out = [_recall(_video_best(kind, gt_trip, gt_boxes8, gt_mask, *rel, match=match),
                   gt_mask, ks) for kind in ("with", "no", "semi")]
    return (*out, gt_mask.any(-1))


def pack_gt_video(gt_annotation, evaluator, g_max: int = 32, f_bucket: int | None = None):
    """AG_Test per-frame GT lists -> padded (F, G, ...) triplet arrays, with
    the host evaluator's own GT-graph builder.

    Returns (trip, boxes8, mask, dropped); dropped counts the GT that the
    buckets leave out (frames past `f_bucket`, relations past `g_max`).
    Callers must surface a nonzero count: a smaller GT denominator inflates
    the device R@K over the host evaluator's."""
    F = len(gt_annotation) if f_bucket is None else f_bucket
    trip = np.zeros((F, g_max, 3), np.int64)
    boxes8 = np.zeros((F, g_max, 8), np.float32)
    mask = np.zeros((F, g_max), bool)
    dropped = 0
    for f, frame_gt in enumerate(gt_annotation):
        e = evaluator._gt_entry(frame_gt)
        rels = e["gt_relations"]
        if f >= F:
            dropped += len(rels)
            continue
        cls = e["gt_classes"].astype(np.int64)
        bx = e["gt_boxes"].astype(np.float32)
        n = min(len(rels), g_max)
        dropped += len(rels) - n
        for i in range(n):
            s, o, p = rels[i]
            trip[f, i] = [cls[s], p, cls[o]]
            boxes8[f, i, :4] = bx[s]
            boxes8[f, i, 4:] = bx[o]
        mask[f, :n] = True
    return trip, boxes8, mask, dropped


def host_args(entry, pred: dict, packed) -> tuple[np.ndarray, ...]:
    """The 12 scorer arguments of one video as host arrays: its packed GT,
    the Entry's relation slots and boxes, and the model outputs. Attention
    goes through the same float32 softmax as the host evaluator's."""
    trip, boxes8, mask, _ = packed
    return (trip, boxes8, mask,
            to_numpy(entry.pair_idx).astype(np.int64),
            to_numpy(entry.im_idx).astype(np.int64),
            to_numpy(entry.rel_mask).astype(bool),
            np_softmax(np.asarray(to_numpy(pred["attention_distribution"]), np.float32)),
            np.asarray(to_numpy(pred["spatial_distribution"]), np.float32),
            np.asarray(to_numpy(pred["contacting_distribution"]), np.float32),
            np.asarray(to_numpy(entry.boxes), np.float32),
            to_numpy(pred["pred_labels"]).astype(np.int64),
            np.asarray(to_numpy(pred["pred_scores"]), np.float32))


def device_eval_batch(entries, preds: list[dict], gt_annotations, evaluator,
                      g_max: int = 32, f_bucket: int | None = None,
                      device=None) -> list[dict]:
    """Score a whole eval batch on the card: per group of videos with the
    same padded shapes, one stacked upload per argument, one call of the
    three scorers and one packed device-to-host fetch.

    Returns per video {'recall', 'recall_nogc', 'semi': (F_valid, 3) rows of
    the frames that have GT, 'gt_dropped': int}. `device=None` is the card."""
    device = resolve_device(device)
    packed = [pack_gt_video(g, evaluator, g_max, f_bucket) for g in gt_annotations]
    args = [host_args(e, p, pk) for e, p, pk in zip(entries, preds, packed)]
    rows: list[dict | None] = [None] * len(args)
    by_shape: dict[tuple, list[int]] = {}
    for i, a in enumerate(args):
        by_shape.setdefault(tuple(x.shape for x in a), []).append(i)
    for idxs in by_shape.values():
        stacked = [torch.from_numpy(np.stack([args[i][j] for i in idxs])).to(device)
                   for j in range(12)]
        rc, ng, sm, has = _recall_batch_all(*stacked)
        host = torch.cat([rc, ng, sm, has[..., None].float()], -1).cpu().numpy()
        K = rc.shape[-1]
        for bi, i in enumerate(idxs):
            sel = host[bi, :, 3 * K] > 0
            rows[i] = {"recall": host[bi, sel, :K], "recall_nogc": host[bi, sel, K:2 * K],
                       "semi": host[bi, sel, 2 * K:3 * K], "gt_dropped": packed[i][3]}
    return rows  # type: ignore[return-value]


def device_eval_video(entry, pred: dict, gt_annotation, evaluator, g_max: int = 32,
                      f_bucket: int | None = None, device=None) -> dict:
    """All three R@K variants of one video (`device_eval_batch` of one)."""
    return device_eval_batch([entry], [pred], [gt_annotation], evaluator, g_max, f_bucket,
                             device)[0]
