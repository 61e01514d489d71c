"""Greedy non-maximum suppression over padded box sets (port of
nl_vsgg_tpu/ops/nms.py), batched over leading axes.

`nms_mask` / `batched_nms_mask`: the full pairwise IoU matrix formed once,
then the greedy pass in score order (a stable argsort of the scores, so
equal scores keep their input order) updating a suppression mask as tensors;
the keep flags are scattered back to the input order. The pass is a Python
loop over the N boxes of about five tensor ops a step, so on the card it
costs O(N) kernel launches (about 1500 for N=300) where the JAX op is one
compiled `lax.fori_loop`. It makes no host sync.
With `class_ids`, boxes of different classes never suppress each other.
They are public ops that no path of the JAX package calls (its RPN imports
`nms_mask` but calls `nms_topk`; sgdet inference runs its own host NMS,
models/sgdet_infer._nms).

`nms_topk`: greedy NMS visits boxes in score order, so its first k
survivors are k rounds of pick-the-best-live-box and suppress-its-overlaps.
The JAX function runs those rounds as a `lax.scan` per image (vmapped over
frames); here they are a loop of k steps over (F, N) live scores, one
argmax per row per step (the first maximum among ties, as `jnp.argmax`).

The legacy +1-pixel IoU is the default everywhere.
"""

from __future__ import annotations

import torch

from .boxes import iou

NEG_INF = -1e30


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor | None,
                     iou_threshold: float, valid: torch.Tensor | None = None,
                     plus_one: bool = True) -> torch.Tensor:
    """Per-class greedy NMS: boxes (..., N, 4), scores (..., N), class_ids
    (..., N) or None (one class), valid (..., N) bool -> keep (..., N) bool."""
    n = scores.shape[-1]
    if valid is None:
        valid = torch.ones_like(scores, dtype=torch.bool)
    order = torch.argsort(-torch.where(valid, scores.float(), NEG_INF), dim=-1, stable=True)
    sboxes = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    svalid = valid.gather(-1, order)
    overlap = iou(sboxes, sboxes, plus_one) > iou_threshold          # (..., N, N)
    if class_ids is not None:
        scls = class_ids.gather(-1, order)
        overlap &= scls[..., :, None] == scls[..., None, :]
    ar = torch.arange(n, device=scores.device)
    keep = torch.zeros_like(svalid)
    suppressed = torch.zeros_like(svalid)
    for i in range(n):
        keep_i = svalid[..., i] & ~suppressed[..., i]
        keep[..., i] = keep_i
        # a kept box suppresses every later box it overlaps
        suppressed |= keep_i[..., None] & (ar > i) & overlap[..., i, :]
    return torch.zeros_like(keep).scatter_(-1, order, keep)


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor | None = None, plus_one: bool = True) -> torch.Tensor:
    """Greedy NMS: boxes (..., N, 4), scores (..., N), valid (..., N) bool ->
    keep (..., N) bool."""
    return batched_nms_mask(boxes, scores, None, iou_threshold, valid, plus_one)


def nms_topk(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float, k: int,
             valid: torch.Tensor | None = None, class_ids: torch.Tensor | None = None,
             plus_one: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes (F, N, 4), scores (F, N), valid (F, N) bool, class_ids (F, N) ->
    (indices (F, k) int64, keep_valid (F, k) bool): each row's first k
    survivors in score order; an exhausted row pads with index 0, False.
    With `class_ids`, boxes of different classes never suppress each other."""
    F_, n = scores.shape
    live = scores.float() if valid is None else torch.where(valid, scores.float(), NEG_INF)
    live = live.clone()
    rows = torch.arange(F_, device=scores.device)
    idx, oks = [], []
    for _ in range(k):
        i = live.argmax(dim=1)                                      # (F,)
        ok = live[rows, i] > NEG_INF / 2
        supp = iou(boxes[rows, i][:, None], boxes, plus_one)[:, 0] > iou_threshold
        if class_ids is not None:
            supp &= class_ids == class_ids[rows, i][:, None]
        live = live.masked_fill(supp, NEG_INF)
        live[rows, i] = NEG_INF                                     # self always leaves the pool
        idx.append(torch.where(ok, i, 0))
        oks.append(ok)
    return torch.stack(idx, 1), torch.stack(oks, 1)
