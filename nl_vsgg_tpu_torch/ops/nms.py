"""First-k greedy non-maximum suppression over padded box sets, batched over
a leading axis (port of nl_vsgg_tpu/ops/nms.py::nms_topk).

Greedy NMS visits boxes in score order, so its first k survivors are k
rounds of pick-the-best-live-box and suppress-its-overlaps. The JAX
function runs those rounds as a `lax.scan` per image (vmapped over
frames); here they are a loop of k steps over (F, N) live scores, one
argmax per row per step (the first maximum among ties, as `jnp.argmax`).
The legacy +1-pixel IoU is the default. `nms_mask` and `batched_nms_mask`
are not ported yet (they serve the sgdet-inference path).
"""

from __future__ import annotations

import torch

from .boxes import iou

NEG_INF = -1e30


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
