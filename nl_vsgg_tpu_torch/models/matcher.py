"""DETR-style Hungarian matching (port of nl_vsgg_tpu/models/matcher.py).

The cost matrix (cosine distance of class distributions, cosine distance of
RoI features, L1 of cxcywh boxes, minus generalized IoU; reference
lib/matcher.py:125-146) is tensor math in float32 on whatever device the
inputs are on. Two solvers:

  * `solve_lsap_host`: scipy's linear_sum_assignment, exact, the
    reference's solver; the tracker uses it.
  * `solve_lsap_auction`: a forward auction in torch on the inputs' device
    (the card's, for on-device matching), a fixed number of rounds on a
    padded cost matrix, as the JAX solver runs. eps-optimal: its total cost
    lies within rows * eps of the optimum, so it equals scipy's assignment
    on cost matrices whose optimum beats every other assignment by more.

The reference converts boxes with `xywh_to_cxcywh` even though its entry
boxes are xyxy; that belongs to its caller (models/track.py), and `match`
here takes the layout the caller gives, as the original does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.boxes import cxcywh_to_xyxy, generalized_iou, xywh_to_cxcywh


def _f32(x) -> torch.Tensor:
    return x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x), dtype=torch.float32)


def cosine_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity, (N, d) x (M, d) -> (N, M)."""
    xn = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    yn = y / (y.norm(dim=-1, keepdim=True) + 1e-12)
    return 1.0 - xn @ yn.T


@dataclass(frozen=True)
class HungarianMatcher:
    """lib/matcher.py:81-150; the DSG-DETR tracker uses (0.5, 1, 1, 0.5)."""

    cost_class: float = 1.0
    cost_feature: float = 1.0
    cost_bbox: float = 1.0
    cost_giou: float = 1.0

    def cost_matrix(self, out_boxes_xywh, out_feats, out_dists,
                    tgt_boxes_xywh, tgt_feats, tgt_dists) -> torch.Tensor:
        """(N, M) float32 cost of matching each output to each target;
        numpy arrays or tensors in, float32 out."""
        ob = xywh_to_cxcywh(_f32(out_boxes_xywh))
        tb = xywh_to_cxcywh(_f32(tgt_boxes_xywh))
        cost_dist = cosine_cost(_f32(out_dists), _f32(tgt_dists))
        cost_feat = cosine_cost(_f32(out_feats), _f32(tgt_feats))
        cost_bbox = (ob[:, None] - tb[None]).abs().sum(-1)
        cost_giou = -generalized_iou(cxcywh_to_xyxy(ob), cxcywh_to_xyxy(tb))
        return (self.cost_class * cost_dist + self.cost_feature * cost_feat
                + self.cost_bbox * cost_bbox + self.cost_giou * cost_giou)

    def __call__(self, outputs: dict, targets: dict):
        """The reference's forward: (row_ind, col_ind, dist_costs,
        feat_costs), numpy, from the exact host solver."""
        C = self.cost_matrix(outputs["boxes"], outputs["features"], outputs["dists"],
                             targets["boxes"], targets["features"], targets["dists"])
        cost_dist = cosine_cost(_f32(outputs["dists"]), _f32(targets["dists"]))
        cost_feat = cosine_cost(_f32(outputs["features"]), _f32(targets["features"]))
        row, col = solve_lsap_host(C.cpu().numpy())
        return (row, col, cost_dist.cpu().numpy()[row, col], cost_feat.cpu().numpy()[row, col])


def solve_lsap_host(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact LSAP via scipy (the reference's solver)."""
    from scipy.optimize import linear_sum_assignment
    return linear_sum_assignment(np.asarray(cost))


def solve_lsap_auction(cost: torch.Tensor, n_iter: int = 200,
                       eps: float | None = None) -> torch.Tensor:
    """Forward auction on an (n, m) cost matrix, n <= m, on its device:
    (n,) int64 column of each row, -1 where a row is still unassigned after
    `n_iter` rounds (not the case for n_iter >= about n / eps on bounded
    costs). Each round every unassigned row bids for its best column by
    the gap to its second best plus `eps` (default 1 / (n + 1)); a column
    goes to its highest bidder, whose bid raises its price, and evicts its
    previous owner. Minimizes cost by maximizing the benefit -cost."""
    n, m = cost.shape
    if n > m:
        raise ValueError(f"the auction solver takes rows <= columns, got {n} x {m}")
    dev = cost.device
    benefit = -cost
    eps = eps if eps is not None else 1.0 / (n + 1)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=cost.dtype, device=dev)
    prices = torch.zeros(m, dtype=cost.dtype, device=dev)
    owner = torch.full((m,), -1, dtype=torch.long, device=dev)   # row owning each column
    assign = torch.full((n,), -1, dtype=torch.long, device=dev)
    for _ in range(n_iter):
        unassigned = assign == -1
        values = benefit - prices[None, :]
        best_j = values.argmax(1)
        best_v = values.gather(1, best_j[:, None])[:, 0]
        onehot = best_j[:, None] == cols[None, :]
        second_v = torch.where(onehot, neg_inf, values).amax(1)
        bid = best_v - second_v + eps
        bid_amt = torch.where(unassigned, bid, neg_inf)
        col_bid = torch.full((m,), float("-inf"), dtype=cost.dtype, device=dev).scatter_reduce(
            0, best_j, bid_amt, "amax")
        # the highest-bidding unassigned row of each column wins it
        row_scores = torch.where(unassigned[:, None] & onehot, bid[:, None], neg_inf)
        has_bid = row_scores.isfinite().any(0)
        winner = torch.where(has_bid, row_scores.argmax(0), -1)
        prices = torch.where(has_bid, prices + col_bid.clamp(min=0.0), prices)
        evicted = torch.where(has_bid, owner, -1)
        assign = torch.where(torch.isin(rows, evicted), -1, assign)
        owner = torch.where(has_bid, winner, owner)
        # assign[winner[j]] = j for the columns that had a bid; the others
        # write to a dropped slot n
        slot = torch.cat([assign, assign.new_full((1,), -1)])
        slot[torch.where(winner >= 0, winner, n)] = torch.where(has_bid, cols, -1)
        assign = slot[:n]
    return assign
