"""Training losses for the relation models, masked, per video (port of
nl_vsgg_tpu/models/losses.py).

The label construction and loss math of the reference training loop
(tools/train_STTran.py:148-186):

  * object_loss: cross entropy of the 37-way object logits against the
    grounded labels;
  * attention_relation_loss: cross entropy over relations with at least one
    attention GT id; with several ids one is drawn uniformly;
  * spatial/contact_relation_loss: BCE (`bce=True`, the shipped config)
    over relations with at least one positive, or MultiLabelMarginLoss.

Each term is a masked mean per video that is exactly 0 when no row
qualifies (the reference's `if mask.sum() > 0` branch), and padding rows
never contribute. The JAX package computes them per video under vmap; the
port's inputs carry a leading video axis, and every term comes out as a
(B,) tensor for the train step's validity-weighted mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..data.entry import Entry


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `values` (B, N) over each video's rows where mask is True;
    0 where none are."""
    m = mask.to(values.dtype)
    return (values * m).sum(-1) / m.sum(-1).clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE with integer labels (nn.CrossEntropyLoss, no reduction)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element binary cross entropy from logits (BCELoss on
    sigmoid(logits), in the stable form)."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def multilabel_margin(logits: torch.Tensor, multi_hot: torch.Tensor) -> torch.Tensor:
    """nn.MultiLabelMarginLoss per row from a multi-hot target:
    sum over positive j and negative i of max(0, 1 - (x_j - x_i)) / C."""
    C = logits.shape[-1]
    pos = multi_hot > 0
    diff = 1.0 - (logits[..., :, None] - logits[..., None, :])
    pair = pos[..., :, None] & ~pos[..., None, :]
    return torch.where(pair, diff.clamp(min=0.0), 0.0).sum((-2, -1)) / C


def sample_multi_hot(multi_hot: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A uniform draw among the set bits of each row (rows with none -> 0):
    the argmax of independent uniforms over the set positions."""
    u = torch.rand(multi_hot.shape, generator=generator, device=multi_hot.device)
    return torch.where(multi_hot > 0, u, -1.0).argmax(-1)


def sttran_losses(pred: dict[str, torch.Tensor], entry: Entry, generator: torch.Generator,
                  bce: bool = True) -> dict[str, torch.Tensor]:
    """Every loss term and 'total', each (B,): one value per video. `pred` is
    the STTran output (logits) over the batched `entry`."""
    losses: dict[str, torch.Tensor] = {}
    obj_ce = cross_entropy(pred["distribution"], entry.labels)
    losses["object_loss"] = _masked_mean(obj_ce, entry.box_mask)

    att_rows = entry.rel_mask & (entry.attention_gt.sum(-1) > 0)
    att_label = sample_multi_hot(entry.attention_gt, generator)
    att_ce = cross_entropy(pred["attention_distribution"], att_label)
    losses["attention_relation_loss"] = _masked_mean(att_ce, att_rows)

    if bce:
        sp_rows = entry.rel_mask & (entry.spatial_gt.sum(-1) > 0)
        con_rows = entry.rel_mask & (entry.contacting_gt.sum(-1) > 0)
        sp = bce_with_logits(pred["spatial_logits"], entry.spatial_gt).mean(-1)
        con = bce_with_logits(pred["contacting_logits"], entry.contacting_gt).mean(-1)
    else:
        # margin mode masks by `(index_labels > 0).sum() != 0`
        # (tools/train_STTran.py:171-172): a row whose only GT id is
        # predicate 0 is left out, unlike BCE mode
        sp_rows = entry.rel_mask & (entry.spatial_gt[..., 1:].sum(-1) > 0)
        con_rows = entry.rel_mask & (entry.contacting_gt[..., 1:].sum(-1) > 0)
        sp = multilabel_margin(pred["spatial_logits"], entry.spatial_gt)
        con = multilabel_margin(pred["contacting_logits"], entry.contacting_gt)
    losses["spatial_relation_loss"] = _masked_mean(sp, sp_rows)
    losses["contact_relation_loss"] = _masked_mean(con, con_rows)

    losses["total"] = (losses["object_loss"] + losses["attention_relation_loss"]
                       + losses["spatial_relation_loss"] + losses["contact_relation_loss"])
    return losses
