"""Train and eval steps over batched Entries (port of
nl_vsgg_tpu/train/step.py).

The JAX step vmaps the per-video model over the leading batch axis; the
port's model is natively batched over it, so a step is one call. Losses are
per video (models/losses.py) and the batch loss is their validity-weighted
mean: a video with no valid box (a fill video) weighs 0, through `where`
and not a product, so a NaN of a fill video cannot poison the sum. The
BatchNorm running buffers take the same weighted mean of the per-video
updates (MaskedBatchNorm.commit).

The NaN/empty guard (lib/utils.py:3-12): a step whose loss or any gradient
is not finite, or whose batch has no box, leaves the parameters, the AdamW
state (its step count included) and the BatchNorm buffers bit-identical and
adds 1 to `skipped`. Deciding it costs one host sync per step.

Device rule: the step runs where the model is. The model is built on CUDA
unless its caller asked for the CPU (`STTran(device="cpu")`); the batch and
the generator must be on the model's device, so there is no silent CPU
path. `place_entries` makes such a batch from host Entries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..data.entry import Entry, stack_entries
from ..device import resolve_device
from ..models.layers import MaskedBatchNorm
from ..models.losses import sttran_losses
from .state import TrainState

__all__ = ["eval_step", "make_train_step", "place_entries", "stack_entries"]

LOSS_KEYS = ("object_loss", "attention_relation_loss", "spatial_relation_loss",
             "contact_relation_loss", "total")


def place_entries(entries: list[Entry], zero_union: bool = False, rel_bf16: bool = False,
                  device=None) -> Entry:
    """A batch on `device` (None: the card) from same-bucket host Entries
    (nl_vsgg_tpu/train/step.py::place_entries).

    Each field is stacked on the host and moved in one copy. `zero_union`
    (no union-feature provider: union_feat is all zeros) ships a width-0
    union_feat of shape (B, R, 7, 7, 0), which the models turn into the
    union projection's exact bias broadcast (models/sttran.union_projection),
    so the zeros, about 95% of an Entry's bytes at 96 x 7 x 7 x 2048, are
    neither stacked nor copied. `rel_bf16` casts union_feat and
    spatial_masks to bfloat16, the cast a bf16-compute model makes of them
    itself (only bf16 layers read them), so the step's math is unchanged.
    The casts run on the device after the copy. (The JAX function's
    `cast_bf16`, for the serving CLI, is not ported.)"""
    device = resolve_device(device)
    big = torch.bfloat16 if rel_bf16 else torch.float32
    placed = {}
    for f in dataclasses.fields(Entry):
        if f.name == "union_feat" and zero_union:
            shape = (len(entries),) + tuple(entries[0].union_feat.shape[:-1]) + (0,)
            placed[f.name] = torch.zeros(shape, dtype=big, device=device)
            continue
        v = torch.stack([getattr(e, f.name) for e in entries]).to(device)
        if f.name in ("union_feat", "spatial_masks") and rel_bf16:
            v = v.to(big)
        placed[f.name] = v
    return Entry(**placed)


def eval_step(model: torch.nn.Module, batch: Entry) -> dict[str, torch.Tensor]:
    """batch: Entry[B, ...] on the model's device -> pred dict[B, ...]."""
    with torch.inference_mode():
        return model(batch, train=False)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def make_train_step(model: torch.nn.Module, optimizer, bce: bool = True) -> Callable:
    """Returns train_step(state, batch: Entry[B, ...], generator) ->
    (state, metrics). `metrics` holds the four losses, 'total' and 'valid'
    as 0-dim float32 tensors on the model's device; `generator` draws the
    step's dropout masks, attention seeds and attention-label samples."""
    device = _device_of(model)
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]

    def train_step(state: TrainState, batch: Entry, generator: torch.Generator):
        if not (_same_device(batch.box_mask.device, device)
                and _same_device(generator.device, device)):
            raise ValueError(f"the model is on {device}; the batch is on "
                             f"{batch.box_mask.device} and the generator on "
                             f"{generator.device}")
        vid_w = batch.box_mask.any(-1).float()
        denom = vid_w.sum().clamp(min=1.0)

        def wmean(x: torch.Tensor) -> torch.Tensor:
            return torch.where(vid_w > 0, x * vid_w, 0.0).sum(0) / denom

        optimizer.zero_grad()
        pred = model(batch, train=True, generator=generator)
        per_video = sttran_losses(pred, batch, generator, bce=bce)
        losses = {k: wmean(per_video[k]) for k in LOSS_KEYS}
        losses["total"].backward()

        with torch.no_grad():
            grads = optimizer.grads() if hasattr(optimizer, "grads") else [
                p.grad for p in model.parameters() if p.grad is not None]
            worst = torch.stack(torch._foreach_norm(grads, float("inf")))
            valid_t = (torch.isfinite(losses["total"]) & torch.isfinite(worst).all()
                       & batch.box_mask.any())
        valid = bool(valid_t)  # the step's one host sync
        if valid:
            optimizer.step()
            for m in norms:
                m.commit(vid_w)
        else:
            for m in norms:
                m.discard()
        optimizer.zero_grad()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["valid"] = valid_t.float()
        state = dataclasses.replace(state, step=state.step + 1,
                                    skipped=state.skipped + (0 if valid else 1))
        return state, metrics

    return train_step
