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

Data parallelism: `model` may be a DistributedDataParallel
(parallel/mesh.data_parallel). The step then gives what the JAX step gives
over the whole global batch, where one SPMD program takes every mean over
all B videos: the loss denominator is the all-reduced count of valid
videos, and each rank backpropagates its weighted sum times world / count,
so DDP's mean over the ranks is the global weighted mean; the guard is
one decision on every rank (the all-reduced losses, the all-reduced
gradients' finiteness, a box anywhere); the BatchNorm updates' weighted
sums and weights are all-reduced before they are written, so the buffers
match on every rank and match the one-process run. That costs two
all-reduces of a few scalars a step and one of the BatchNorm sums.

Device rule: the step runs where the model is. The model is built on CUDA
unless its caller asked for the CPU (`STTran(device="cpu")`); the batch and
the generator must be on the model's device, so there is no silent CPU
path. `place_entries` makes such a batch from host Entries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..data.entry import Entry, stack_entries
from ..device import resolve_device
from ..models.layers import MaskedBatchNorm
from ..models.losses import sttran_losses
from .state import TrainState

__all__ = ["eval_step", "make_train_step", "place_entries", "stack_entries"]

LOSS_KEYS = ("object_loss", "attention_relation_loss", "spatial_relation_loss",
             "contact_relation_loss", "total")


def place_entries(entries: list[Entry], zero_union: bool = False, cast_bf16: bool = False,
                  rel_bf16: bool = False, device=None) -> Entry:
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
    `cast_bf16` (serving with a bf16-compute model) also casts `features`,
    which the object classifier otherwise reads in float32. The casts run on
    the device after the copy."""
    device = resolve_device(device)
    rel_bf16 = rel_bf16 or cast_bf16
    big = torch.bfloat16 if rel_bf16 else torch.float32
    placed = {}
    for f in dataclasses.fields(Entry):
        if f.name == "union_feat" and zero_union:
            shape = (len(entries),) + tuple(entries[0].union_feat.shape[:-1]) + (0,)
            placed[f.name] = torch.zeros(shape, dtype=big, device=device)
            continue
        v = torch.stack([getattr(e, f.name) for e in entries]).to(device)
        if (f.name in ("union_feat", "spatial_masks") and rel_bf16) or \
                (f.name == "features" and cast_bf16):
            v = v.to(torch.bfloat16)
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
    step's dropout masks, attention seeds and attention-label samples.
    Under DDP, `batch` is the rank's block of the global batch and the
    metrics are the global batch's."""
    ddp = isinstance(model, torch.nn.parallel.DistributedDataParallel)
    core = model.module if ddp else model
    world = dist.get_world_size(model.process_group) if ddp else 1
    device = _device_of(core)
    norms = [m for m in core.modules() if isinstance(m, MaskedBatchNorm)]

    def train_step(state: TrainState, batch: Entry, generator: torch.Generator):
        if not (_same_device(batch.box_mask.device, device)
                and _same_device(generator.device, device)):
            raise ValueError(f"the model is on {device}; the batch is on "
                             f"{batch.box_mask.device} and the generator on "
                             f"{generator.device}")
        vid_w = batch.box_mask.any(-1).float()
        count, any_box = vid_w.sum(), batch.box_mask.any()
        if ddp:  # the global batch's count of valid videos, and a box anywhere
            glob = torch.stack([count, any_box.float()])
            dist.all_reduce(glob, group=model.process_group)
            count, any_box = glob[0], glob[1] > 0
        denom = count.clamp(min=1.0)

        optimizer.zero_grad()
        pred = model(batch, train=True, generator=generator)
        per_video = sttran_losses(pred, batch, generator, bce=bce)
        sums = torch.stack([torch.where(vid_w > 0, per_video[k] * vid_w, 0.0).sum(0)
                            for k in LOSS_KEYS])
        (sums[-1] / denom if world == 1 else sums[-1] * world / denom).backward()

        with torch.no_grad():
            sums = sums.detach()
            if ddp:
                dist.all_reduce(sums, group=model.process_group)
            losses = dict(zip(LOSS_KEYS, sums / denom))
            grads = optimizer.grads() if hasattr(optimizer, "grads") else [
                p.grad for p in core.parameters() if p.grad is not None]
            worst = torch.stack(torch._foreach_norm(grads, float("inf")))
            valid_t = torch.isfinite(losses["total"]) & torch.isfinite(worst).all() & any_box
        valid = bool(valid_t)  # the step's one host sync
        if valid:
            optimizer.step()
            _commit_norms(norms, vid_w, model.process_group if ddp else None)
        else:
            for m in norms:
                m.discard()
        optimizer.zero_grad()
        metrics = dict(losses)
        metrics["valid"] = valid_t.float()
        state = dataclasses.replace(state, step=state.step + 1,
                                    skipped=state.skipped + (0 if valid else 1))
        return state, metrics

    return train_step


def _commit_norms(norms, vid_w: torch.Tensor, group) -> None:
    """Write every BatchNorm's pending update; under a process group the
    weighted sums are all-reduced first, all norms in one call."""
    if group is None:
        for m in norms:
            m.commit(vid_w)
        return
    live = [m for m in norms if m.pending is not None]
    if not live:
        return
    parts = [m.commit_sums(vid_w) for m in live]
    flat = torch.cat([torch.cat([a, b, w.view(1)]) for a, b, w in parts])
    dist.all_reduce(flat, group=group)
    for m, part in zip(live, flat.split([2 * a.numel() + 1 for a, _, _ in parts])):
        c = m.running_mean.numel()
        m.commit_apply(part[:c], part[c:2 * c], part[2 * c])
