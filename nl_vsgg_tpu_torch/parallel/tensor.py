"""Tensor parallelism over the mesh's model axis: the collectives that XLA
inserts for the JAX package's `P(None, 'model')` kernels, written by hand
(port of nl_vsgg_tpu/parallel/mesh.py `_param_spec` and what it implies).

The rule (`_param_spec`): a Dense kernel whose output dim is at least 1024
and even is sharded over 'model' by its output columns. In the relation
models that is every transformer layer's q/k/v projection, `out_proj`,
`linear1` and `linear2`, and the object heads' 1024-wide first layer
(`decoder_lin.0`, DSG-DETR sgcls `decoder_fc1`). The port packs q/k/v as
one (3E, E) `in_proj_weight`; the rule applies to each E block, so rank r
holds the rows of its model index of q, k and v, as JAX's shard r holds
those columns of each kernel. A bias goes with its columns.

A sharded layer computes y = gather_out(F.linear(copy_in(x), W_r, b_r)):

  * `copy_in`: the identity forward; the backward all-reduces (sums) the
    input's gradient over the model group, since each rank's slice
    contributes a partial x-gradient. Without it every gradient upstream of
    a sharded layer would be partial;
  * `gather_out`: all-gather of the ranks' column slices concatenated on
    the last dim (per block, for the packed q/k/v); its backward keeps the
    rank's own slice of the gradient. (`torch.distributed.nn.functional.
    all_gather` would sum the gradient over the ranks instead: every model
    rank computes the same loss downstream, so that multiplies the
    gradients by the model-axis size.)

Everything downstream of a gather is replicated: every rank of a model
group computes it from the same bits, with the same dropout masks (one
generator seed for the whole model group). A kernel that sums in no fixed
order (the card's atomics, threaded CPU kernels under load) can still
round a replicated gradient apart on one rank, and the replicas would then
drift: the train step broadcasts the replicated parameters' gradients from
the group's first rank after each backward (`broadcast_grads`).
Under gloo the gathers move raw bytes (every dtype crosses) and a bfloat16
gradient is all-reduced in float32, cast back after (the cast up is exact;
the sum is rounded once). `COMM` counts the bytes of the gathered outputs,
of the all-reduced gradients and of the broadcast ones.

`shard_module(model, mesh)` slices a built (full) model in place for the
rank; `full_state_dict` / `load_full_state_dict` gather and slice the
one-rank layout, so checkpoints are the same files at every mesh shape.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import distributed as D

MIN_DIM = 1024   # nl_vsgg_tpu/parallel/mesh.py _MODEL_SHARD_MIN_DIM

COMM = {"gather_bytes": 0, "gathers": 0, "allreduce_bytes": 0, "allreduces": 0,
        "broadcast_bytes": 0, "broadcasts": 0}


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class TP:
    """A rank's place on the model axis: its model group (None: slicing
    only, no collective), its model index and the axis size."""

    group: object
    index: int
    size: int

    def __deepcopy__(self, memo):   # a process group is not copied with a module
        return self


def shardable(out_features: int) -> bool:
    """`_param_spec`'s rule on a Dense kernel's output dim."""
    return out_features >= MIN_DIM and out_features % 2 == 0


# ------------------------------------------------------------ the collectives
def _gather_last(y: torch.Tensor, tp: TP, blocks: int) -> torch.Tensor:
    """(..., blocks * c) column slices on each rank -> (..., blocks * size *
    c): each block's slices in rank order, the blocks in order."""
    raw = y.contiguous()
    buf = raw.view(torch.uint8) if raw.dtype != torch.uint8 else raw
    parts = buf.new_empty((tp.size,) + tuple(buf.shape))
    dist.all_gather(list(parts.unbind(0)), buf, group=tp.group)
    COMM["gather_bytes"] += parts.numel()
    COMM["gathers"] += 1
    full = parts.view(y.dtype)                          # (size, ..., blocks * c)
    full = full.unflatten(-1, (blocks, -1)).movedim(0, -2)   # (..., blocks, size, c)
    return full.flatten(-3)


def _own_last(g: torch.Tensor, tp: TP, blocks: int) -> torch.Tensor:
    """The rank's column slices of a gathered (..., blocks * size * c)."""
    return g.unflatten(-1, (blocks, tp.size, -1))[..., tp.index, :].flatten(-2).contiguous()


def _all_reduce(g: torch.Tensor, tp: TP) -> torch.Tensor:
    g = g.contiguous()
    low = g.dtype in (torch.bfloat16, torch.float16) and D.backend() != "nccl"
    buf = g.float() if low else g.clone()
    dist.all_reduce(buf, group=tp.group)
    COMM["allreduce_bytes"] += buf.numel() * buf.element_size()
    COMM["allreduces"] += 1
    return buf.to(g.dtype) if low else buf


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, tp, blocks):
        ctx.tp, ctx.blocks = tp, blocks
        return _gather_last(y, tp, blocks)

    @staticmethod
    def backward(ctx, g):
        return _own_last(g, ctx.tp, ctx.blocks), None, None


def copy_in(x: torch.Tensor, tp: TP) -> torch.Tensor:
    return _CopyIn.apply(x, tp)


def gather_out(y: torch.Tensor, tp: TP, blocks: int = 1) -> torch.Tensor:
    return _GatherOut.apply(y, tp, blocks)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, tp: TP,
                  blocks: int = 1) -> torch.Tensor:
    """F.linear over a rank's output rows of `weight` (`blocks` equal blocks
    of them), gathered to the full output."""
    return gather_out(F.linear(copy_in(x, tp), weight, bias), tp, blocks)


class ColumnParallelLinear(nn.Linear):
    """An nn.Linear holding the rank's output rows (`shard_module` turns a
    wide Linear into one). Its forward is the full layer's output on every
    rank; `models.layers.linear` casts and takes the same path."""

    tp: TP

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_linear(x, self.weight, self.bias, self.tp)


# ------------------------------------------------------------ the layout
def _sharded_entries(model: nn.Module):
    """(module, parameter names, blocks, its full output width) of every
    layer the rule shards, in module order."""
    from ..models.layers import MaskedMHA

    for m in model.modules():
        if isinstance(m, MaskedMHA):
            if shardable(m.embed_dim):
                yield m, ("in_proj_weight", "in_proj_bias"), 3, m.embed_dim
        elif isinstance(m, nn.Linear) and shardable(m.out_features):
            yield m, ("weight", "bias"), 1, m.out_features


def check_widths(model: nn.Module, model_size: int) -> None:
    """Refuse a model axis that does not divide the output width of a layer
    the rule shards, naming the widths."""
    bad = sorted({w for *_, w in _sharded_entries(model) if w % model_size})
    if bad:
        raise ValueError(f"mesh model={model_size} does not divide the output width(s) {bad} "
                         f"of the layers the model axis shards (Dense outputs >= {MIN_DIM}, "
                         f"even); pick a model axis that divides them")


def take_shard(full: torch.Tensor, tp: TP, blocks: int) -> torch.Tensor:
    """The rank's rows of a full (blocks * O, ...) tensor."""
    return full.unflatten(0, (blocks, tp.size, -1))[:, tp.index].flatten(0, 1).clone()


def gather_shard(local: torch.Tensor, tp: TP, blocks: int) -> torch.Tensor:
    """The full tensor from every rank's rows (a collective over the group)."""
    if tp.group is None:
        raise ValueError("gathering a sharded tensor needs the model group")
    return _gather_last(local.movedim(0, -1), tp, blocks).movedim(-1, 0).contiguous()


def shard_module(model: nn.Module, mesh) -> nn.Module:
    """Slice every layer the rule shards to the rank's output rows, in
    place (the model holds the full weights, the same on every rank). A
    width that the model axis does not divide is refused, naming it. A mesh
    of model 1 leaves the model as it is. Returns the model."""
    if mesh.model == 1:
        return model
    check_widths(model, mesh.model)
    tp = TP(mesh.model_group, mesh.model_index, mesh.model)
    for m, names, blocks, _ in _sharded_entries(model):
        for n in names:
            p = getattr(m, n)
            setattr(m, n, nn.Parameter(take_shard(p.detach(), tp, blocks),
                                       requires_grad=p.requires_grad))
        m.tp = tp
        if type(m) is nn.Linear:
            m.__class__ = ColumnParallelLinear
    return model


def model_axis(model: nn.Module) -> TP | None:
    """The model's TP, or None when no layer of it is sharded."""
    for m in model.modules():
        tp = getattr(m, "tp", None)
        if isinstance(tp, TP):
            return tp
    return None


def shard_specs(model: nn.Module) -> dict[str, tuple[TP, int]]:
    """{state_dict key: (TP, blocks)} of the sharded tensors."""
    prefix = {id(m): n for n, m in model.named_modules()}
    return {f"{prefix[id(m)]}.{n}".lstrip("."): (m.tp, blocks)
            for m, names, blocks, _ in _sharded_entries(model)
            if isinstance(getattr(m, "tp", None), TP) for n in names}


def sharded_parameters(model: nn.Module) -> tuple[object, list[nn.Parameter]]:
    """(the model group, the sharded parameters): the clip sums their
    squared norms over the group."""
    specs = shard_specs(model)
    params = dict(model.named_parameters())
    tp = model_axis(model)
    return (tp.group if tp is not None else None), [params[k] for k in specs if k in params]


def replicated_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The parameters the model axis does not shard: every rank of a model
    group holds them whole."""
    sharded = {id(p) for p in sharded_parameters(model)[1]}
    return [p for p in model.parameters() if id(p) not in sharded]


def broadcast_grads(params: list[nn.Parameter], tp: TP) -> None:
    """The gradients of `params` (the replicated parameters) as the model
    group's first rank holds them, on every rank of the group (a collective
    over it): one copy of the replicated state, whatever order a kernel
    summed in on each rank."""
    grads = [p.grad for p in params if p.grad is not None]
    src = dist.get_global_rank(tp.group, 0)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        same = [g for g in grads if g.dtype == dtype]
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.broadcast(flat, src=src, group=tp.group)
        for g, new in zip(same, flat.split([g.numel() for g in same])):
            g.copy_(new.view_as(g))
        COMM["broadcast_bytes"] += flat.numel() * flat.element_size()
        COMM["broadcasts"] += 1


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The one-rank state_dict: sharded tensors gathered over the model
    group (a collective on every rank of it), the rest as they are."""
    specs = shard_specs(model)
    return {k: gather_shard(v, *specs[k]) if k in specs else v
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, sd: dict) -> None:
    """Load a one-rank state_dict into a sharded model (each sharded tensor
    sliced to the rank's rows), strictly."""
    specs = shard_specs(model)
    model.load_state_dict({k: take_shard(v, *specs[k]) if k in specs else v
                           for k, v in sd.items()}, strict=True)
