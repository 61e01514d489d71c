"""The data-parallel mesh (port of nl_vsgg_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over its devices: 'data'
shards the video batch, 'model' the output dim of Dense kernels 1024 or
more wide (`_param_spec`). Here a rank is one process on one device, and
the data axis is `torch.nn.parallel.DistributedDataParallel` over the
ranks: the parameters are broadcast from rank 0 when it is built and the
gradients are all-reduced in the backward. The train step (train/step.py)
then takes every mean over the global batch. The model axis is not ported:
`mesh.model > 1` is refused (ROADMAP_TP).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from . import distributed as D

ROADMAP_TP = ("ROADMAP.md Queue 1 item 1a (the model axis as tensor parallel: "
              "column-parallel Linears with a differentiable all-gather)")
# bytes each DDP all-reduce moved, counted by the communication hook
ALLREDUCE = {"bytes": 0, "calls": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """data x model ranks; this process's rank and device."""

    data: int
    model: int
    rank: int
    device: torch.device


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The mesh over the process group's ranks (one rank without a group);
    `data` -1 takes every rank."""
    if model != 1:
        raise ValueError(f"mesh model={model}: the model axis is not ported ({ROADMAP_TP}); "
                         f"use model 1")
    n = D.world_size()
    data = n // model if data == -1 else data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    dev = D.rank_device() or torch.device(device if device is not None else "cuda")
    return Mesh(data, model, D.rank(), dev)


def _counting_allreduce(state, bucket):
    """DDP's own all-reduce hook (the mean over the ranks), counted."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    buf = bucket.buffer()
    ALLREDUCE["bytes"] += buf.numel() * buf.element_size()
    ALLREDUCE["calls"] += 1
    return default_hooks.allreduce_hook(state, bucket)


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """`model` under DDP on its device (the model itself without a process
    group; a group of one rank gets a DDP too), its parameters broadcast
    from rank 0. The BatchNorm running buffers are kept equal by the train
    step's own all-reduce (MaskedBatchNorm.commit_sums), so DDP broadcasts
    none in the forward. Parameters that get no gradient (the union
    projection's weight under the width-0 union) are found every step
    (`find_unused_parameters`): they take a zero gradient, as under JAX."""
    if not D.initialized():
        return model
    dev = next(model.parameters()).device
    with warnings.catch_warnings():  # newer torch renames it; the semantics here are the same
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*deprecated")
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None, broadcast_buffers=False,
            find_unused_parameters=True)
    ddp.register_comm_hook(None, _counting_allreduce)
    return ddp
