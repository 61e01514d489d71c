"""The ('data', 'model') mesh (port of nl_vsgg_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over its devices: 'data'
shards the video batch, 'model' the output dim of Dense kernels 1024 or
more wide (`_param_spec`), and XLA inserts the collectives. Here a rank is
one process on one device, laid out as JAX's
`np.asarray(devices).reshape(data, model)`: rank r is data index r //
model and model index r % model. Two kinds of process groups join them:

  * the data group of a model index: the ranks that hold the same slice of
    the model, one per data index. The data axis is
    `torch.nn.parallel.DistributedDataParallel` over it (`data_parallel`):
    the parameters are broadcast from its first rank when it is built and
    the gradients are all-reduced in the backward; the train step
    (train/step.py) takes every mean over the global batch;
  * the model group of a data index: the ranks that hold one replica
    between them. The model axis is tensor parallel over it
    (parallel/tensor.py): each rank holds the columns of its model index of
    every wide Linear, and the hand-written collectives that XLA inserts for
    `P(None, 'model')` gather the outputs.

With `model` 1 the data group is the whole world and there is no model
group, as before the model axis was ported.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from . import distributed as D

# bytes each DDP all-reduce moved, counted by the communication hook
ALLREDUCE = {"bytes": 0, "calls": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """data x model ranks; this process's rank and device, its data and
    model index, and its data and model groups (None without a process
    group; the data group is None for the whole world)."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_index: int = 0
    model_index: int = 0
    data_group: object = None
    model_group: object = None


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The mesh over the process group's ranks (one rank without a group);
    `data` -1 takes every rank. Every rank must call it, in the same order
    as the others: it makes the groups with `dist.new_group`."""
    n = D.world_size()
    if model < 1:
        raise ValueError(f"mesh model={model}: the model axis needs at least 1 rank")
    data = n // model if data == -1 else data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    dev = D.rank_device() or torch.device(device if device is not None else "cuda")
    r = D.rank()
    data_group = model_group = None
    if D.initialized() and model > 1:
        timeout = D._GROUP.timeout
        for m in range(model):      # every rank makes every group, in one order
            g = dist.new_group(list(range(m, n, model)), timeout=timeout)
            if m == r % model:
                data_group = g
        for d in range(data):
            g = dist.new_group(list(range(d * model, (d + 1) * model)), timeout=timeout)
            if d == r // model:
                model_group = g
        D.set_model_axis(model)
    return Mesh(data, model, r, dev, r // model, r % model, data_group, model_group)


def _counting_allreduce(state, bucket):
    """DDP's own all-reduce hook (the mean over the ranks), counted."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    buf = bucket.buffer()
    ALLREDUCE["bytes"] += buf.numel() * buf.element_size()
    ALLREDUCE["calls"] += 1
    return default_hooks.allreduce_hook(state, bucket)


def data_parallel(model: torch.nn.Module, mesh: Mesh | None = None) -> torch.nn.Module:
    """`model` under DDP on its device over the mesh's data group (the
    whole world without a mesh; the model itself without a process group;
    a group of one rank gets a DDP too), its parameters broadcast from the
    group's first rank. The BatchNorm running buffers are kept equal by the
    train step's own all-reduce (MaskedBatchNorm.commit_sums), so DDP
    broadcasts none in the forward. Parameters that get no gradient (the
    union projection's weight under the width-0 union) are found every step
    (`find_unused_parameters`): they take a zero gradient, as under JAX."""
    if not D.initialized():
        return model
    dev = next(model.parameters()).device
    with warnings.catch_warnings():  # newer torch renames it; the semantics here are the same
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*deprecated")
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None, broadcast_buffers=False,
            find_unused_parameters=True,
            process_group=mesh.data_group if mesh is not None else None)
    # the hook's state is the group it all-reduces over (None would be the world)
    ddp.register_comm_hook(ddp.process_group, _counting_allreduce)
    return ddp
