"""All-gather and point-to-point exchange of the card's tensors for the
sharded forwards (parallel/sequence.py, sttran_sp.py, dsg_detr_sp.py).

NCCL takes CUDA tensors for every collective. Gloo, in the PyTorch build
the card runs (2.11, CUDA 12.8), takes them for all-reduce (small, 104 MB
and asynchronous, as DDP's hooks call it), broadcast and all-gather, and
aborts the process on point-to-point ("writev ... Bad address" in its TCP
transport: it hands the device pointer to the socket); chip_smoke.py phase
16 probes each in its own pair of processes. So under gloo `shift` moves
CUDA tensors through pinned host memory: a copy down, the exchange on the
host, a copy up. This is transport only; the compute stays on the
tensors' device. `STAGED["bytes"]` counts the bytes copied down and up.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import distributed as D

STAGED = {"bytes": 0}


def reset_staged() -> None:
    STAGED["bytes"] = 0


def _staged(t: torch.Tensor) -> bool:
    """Whether a point-to-point exchange of `t` goes through host memory."""
    return t.is_cuda and D.backend() != "nccl"


def _down(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=torch.cuda.is_available())
    host.copy_(t)
    STAGED["bytes"] += t.numel() * t.element_size()
    return host


def _up(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    STAGED["bytes"] += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=True)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """`t` (at least 1-d) as raw bytes, its last dim times the element
    size: every dtype crosses, bool and bfloat16 included, whatever the
    backend takes."""
    return t.contiguous().view(torch.uint8)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks, at least 1-d),
    concatenated along dim 0 in rank order."""
    n = D.world_size()
    if n == 1:
        return t
    raw = _bytes(t)
    out = raw.new_empty((n * raw.shape[0],) + tuple(raw.shape[1:]))
    dist.all_gather(list(out.chunk(n)), raw)
    return out.view(t.dtype)


def shift(t: torch.Tensor, step: int) -> torch.Tensor:
    """Point-to-point neighbour exchange: rank r sends `t` to rank r + step
    and returns what rank r - step sent it; a rank with no such sender
    (past either end, no wrap-around) returns zeros like `t`."""
    r, n = D.rank(), D.world_size()
    dst, src = r + step, r - step
    staged = _staged(t)
    send = _down(_bytes(t)) if staged else _bytes(t)
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, send, dst))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, recv, src))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if not 0 <= src < n:
        return torch.zeros_like(t)
    return (_up(recv, t) if staged else recv).view(t.dtype)
