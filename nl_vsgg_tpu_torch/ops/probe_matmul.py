"""A tall-skinny bf16 product, (M, 128) @ (128, 128) with fp32 sums and a
bf16 result: the launch-overhead probe's matmul kernel
(`csrc/probe_matmul.cu`: mma.sync on the tensor cores, w held resident, a
persistent grid of one block an SM walking 32-row tiles of x through a
cp.async ring) and its plain version.

Port of tools/probe_pallas_overhead.py's mm-pallas kernel. `torch.matmul`
is not a port of it; the probe times it beside the kernel as the library
row (mm-xla's counterpart).

`probe_matmul` takes the plain version only for tensors on the CPU; on CUDA
it launches the kernel or raises. `LAUNCHES["probe_matmul"]` counts
launches; `reset_launches()` sets it to 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

K = 128  # the depth and width of w
TILE_ROWS = 32  # rows of x a kernel tile (csrc/probe_matmul.cu BM)

LAUNCHES = {"probe_matmul": 0}


def reset_launches() -> None:
    LAUNCHES["probe_matmul"] = 0


def _check(x, w):
    if x.dim() != 2 or x.shape[1] != K or tuple(w.shape) != (K, K):
        raise ValueError(f"expected x (M, {K}) and w ({K}, {K}), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x.dtype}/{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def probe_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(x @ w) in float32, rounded once to bf16."""
    _check(x, w)
    return (x.float() @ w.float()).to(torch.bfloat16)


def probe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, 128) @ w (128, 128) -> (M, 128) bf16, fp32 sums."""
    if x.device.type == "cpu":
        return probe_matmul_reference(x, w)
    _check(x, w)
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((x.shape[0], K), dtype=torch.bfloat16, device=x.device)
    if x.shape[0] == 0:
        return y
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("probe_matmul needs 16-byte aligned storage")
    tiles = -(-x.shape[0] // TILE_ROWS)
    blocks = min(tiles, _build.sm_count(x.device))
    with torch.cuda.device(x.device):
        rc = _fn()(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0], blocks,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_matmul kernel launch failed: cudaError {rc}")
    LAUNCHES["probe_matmul"] += 1
    return y


def _fn():
    fn = _build.load("probe_matmul").probe_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn
