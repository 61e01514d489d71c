"""y = 2 x in float32 or bfloat16: the launch-overhead probe's copy kernel
(`csrc/probe_copy.cu`) and its plain version.

Port of the copy kernels of tools/probe_pallas_overhead.py (tiny-copy,
slab-copy, slab-copy-g8). The TPU's grid steps become the kernel's block
count, an argument: `nl_vsgg_tpu_torch.tools.probe_overhead` launches one
block (tiny-copy), a grid that fills every SM (slab-copy) and eight blocks
(slab-copy-g8).

`probe_copy` takes the plain version only for tensors on the CPU; on CUDA it
launches the kernel or raises. `LAUNCHES["probe_copy"]` counts launches;
`reset_launches()` sets it to 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"probe_copy": 0}


def reset_launches() -> None:
    LAUNCHES["probe_copy"] = 0


def probe_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """x * 2 (exact in both types)."""
    return x * 2


def probe_copy(x: torch.Tensor, blocks: int = 1) -> torch.Tensor:
    """2 x, of x's shape and type, by a kernel of `blocks` blocks."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    if x.device.type == "cpu":
        return probe_copy_reference(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("probe_copy needs 16-byte aligned storage")
    with torch.cuda.device(x.device):
        rc = _fn()(_DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), x.numel(), blocks,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_copy kernel launch failed: cudaError {rc}")
    LAUNCHES["probe_copy"] += 1
    return y


def _fn():
    fn = _build.load("probe_copy").probe_copy
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn
