"""y = 2 x in float32 or bfloat16: the launch-overhead probe's copy kernel
(`csrc/probe_copy.cu`) and its plain version.

Port of the copy kernels of tools/probe_pallas_overhead.py (tiny-copy,
slab-copy, slab-copy-g8). The probe's units of work stay as it defines
them (one for tiny-copy and slab-copy, eight per-image units for
slab-copy-g8); `copy_plan` spreads each unit over enough blocks that the
units together fill the card, so a TPU grid step is not a Hopper block.

`probe_copy` takes the plain version only for tensors on the CPU; on CUDA it
launches the kernel or raises. `LAUNCHES["probe_copy"]` counts launches;
`reset_launches()` sets it to 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256          # csrc/probe_copy.cu THREADS
DEPTH = 2              # 16-byte loads in flight a thread (DEPTH)
CHUNK = THREADS * DEPTH   # vectors a block moves a pass (CHUNK)
BLOCKS_PER_SM = 8      # 256-thread blocks: a full SM holds 8
ROUTE = "loads"        # the kernel's body: DEPTH plain loads a thread (BULK false)
MAX_UNITS = 65535      # units are the grid's y dimension

LAUNCHES = {"probe_copy": 0}


def reset_launches() -> None:
    LAUNCHES["probe_copy"] = 0


def probe_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """x * 2 (exact in both types)."""
    return x * 2


def copy_plan(n: int, dtype: torch.dtype, units: int, sms: int, depth: int = DEPTH,
              threads: int = THREADS) -> dict:
    """The kernel's grid for n elements split into `units` units on a card
    of `sms` SMs. Unit u owns the 16-byte vectors [u per, (u + 1) per) (per
    = ceil(vectors / units), cut at the last vector). Each unit gets
    `blocks_per_unit` blocks: as many as its vectors need at `depth` x
    THREADS a block, but at least its share of the SMs (down to one vector
    a thread), and at most its share of sms x BLOCKS_PER_SM; "depth" is the
    loads in flight a thread (1 where the grid has a thread for every
    vector, as the kernel picks it). The `tail` elements past the last
    whole vector go to the last unit's first block."""
    if units < 1 or units > MAX_UNITS:
        raise ValueError(f"units must be in [1, {MAX_UNITS}], got {units}")
    e = 16 // (4 if dtype == torch.float32 else 2)
    vectors = n // e
    per = -(-vectors // units)
    want = max(-(-per // (depth * threads)), min(-(-per // threads), sms // units))
    blocks = max(1, min(want, sms * BLOCKS_PER_SM // units))
    depth = 1 if blocks * threads >= per else depth   # a thread for every vector: one load
    return {"route": ROUTE, "units": units, "blocks_per_unit": blocks, "grid": (blocks, units),
            "threads": threads, "depth": depth, "chunk": depth * threads, "vectors": vectors,
            "per_unit": per, "tail": n - vectors * e, "elements_per_vector": e}


def probe_copy(x: torch.Tensor, units: int = 1) -> torch.Tensor:
    """2 x, of x's shape and type, by one kernel launch over `units` units."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if units < 1 or units > MAX_UNITS:
        raise ValueError(f"units must be in [1, {MAX_UNITS}], got {units}")
    if x.device.type == "cpu":
        return probe_copy_reference(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("probe_copy needs 16-byte aligned storage")
    plan = copy_plan(x.numel(), x.dtype, units, _build.sm_count(x.device))
    with torch.cuda.device(x.device):
        rc = _fn()(_DTYPES[x.dtype], x.data_ptr(), y.data_ptr(), x.numel(), plan["per_unit"],
                   units, plan["blocks_per_unit"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_copy kernel launch failed: cudaError {rc}")
    LAUNCHES["probe_copy"] += 1
    return y


def _fn():
    fn = _build.load("probe_copy").probe_copy
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, ctypes.c_longlong, ctypes.c_longlong, i, i, p]
        fn.restype = ctypes.c_int
    return fn
