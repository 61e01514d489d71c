"""Grouped 3x3 convolution, stride 1, SAME padding, channel-last, with an
optional fused per-channel bias and ReLU: the CUDA kernel's wrapper and its
plain version.

Port of nl_vsgg_tpu/ops/pallas_grouped_conv.py::grouped_conv3x3 (the kernel
is `csrc/grouped_conv.cu`): the conv2 of a ResNeXt bottleneck at stride 1,
with the FrozenBN that follows folded in (its scale into the weights, its
bias and the ReLU into the epilogue).

Layout, as the JAX function's: x (N, H, W, C), w (3, 3, C // groups, C)
HWIO, the UNPACKED grouped kernel (a block-diagonal packed kernel is
refused), bias (C,). Sums are float32; the output is in `out_dtype`
(default: x's type).

`grouped_conv3x3` takes the plain version only for tensors on the CPU; on
CUDA it launches the kernel or raises. `LAUNCHES["grouped_conv3x3"]` counts
launches; `reset_launches()` sets it to 0.

What the kernel takes. bfloat16 inputs run on the tensor cores: c = C //
groups in {8, 16, 32, 64}, C % 64 == 0 (a block owns 64 output channels),
x and w on 16-byte aligned storage (cp.async copies 16 bytes), the output
bfloat16 or float32. `tile_plan` cuts the output into tiles of at most 256
pixels (TH rows x TW <= 64 columns of one image, or NB whole small images)
whose ring of two halo'd input tiles and the slab's weights fit a block's
shared memory, and sizes the persistent grid from the SM count. float32
inputs (the check path) run on the CUDA cores: C % 64 == 0, c % 4 == 0, c
dividing 64 or a multiple of it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_C = 64          # output channels a kernel block (csrc/grouped_conv.cu SLAB, CB)
TC_GROUP_WIDTHS = (8, 16, 32, 64)   # c the tensor-core (bf16) kernel is built for
TILE_PIXELS = 256     # output pixels a bf16 tile: 8 warps x 32 (TC_PIXELS)
TILE_COLS = 64        # widest tile in columns
STAGES = 2            # input tiles in the cp.async ring
PIXEL_STRIDE = BLOCK_C + 8        # staged pixel / weight row, in bf16 (SPS)
SMEM_LIMIT = 232448   # shared memory a block may use on sm_90

LAUNCHES = {"grouped_conv3x3": 0}


def reset_launches() -> None:
    LAUNCHES["grouped_conv3x3"] = 0


def _check(x, w, groups, bias):
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    C = x.shape[3]
    if groups <= 0 or C % groups:
        raise ValueError(f"C={C} is not divisible by groups={groups}")
    c = C // groups
    if tuple(w.shape) != (3, 3, c, C):
        raise ValueError(f"expected unpacked kernel (3,3,{c},{C}), got {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (C,):
        raise ValueError(f"bias must be ({C},), got {tuple(bias.shape)}")
    devs = {t.device for t in (x, w, bias) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got {x.dtype}/{w.dtype}")


def tile_smem_bytes(c: int, TH: int, TW: int, NB: int) -> int:
    """Shared memory of the bf16 kernel: the slab's weight rows (9 c rounded
    up to 16) and STAGES halo'd input tiles, every row PIXEL_STRIDE bf16."""
    rows = -(-9 * c // 16) * 16
    return 2 * PIXEL_STRIDE * (rows + STAGES * NB * (TH + 2) * (TW + 2))


def tile_plan(N: int, H: int, W: int, C: int, c: int, sms: int) -> dict:
    """The bf16 kernel's tiles and grid for an (N, H, W, C) map with c
    channels a group on a card of `sms` SMs: TH x TW output pixels of NB
    images a tile (at most TILE_PIXELS; NB > 1 only when a tile holds whole
    images), `tiles` tiles numbered with the column block fastest, and
    `per_slab` blocks for each BLOCK_C output channels (the SMs shared by
    the C // BLOCK_C slabs, at least 1, at most one a tile)."""
    TW = min(W, TILE_COLS)
    TH = max(1, min(H, TILE_PIXELS // TW))
    NB = max(1, min(N, TILE_PIXELS // (H * W))) if (TH, TW) == (H, W) else 1
    while tile_smem_bytes(c, TH, TW, NB) > SMEM_LIMIT:
        if NB > 1:
            NB -= 1
        elif TH > 1:
            TH = (TH + 1) // 2
        else:
            TW = (TW + 1) // 2
    tiles = -(-N // NB) * -(-H // TH) * -(-W // TW)
    per_slab = max(1, min(tiles, sms // (C // BLOCK_C)))
    return {"TH": TH, "TW": TW, "NB": NB, "tiles": tiles, "per_slab": per_slab,
            "smem": tile_smem_bytes(c, TH, TW, NB)}


def grouped_conv3x3_reference(x: torch.Tensor, w: torch.Tensor, groups: int,
                              bias: torch.Tensor | None = None, relu: bool = False,
                              out_dtype=None) -> torch.Tensor:
    """F.conv2d(groups=groups) in float32, then bias and ReLU; NHWC in and out."""
    _check(x, w, groups, bias)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1, groups=groups).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.float()
    if relu:
        y = y.clamp(min=0.0)
    return y.to(out_dtype or x.dtype).contiguous()


def grouped_conv3x3(x: torch.Tensor, w: torch.Tensor, groups: int,
                    bias: torch.Tensor | None = None, relu: bool = False,
                    out_dtype=None) -> torch.Tensor:
    """The grouped 3x3 stride-1 SAME conv of x (N, H, W, C) by w (3, 3, c, C),
    + bias, ReLU -> (N, H, W, C) contiguous."""
    if x.device.type == "cpu":
        return grouped_conv3x3_reference(x, w, groups, bias, relu, out_dtype)
    _check(x, w, groups, bias)
    N, H, W, C = x.shape
    c = C // groups
    tc = x.dtype == torch.bfloat16
    if tc and (C % BLOCK_C or c not in TC_GROUP_WIDTHS):
        raise ValueError(f"the bf16 kernel takes C % {BLOCK_C} == 0 and c = C/groups in "
                         f"{TC_GROUP_WIDTHS}; got C={C}, c={c}")
    if not tc and (C % BLOCK_C or (BLOCK_C % c and c % BLOCK_C) or c % 4):
        raise ValueError(f"the fp32 kernel takes C % {BLOCK_C} == 0, c = C/groups dividing "
                         f"or a multiple of {BLOCK_C}, and c % 4 == 0; got C={C}, c={c}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    x, w = x.contiguous(), w.contiguous()
    if tc and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 grouped_conv3x3 kernel needs 16-byte aligned x and w")
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty((N, H, W, C), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = tile_plan(N, H, W, C, c, _build.sm_count(x.device)) if tc else \
        {"TH": 0, "TW": 0, "NB": 0, "per_slab": 0}
    with torch.cuda.device(x.device):
        rc = _fn()(_DTYPES[x.dtype], _DTYPES[out_dtype], x.data_ptr(), w.data_ptr(),
                   None if b is None else b.data_ptr(), out.data_ptr(), N, H, W, C, c,
                   int(relu), plan["TH"], plan["TW"], plan["NB"], plan["per_slab"],
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_conv3x3 kernel launch failed: cudaError {rc}")
    LAUNCHES["grouped_conv3x3"] += 1
    return out


def _fn():
    fn = _build.load("grouped_conv").grouped_conv3x3
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
