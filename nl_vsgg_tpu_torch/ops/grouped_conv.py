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
CUDA it launches the kernel or raises. `ROUTE_LAUNCHES` counts launches by
route, `launches()` gives their sum; `reset_launches()` sets them to 0.

Routes, picked before the launch by `conv_route` (each has its own C entry,
which refuses what the route does not take):
  "tc"      bfloat16 inputs, tensor cores (mma.sync m16n8k16): c = C //
            groups in {8, 16, 32, 64}, C % 64 == 0 (a block owns 64 output
            channels), x and w on 16-byte aligned storage (cp.async copies
            16 bytes), the output bfloat16 or float32. `tile_plan` cuts the
            output into tiles of at most 256 pixels (TH rows x TW <= 64
            columns of one image, or NB whole small images) whose ring of
            two halo'd input tiles and the slab's weights fit a block's
            shared memory, and sizes the persistent grid from the SM count.
  "3xtf32"  float32 inputs at the same c, C and alignment: the same implicit
            GEMM on TF32 tensor cores (mma.sync m16n8k8), each product
            formed as three from hi / lo splits of both operands, which
            keeps float32's 1e-5 where one TF32 product would not.
            `tf32_plan`: tiles of at most 128 pixels (TW <= 16 columns) for
            a 64-channel slab, at c = 64 of 256 pixels for half a group's
            channels (five whole 7x7 crops, staged without their zero
            border); rows of 64 floats XOR-swizzled instead of padded. The
            default route of the float32 detector (`preprocess features`,
            the union provider, the test CLI); its bound at a 32-frame pass
            is 16.2 ms of bytes, its own floor 26.0 ms of three TF32
            products at 495 TFLOP/s (PERF.md).
  "fma"     other float32 inputs (c % 4 == 0, c dividing 64 or a multiple
            of it, C % 64 == 0, or storage off 16 bytes): the first kernel,
            scalar FMAs on the CUDA cores.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_C = 64          # output channels a kernel block (csrc/grouped_conv.cu SLAB, CB)
TC_GROUP_WIDTHS = (8, 16, 32, 64)   # c the tensor-core routes are built for
TILE_PIXELS = 256     # output pixels a bf16 tile: 8 warps x 32 (TC_PIXELS)
TILE_COLS = 64        # widest bf16 tile in columns
TF32_TILE_COLS = 16      # widest 3xtf32 tile in columns
TF32_ROW = 64            # floats a 3xtf32 staged pixel (TF_ROW)
STAGES = 2            # input tiles in the cp.async ring
PIXEL_STRIDE = BLOCK_C + 8        # staged pixel / weight row, in bf16 (SPS)
SMEM_LIMIT = 232448   # shared memory a block may use on sm_90
ROUTES = ("tc", "3xtf32", "fma")
_ENTRY = {r: f"grouped_conv3x3_{r}" for r in ROUTES}

ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def launches() -> int:
    """Kernel launches since the last `reset_launches()`, all routes."""
    return sum(ROUTE_LAUNCHES.values())


def reset_launches() -> None:
    for r in ROUTES:
        ROUTE_LAUNCHES[r] = 0


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


def tf32_block_channels(c: int) -> int:
    """Output channels a 3xtf32 block: a BLOCK_C slab, or half of c = 64's
    one group (tf_block_c)."""
    return 32 if c == 64 else BLOCK_C


def tf32_tile_pixels(c: int) -> int:
    """Output pixels a 3xtf32 tile: 8 warps of 32 pixels x 32 channels over
    the block's channels (tf_pixels): 128, or 256 at c = 64."""
    return 32 * 8 // (tf32_block_channels(c) // 32)


def tf32_smem_bytes(c: int, TH: int, TW: int, NB: int, whole: bool) -> int:
    """Shared memory of the 3xtf32 kernel: the block's 9 c weight rows of
    `tf32_block_channels(c)` floats, one zero pixel and STAGES input tiles
    of TF32_ROW floats a pixel (swizzled, no pad); a tile of whole images
    (`whole`: TH = H, TW = W) stages its pixels only, any other its halo."""
    px = NB * TH * TW if whole else NB * (TH + 2) * (TW + 2)
    return 4 * (9 * c * tf32_block_channels(c) + TF32_ROW * (1 + STAGES * px))


def _plan(N, H, W, C, sms, pixels, cols, smem_bytes, block_c) -> dict:
    TW = min(W, cols)
    TH = max(1, min(H, pixels // TW))
    NB = max(1, min(N, pixels // (H * W))) if (TH, TW) == (H, W) else 1
    while smem_bytes(TH, TW, NB) > SMEM_LIMIT:
        if NB > 1:
            NB -= 1
        elif TH > 1:
            TH = (TH + 1) // 2
        else:
            TW = (TW + 1) // 2
    tiles = -(-N // NB) * -(-H // TH) * -(-W // TW)
    per_slab = max(1, min(tiles, sms // (C // block_c)))
    return {"TH": TH, "TW": TW, "NB": NB, "tiles": tiles, "per_slab": per_slab,
            "smem": smem_bytes(TH, TW, NB)}


def tile_plan(N: int, H: int, W: int, C: int, c: int, sms: int) -> dict:
    """The bf16 kernel's tiles and grid for an (N, H, W, C) map with c
    channels a group on a card of `sms` SMs: TH x TW output pixels of NB
    images a tile (at most TILE_PIXELS; NB > 1 only when a tile holds whole
    images), `tiles` tiles numbered with the column block fastest, and
    `per_slab` blocks for each BLOCK_C output channels (the SMs shared by
    the C // BLOCK_C slabs, at least 1, at most one a tile)."""
    return _plan(N, H, W, C, sms, TILE_PIXELS, TILE_COLS,
                 lambda TH, TW, NB: tile_smem_bytes(c, TH, TW, NB), BLOCK_C)


def tf32_plan(N: int, H: int, W: int, C: int, c: int, sms: int) -> dict:
    """The 3xtf32 kernel's tiles and grid, as `tile_plan` with at most
    `tf32_tile_pixels(c)` pixels and TF32_TILE_COLS columns a tile and
    `per_slab` blocks for each `tf32_block_channels(c)` output channels:
    8 x 16 in the trunk, five whole 7x7 crops in the head."""
    return _plan(N, H, W, C, sms, tf32_tile_pixels(c), TF32_TILE_COLS,
                 lambda TH, TW, NB: tf32_smem_bytes(c, TH, TW, NB, (TH, TW) == (H, W)),
                 tf32_block_channels(c))


def conv_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route of x (N, H, W, C) by w (3, 3, c, C), from dtype, widths and
    16-byte alignment alone: "tc" for bfloat16, "3xtf32" for float32 at c in
    TC_GROUP_WIDTHS, C % BLOCK_C == 0 and aligned storage, else "fma"."""
    if x.dtype == torch.bfloat16:
        return "tc"
    if (w.shape[2] in TC_GROUP_WIDTHS and x.shape[3] % BLOCK_C == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "3xtf32"
    return "fma"


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
    x, w = x.contiguous(), w.contiguous()
    route = conv_route(x, w)
    if route == "tc" and (C % BLOCK_C or c not in TC_GROUP_WIDTHS):
        raise ValueError(f"the bf16 kernel takes C % {BLOCK_C} == 0 and c = C/groups in "
                         f"{TC_GROUP_WIDTHS}; got C={C}, c={c}")
    if route == "fma" and (C % BLOCK_C or (BLOCK_C % c and c % BLOCK_C) or c % 4):
        raise ValueError(f"the fp32 kernel takes C % {BLOCK_C} == 0, c = C/groups dividing "
                         f"or a multiple of {BLOCK_C}, and c % 4 == 0; got C={C}, c={c}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if route == "tc" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the bf16 grouped_conv3x3 kernel needs 16-byte aligned x and w")
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty((N, H, W, C), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan_fn = {"tc": tile_plan, "3xtf32": tf32_plan}.get(route)
    plan = plan_fn(N, H, W, C, c, _build.sm_count(x.device)) if plan_fn else \
        {"TH": 0, "TW": 0, "NB": 0, "per_slab": 0}
    with torch.cuda.device(x.device):
        rc = _fn(route)(_DTYPES[out_dtype], x.data_ptr(), w.data_ptr(),
                        None if b is None else b.data_ptr(), out.data_ptr(), N, H, W, C, c,
                        int(relu), plan["TH"], plan["TW"], plan["NB"], plan["per_slab"],
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_conv3x3 kernel launch failed ({route} route): "
                           f"cudaError {rc}")
    ROUTE_LAUNCHES[route] += 1
    return out


def _fn(route: str):
    """The C entry of `route` (all three take the same arguments)."""
    fn = getattr(_build.load("grouped_conv"), _ENTRY[route])
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
