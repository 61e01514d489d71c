"""The packed grouped 3x3 conv of the ablation probe and its ablation
variants: the CUDA kernels' wrappers (`csrc/grouped_conv_ablate.cu`,
wgmma and mma.sync on the tensor cores) and their plain versions.

Port of tools/probe_pallas_ablate.py (`make`, NHWC, and `make_bt`,
block-major). Groups of the stage-4 conv are packed block-diagonally into
super-groups of CB = 128 channels, so each tap is a dense 128 x 128
product. Shapes (N, H, W, C with C % 128 == 0, nb = C / 128):

    NHWC         x (N, H + 2, W, C)          w (3, 3, 128, C)      out (N, H, W, C)
    block-major  x (nb, N, H + 2, W, 128)    w (3, 3, nb, 128, 128) out (nb, N, H, W, 128)

x carries its 2 halo rows: H is the output's height. With xp = x,
blk(o) = o // 128 and xp zero outside [0, W) along W, the variants are

    full      out[n,h,w,o] = sum_{dh,dw,i} xp[n, h+dh, w+dw-1, blk(o)*128+i] w[dh,dw,i,o]
              (VALID in H, SAME in W, groups = nb): the real conv;
    mm-only   the probe's nine products with no shift, at one image a step:
              per image Xn = xp[n] flattened to ((H+2) W, 128) per block,
              out = (sum_t Xn @ w[t//3, t%3])[:H W], i.e.
              out[n,h,w,o] = sum_{t,i} xp[n, h, w, blk(o)*128+i] w[t//3, t%3, i, o];
    mm1-only  the same with the one product of tap 0, w[0, 0];
    add-only  nine adds of the constant 0.001 and no product: each output is
              0.001 times the number of taps in bounds in W (9 inside, 6 at
              the two W edges);
    bt-full   `full` in the block-major layout;
    bt-mm1    the probe's block-major single product (`make_bt` keeps
              taps[:1] = [(1, 0)], the centre tap):
              out[n,h,w,o] = sum_i xp[n, h+1, w, blk(o)*128+i] w[1, 1, i, o].

The probe's `tn` (images a grid step) has no meaning for a Hopper block; the
kernel's tile of output rows, `tile_rows`, takes its place. `kernel_plan`
says what a launch uses and which route the kernel takes, from dtype and
shape alone: "ring" (bf16, tile_rows * W a multiple of 64 and at most 256,
W a multiple of 8: persistent blocks that walk the row tiles of one image
and super-group, input rows staged once, tap weights through a ring of
tensor copies, products on wgmma) or "tile" (float32, and bf16 tiles the
ring refuses: tile_rows * W a multiple of 32 and at most 256; the first
design). Storage must be 16-byte aligned on both. The sums are float32 and
the output is in x's type. `to_block_major` / `from_block_major` are the
probe's layout changes (`probe_pallas_ablate.py:133-134`, `:154`).

`grouped_conv_ablate` and `grouped_conv_ablate_bt` take the plain versions
only for tensors on the CPU; on CUDA they launch the kernel or raise.
`LAUNCHES` counts launches of each; `reset_launches()` sets them to 0.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

CB = 128
VARIANTS = ("full", "mm-only", "mm1-only", "add-only")
BT_VARIANTS = ("bt-full", "bt-mm1")
ADD = 0.001
_CODES = {"full": 0, "mm-only": 1, "mm1-only": 2, "add-only": 3, "bt-full": 0, "bt-mm1": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"tile": 0, "ring": 1}
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
WG_PIXELS = 64            # csrc WG_PIXELS: output pixels a warpgroup
RING_MAX_PIXELS = 256     # RING_MAX_PIXELS: output pixels a tile
PIXEL_BYTES = 2 * CB      # a staged pixel or weight row, bf16
MAX_W_STAGES = 3          # tap weight slots of the ring where shared memory allows, else 2

LAUNCHES = {"grouped_conv_ablate": 0, "grouped_conv_ablate_bt": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def to_block_major(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, Hx, W, C) -> (nb, N, Hx, W, 128); w (3, 3, 128, C) -> (3, 3, nb, 128, 128)."""
    wt = w.reshape(3, 3, CB, w.shape[3] // CB, CB).permute(0, 1, 3, 2, 4).contiguous()
    return _maps_to_block_major(x), wt


def _maps_to_block_major(t):
    N, Hx, W, C = t.shape
    return t.reshape(N, Hx, W, C // CB, CB).permute(3, 0, 1, 2, 4).contiguous()


def from_block_major(t: torch.Tensor) -> torch.Tensor:
    """(nb, N, Hx, W, 128) -> (N, Hx, W, nb * 128)."""
    nb, N, Hx, W, cb = t.shape
    return t.permute(1, 2, 3, 0, 4).reshape(N, Hx, W, nb * cb)


def _weights_from_block_major(wt):
    return wt.permute(0, 1, 3, 2, 4).reshape(3, 3, CB, wt.shape[2] * CB)


def _check(x, w, block_major, variant):
    names = BT_VARIANTS if block_major else VARIANTS
    if variant not in names:
        raise ValueError(f"variant must be one of {names}, got {variant!r}")
    if block_major:
        if x.dim() != 5 or x.shape[4] != CB or tuple(w.shape) != (3, 3, x.shape[0], CB, CB):
            raise ValueError(f"expected x (nb, N, H+2, W, {CB}) and w (3, 3, nb, {CB}, {CB}), "
                             f"got {tuple(x.shape)} and {tuple(w.shape)}")
    elif x.dim() != 4 or x.shape[3] % CB or tuple(w.shape) != (3, 3, CB, x.shape[3]):
        raise ValueError(f"expected x (N, H+2, W, C) with C % {CB} == 0 and w (3, 3, {CB}, C), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[-3] < 3:
        raise ValueError(f"x needs its 2 halo rows and at least one output row, got "
                         f"{x.shape[-3]} rows")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share float32 or bfloat16, got {x.dtype}/{w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def _nhwc_reference(x, w, variant):
    N, Hx, W, C = x.shape
    H, nb = Hx - 2, C // CB
    xf, wf = x.float(), w.float()
    if variant == "full":
        y = F.conv2d(xf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1), padding=(0, 1),
                     groups=nb).permute(0, 2, 3, 1)
    elif variant in ("mm-only", "mm1-only"):
        xr = xf[:, :H].reshape(N, H, W, nb, CB)
        taps = 9 if variant == "mm-only" else 1
        wr = wf.reshape(9, CB, nb, CB)[:taps]
        y = torch.einsum("nhwbi,tibo->nhwbo", xr, wr).reshape(N, H, W, C)
    else:  # add-only, in the kernel's tap order
        col = torch.arange(W, device=x.device)
        acc = torch.zeros(W, device=x.device)
        for t in range(9):
            src = col + t % 3 - 1
            acc = acc + ADD * ((src >= 0) & (src < W)).float()
        y = acc[None, None, :, None].expand(N, H, W, C)
    return y.to(x.dtype).contiguous()


def grouped_conv_ablate_reference(x: torch.Tensor, w: torch.Tensor, variant: str) -> torch.Tensor:
    """The NHWC variant's function in float32, in x's type."""
    _check(x, w, False, variant)
    return _nhwc_reference(x, w, variant)


def grouped_conv_ablate_bt_reference(xt: torch.Tensor, wt: torch.Tensor,
                                     variant: str) -> torch.Tensor:
    """The block-major variant's function in float32, in xt's type."""
    _check(xt, wt, True, variant)
    if variant == "bt-full":
        out = _nhwc_reference(from_block_major(xt), _weights_from_block_major(wt), "full")
        return _maps_to_block_major(out)
    H = xt.shape[2] - 2
    y = torch.einsum("bnhwi,bio->bnhwo", xt[:, :, 1:H + 1].float(), wt[1, 1].float())
    return y.to(xt.dtype).contiguous()


def smem_bytes(dtype: torch.dtype, tile_rows: int, W: int) -> int:
    """Shared memory of one "tile" block: one tap's weights and the
    tile_rows + 2 staged input rows of W + 2 columns, rows padded by 16 bytes."""
    el = 2 if dtype == torch.bfloat16 else 4
    ps = CB + 16 // el
    return el * ps * (CB + (tile_rows + 2) * (W + 2))


def ring_smem_bytes(tile_rows: int, W: int, stages: int) -> int:
    """Shared memory of one "ring" block (csrc ring_smem): `stages` tap slots
    of 32 KB, 2 tile_rows + 2 input row slots of W pixels x 256 bytes, a
    256-byte zero row (the W halo), a full and an empty barrier a slot and
    two for the tiles' rows."""
    return (stages * CB * PIXEL_BYTES + (2 * tile_rows + 2) * W * PIXEL_BYTES + PIXEL_BYTES
            + (2 * stages + 2) * 8)


def ring_stages(tile_rows: int, W: int) -> int:
    """The ring's tap slots: MAX_W_STAGES where they fit, else 2."""
    return MAX_W_STAGES if ring_smem_bytes(tile_rows, W, MAX_W_STAGES) <= SMEM_LIMIT else 2


def kernel_plan(dtype: torch.dtype, N: int, H: int, W: int, C: int, tile_rows: int,
                sms: int) -> dict:
    """What one launch uses at output (N, H, W, C) with `tile_rows` output
    rows a tile on a card of `sms` SMs: {"route", "tile_rows", "threads",
    "stages", "smem", "grid", "parts", "rows_per_part", "tiles"}. The ring
    takes bf16 with tile_rows * W a multiple of 64, at most 256, W a
    multiple of 8 (its rows are 128-byte swizzled tensor-copy boxes), within
    the shared-memory limit at 2 tap slots: `parts` blocks for each image
    and super-group (SMs over images x super-groups, at least 1, at most
    H), each walking ceil(H / parts) output rows in tiles of tile_rows; a
    warpgroup (wgmma) a 64 pixels; `stages` its row and tap slots (3 tap
    slots where they fit, 2 for the one-tap variants). Otherwise the tile
    route: a block a tile, 2 threads a pixel. Raises ValueError for what
    neither takes."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    if N < 1 or H < 1 or W < 1 or C < CB or C % CB:
        raise ValueError(f"expected N, H, W >= 1 and C a multiple of {CB}, got "
                         f"{(N, H, W, C)}")
    nb, pixels = C // CB, tile_rows * W
    if (dtype == torch.bfloat16 and pixels % WG_PIXELS == 0 and pixels <= RING_MAX_PIXELS
            and W % 8 == 0 and ring_smem_bytes(tile_rows, W, 2) <= SMEM_LIMIT):
        parts = max(1, min(H, sms // (N * nb)))
        rows = -(-H // parts)
        parts = -(-H // rows)                      # no part left empty
        stages = ring_stages(tile_rows, W)
        return {"route": "ring", "tile_rows": tile_rows, "threads": 2 * pixels,
                "stages": {"rows": 2 * tile_rows + 2, "taps": stages},
                "smem": ring_smem_bytes(tile_rows, W, stages), "grid": (parts, N, nb),
                "parts": parts, "rows_per_part": rows,
                "tiles": parts * N * nb * -(-rows // tile_rows)}
    if pixels % 32 or pixels > 256:
        raise ValueError(f"the kernel needs tile_rows * W a multiple of 32 (of 64 for the "
                         f"bf16 ring) and at most 256, got tile_rows={tile_rows}, W={W}")
    smem = smem_bytes(dtype, tile_rows, W)
    if smem > SMEM_LIMIT:
        raise ValueError(f"tile_rows={tile_rows} at W={W} in {dtype} needs {smem} bytes of "
                         f"shared memory, more than a block's {SMEM_LIMIT}")
    tiles = -(-H // tile_rows)
    return {"route": "tile", "tile_rows": tile_rows, "threads": 2 * pixels,
            "stages": {"rows": tile_rows + 2, "taps": 1}, "smem": smem,
            "grid": (tiles, N, nb), "parts": tiles, "rows_per_part": tile_rows,
            "tiles": tiles * N * nb}


def route(x: torch.Tensor, tile_rows: int, block_major: bool = False) -> str:
    """The route a launch on x takes at `tile_rows` (`kernel_plan`)."""
    return kernel_plan(x.dtype, *_out_geometry(x, block_major), tile_rows, 1)["route"]


def _out_geometry(x, block_major):
    if block_major:
        nb, N, Hx, W, _ = x.shape
        return N, Hx - 2, W, nb * CB
    N, Hx, W, C = x.shape
    return N, Hx - 2, W, C


def _launch(x, w, variant, tile_rows, block_major):
    N, H, W, C = _out_geometry(x, block_major)
    plan = kernel_plan(x.dtype, N, H, W, C, tile_rows, _build.sm_count(x.device))
    x, w = x.contiguous(), w.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_conv_ablate needs 16-byte aligned storage")
    shape = (C // CB, N, H, W, CB) if block_major else (N, H, W, C)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _fn()(_DTYPES[x.dtype], _CODES[variant], int(block_major), _ROUTES[plan["route"]],
                   x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, tile_rows,
                   plan["parts"], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_conv_ablate kernel launch failed: cudaError {rc}")
    LAUNCHES["grouped_conv_ablate_bt" if block_major else "grouped_conv_ablate"] += 1
    return out


def grouped_conv_ablate(x: torch.Tensor, w: torch.Tensor, variant: str = "full",
                        tile_rows: int = 2) -> torch.Tensor:
    """An NHWC variant (`VARIANTS`) of x (N, H+2, W, C) by w (3, 3, 128, C)
    -> (N, H, W, C), `tile_rows` output rows a kernel block."""
    _check(x, w, False, variant)
    if x.device.type == "cpu":
        return _nhwc_reference(x, w, variant)
    return _launch(x, w, variant, tile_rows, False)


def grouped_conv_ablate_bt(xt: torch.Tensor, wt: torch.Tensor, variant: str = "bt-full",
                           tile_rows: int = 2) -> torch.Tensor:
    """A block-major variant (`BT_VARIANTS`) of xt (nb, N, H+2, W, 128) by wt
    (3, 3, nb, 128, 128) -> (nb, N, H, W, 128)."""
    if xt.device.type == "cpu":
        return grouped_conv_ablate_bt_reference(xt, wt, variant)
    _check(xt, wt, True, variant)
    return _launch(xt, wt, variant, tile_rows, True)


def _fn():
    fn = _build.load("grouped_conv_ablate").grouped_conv_ablate
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
