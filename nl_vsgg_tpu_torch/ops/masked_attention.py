"""Masked multi-head attention: the CUDA kernels' wrappers and their plain
versions.

Port of nl_vsgg_tpu/ops/pallas_attention.py::fused_masked_mha, forward and
backward, with probability dropout (the kernels are
`csrc/masked_attention.cu`). The relation transformers express every
grouping (same frame, same window) as a boolean (Lq, Lk) allow matrix per
video; softmax runs over the allowed keys only, and a query row with no
allowed key outputs 0.

Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), allow (B, Lq, Lk) bool, seeds
(B,) int32 (one dropout seed per video). The head dim is not padded
(STTran's and DSG-DETR's relation layers' is 242, DSG-DETR's tracklet
encoder's 297); the kernels handle the tail. D <= 320 (`_MAX_HEAD_DIM`);
the staged routes take D <= 256.

Dropout keeps p[b, h, q, k] where `dropout_bits` >= rate * 2^32 and scales
the kept probabilities by 1 / (1 - rate), after the softmax, as the JAX
kernel does. The bits are a counter hash of (seed, head, query, key) built
from xor, shifts and 32-bit multiplies whose low half is kept, so the plain
version here and the kernels compute the same mask, and the backward
regenerates it instead of storing it.

`masked_mha` takes the plain version only for tensors on the CPU (autograd
differentiates it there). For CUDA tensors it launches the kernels or
raises; it never falls back. On CUDA, when q, k or v needs a gradient it is
a `torch.autograd.Function`: the forward also writes the log-sum-exp, and
the backward launches the dQ kernel and then the dK/dV kernel. Without
gradients and at rate 0 it is the eval forward: no lse, no hashing.

`LAUNCHES` counts kernel launches by kernel ("fwd", "bwd_dq", "bwd_dkv");
`reset_launches()` sets them to 0.

Each kernel has three routes, the forward four, one launch each, picked
before the launch from dtype, shapes and alignment alone (`fwd_route`,
`dq_route`, `dkv_route`; never from the mask's contents). "staged" (rule
`staged_layout`: bf16, at most 8 heads, an even head dim of at most 256,
q/k/v/g rows and batch and token strides on 16-byte boundaries, H * D * 2
bytes a multiple of 16; the serving and training paths' column blocks of
the fused projection) brings token rows in by 16-byte copies:
  - the forward and dK/dV: one block a (video, tile of 16 query or key
    rows, 2 heads; `fwd_plan`, `dkv_plan`); the block lists the union of
    its rows' allowed keys (queries), copies their rows' slices once a tile
    and runs 16 x 8 tiles of the products on the tensor cores, the warps of
    a head (`FWD_PARTS`, `DKV_PARTS`) splitting S's k-steps;
  - dQ: one block a query row, its allowed keys walked once, summing dQ as
    scale (sum p dP k - r sum p k).
"tiled" (rule `tiled_layout`: float32, at most 8 heads, D <= 320, odd D
too, rows of whole 16-byte pieces, pointers and batch and token strides on
16 bytes; DSG-DETR's tracklet encoder, 8 heads of 297) runs one block a
(video, tile of 16 rows, head) for all three kernels (`tiled_plan`), the
rows of a tile taken in `row_order`: each video's rows by their first
allowed column, so that rows with the same allowed keys share a tile. The
block lists the union of its rows' allowed columns once and stages their
slices once a tile (8 columns a cp.async chunk, the 16-byte window around
a head's slice); the products run on the tensor cores in about float32
accuracy (each operand a TF32 part and the rest, three mma.sync a
product), dQ in one walk as on the staged route.
"resident", the forward only, tried after "staged" (rule `resident_layout`:
float32, Lk <= 128, D <= 128, any number of heads, the tiled rule's
alignment; CLIP's towers, 12 heads of 64 over 50 tokens and 8 of 64 over
77) runs one block a (video, head, tile of 64 query rows; `resident_plan`):
every key's k and v slices copied once into shared memory, each warp's 16
rows of scores in registers, an exact two-pass softmax over the whole row.
No key list and no row order.
"per-element" (bf16 with odd D or D above 256, other views, more than 8
heads outside the resident rule) runs one warp a (row, head) and loads a
head's dims one by one, 8 a lane up to D = 256 and 10 up to 320.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 320              # the per-element kernels: 10 dims a lane
STAGED_MAX_HEAD_DIM = 256        # the staged kernels: 16 k-steps of 16 dims
LSE_EMPTY = -1e30  # lse of a query row with no allowed key (the JAX NEG_INF)
_M32 = 0xFFFFFFFF

LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}

# the staged routes (csrc/masked_attention.cu WARPS, KC, STAGES, TILE, HG, CK,
# FWD_STAGES, DKV_STAGES, FWD_PARTS, DKV_PARTS and the *_staged_smem functions)
STAGED_MAX_HEADS = 8             # dQ: one warp a head
STAGED_SMEM_MAX = 113 * 1024     # dQ: two blocks of an SM's 228 KB (1 KB each reserved)
BLOCK_SMEM_MAX = 232448          # a block's shared memory on sm_90 (227 KB)
STAGED_KEYS = 2                  # dQ: keys a cp.async chunk
STAGED_CHUNKS = 2                # dQ: chunks in the ring
TILE_ROWS = 16                   # forward / dK/dV: query / key rows a block (the mma's m)
HEAD_GROUP = 2                   # forward / dK/dV: heads a block
CHUNK_ROWS = 8                   # forward / dK/dV: keys / queries a cp.async chunk
FWD_CHUNKS = DKV_CHUNKS = 2      # forward / dK/dV: chunks in the ring
FWD_PARTS, DKV_PARTS = 4, 2      # forward / dK/dV: warps a head
# the tiled routes (csrc/masked_attention.cu TT, TCK, TSTAGES, TPARTS, WT_LD,
# tiled_row, tiled_smem and tiled_static_smem)
TILED_MAX_HEADS = 8
TILED_ROWS = 16                  # rows a tile (query rows: forward, dQ; key rows: dK/dV)
TILED_CHUNK = 8                  # columns a cp.async chunk
TILED_CHUNKS = 1                 # chunks in the ring
TILED_PARTS = 4                  # warps a block
_WT_LD = 12                      # row stride of a warp's 16 x 8 weight tile
# the resident forward (csrc/masked_attention.cu RESIDENT_MAX_KEYS,
# RESIDENT_MAX_HEAD_DIM, RROWS, RPARTS, resident_smem and resident_static_smem)
RESIDENT_MAX_KEYS = 128          # a warp's 16 x Lk scores in registers
RESIDENT_MAX_HEAD_DIM = 128      # and its 16 x D outputs
RESIDENT_ROWS = 64               # query rows a block, 16 a warp
RESIDENT_PARTS = 4               # warps a block
_DQ_ENTRY = {"staged": "masked_mha_bwd_dq_staged", "tiled": "masked_mha_bwd_dq_tiled",
             "per-element": "masked_mha_bwd_dq"}
_FWD_ENTRY = {"staged": "masked_mha_fwd_staged", "resident": "masked_mha_fwd_resident",
              "tiled": "masked_mha_fwd_tiled", "per-element": "masked_mha_fwd"}
_DKV_ENTRY = {"staged": "masked_mha_bwd_dkv_staged", "tiled": "masked_mha_bwd_dkv_tiled",
              "per-element": "masked_mha_bwd_dkv"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------ dropout bits
def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 tensors holding uint32 values, in 16-bit
    halves of c so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (the kernel's `fmix32`)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(seeds: torch.Tensor, num_heads: int, lq: int, lk: int) -> torch.Tensor:
    """The uint32 dropout bits (as int64) for every (video, head, query,
    key): (B, H, Lq, Lk), the same values the kernels compute."""
    dev = seeds.device
    s = (seeds.long() & _M32).view(-1, 1, 1, 1)
    h = torch.arange(1, num_heads + 1, device=dev).view(1, -1, 1, 1)
    qi = torch.arange(1, lq + 1, device=dev).view(1, 1, -1, 1)
    ki = torch.arange(1, lk + 1, device=dev).view(1, 1, 1, -1)
    row = _fmix32(s ^ _mul32(h, 0x9E3779B9))
    row = _fmix32(row ^ _mul32(qi, 0x85EBCA77))
    return _fmix32(row ^ _mul32(ki, 0xC2B2AE3D))


def drop_threshold(rate: float) -> int:
    """Bits below this are dropped (_keep_mask's uint32 threshold)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def dropout_keep(seeds: torch.Tensor, num_heads: int, lq: int, lk: int,
                 rate: float) -> torch.Tensor:
    """The (B, H, Lq, Lk) bool keep mask at `rate`."""
    return dropout_bits(seeds, num_heads, lq, lk) >= drop_threshold(rate)


# ---------------------------------------------------------- plain versions
def _probs(q, k, allow, sm_scale):
    """fp32 softmax over the allowed keys, 0 on rows with none: (B, H, Lq, Lk)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    allow4 = allow[:, None]
    logits = logits.masked_fill(~allow4, float("-inf"))
    # a row with no allowed key is all -inf, its softmax NaN: select 0 there
    return torch.where(allow4.any(-1, keepdim=True), torch.softmax(logits, dim=-1), 0.0)


def _drop(p, seeds, rate):
    if rate <= 0.0:
        return p
    keep = dropout_keep(seeds, p.shape[1], p.shape[2], p.shape[3], rate)
    return torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)


def masked_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         allow: torch.Tensor, sm_scale: float, dropout_rate: float = 0.0,
                         seeds: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch: fp32 scores, masked softmax, zero rows, dropout from
    `dropout_keep`, fp32 sums; the output in the input dtype. Same shapes
    as `masked_mha`; autograd differentiates it."""
    _check_dropout(dropout_rate, seeds, q.shape[0])
    p = _drop(_probs(q, k, allow, sm_scale), seeds, dropout_rate)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def masked_mha_lse_reference(q, k, allow, sm_scale) -> torch.Tensor:
    """(B, H, Lq) fp32 log-sum-exp over the allowed keys; LSE_EMPTY on rows
    with none."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    lse = torch.logsumexp(logits.masked_fill(~allow[:, None], float("-inf")), dim=-1)
    return torch.where(allow.any(-1)[:, None], lse, LSE_EMPTY)


def _bwd_parts(q, k, v, allow, sm_scale, g, dropout_rate, seeds):
    """Dense fp32 P and dP = keep-scaled g V^T, (B, H, Lq, Lk) each."""
    _check_dropout(dropout_rate, seeds, q.shape[0])
    p = _probs(q, k, allow, sm_scale)
    dp = _drop(torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float()), seeds, dropout_rate)
    return p, dp


def masked_mha_bwd_dq_reference(q, k, v, allow, sm_scale, g, dropout_rate: float = 0.0,
                                seeds=None):
    """(dq in the input dtype, r (B, H, Lq) fp32): r = rowsum(dP P),
    dS = P (dP - r) scale, dQ = dS K, in dense fp32."""
    p, dp = _bwd_parts(q, k, v, allow, sm_scale, g, dropout_rate, seeds)
    r = (dp * p).sum(-1)
    dq = torch.einsum("bhqk,bkhd->bqhd", p * (dp - r[..., None]) * sm_scale, k.float())
    return dq.to(q.dtype), r


def masked_mha_bwd_dkv_reference(q, k, v, allow, sm_scale, g, r, dropout_rate: float = 0.0,
                                 seeds=None):
    """(dk, dv) in the input dtype from the dQ step's r: dV = P~^T g,
    dK = dS^T Q, in dense fp32."""
    p, dp = _bwd_parts(q, k, v, allow, sm_scale, g, dropout_rate, seeds)
    dv = torch.einsum("bhqk,bqhd->bkhd", _drop(p, seeds, dropout_rate), g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", p * (dp - r[..., None]) * sm_scale, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def masked_mha_bwd_reference(q, k, v, allow, sm_scale, g, dropout_rate: float = 0.0,
                             seeds=None):
    """(dq, dk, dv) in the input dtype from _bwd_kernel's formulas in dense
    fp32: dV = P~^T g, dP = keep-scaled g V^T, dS = P (dP - rowsum(dP P))
    scale, dQ = dS K, dK = dS^T Q."""
    dq, r = masked_mha_bwd_dq_reference(q, k, v, allow, sm_scale, g, dropout_rate, seeds)
    return (dq, *masked_mha_bwd_dkv_reference(q, k, v, allow, sm_scale, g, r, dropout_rate,
                                              seeds))


# ------------------------------------------------------------------ checks
def _check_dropout(rate, seeds, B):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {rate}")
    if rate > 0.0 and (seeds is None or seeds.shape != (B,)):
        raise ValueError(f"dropout needs seeds of shape ({B},), got "
                         f"{None if seeds is None else tuple(seeds.shape)}")


def _packed(name, t, D):
    if t.stride(3) != 1 or t.stride(2) != D:
        raise ValueError(f"{name} must have packed (H, D) axes (strides "
                         f"({D}, 1)), got {t.stride()}")


def _check(q, k, v, allow):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, L, H, D)")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != (B, Lk, H, D):
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if allow.shape != (B, Lq, Lk) or allow.dtype != torch.bool:
        raise ValueError(f"allow must be a ({B}, {Lq}, {Lk}) bool mask, got "
                         f"{tuple(allow.shape)} {allow.dtype}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if D > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {_MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _packed(name, t, D)
    devs = {t.device for t in (q, k, v, allow)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_mha runs on cpu or cuda, got {q.device}")


def _drop_args(rate, seeds, device):
    """(seeds pointer or None, threshold, keep scale) for a launch."""
    if rate <= 0.0:
        return None, 0, 1.0
    if seeds.device != device or seeds.dtype != torch.int32:
        raise ValueError(f"seeds must be int32 on {device}, got {seeds.dtype} on "
                         f"{seeds.device}")
    return seeds.contiguous(), drop_threshold(rate), 1.0 / (1.0 - rate)


# ---------------------------------------------------------------- wrappers
def masked_mha_forward(q, k, v, allow, sm_scale: float, dropout_rate: float = 0.0,
                       seeds=None, with_lse: bool = True):
    """The forward kernel: (out (B, Lq, H, D), lse (B, H, Lq) fp32 or None).

    On the CPU the plain versions stand in."""
    _check(q, k, v, allow)
    _check_dropout(dropout_rate, seeds, q.shape[0])
    if q.device.type == "cpu":
        out = masked_mha_reference(q, k, v, allow, sm_scale, dropout_rate, seeds)
        return out, masked_mha_lse_reference(q, k, allow, sm_scale) if with_lse else None
    return _forward_cuda(q, k, v, allow, sm_scale, dropout_rate, seeds, with_lse)


def _forward_cuda(q, k, v, allow, sm_scale, dropout_rate, seeds, with_lse):
    """The forward launch on checked inputs."""
    B, Lq, H, D = q.shape
    seeds, threshold, keep_scale = _drop_args(dropout_rate, seeds, q.device)
    allow = allow.contiguous()
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device) if with_lse else None
    route = fwd_route(q, k, v)
    order = _order(route, allow)
    with torch.cuda.device(q.device):
        rc = _fn(_FWD_ENTRY[route])(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), allow.data_ptr(),
            *map(_ptr, order), _ptr(seeds), out.data_ptr(), _ptr(lse), B, Lq, k.shape[1], H,
            D, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(sm_scale), threshold, keep_scale, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    LAUNCHES["fwd"] += 1
    return out, lse


def _check_bwd(q, k, v, allow, g, lse, dropout_rate, seeds):
    _check(q, k, v, allow)
    _check_dropout(dropout_rate, seeds, q.shape[0])
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype} {g.device}")
    B, Lq, H, _ = q.shape
    if q.device.type == "cuda" and (lse is None or lse.shape != (B, H, Lq)
                                    or lse.dtype != torch.float32):
        raise ValueError("the backward needs the forward's (B, H, Lq) float32 lse")
    if g.stride(3) != 1 or g.stride(2) != q.shape[3]:
        g = g.contiguous()
    return g


def _bwd_dims(q, k, v, g, sm_scale, threshold, keep_scale):
    B, Lq, H, D = q.shape
    return (B, Lq, k.shape[1], H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), g.stride(0), g.stride(1), float(sm_scale),
            threshold, keep_scale)


def staged_layout(tensors) -> bool:
    """Whether the staged routes can take these (B, L, H, D) tensors: bf16,
    at most 8 heads, an even head dim of at most 256 (a head's slice starts
    on 4 bytes: its bf16 pairs), rows of whole 16-byte pieces, and every tensor's
    pointer and batch and token strides on 16 bytes (the 16-byte copies of
    whole token rows). The one rule of `dq_route`, `fwd_route` and
    `dkv_route`."""
    _, _, H, D = tensors[0].shape
    return (tensors[0].dtype == torch.bfloat16 and H <= STAGED_MAX_HEADS and D % 2 == 0
            and D <= STAGED_MAX_HEAD_DIM and (H * D) % 8 == 0
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                    for t in tensors))


def tiled_layout(tensors) -> bool:
    """Whether the tiled routes can take these (B, L, H, D) tensors:
    float32, at most 8 heads, a head dim of at most 320 (odd too: a head's
    slice is copied with the 16-byte window around it), rows of whole
    16-byte pieces, and every tensor's pointer and batch and token strides
    on 16 bytes (the 16-byte copies). The one rule of the three routes'
    tiled choice; `tiled_refuses` in csrc/masked_attention.cu is the same."""
    _, _, H, D = tensors[0].shape
    return (tensors[0].dtype == torch.float32 and H <= TILED_MAX_HEADS
            and D <= _MAX_HEAD_DIM and (H * D) % 4 == 0
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
                    for t in tensors))


def resident_layout(tensors) -> bool:
    """Whether the resident forward can take these (B, L, H, D) q, k, v:
    float32, at most RESIDENT_MAX_KEYS keys and a head dim of at most
    RESIDENT_MAX_HEAD_DIM (odd too), any number of heads, rows of whole
    16-byte pieces, and every tensor's pointer and batch and token strides
    on 16 bytes (the 16-byte copies). `resident_refuses` in
    csrc/masked_attention.cu is the same rule."""
    _, _, H, D = tensors[0].shape
    return (tensors[0].dtype == torch.float32 and tensors[1].shape[1] <= RESIDENT_MAX_KEYS
            and D <= RESIDENT_MAX_HEAD_DIM and (H * D) % 4 == 0
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
                    for t in tensors))


def resident_plan(lq: int, lk: int, head_dim: int) -> dict:
    """A resident launch: one block of RESIDENT_PARTS warps a (video, head,
    tile of RESIDENT_ROWS query rows), `blocks` tiles a (video, head), block
    t taking rows [t * RESIDENT_ROWS, (t + 1) * RESIDENT_ROWS), 16 a warp.
    `smem`: every key's v and k windows (Lk rounded up to 8) and the tile's
    q windows, `tiled_row` floats a row; `static_smem`: each warp's 16 x 8
    weight tile. `fits` also holds the route's shape limits."""
    threads = 32 * RESIDENT_PARTS
    smem = (2 * -(-lk // 8) * 8 + RESIDENT_ROWS) * tiled_row(head_dim) * 4
    static = RESIDENT_PARTS * TILED_ROWS * _WT_LD * 4
    return {"rows": RESIDENT_ROWS, "blocks": -(-lq // RESIDENT_ROWS), "threads": threads,
            "smem": smem, "static_smem": static,
            "fits": (lk <= RESIDENT_MAX_KEYS and head_dim <= RESIDENT_MAX_HEAD_DIM
                     and smem + static <= BLOCK_SMEM_MAX)}


def tiled_row(head_dim: int) -> int:
    """Floats a staged row of the tiled kernels: the widest 16-byte window
    of a head's slice, 4 mod 8 floats (bank-conflict-free fragment
    loads)."""
    return ((head_dim + 6) & ~3) | 4


def tiled_smem_bytes(columns: int, head_dim: int, kind: str) -> int:
    """Shared memory of one tiled block of `kind` ("fwd", "dq" or "dkv")
    over `columns` columns (keys, or queries for dK/dV): its 16 rows'
    windows of one tensor (the forward's q) or two (dQ's q and g, dK/dV's k
    and v), a ring of TILED_CHUNKS chunks of TILED_CHUNK windows of two
    tensors (float32, `tiled_row` floats a row), for dK/dV each listed
    query's lse, r and dropout row key, the column list (int32) and its row
    bits (16 bits a column)."""
    row_tiles = 1 if kind == "fwd" else 2
    rows = row_tiles * TILED_ROWS + TILED_CHUNKS * 2 * TILED_CHUNK
    return rows * tiled_row(head_dim) * 4 + (columns * 12 if kind == "dkv" else 0) + columns * 6


def tiled_plan(kind: str, lq: int, lk: int, head_dim: int) -> dict:
    """A tiled launch of `kind` ("fwd", "dq" or "dkv"): one block of
    TILED_PARTS warps a (video, tile, head); tile t takes the rows at places
    [t * TILED_ROWS, (t + 1) * TILED_ROWS) of `row_order`'s order (query
    rows, key rows for dK/dV), so `tiles` of them take every row once.
    `static_smem` is the kernel's own: a count a warp, the tile's rows, and
    per product (the forward's S; the backward's S and dP) each lane's
    partial 16 x 8 tile (a float4) and each warp's 16 x 8 weight tile."""
    rows, cols = (lk, lq) if kind == "dkv" else (lq, lk)
    threads = 32 * TILED_PARTS
    sums = 1 if kind == "fwd" else 2
    smem = tiled_smem_bytes(cols, head_dim, kind)
    static = (TILED_PARTS * 4 + TILED_ROWS * 4 + threads * 16 * sums
              + TILED_PARTS * TILED_ROWS * _WT_LD * 4 * sums)
    return {"rows": TILED_ROWS, "tiles": -(-rows // TILED_ROWS), "threads": threads,
            "smem": smem, "static_smem": static, "fits": smem + static <= BLOCK_SMEM_MAX}


def row_order(allow: torch.Tensor) -> torch.Tensor:
    """(B, L) int64: each video's rows of a (B, L, N) bool mask in the order
    the tiled kernels take them: by the first allowed column (a stable
    sort, so rows that allow the same columns first keep their order), the
    rows that allow none last. On same-group masks every 16 rows of the
    order then share their allowed columns. A plan, not a product: any
    order gives the same outputs, each row written to its own slot."""
    n = allow.shape[-1]
    some, first = allow.view(torch.uint8).max(-1)  # the first maximum: the first allowed
    first = torch.where(some.bool(), first, n)
    # 16-bit keys sort in fewer passes than the indices' int64
    return torch.sort(first.to(torch.int16) if n < 2 ** 15 else first, dim=-1,
                      stable=True).indices


def _order(route: str, mask: torch.Tensor) -> list:
    """The tiled entries' order tensor, passed after the mask (the caller
    holds it until the launch is queued); none on the other routes."""
    return [row_order(mask)] if route == "tiled" else []


def dq_staged_smem_bytes(lk: int, num_heads: int, head_dim: int) -> int:
    """Shared memory of one staged dQ block: the q and g rows, a ring of
    STAGED_CHUNKS chunks of STAGED_KEYS keys' k and v rows (bf16), the key
    list."""
    e = num_heads * head_dim
    return (2 + 2 * STAGED_CHUNKS * STAGED_KEYS) * e * 2 + lk * 4


def _shared_row(num_heads: int, head_dim: int) -> int:
    """Elements a shared row of the staged forward and dK/dV: a group's
    16-byte window (its heads' slice and up to 8 elements around it),
    rounded to 8 mod 16 (bank-conflict-free fragment loads)."""
    w = min(num_heads, HEAD_GROUP) * head_dim + 8
    return w + (24 - w % 16) % 16


def fwd_staged_smem_bytes(lk: int, num_heads: int, head_dim: int) -> int:
    """Shared memory of one staged forward block: its TILE_ROWS query rows'
    slices of HEAD_GROUP heads, a ring of FWD_CHUNKS chunks of CHUNK_ROWS
    keys' k and v slices (bf16, rows `_shared_row` apart), the key list
    (int32) and its row bits (16 bits a key)."""
    eg = _shared_row(num_heads, head_dim)
    return (TILE_ROWS + 2 * FWD_CHUNKS * CHUNK_ROWS) * eg * 2 + lk * 6


def dkv_staged_smem_bytes(lq: int, num_heads: int, head_dim: int) -> int:
    """Shared memory of one staged dK/dV block: its TILE_ROWS key rows' k and
    v slices of HEAD_GROUP heads, a ring of DKV_CHUNKS chunks of CHUNK_ROWS
    queries' q and g slices (bf16, rows `_shared_row` apart), lse, r and
    the dropout row key of each (query, head of the group) (fp32 / uint32),
    the query list (int32) and its row bits (16 bits a query)."""
    eg = _shared_row(num_heads, head_dim)
    return (2 * TILE_ROWS + 2 * DKV_CHUNKS * CHUNK_ROWS) * eg * 2 + lq * HEAD_GROUP * 12 + lq * 6


def _plan(length: int, num_heads: int, parts: int, sums: int, smem: int) -> dict:
    """A staged launch: one block a (video, tile, head group) of `parts`
    warps a head; tile t covers rows [t * TILE_ROWS, min(length, (t + 1) *
    TILE_ROWS)), so `tiles` of them cover every row once, the last one short
    when TILE_ROWS does not divide length. `static_smem` is the kernel's own
    shared memory: each lane's `sums` partial 16 x 8 tiles (a float4 each)
    and a count a warp."""
    threads = 32 * parts * HEAD_GROUP
    static = threads * 16 * sums + threads // 32 * 4
    return {"rows": TILE_ROWS, "tiles": -(-length // TILE_ROWS),
            "head_groups": -(-num_heads // HEAD_GROUP), "threads": threads, "smem": smem,
            "static_smem": static, "fits": smem + static <= BLOCK_SMEM_MAX}


def fwd_plan(lq: int, lk: int, num_heads: int, head_dim: int) -> dict:
    """The staged forward's blocks: {"rows", "tiles", "head_groups",
    "threads", "smem", "static_smem", "fits"}, ring depth FWD_CHUNKS of
    CHUNK_ROWS keys."""
    return _plan(lq, num_heads, FWD_PARTS, 1, fwd_staged_smem_bytes(lk, num_heads, head_dim))


def dkv_plan(lq: int, lk: int, num_heads: int, head_dim: int) -> dict:
    """The staged dK/dV kernel's blocks over key tiles, as `fwd_plan` (S^T
    and dP~^T partial sums), ring depth DKV_CHUNKS of CHUNK_ROWS queries."""
    return _plan(lk, num_heads, DKV_PARTS, 2, dkv_staged_smem_bytes(lq, num_heads, head_dim))


def _tiled(kind, tensors) -> bool:
    _, Lq, _, D = tensors[0].shape
    return tiled_layout(tensors) and tiled_plan(kind, Lq, tensors[1].shape[1], D)["fits"]


def dq_route(q, k, v, g) -> str:
    """The dQ kernel's route for these inputs, "staged", "tiled" or
    "per-element", from dtype, shapes and 16-byte alignment alone."""
    _, _, H, D = q.shape
    if (staged_layout((q, k, v, g))
            and dq_staged_smem_bytes(k.shape[1], H, D) <= STAGED_SMEM_MAX):
        return "staged"
    return "tiled" if _tiled("dq", (q, k, v, g)) else "per-element"


def fwd_route(q, k, v) -> str:
    """The forward kernel's route, "staged" (query tiles, `fwd_plan`),
    "resident" (`resident_plan`), "tiled" (`tiled_plan`) or "per-element",
    tried in that order, from dtype, shapes and 16-byte alignment alone."""
    _, Lq, H, D = q.shape
    if staged_layout((q, k, v)) and fwd_plan(Lq, k.shape[1], H, D)["fits"]:
        return "staged"
    if resident_layout((q, k, v)) and resident_plan(Lq, k.shape[1], D)["fits"]:
        return "resident"
    return "tiled" if _tiled("fwd", (q, k, v)) else "per-element"


def dkv_route(q, k, v, g) -> str:
    """The dK/dV kernel's route, "staged" (key tiles, `dkv_plan`), "tiled"
    (`tiled_plan`) or "per-element", from dtype, shapes and 16-byte
    alignment alone."""
    _, Lq, H, D = q.shape
    if staged_layout((q, k, v, g)) and dkv_plan(Lq, k.shape[1], H, D)["fits"]:
        return "staged"
    return "tiled" if _tiled("dkv", (q, k, v, g)) else "per-element"


def masked_mha_bwd_dq(q, k, v, allow, sm_scale: float, g, lse, dropout_rate: float = 0.0,
                      seeds=None):
    """The dQ kernel: (dq contiguous (B, Lq, H, D) in the input dtype,
    r = rowsum(dP * P) (B, H, Lq) fp32) from the forward's lse and the
    output gradient g. On the CPU the plain version stands in (lse unused)."""
    g = _check_bwd(q, k, v, allow, g, lse, dropout_rate, seeds)
    if q.device.type == "cpu":
        return masked_mha_bwd_dq_reference(q, k, v, allow, sm_scale, g, dropout_rate, seeds)
    seeds, threshold, keep_scale = _drop_args(dropout_rate, seeds, q.device)
    allow, lse = allow.contiguous(), lse.contiguous()
    B, Lq, H, D = q.shape
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    r = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    route = dq_route(q, k, v, g)
    order = _order(route, allow)
    with torch.cuda.device(q.device):
        rc = _fn(_DQ_ENTRY[route])(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            allow.data_ptr(), *map(_ptr, order), lse.data_ptr(), _ptr(seeds), dq.data_ptr(),
            r.data_ptr(),
            *_bwd_dims(q, k, v, g, sm_scale, threshold, keep_scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward dQ")
    LAUNCHES["bwd_dq"] += 1
    return dq, r


def masked_mha_bwd_dkv(q, k, v, allow_t, sm_scale: float, g, lse, r,
                       dropout_rate: float = 0.0, seeds=None):
    """The dK/dV kernel: (dk, dv) contiguous (B, Lk, H, D) in the input
    dtype, from the transposed mask allow_t (B, Lk, Lq), the forward's lse
    and the dQ kernel's r. On the CPU the plain version stands in."""
    allow = allow_t.transpose(1, 2)
    g = _check_bwd(q, k, v, allow, g, lse, dropout_rate, seeds)
    if q.device.type == "cpu":
        return masked_mha_bwd_dkv_reference(q, k, v, allow, sm_scale, g, r, dropout_rate,
                                            seeds)
    B, Lq, H, D = q.shape
    if r is None or r.shape != (B, H, Lq) or r.dtype != torch.float32:
        raise ValueError("the dK/dV kernel needs the dQ kernel's (B, H, Lq) float32 r")
    seeds, threshold, keep_scale = _drop_args(dropout_rate, seeds, q.device)
    allow_t, lse, r = allow_t.contiguous(), lse.contiguous(), r.contiguous()
    dk = torch.empty((B, k.shape[1], H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    route = dkv_route(q, k, v, g)
    order = _order(route, allow_t)
    with torch.cuda.device(q.device):
        rc = _fn(_DKV_ENTRY[route])(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            allow_t.data_ptr(), *map(_ptr, order), lse.data_ptr(), r.data_ptr(), _ptr(seeds),
            dk.data_ptr(), dv.data_ptr(), *_bwd_dims(q, k, v, g, sm_scale, threshold, keep_scale),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward dK/dV")
    LAUNCHES["bwd_dkv"] += 1
    return dk, dv


def masked_mha_backward(q, k, v, allow, sm_scale: float, g, lse, dropout_rate: float = 0.0,
                        seeds=None):
    """(dq, dk, dv): the dQ kernel, then the dK/dV kernel on its r (the
    transposed mask is made once per call)."""
    dq, r = masked_mha_bwd_dq(q, k, v, allow, sm_scale, g, lse, dropout_rate, seeds)
    dk, dv = masked_mha_bwd_dkv(q, k, v, allow.transpose(1, 2).contiguous(), sm_scale, g,
                                lse, r, dropout_rate, seeds)
    return dq, dk, dv


class _MaskedMHAFunction(torch.autograd.Function):
    """The CUDA forward with lse, differentiated by the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, allow, sm_scale, dropout_rate, seeds):
        out, lse = masked_mha_forward(q, k, v, allow, sm_scale, dropout_rate, seeds)
        ctx.save_for_backward(q, k, v, allow, seeds, lse)
        ctx.sm_scale, ctx.dropout_rate = sm_scale, dropout_rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, allow, seeds, lse = ctx.saved_tensors
        dq, dk, dv = masked_mha_backward(q, k, v, allow, ctx.sm_scale, g, lse,
                                         ctx.dropout_rate, seeds)
        return dq, dk, dv, None, None, None, None


def masked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, allow: torch.Tensor,
               sm_scale: float, dropout_rate: float = 0.0,
               seeds: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q.k * sm_scale over allowed keys), dropped out at
    `dropout_rate` with `seeds`, times v -> (B, Lq, H, D)."""
    _check(q, k, v, allow)
    _check_dropout(dropout_rate, seeds, q.shape[0])
    if q.device.type == "cpu":
        return masked_mha_reference(q, k, v, allow, sm_scale, dropout_rate, seeds)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _MaskedMHAFunction.apply(q, k, v, allow, sm_scale, dropout_rate, seeds)
    return _forward_cuda(q, k, v, allow, sm_scale, dropout_rate, seeds, False)[0]


# ----------------------------------------------------------------- binding
def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"masked_mha {what} kernel launch failed: cudaError {rc}")


_ARGTYPES = {  # pointers after dtype; then sizes, strides, scale, threshold, keep scale, stream
    "masked_mha_fwd": 7, "masked_mha_fwd_staged": 7, "masked_mha_fwd_resident": 7,
    "masked_mha_fwd_tiled": 8,
    "masked_mha_bwd_dq": 9, "masked_mha_bwd_dq_staged": 9, "masked_mha_bwd_dq_tiled": 10,
    "masked_mha_bwd_dkv": 10, "masked_mha_bwd_dkv_staged": 10, "masked_mha_bwd_dkv_tiled": 11}


def entry_argtypes(name: str) -> list:
    """The ctypes argument types of the C entry `name` of the library."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strides = 6 if name.startswith("masked_mha_fwd") else 8
    return ([i] + [p] * _ARGTYPES[name] + [i] * 5 + [ll] * strides
            + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, p])


def _fn(name: str):
    fn = getattr(_build.load("masked_attention"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = entry_argtypes(name), ctypes.c_int
    return fn
