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
(STTran's is 242); the kernels handle the tail.

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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256
LSE_EMPTY = -1e30  # lse of a query row with no allowed key (the JAX NEG_INF)
_M32 = 0xFFFFFFFF

LAUNCHES = {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}


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
    with torch.cuda.device(q.device):
        rc = _fn("masked_mha_fwd")(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), allow.data_ptr(),
            _ptr(seeds), out.data_ptr(), _ptr(lse), B, Lq, k.shape[1], H, D,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
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
    with torch.cuda.device(q.device):
        rc = _fn("masked_mha_bwd_dq")(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            allow.data_ptr(), lse.data_ptr(), _ptr(seeds), dq.data_ptr(), r.data_ptr(),
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
    with torch.cuda.device(q.device):
        rc = _fn("masked_mha_bwd_dkv")(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            allow_t.data_ptr(), lse.data_ptr(), r.data_ptr(), _ptr(seeds), dk.data_ptr(),
            dv.data_ptr(), *_bwd_dims(q, k, v, g, sm_scale, threshold, keep_scale),
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


_ARGTYPES = {  # after (dtype, pointers...): sizes, strides, scale, threshold, keep scale, stream
    "masked_mha_fwd": 7, "masked_mha_bwd_dq": 9, "masked_mha_bwd_dkv": 10}


def _fn(name: str):
    fn = getattr(_build.load("masked_attention"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        strides = 6 if name == "masked_mha_fwd" else 8
        fn.argtypes = ([i] + [p] * _ARGTYPES[name] + [i] * 5 + [ll] * strides
                       + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn
