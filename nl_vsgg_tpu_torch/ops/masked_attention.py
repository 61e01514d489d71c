"""Masked multi-head attention: the CUDA kernel's wrapper and its plain version.

Port of the eval-mode forward of nl_vsgg_tpu/ops/pallas_attention.py::
fused_masked_mha (the kernel is `csrc/masked_attention.cu`). The relation
transformers express every grouping (same frame, same window) as a boolean
(Lq, Lk) allow matrix per video; softmax runs over the allowed keys only,
and a query row with no allowed key outputs 0.

Layout: q (B, Lq, H, D), k/v (B, Lk, H, D), allow (B, Lq, Lk) bool. The
head dim is not padded (STTran's is 242); the kernel handles the tail.

`masked_mha` takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it never falls back. The kernel
has no backward yet (the training slice brings it), so CUDA inputs that
require grad raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 256


def masked_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         allow: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Plain torch: fp32 scores, masked softmax, zero rows, fp32 sums; the
    output in the input dtype. Same shapes as `masked_mha`."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    allow4 = allow[:, None]
    logits = logits.masked_fill(~allow4, float("-inf"))
    # a row with no allowed key is all -inf, its softmax NaN: select 0 there
    probs = torch.where(allow4.any(-1, keepdim=True),
                        torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


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
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name} must have packed (H, D) axes (strides "
                             f"({D}, 1)), got {t.stride()}")
    devs = {t.device for t in (q, k, v, allow)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def masked_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               allow: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """softmax(q.k * sm_scale over allowed keys) . v -> (B, Lq, H, D)."""
    _check(q, k, v, allow)
    if q.device.type == "cpu":
        return masked_mha_reference(q, k, v, allow, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked_mha runs on cpu or cuda, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "masked_mha: the CUDA kernel has no backward yet (it comes with "
            "the training slice, ROADMAP Queue 2 row 2)")
    fn = _kernel()
    allow = allow.contiguous()
    B, Lq, H, D = q.shape
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                allow.data_ptr(), out.data_ptr(), B, Lq, k.shape[1], H, D,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(f"masked_mha kernel launch failed: cudaError {rc}")
    masked_mha.launches += 1
    return out


masked_mha.launches = 0  # kernel launches since the last reset


def _kernel():
    lib = _build.load("masked_attention")
    fn = lib.masked_mha_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn
