"""masked_mha, train side: gradients and dropout.

(a) The plain version's gradients (autograd) and the backward wrapper's
    CPU path (`masked_mha_backward`, the dense formulas the CUDA kernels are
    held against) against the JAX Pallas kernel's custom VJP in interpret
    mode, deterministic, as tests/test_pallas_attention.py runs it:
    square and rectangular shapes, rows with no allowed key, a batch axis.
    2e-5 on the forward (float32 both sides, sums in another order); 2e-4
    relative / 2e-5 absolute on gradients (that file's own tolerance).
(b) The dropout hash: pinned (seed, head, query, key) -> bits checked
    against a pure-Python copy of the hash; the keep rate within binomial
    bounds; the same mask in the forward and the backward (autograd
    gradients of the plain version with dropout on against the same
    function with the mask materialized once), to 1e-5.

The CUDA kernels run only on a GPU: tests/test_torch_kernels_gpu.py holds
them against the plain versions on a card, and `chip_smoke.py` does so at
the training shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.ops.pallas_attention import NEG_INF, fused_masked_mha
from nl_vsgg_tpu_torch.ops import masked_attention as ma

H, D, DP = 4, 30, 128
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
M32 = 0xFFFFFFFF


def make(rng, b, lq, lk):
    q, k, v = (rng.standard_normal((b, n, H, D)).astype(np.float32) for n in (lq, lk, lk))
    allow = rng.random((b, lq, lk)) < 0.5
    allow[:, 1] = False   # a row with no allowed key in every video
    allow[-1] = False     # a video with no allowed pair at all
    if lk > 2:
        allow[0, :, 2] = False  # a key no query may see
    w = rng.standard_normal((b, lq, H, D)).astype(np.float32)  # loss weights
    return q, k, v, allow, w


def jax_grads(q, k, v, allow, w, scale):
    pad = ((0, 0), (0, 0), (0, 0), (0, DP - D))
    bias = jnp.where(jnp.asarray(allow), 0.0, NEG_INF).astype(jnp.float32)
    seeds = jnp.zeros((q.shape[0], 1), jnp.int32)

    def loss(q, k, v):
        out = jax.vmap(lambda a, b, c, bi, s: fused_masked_mha(
            a, b, c, bi, s, sm_scale=scale, interpret=True))(
                jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), bias, seeds)
        return jnp.sum(out[..., :D] * w), out[..., :D]

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("b,lq,lk", [(3, 12, 12), (2, 8, 20), (3, 16, 6)])
def test_plain_gradients_match_pallas_kernel(b, lq, lk):
    q, k, v, allow, w = make(np.random.default_rng(lq * 31 + lk), b, lq, lk)
    scale = 1.0 / np.sqrt(D)
    ref_out, ref_grads = jax_grads(q, k, v, allow, w, scale)

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    allow_t, w_t = torch.from_numpy(allow), torch.from_numpy(w)
    out = ma.masked_mha(qt, kt, vt, allow_t, scale)
    (out * w_t).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **FWD_TOL)
    for t, ref, name in zip((qt, kt, vt), ref_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), ref, **GRAD_TOL, err_msg=f"autograd d{name}")

    # the backward wrapper's CPU path: the kernels' dense formulas
    with torch.no_grad():
        o2, lse = ma.masked_mha_forward(qt, kt, vt, allow_t, scale)
        grads = ma.masked_mha_backward(qt, kt, vt, allow_t, scale, w_t, lse)
    torch.testing.assert_close(o2, out.detach(), rtol=0, atol=0)
    for got, ref, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), ref, **GRAD_TOL, err_msg=f"wrapper d{name}")
    # rows and keys with no allowed pair get exactly 0
    assert (grads[0][:, 1] == 0).all() and (grads[0][-1] == 0).all()
    assert (grads[1][-1] == 0).all() and (grads[2][-1] == 0).all()
    if lk > 2:
        assert (grads[1][0, 2] == 0).all() and (grads[2][0, 2] == 0).all()


def test_autograd_function_with_plain_stand_ins():
    """The CUDA autograd.Function, run on CPU tensors where its forward and
    backward wrappers take their plain versions: the same output and
    gradients as autograd through the plain version, dropout on."""
    q, k, v, allow, w = make(np.random.default_rng(9), 2, 10, 13)
    seeds = torch.tensor([3, -8], dtype=torch.int32)
    allow_t, w_t = torch.from_numpy(allow), torch.from_numpy(w)
    results = []
    for fn in (ma._MaskedMHAFunction.apply, ma.masked_mha):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = fn(*ts, allow_t, 0.3, 0.2, seeds)
        (out * w_t).sum().backward()
        results.append([out.detach()] + [t.grad for t in ts])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_lse_matches_logsumexp_with_sentinel():
    q, k, v, allow, _ = make(np.random.default_rng(3), 2, 9, 11)
    qt, kt, vt, at = (torch.from_numpy(x) for x in (q, k, v, allow))
    _, lse = ma.masked_mha_forward(qt, kt, vt, at, 0.25)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * 0.25
    logits = np.where(allow[:, None], logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        ref = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    ref = np.where(allow.any(-1)[:, None], ref, ma.LSE_EMPTY)
    assert lse.shape == (2, H, 9) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-6, atol=1e-5)


# ------------------------------------------------------------ dropout hash
def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def py_bits(seed, head, q, k):
    """The hash as plain Python ints (the kernel's fmix32 / row_key /
    drop_bits)."""
    a = _fmix((seed & M32) ^ (((head + 1) * 0x9E3779B9) & M32))
    a = _fmix(a ^ (((q + 1) * 0x85EBCA77) & M32))
    return _fmix(a ^ (((k + 1) * 0xC2B2AE3D) & M32))


PINNED = [  # (seed, head, q, k) -> bits; the CUDA kernel computes these too
    ((0, 0, 0, 0), 1239484813),
    ((1, 3, 5, 7), 1195423495),
    ((-1, 7, 191, 95), 3456548918),
    ((123456789, 2, 100, 150), 1325550869),
    ((-2 ** 31, 5, 0, 199), 180452340),
]


def test_dropout_bits_pinned_and_match_python():
    seeds = torch.tensor([s for (s, *_), _ in PINNED], dtype=torch.int32)
    bits = ma.dropout_bits(seeds, 8, 192, 200)
    for i, ((seed, h, q, k), want) in enumerate(PINNED):
        assert py_bits(seed, h, q, k) == want
        assert int(bits[i, h, q, k]) == want
    rng = np.random.default_rng(0)
    for _ in range(300):
        i, h, q, k = (int(rng.integers(n)) for n in (len(PINNED), 8, 192, 200))
        assert int(bits[i, h, q, k]) == py_bits(int(seeds[i]), h, q, k)
    assert bits.min() >= 0 and bits.max() <= M32


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_within_binomial_bounds(rate):
    seeds = torch.tensor([7, -3, 2 ** 30, 99], dtype=torch.int32)
    keep = ma.dropout_keep(seeds, 8, 64, 96, rate)
    n = keep.numel()
    sd = np.sqrt(n * rate * (1 - rate))
    assert abs(float(keep.sum()) - n * (1 - rate)) < 5 * sd
    # every (video, head) slice keeps near the rate too
    per_slice = keep.float().mean((2, 3))
    slice_sd = np.sqrt(rate * (1 - rate) / (64 * 96))
    assert float((per_slice - (1 - rate)).abs().max()) < 5 * slice_sd
    # different seeds and heads give different masks
    assert (keep[0] != keep[1]).any() and (keep[0, 0] != keep[0, 1]).any()


def test_dropout_same_mask_in_forward_and_backward():
    """Autograd through the plain version with dropout on, the backward
    formulas (which regenerate the mask) and the same function with the
    mask materialized once all give one set of gradients."""
    rate = 0.3
    q, k, v, allow, w = make(np.random.default_rng(11), 3, 10, 14)
    seeds = torch.tensor([5, -17, 2 ** 31 - 1], dtype=torch.int32)
    scale = 0.2
    keep = ma.dropout_keep(seeds, H, 10, 14, rate)
    assert 0 < float(keep.float().mean()) < 1

    def manual(q, k, v):
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        a4 = torch.from_numpy(allow)[:, None]
        p = torch.softmax(logits.masked_fill(~a4, float("-inf")), -1)
        p = torch.where(a4.any(-1, keepdim=True), p, 0.0)
        p = torch.where(keep, p / (1 - rate), 0.0)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    w_t, allow_t = torch.from_numpy(w), torch.from_numpy(allow)
    grads = {}
    for name, fn in (("manual", manual),
                     ("plain", lambda a, b, c: ma.masked_mha(a, b, c, allow_t, scale, rate,
                                                            seeds))):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        out = fn(*ts)
        (out * w_t).sum().backward()
        grads[name] = (out.detach(), [t.grad for t in ts])
    torch.testing.assert_close(grads["plain"][0], grads["manual"][0], rtol=1e-5, atol=1e-5)
    formulas = ma.masked_mha_bwd_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                           allow_t, scale, w_t, rate, seeds)
    for a, b, c in zip(grads["plain"][1], grads["manual"][1], formulas):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(c, b, rtol=1e-5, atol=1e-5)
    # dropout really changed the result
    no_drop = ma.masked_mha(*(torch.from_numpy(x) for x in (q, k, v)), allow_t, scale)
    assert float((no_drop - grads["plain"][0]).abs().max()) > 1e-2


@pytest.mark.parametrize("bad", ["rate", "no_seeds", "seed_shape"])
def test_dropout_arguments_checked(bad):
    q, k, v, allow, _ = (torch.from_numpy(x) for x in make(np.random.default_rng(1), 2, 5, 5))
    rate, seeds = 0.1, torch.zeros(2, dtype=torch.int32)
    if bad == "rate":
        rate = 1.0
    elif bad == "no_seeds":
        seeds = None
    else:
        seeds = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        ma.masked_mha(q, k, v, allow, 0.5, rate, seeds)


def test_zero_rate_ignores_seeds_and_counts_no_launch():
    q, k, v, allow, _ = (torch.from_numpy(x) for x in make(np.random.default_rng(2), 2, 6, 7))
    before = dict(ma.LAUNCHES)
    a = ma.masked_mha(q, k, v, allow, 0.5)
    b = ma.masked_mha(q, k, v, allow, 0.5, 0.0, torch.tensor([1, 2], dtype=torch.int32))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ma.LAUNCHES == before  # the CPU path launches nothing
