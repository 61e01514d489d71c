"""masked_mha: the plain version against the JAX Pallas kernel (interpret
mode, as tests/test_pallas_attention.py runs it on the CPU) and against
that file's `ref_mha`; the wrapper's dispatch and checks; the entry points'
device rule. Square and rectangular shapes, zero-key rows, a batch axis,
to 2e-5 (float32 on both sides, sums in another order).

The CUDA kernel itself runs only on a GPU: tests/test_torch_kernels_gpu.py
holds it against the plain version on a card, and `chip_smoke.py` does so at
the serving shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.ops.pallas_attention import NEG_INF, fused_masked_mha
from nl_vsgg_tpu_torch import resolve_device
from nl_vsgg_tpu_torch.ops import masked_attention as ma
from tests.test_pallas_attention import ref_mha

H, D, DP = 4, 30, 128
TOL = dict(rtol=2e-5, atol=2e-5)


def make(rng, b, lq, lk, zero_rows=True):
    q = rng.standard_normal((b, lq, H, D)).astype(np.float32)
    k = rng.standard_normal((b, lk, H, D)).astype(np.float32)
    v = rng.standard_normal((b, lk, H, D)).astype(np.float32)
    allow = rng.random((b, lq, lk)) < 0.5
    if zero_rows:
        allow[:, 1] = False          # a row with no allowed key in every video
        allow[-1] = False            # a video with no allowed pair at all
    return q, k, v, allow


def plain(q, k, v, allow, scale):
    return ma.masked_mha_reference(*(torch.from_numpy(x) for x in (q, k, v, allow)),
                                   scale).numpy()


def pallas(q, k, v, allow, scale):
    d = q.shape[-1]
    pad = ((0, 0), (0, 0), (0, 0), (0, DP - d))
    bias = jnp.where(jnp.asarray(allow), 0.0, NEG_INF).astype(jnp.float32)
    seeds = jnp.zeros((q.shape[0], 1), jnp.int32)
    out = jax.vmap(lambda a, b, c, bi, s: fused_masked_mha(
        a, b, c, bi, s, sm_scale=scale, interpret=True))(
            jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), bias, seeds)
    return np.asarray(out[..., :d])


@pytest.mark.parametrize("b,lq,lk", [(3, 16, 16), (2, 8, 24), (3, 24, 8)])
@pytest.mark.parametrize("zero_rows", [False, True])
def test_plain_matches_pallas_kernel(b, lq, lk, zero_rows):
    q, k, v, allow = make(np.random.default_rng(lq * lk + b), b, lq, lk, zero_rows)
    scale = 1.0 / np.sqrt(D)
    ours = plain(q, k, v, allow, scale)
    np.testing.assert_allclose(ours, pallas(q, k, v, allow, scale), **TOL)
    ref = np.stack([np.asarray(ref_mha(*(jnp.asarray(x[i]) for x in (q, k, v, allow)), scale))
                    for i in range(b)])
    np.testing.assert_allclose(ours, ref, **TOL)
    if zero_rows:
        assert (ours[:, 1] == 0).all() and (ours[-1] == 0).all()
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("heads,length,causal", [(12, 50, False), (8, 77, True)])
def test_plain_matches_pallas_at_clip_head_layouts(heads, length, causal):
    """CLIP's towers' attention, the resident route's shapes on a card: 12
    heads of 64 over 50 tokens with every pair allowed (the image tower),
    8 heads of 64 over 77 causal (the text tower); 2 videos, float32, the
    heads padded to 128 for the JAX kernel as its MaskedMHA pads them.
    Float32 on both sides, sums in another order: 1e-5."""
    rng = np.random.default_rng(heads * length)
    b, d = 2, 64
    q, k, v = (rng.standard_normal((b, length, heads, d)).astype(np.float32) for _ in range(3))
    allow = np.ones((b, length, length), bool)
    if causal:
        allow &= np.tril(np.ones((length, length), bool))
    scale = 1.0 / np.sqrt(d)
    ours = plain(q, k, v, allow, scale)
    np.testing.assert_allclose(ours, pallas(q, k, v, allow, scale), rtol=1e-5, atol=1e-5)
    assert np.isfinite(ours).all()


def test_bf16_plain_accumulates_in_fp32():
    q, k, v, allow = make(np.random.default_rng(5), 2, 12, 12)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = ma.masked_mha_reference(*(x.bfloat16() for x in t), torch.from_numpy(allow), 0.2)
    ref = ma.masked_mha_reference(*(x.bfloat16().float() for x in t), torch.from_numpy(allow), 0.2)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref.bfloat16(), rtol=0, atol=0)


def test_cpu_dispatch_is_the_plain_version():
    q, k, v, allow = (torch.from_numpy(x) for x in make(np.random.default_rng(6), 2, 10, 14))
    before = dict(ma.LAUNCHES)
    out = ma.masked_mha(q, k, v, allow, 0.3)
    torch.testing.assert_close(out, ma.masked_mha_reference(q, k, v, allow, 0.3), rtol=0, atol=0)
    assert ma.LAUNCHES == before  # the counters count kernel launches only


def test_strided_projection_views_accepted():
    """q/k/v as column blocks of one fused projection output, as MaskedMHA
    passes them: packed (H, D) axes, token stride 3 * H * D."""
    qkv = torch.randn(2, 9, 3 * H * D)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, -1))
    allow = torch.rand(2, 9, 9) < 0.5
    out = ma.masked_mha(q, k, v, allow, 0.1)
    torch.testing.assert_close(out, ma.masked_mha_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), allow, 0.1))


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_shape", "kv_shape", "dtype",
                                 "head_stride", "head_dim"])
def test_wrapper_rejects_bad_inputs(bad):
    q, k, v = torch.randn(2, 5, H, D), torch.randn(2, 6, H, D), torch.randn(2, 6, H, D)
    allow = torch.ones(2, 5, 6, dtype=torch.bool)
    if bad == "mask_dtype":
        allow = allow.float()
    elif bad == "mask_shape":
        allow = allow[:, :4]
    elif bad == "kv_shape":
        v = v[:, :5]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_stride":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "head_dim":
        q, k, v = (torch.randn(2, n, 1, 321) for n in (5, 6, 6))  # D > 320
    with pytest.raises((ValueError, TypeError)):
        ma.masked_mha(q, k, v, allow, 1.0)


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means the GPU: with none present the entry points raise
    instead of running on the CPU; device='cpu' runs."""
    from nl_vsgg_tpu_torch import serve
    from nl_vsgg_tpu_torch.models.sttran import STTran

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        STTran(feat_dim=16, dec_layer_num=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.predict(torch.nn.Identity(), [], batch=1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert STTran(feat_dim=16, dec_layer_num=1, device="cpu").a_rel_compress.weight.device.type == "cpu"
