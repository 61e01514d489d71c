"""The port's transformer blocks and eval-mode MaskedBatchNorm against the
JAX package's, on weights transplanted from the port through
nl_vsgg_tpu/models/convert_ref.py. Batched inputs (JAX's layers broadcast
over leading axes), rows with no allowed key included.

Tolerances: 2e-5 where both sides run the same float32 math in another
order; 5e-5 through LayerNorm, whose eps is torch's 1e-5 in the port and
flax's 1e-6 in the JAX package (about 5e-6 relative on unit-variance rows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.models import convert_ref
from nl_vsgg_tpu.models import layers as jl
from nl_vsgg_tpu_torch.models import layers as tl
from nl_vsgg_tpu_torch.models.sttran import init_weights

E, H, FF, B, L, LK = 48, 4, 64, 3, 10, 7


def port(module, seed=0):
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.eval()


def sd_view(module, prefix="m"):
    return convert_ref._SD({f"{prefix}.{k}": v for k, v in module.state_dict().items()})


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def allow_mask(rng, q, k):
    a = rng.random((B, q, k)) < 0.5
    a[:, 2] = False  # a row with no allowed key
    return a


def both(x):
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("path", ["qkv_shared", "qk_shared", "separate", "dup2"])
def test_masked_mha_paths(path):
    rng = np.random.default_rng(1)
    m = port(tl.MaskedMHA(E, H))
    params = {"params": convert_ref._mha(sd_view(m), "m")}
    jm = jl.MaskedMHA(E, H)
    x_t, x_j = both(arr(rng, B, L, E))
    if path == "dup2":
        pos_t, pos_j = both(arr(rng, 2, E))
        al_t, al_j = both(allow_mask(rng, 2 * L, 2 * L))
        ours = m(x_t, x_t, x_t, al_t, dup2_pos=pos_t)
        ref = jm.apply(params, x_j, x_j, x_j, al_j, True, pos_j)
    elif path == "qkv_shared":
        al_t, al_j = both(allow_mask(rng, L, L))
        ours, ref = m(x_t, x_t, x_t, al_t), jm.apply(params, x_j, x_j, x_j, al_j)
    elif path == "qk_shared":
        v_t, v_j = both(arr(rng, B, L, E))
        al_t, al_j = both(allow_mask(rng, L, L))
        ours, ref = m(x_t, x_t, v_t, al_t), jm.apply(params, x_j, x_j, v_j, al_j)
    else:  # rectangular: L queries over LK keys
        k_t, k_j = both(arr(rng, B, LK, E))
        v_t, v_j = both(arr(rng, B, LK, E))
        al_t, al_j = both(allow_mask(rng, L, LK))
        ours, ref = m(x_t, k_t, v_t, al_t), jm.apply(params, x_j, k_j, v_j, al_j)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_encoder_layer():
    rng = np.random.default_rng(2)
    m = port(tl.MaskedEncoderLayer(E, H, FF))
    params = {"params": convert_ref._encoder_layer(sd_view(m), "m")}
    x_t, x_j = both(arr(rng, B, L, E))
    al_t, al_j = both(allow_mask(rng, L, L))
    ref = jl.MaskedEncoderLayer(E, H, FF, dropout=0.0).apply(params, x_j, al_j, True)
    np.testing.assert_allclose(m(x_t, al_t).detach().numpy(), np.asarray(ref),
                               rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("form", ["square", "dup2", "rectangular"])
def test_decoder_layer(form):
    rng = np.random.default_rng(3)
    m = port(tl.MaskedDecoderLayer(E, H, FF))
    sd = sd_view(m)
    params = {"params": {"multihead2": convert_ref._mha(sd, "m.multihead2"),
                         "linear1": convert_ref._lin(sd, "m.linear1"),
                         "linear2": convert_ref._lin(sd, "m.linear2"),
                         "norm3": convert_ref._ln(sd, "m.norm3")}}
    jm = jl.MaskedDecoderLayer(E, H, FF, dropout=0.0)
    x_t, x_j = both(arr(rng, B, L, E))
    if form == "square":
        pos_t, pos_j = both(arr(rng, L, E))
        al_t, al_j = both(allow_mask(rng, L, L))
        ours, ref = m(x_t, pos_t, al_t), jm.apply(params, x_j, pos_j, al_j, True)
    elif form == "dup2":
        pe_t, pe_j = both(arr(rng, 2, E))
        al_t, al_j = both(allow_mask(rng, 2 * L, 2 * L))
        ours = m(x_t, pe_t, al_t, dup2=True)
        ref = jm.apply(params, x_j, pe_j, al_j, True, None, None, True)
    else:
        pos_t, pos_j = both(arr(rng, B, L, E))
        kv_t, kv_j = both(arr(rng, B, LK, E))
        pkv_t, pkv_j = both(arr(rng, LK, E))
        al_t, al_j = both(allow_mask(rng, L, LK))
        ours = m(x_t, pos_t, al_t, kv=kv_t, pos_kv=pkv_t)
        ref = jm.apply(params, x_j, pos_j, al_j, True, kv=kv_j, pos_kv=pkv_j)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("layout", ["rows", "nchw"])
def test_masked_batchnorm_eval(layout):
    rng = np.random.default_rng(4)
    C = 6
    m = port(tl.MaskedBatchNorm(C, channel_dim=1 if layout == "nchw" else -1))
    p, s = convert_ref._bn(sd_view(m), "m")
    x = arr(rng, B, 5, 4, C) * 3 + 1          # channel-last, as JAX takes it
    mask = rng.random((B, 5)) < 0.7
    ref = jl.MaskedBatchNorm().apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                                     jnp.asarray(mask), use_running_average=True)
    if layout == "nchw":
        ours = m(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(mask))
        ours = ours.permute(0, 2, 3, 1)
    else:
        ours = m(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_bf16_compute_dtype_keeps_fp32_params():
    m = port(tl.MaskedEncoderLayer(E, H, FF, dtype=torch.bfloat16))
    x = torch.randn(B, L, E)
    allow = torch.rand(B, L, L) < 0.5
    out = m(x, allow)
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    ref = port(tl.MaskedEncoderLayer(E, H, FF))(x, allow)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=0.1)


@pytest.mark.parametrize("layer", ["encoder", "decoder"])
def test_dropout_draws_from_the_generator(layer):
    """A generator switches dropout on: the same seed gives the same
    output, another seed another; no generator (eval) or rate 0 gives the
    eval output; torch's global generator is never drawn from."""
    cls = tl.MaskedEncoderLayer if layer == "encoder" else tl.MaskedDecoderLayer
    m = port(cls(E, H, FF))
    x = torch.randn(B, L, E)
    allow = torch.rand(B, L, L) < 0.5
    args = (x, allow) if layer == "encoder" else (x, torch.randn(L, E), allow)

    def run(seed=None, rate=0.1):
        for mod in m.modules():  # the layer's and its attention's rate
            if isinstance(getattr(mod, "dropout", None), float):
                mod.dropout = rate
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return m(*args, generator=g)

    torch.manual_seed(0)
    global_state = torch.get_rng_state()
    eval_out = run()
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(torch.get_rng_state(), global_state)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, eval_out)
    torch.testing.assert_close(run(1, rate=0.0), eval_out, rtol=0, atol=0)


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200, 500)
    out = tl.dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.9) < 5 * np.sqrt(0.09 / x.numel())
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert tl.dropout(x, 0.1, None) is x
