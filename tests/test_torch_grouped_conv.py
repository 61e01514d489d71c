"""The port's grouped 3x3 conv (`nl_vsgg_tpu_torch.ops.grouped_conv`, the
plain version the CPU takes) against the JAX Pallas `grouped_conv3x3` in
interpret mode, at every geometry class of tests/test_pallas_grouped_conv.py
(c per group in {8, 16, 32, 64}, the tiling edge cases), with the fused
bias + ReLU epilogue, bf16 inputs and the packed-kernel rejection.

Tolerance 1e-5 on unit-scale inputs with 0.1-scale weights: float32 sums
of at most 9 * 128 products in another order on each side. bf16: both sum
the same bf16 inputs in fp32 and round once, so they may differ by one
bf16 ulp (2^-7 relative)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.ops.pallas_grouped_conv import grouped_conv3x3 as jax_conv
from nl_vsgg_tpu_torch.ops import grouped_conv as tgc
from tests.test_pallas_grouped_conv import CASES

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, N, H, W, C, groups):
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C // groups, C)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("N,H,W,C,groups", CASES)
def test_fp32_matches_pallas(rng, N, H, W, C, groups):
    x, w = _inputs(rng, N, H, W, C, groups)
    ref = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), groups, interpret=True))
    got = tgc.grouped_conv3x3(torch.from_numpy(x), torch.from_numpy(w), groups)
    assert got.shape == (N, H, W, C) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("c", [8, 64])
def test_bias_relu_epilogue_matches_pallas(rng, c):
    x, w = _inputs(rng, 2, 5, 6, 32 * c, 32)
    bias = rng.standard_normal(32 * c).astype(np.float32)
    ref = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), 32, jnp.asarray(bias),
                              relu=True, interpret=True))
    got = tgc.grouped_conv3x3(torch.from_numpy(x), torch.from_numpy(w), 32,
                              torch.from_numpy(bias), relu=True)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert (got >= 0).all()


def test_bf16_matches_pallas(rng):
    x, w = _inputs(rng, 2, 6, 8, 512, 32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = np.asarray(jax_conv(xb, wb, 32, interpret=True), np.float32)
    got = tgc.grouped_conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-3)
    out32 = tgc.grouped_conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                                32, out_dtype=torch.float32)
    assert out32.dtype == torch.float32


def test_rejects_packed_kernel():
    x = torch.zeros(1, 4, 4, 256)
    with pytest.raises(ValueError, match="unpacked kernel"):
        tgc.grouped_conv3x3(x, torch.zeros(3, 3, 64, 256), 32)     # eff-4 packed shape
    with pytest.raises(TypeError):
        tgc.grouped_conv3x3(x, torch.zeros(3, 3, 8, 256, dtype=torch.bfloat16), 32)
