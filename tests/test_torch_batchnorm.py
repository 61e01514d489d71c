"""Train-mode MaskedBatchNorm against the JAX package's MaskedBatchNorm
(with its hand backward, _masked_bn_core) run per video under vmap, as the
JAX train step runs it: the output, each video's own statistics, the
validity-weighted running buffers, and the gradients of x, weight and bias.
Three layouts: rows (B, N, C), rows with spatial dims (B, N, 4, C) (the
count includes them), and the mask tower's NCHW (B*R, C, H, W) with a
(B, R) mask, reduced per video, never over the pooled rows.

Tolerance 2e-5 relative and absolute: float32 on both sides, the same
two-pass formulas, sums in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.models import layers as jl
from nl_vsgg_tpu_torch.models import layers as tl

B, N, C = 3, 7, 5
TOL = dict(rtol=2e-5, atol=2e-5)


def case(layout, seed=0):
    rng = np.random.default_rng(seed)
    spatial = {"rows": (), "rows_spatial": (4,), "nchw": (3, 3)}[layout]
    x = (rng.standard_normal((B, N, *spatial, C)) * 2 + 0.5).astype(np.float32)
    x[1] += 3.0  # videos with different statistics: pooling them would show
    mask = rng.random((B, N)) < 0.6
    mask[:, 0] = True
    mask[2] = False  # a fill video
    x[2] = 5.0  # a fill video's junk stays out of every other video
    dy = rng.standard_normal(x.shape).astype(np.float32)
    return x, mask, dy


def jax_side(x, mask, dy, momentum, weight, bias, mean0, var0):
    jm = jl.MaskedBatchNorm(momentum=momentum)
    variables = {"params": {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def per_video(params, x, m):
        out, upd = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            x, m, use_running_average=False, mutable=["batch_stats"])
        return out, upd["batch_stats"]

    def loss(params, x):
        out, stats = jax.vmap(per_video, in_axes=(None, 0, 0))(params, x, jnp.asarray(mask))
        return jnp.sum(out * dy), (out, stats)

    (_, (out, stats)), (dparams, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    w = mask.any(-1).astype(np.float32)

    def wmean(a):
        a = np.asarray(a)
        return np.where(w[:, None] > 0, a * w[:, None], 0.0).sum(0) / max(w.sum(), 1.0)

    return (np.asarray(out), {k: wmean(v) for k, v in stats.items()},
            np.asarray(dx), np.asarray(dparams["scale"]), np.asarray(dparams["bias"]))


@pytest.mark.parametrize("layout", ["rows", "rows_spatial", "nchw"])
@pytest.mark.parametrize("momentum", [0.1, 0.01])
def test_train_mode_matches_jax(layout, momentum):
    x, mask, dy = case(layout)
    m = tl.MaskedBatchNorm(C, channel_dim=1 if layout == "nchw" else -1, momentum=momentum)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        m.bias.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(2))
        m.running_mean.uniform_(-1, 1, generator=torch.Generator().manual_seed(3))
        m.running_var.uniform_(0.5, 2, generator=torch.Generator().manual_seed(4))
    ref_out, ref_stats, ref_dx, ref_dw, ref_db = jax_side(
        x, mask, dy, momentum, *(t.detach().numpy().copy() for t in
                                 (m.weight, m.bias, m.running_mean, m.running_var)))

    if layout == "nchw":  # (B, R, H, W, C) -> (B*R, C, H, W)
        xt = torch.tensor(x.reshape(B * N, 3, 3, C)).permute(0, 3, 1, 2).requires_grad_()
        dyt = torch.from_numpy(dy.reshape(B * N, 3, 3, C)).permute(0, 3, 1, 2)
    else:
        xt = torch.tensor(x, requires_grad=True)
        dyt = torch.from_numpy(dy)
    out = m(xt, torch.from_numpy(mask), train=True)
    (out * dyt).sum().backward()
    out_cl, dx_cl = out.detach(), xt.grad
    if layout == "nchw":
        out_cl = out_cl.permute(0, 2, 3, 1).reshape(x.shape)
        dx_cl = dx_cl.permute(0, 2, 3, 1).reshape(x.shape)
    assert np.isfinite(out_cl.numpy()).all() and np.isfinite(dx_cl.numpy()).all()
    np.testing.assert_allclose(out_cl.numpy(), ref_out, **TOL)
    np.testing.assert_allclose(dx_cl.numpy(), ref_dx, **TOL)
    np.testing.assert_allclose(m.weight.grad.numpy(), ref_dw, **TOL)
    np.testing.assert_allclose(m.bias.grad.numpy(), ref_db, **TOL)

    before = (m.running_mean.clone(), m.running_var.clone())
    m.commit(torch.from_numpy(mask).any(-1))
    assert m.pending is None and int(m.num_batches_tracked) == 1
    np.testing.assert_allclose(m.running_mean.numpy(), ref_stats["mean"], **TOL)
    np.testing.assert_allclose(m.running_var.numpy(), ref_stats["var"], **TOL)
    assert not torch.equal(before[0], m.running_mean)


def test_statistics_are_per_video_not_pooled():
    """Two videos with different means: each is normalized to mean 0 over
    its own valid rows; one pooled normalization would not do that."""
    x = torch.cat([torch.randn(1, 50, 3), torch.randn(1, 50, 3) + 10.0])
    mask = torch.ones(2, 50, dtype=torch.bool)
    out = tl.MaskedBatchNorm(3)(x, mask, train=True)
    torch.testing.assert_close(out.mean(1), torch.zeros(2, 3), rtol=0, atol=1e-5)


def test_discard_leaves_buffers_and_mask_is_required():
    x, mask, _ = case("rows_spatial", seed=5)
    m = tl.MaskedBatchNorm(C)
    state = {k: v.clone() for k, v in m.state_dict().items()}
    m(torch.from_numpy(x), torch.from_numpy(mask), train=True)
    assert m.pending is not None
    m.discard()
    m.commit(torch.ones(B))  # nothing pending: a no-op
    for k, v in m.state_dict().items():
        assert torch.equal(v, state[k]), k
    with pytest.raises(ValueError):
        m(torch.from_numpy(x), None, train=True)
