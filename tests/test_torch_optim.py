"""The port's optimizer chain (global-norm clip at 5 in optax's form, then
AdamW) against the JAX package's optax chain on the same gradients, with
the clip both idle and active and a learning-rate change mid-way; a
parameter without a gradient steps as a zero-gradient one does under JAX.
PlateauScheduler against the JAX one and torch's ReduceLROnPlateau.

Tolerance 1e-6 relative, 1e-7 absolute at lr 1e-2: the same update in
another order, and optax forms the bias correction 1 - 0.999^t in float32
(1.3e-5 relative off at t = 1) where torch forms it in float64, so one
update may differ by about 7e-6 of its size (lr).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.train import state as jstate
from nl_vsgg_tpu_torch.train import state as tstate

SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}


def test_clipped_adamw_matches_optax():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    # grad scales: clip idle (norm < 5), active (norm >> 5), idle, active
    steps = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in SHAPES.items()} for scale in (0.3, 20.0, 0.1, 50.0)]
    for g in steps[2:3]:
        g["c"][:] = 0.0  # no gradient for "c" on this step (torch: .grad None)

    tx = jstate.make_optimizer(lr=1e-2, weight_decay=1e-2, grad_clip_norm=5.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = tstate.make_optimizer(tp.values(), lr=1e-2, weight_decay=1e-2, grad_clip_norm=5.0)
    for i, g in enumerate(steps):
        if i == 2:  # a scheduler's change of lr
            opt_state.hyperparams["learning_rate"] = jnp.asarray(3e-3, jnp.float32)
            tstate.set_learning_rate(tstate.TrainState(None, opt), 3e-3)
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)

        opt.zero_grad()
        for k, p in tp.items():
            if i != 2 or k != "c":
                p.grad = torch.tensor(g[k])
        opt.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {i} {k}")
    assert all(opt.adamw.state[p]["step"] == 4 for p in tp.values())


def test_clip_is_optax_form():
    """g * min(1, 5 / ||g||): norm 5 after clipping (to float32 rounding),
    no epsilon; an idle clip leaves g bit-identical."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = tstate.make_optimizer([p], lr=0.0, weight_decay=0.0)
    p.grad = torch.tensor([30.0, 40.0, 0.0])
    assert float(opt.clip_()) == 50.0
    torch.testing.assert_close(p.grad, torch.tensor([3.0, 4.0, 0.0]), rtol=1e-7, atol=0)
    p.grad = torch.tensor([0.3, 0.4, 0.0])
    opt.clip_()
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4, 0.0]))


@pytest.mark.parametrize("scores", [
    [0.1, 0.2, 0.2, 0.2, 0.3, 0.25, 0.25, 0.25, 0.25, 0.9],
    [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
    [0.3, 0.30005, 0.3001, 0.29, 0.28, 0.27, 0.26],
])
def test_plateau_scheduler_matches_jax_and_torch(scores):
    ours, ref = tstate.PlateauScheduler(1e-3, min_lr=2e-4), jstate.PlateauScheduler(1e-3, min_lr=2e-4)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1e-3)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="max", patience=1, factor=0.5, threshold=1e-4, threshold_mode="abs",
        min_lr=2e-4)
    for s in scores:
        a, b = ours.step(s), ref.step(s)
        sched.step(s)
        assert a == b
        assert a == pytest.approx(opt.param_groups[0]["lr"], rel=1e-12)
    restored = tstate.PlateauScheduler(1.0)
    restored.load_state_dict(ours.state_dict())
    assert restored.state_dict() == ours.state_dict() == ref.state_dict()
