"""Remat of the relation transformer (cfg.remat: models/layers.remat,
STTranTransformer and DSGDETR `remat=True`), against the dense run of the
same weights and against the JAX package's `nn.remat` STTran.

- Dropout on (rate 0.1), one generator seed: the remat forward's outputs
  and losses equal the dense run's exactly (the forward is the same
  computation), every gradient within 1e-6 of its tensor's largest
  magnitude (the recomputation draws the same dropout masks and attention
  seeds from the generator, which `remat` rewinds), and the generator's
  state after the backward equals the dense run's; for STTran 'latter'
  (the last decoder layer unwrapped, as in the JAX model) and 'both' (every
  layer wrapped), and for DSG-DETR; then one train step each way: the same
  parameters and generator state.
- Dropout off, against JAX's `remat=True` STTran with 2 decoder layers in
  eval mode (the setup of tests/test_train.py:212): outputs within 1e-4,
  the loss's gradients within tests/test_train.py's remat tolerance (rtol
  1e-3, atol 1e-4).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.models.losses import sttran_losses as j_losses
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu_torch.data.entry import stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.convert import sttran_from_jax
from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
from nl_vsgg_tpu_torch.models.losses import sttran_losses
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step
from tests.test_torch_sttran import to_jax_entry

FEAT = 32
GRAD_REL = 1e-6


def _batch(seed=7, n=2):
    rng = np.random.default_rng(seed)
    return stack_entries([make_synthetic_entry(rng, n_frames=4, bucket_boxes=24, bucket_rels=16,
                                               feat_dim=FEAT) for _ in range(n)])


def _build(kind, remat):
    if kind == "dsg":
        return DSGDETR(mode="sgdet", feat_dim=FEAT, dec_layer_num=2, dropout=0.1, remat=remat,
                       device="cpu", generator=torch.Generator().manual_seed(3))
    return STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=2, dropout=0.1, remat=remat,
                  transformer_fusion=kind, device="cpu",
                  generator=torch.Generator().manual_seed(3))


def _run(model, batch):
    g = torch.Generator().manual_seed(11)
    out = model(batch, train=True, generator=g)
    losses = sttran_losses(out, batch, g)
    losses["total"].sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return out, {k: v.detach() for k, v in losses.items()}, grads, g.get_state()


@pytest.mark.parametrize("kind", ["latter", "both", "dsg"])
def test_remat_with_dropout_equals_the_dense_run(kind):
    batch = _batch()
    dense, rem = _build(kind, False), _build(kind, True)
    rem.load_state_dict(dense.state_dict())
    od, ld, gd, sd = _run(dense, batch)
    orr, lr, gr, sr = _run(rem, batch)
    for k in ("global_output", "attention_distribution", "spatial_distribution"):
        assert torch.equal(od[k], orr[k]), k
    for k in ld:
        assert torch.equal(ld[k], lr[k]), k
    assert torch.equal(sd, sr)
    assert gd.keys() == gr.keys()
    for n in gd:
        scale = max(float(gd[n].abs().max()), 1e-30)
        assert float((gd[n] - gr[n]).abs().max()) <= GRAD_REL * scale, n
    # the dropout really drew: another seed moves the output
    g = torch.Generator().manual_seed(12)
    assert not torch.equal(rem(batch, train=True, generator=g)["global_output"],
                           od["global_output"])


def test_remat_train_step_equals_the_dense_step():
    batch = _batch(seed=8, n=3)
    models = {r: _build("latter", r) for r in (False, True)}
    models[True].load_state_dict(models[False].state_dict())
    after = {}
    for r, m in models.items():
        st = create_train_state(m, lr=1e-3)
        g = torch.Generator().manual_seed(5)
        st, met = make_train_step(m, st.optimizer)(st, batch, g)
        assert float(met["valid"]) == 1.0
        after[r] = (m.state_dict(), float(met["total"]), g.get_state())
    (sd, ld, gd), (sr, lr, gr) = after[False], after[True]
    assert ld == lr and torch.equal(gd, gr)
    for k in sd:
        scale = max(float(sd[k].float().abs().max()), 1e-30)
        assert float((sd[k].float() - sr[k].float()).abs().max()) <= 1e-6 * scale, k


def test_remat_without_gradients_runs_the_layers_as_they_are():
    batch = _batch()
    dense, rem = _build("latter", False), _build("latter", True)
    rem.load_state_dict(dense.state_dict())
    with torch.inference_mode():
        a, b = dense(batch), rem(batch)
    assert torch.equal(a["global_output"], b["global_output"])


def test_remat_matches_jax_remat_sttran():
    """tests/test_train.py:212's setup, the port against the JAX model."""
    rng = np.random.default_rng(7)
    e = make_synthetic_entry(rng, n_frames=4, bucket_boxes=24, bucket_rels=16, feat_dim=FEAT)
    je = jax.tree.map(jnp.asarray, to_jax_entry(e))
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=2, remat=True)
    variables = jax.jit(functools.partial(jm.init, train=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, je)

    def loss(params):
        pred = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, je,
                        train=False)
        return j_losses(pred, je, jax.random.key(2), bce=True)["total"], pred

    (_, jpred), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=2, remat=True, device="cpu")
    model.load_state_dict(sttran_from_jax(jax.device_get(variables["params"]),
                                          jax.device_get(variables["batch_stats"])))
    batch = stack_entries([e])
    out = model(batch, train=False)       # gradients on: the wrapped layers recompute
    sttran_losses(out, batch, torch.Generator().manual_seed(2))["total"].sum().backward()
    np.testing.assert_allclose(out["global_output"][0].detach().numpy(),
                               np.asarray(jpred["global_output"]), rtol=1e-4, atol=1e-4)
    want = sttran_from_jax(jax.device_get(jgrad), jax.device_get(variables["batch_stats"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    checked = 0
    for n, g in grads.items():
        if g is None:
            assert float(want[n].abs().max()) == 0.0, n
            continue
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-3, atol=1e-4, err_msg=n)
        checked += 1
    assert checked > 40
