"""The port's train step against the JAX package's make_train_step.

* A 10-step trajectory from one init (the port's random weights carried
  into the flax tree by convert_ref.convert_sttran), feat 2048, one decoder
  layer, over two alternating 3-video batches of [a normal video, a video
  whose relations all sit in frame 0, an all-padding fill video]. Dropout
  is off on both sides (flax Dropout patched to the identity as in
  tests/test_train_trajectory.py, the port's rate 0); BatchNorm stays in
  train mode, so the running statistics drift as in a real run. The
  synthetic attention GT is one-hot, so the attention-label draw is
  deterministic in both. Tolerances are tests/test_train_trajectory.py's:
  per-step total loss 4e-4 relative (float32 reduction-order drift over
  the steps), final parameters and BatchNorm buffers 1e-3 relative plus
  2 * lr * steps absolute (a sign-noisy Adam direction of a near-zero
  gradient may move an element one full update per step).
* The NaN/empty skip: an all-padding batch and a NaN batch leave the
  parameters, the AdamW state (its step count included) and the BatchNorm
  buffers bit-identical and count 1 skip each.
* No dilution (tests/test_train.py:151-182): the batch [e] and the batch
  [e, fill video] step to the same parameters and buffers, under SGD
  (Adam's m / sqrt(v) would blow float32 reduction-order noise up), to
  1e-5; dropout off, since a (B, ...) mask draw depends on B.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.models.convert_ref import convert_sttran
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.train import create_train_state as j_create
from nl_vsgg_tpu.train import make_optimizer as j_optimizer
from nl_vsgg_tpu.train import make_train_step as j_make_step
from nl_vsgg_tpu.train import stack_entries as j_stack
from nl_vsgg_tpu_torch.data.entry import empty_entry, stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step
from tests.test_torch_sttran import mixed_batch, to_jax_entry

N_STEPS, LR, FEAT = 10, 1e-5, 2048


@pytest.fixture()
def no_flax_dropout(monkeypatch):
    import flax.linen as nn
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return np.asarray(tree)


def test_10_step_trajectory_matches_jax(no_flax_dropout):
    batches = [mixed_batch(seed=3), mixed_batch(seed=4)]
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, dropout=0.0, device="cpu",
                   generator=torch.Generator().manual_seed(21))
    init_params, init_stats, unused = convert_sttran(model.state_dict())
    assert unused == []
    # convert_sttran returns views of the live tensors, which the port's
    # optimizer updates in place: keep a copy of the init
    init_params, init_stats = jax.tree.map(np.copy, (init_params, init_stats))

    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)
    jentries = [[to_jax_entry(e) for e in b] for b in batches]
    state, tx = j_create(jm, jentries[0][0], jax.random.key(0),
                         tx=j_optimizer(LR, weight_decay=1e-2, grad_clip_norm=5.0))
    state = state.replace(params=jax.tree.map(jnp.array, init_params),
                          batch_stats=jax.tree.map(jnp.array, init_stats))
    jstep = jax.jit(j_make_step(jm, tx, bce=True))
    jbatches = [jax.tree.map(jnp.asarray, j_stack(b)) for b in jentries]

    st = create_train_state(model, lr=LR, weight_decay=1e-2, grad_clip_norm=5.0)
    step = make_train_step(model, st.optimizer, bce=True)
    tbatches = [stack_entries(b) for b in batches]
    gen = torch.Generator().manual_seed(0)

    ours, ref = [], []
    for i in range(N_STEPS):
        state, jmet = jstep(state, jbatches[i % 2], jax.random.key(i))
        st, met = step(st, tbatches[i % 2], gen)
        ref.append(float(jmet["total"]))
        ours.append(float(met["total"]))
        assert float(met["valid"]) == 1.0
        for k in ("object_loss", "attention_relation_loss", "spatial_relation_loss",
                  "contact_relation_loss"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=4e-4,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    assert st.step == N_STEPS and st.skipped == 0 and int(state.skipped) == 0
    np.testing.assert_allclose(ours, ref, rtol=4e-4, err_msg="per-step loss trajectories")

    params, stats, _ = convert_sttran(model.state_dict())
    moved = 0
    for tree, ref_tree, name in ((params, state.params, "param"),
                                 (stats, state.batch_stats, "batch_stats")):
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree):
            np.testing.assert_allclose(_leaf(tree, path), np.asarray(leaf), rtol=1e-3,
                                       atol=2 * LR * N_STEPS,
                                       err_msg=f"final {name} {jax.tree_util.keystr(path)}")
        init = init_params if name == "param" else init_stats
        moved += sum(not np.array_equal(_leaf(tree, p), _leaf(init, p))
                     for p, _ in jax.tree_util.tree_leaves_with_path(ref_tree))
    assert moved > 50  # every parameter tensor and buffer has moved


def _small(seed):
    rng = np.random.default_rng(seed)
    return make_synthetic_entry(rng, n_frames=5, objs_per_frame=2, bucket_boxes=24,
                                bucket_rels=16, feat_dim=64)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {id(p): {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
             for p, s in state.optimizer.adamw.state.items()})


def _assert_same(a, b):
    assert a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for pid in a[1]:
        for k in a[1][pid]:
            assert torch.equal(torch.as_tensor(a[1][pid][k]), torch.as_tensor(b[1][pid][k])), k


@pytest.mark.parametrize("bad", ["empty", "nan"])
def test_invalid_step_is_skipped(bad):
    model = STTran(feat_dim=64, dec_layer_num=1, device="cpu")
    st = create_train_state(model, lr=1e-3)
    step = make_train_step(model, st.optimizer)
    gen = torch.Generator().manual_seed(0)
    good = stack_entries([_small(1), _small(2)])
    st, met = step(st, good, gen)  # AdamW state exists and has stepped once
    assert float(met["valid"]) == 1.0
    before = _snapshot(st)
    if bad == "empty":
        batch = stack_entries([empty_entry(24, 16, 64)] * 2)
    else:
        batch = dataclasses.replace(good, features=good.features.clone())
        batch.features[0, 0, 0] = float("nan")
    st, met = step(st, batch, gen)
    assert float(met["valid"]) == 0.0
    assert st.skipped == 1 and st.step == 2
    _assert_same(before, _snapshot(st))
    assert all(int(s["step"]) == 1 for s in st.optimizer.adamw.state.values())
    st, met = step(st, good, gen)  # and training goes on
    assert float(met["valid"]) == 1.0 and st.skipped == 1


def test_padded_videos_do_not_dilute():
    e = _small(7)
    runs = []
    for videos in ([e], [e, empty_entry(24, 16, 64)]):
        model = STTran(feat_dim=64, dec_layer_num=1, dropout=0.0, device="cpu",
                       generator=torch.Generator().manual_seed(3))
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        st = create_train_state(model, optimizer=opt)
        st, met = make_train_step(model, opt)(st, stack_entries(videos),
                                              torch.Generator().manual_seed(9))
        assert float(met["valid"]) == 1.0
        runs.append((float(met["total"]), model.state_dict()))
    (l1, sd1), (l2, sd2) = runs
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    init = STTran(feat_dim=64, dec_layer_num=1, device="cpu",
                  generator=torch.Generator().manual_seed(3)).state_dict()
    for k in sd1:
        torch.testing.assert_close(sd2[k], sd1[k], rtol=1e-5, atol=1e-5, msg=k)
    key = "object_classifier.decoder_lin.1.running_mean"
    assert not torch.equal(sd1[key], init[key])  # the buffers did step


def test_step_refuses_other_devices():
    model = STTran(feat_dim=64, dec_layer_num=1, device="cpu")
    st = create_train_state(model)
    step = make_train_step(model, st.optimizer)

    class FakeGen:
        device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="model is on cpu"):
        step(st, stack_entries([_small(1)]), FakeGen())
    with pytest.raises(ValueError, match="generator"):
        model(stack_entries([_small(1)]), train=True)
