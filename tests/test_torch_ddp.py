"""The data-parallel train step (nl_vsgg_tpu_torch/train/step.py under
parallel/mesh.data_parallel) in 2 and 4 gloo ranks on the CPU
(tests/_torch_dist_worker.py), against the JAX package's single-process
`train_step` over the global batch and the port's one-process step.

The global batch is 4 videos at feat 64 (a normal video, one whose
relations all sit in frame 0, two more normal ones); each rank steps its
contiguous block. The model is STTran with one decoder layer and dropout
off, the synthetic attention GT one-hot: a rank's dropout masks and label
draws have its block's shape, so only then is the step a function of the
global batch alone (tests/test_torch_train.py:20-22). Cases and tolerances,
as max |a - b| / (atol + rtol |b|) over every parameter and BatchNorm
buffer:
- SGD (lr 1e-3) against the one-process SGD step: 1e-5 (summing two or
  four blocks' gradients in another order is float32 noise, and SGD passes
  it on unmagnified); then a second step on a global batch whose last
  rank's block holds only fill videos, the same;
- one AdamW step (lr 1e-5) against the one-process step and against the
  JAX step: rtol 1e-3 plus 2 lr absolute (Adam's first step is about lr
  times the gradient's sign, so an element whose gradient is rounding noise
  may move a full step either way); the losses against JAX within 4e-4
  (tests/test_torch_train.py); then a NaN in the last rank's block: every
  rank skips the step, leaving the parameters, buffers and AdamW state
  bit-identical, and steps the next.
Every rank's parameters and buffers are bit-identical after every step.
"""

import copy
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
from nl_vsgg_tpu_torch.models.convert import sttran_from_jax
from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.train.state import create_train_state, make_optimizer
from nl_vsgg_tpu_torch.train.step import make_train_step
from tests._torch_dist_worker import build_model, digest, model_recipe, run_job, worst_ratio
from tests.test_torch_sttran import to_jax_entry

FEAT, NB, NR = 64, 24, 16
LR_SGD, LR_ADAM = 1e-3, 1e-5
SGD_TOL = (1e-5, 1e-5)                  # (rtol, atol)
ADAM_TOL = (1e-3, 2 * LR_ADAM)
LOSS_RTOL = 4e-4
KEYS = ("object_loss", "attention_relation_loss", "spatial_relation_loss",
        "contact_relation_loss", "total")
# the seeded model, as the ranks rebuild it (tests/_torch_dist_worker.py)
MODEL = model_recipe("STTran", 21, mode="sgdet", feat_dim=FEAT, dec_layer_num=1, dropout=0.0)


def _videos():
    rng = np.random.default_rng(5)
    vids = [make_synthetic_entry(rng, n_frames=4, objs_per_frame=2, bucket_boxes=NB,
                                 bucket_rels=NR, feat_dim=FEAT) for _ in range(4)]
    vids[1] = vids[1].replace(rel_mask=vids[1].rel_mask & (vids[1].im_idx == 0))
    return vids


def _one_process(model, batches, opt_kind, lr):
    """The one-process step on each global batch in turn: the state_dict
    and the losses after each."""
    model = copy.deepcopy(model)
    opt = (torch.optim.SGD(model.parameters(), lr=lr) if opt_kind == "sgd"
           else make_optimizer(model.parameters(), lr, 1e-2, 5.0))
    st = create_train_state(model, optimizer=opt)
    step = make_train_step(model, opt)
    out = []
    for entries in batches:
        st, met = step(st, stack_entries(entries), torch.Generator().manual_seed(0))
        assert float(met["valid"]) == 1.0
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    {k: float(met[k]) for k in KEYS}))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    G = _videos()
    fill = empty_entry(NB, NR, FEAT)
    G_fill = [G[0], G[2], fill, fill]   # the last rank's block: fill videos only
    G_nan = list(G)
    G_nan[3] = dataclasses.replace(G[3], features=G[3].features.clone())
    G_nan[3].features[0, 0] = float("nan")
    model = build_model(MODEL)
    refs, losses = {}, {}
    (refs["sgd"], losses["sgd"]), (refs["fill"], losses["fill"]) = _one_process(
        model, [G, G_fill], "sgd", LR_SGD)
    ((refs["adamw"], losses["adamw"]),) = _one_process(model, [G], "adamw", LR_ADAM)

    # the JAX step over the global batch, from the same weights
    with pytest.MonkeyPatch.context() as mp:
        import flax.linen as nn
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, inputs, deterministic=None, rng=None: inputs)
        init_params, init_stats, unused = convert_sttran(copy.deepcopy(model).state_dict())
        assert unused == []
        jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)
        jentries = [to_jax_entry(e) for e in G]
        state, tx = j_create(jm, jentries[0], jax.random.key(0),
                             tx=j_optimizer(LR_ADAM, weight_decay=1e-2, grad_clip_norm=5.0))
        state = state.replace(params=jax.tree.map(jnp.array, init_params),
                              batch_stats=jax.tree.map(jnp.array, init_stats))
        state, jmet = jax.jit(j_make_step(jm, tx, bce=True))(
            state, jax.tree.map(jnp.asarray, j_stack(jentries)), jax.random.key(0))
        assert float(jmet["valid"]) == 1.0
    refs["jax"] = {k: v for k, v in sttran_from_jax(jax.device_get(state.params),
                                                    jax.device_get(state.batch_stats)).items()
                   if not k.endswith("num_batches_tracked")}
    losses["jax"] = {k: float(jmet[k]) for k in KEYS}
    ref_path = tmp_path_factory.mktemp("ddp_refs") / "refs.pt"
    torch.save(refs, ref_path)
    # each case: one model under DDP stepping its batches; refs checked after
    # each step, by name and (rtol, atol)
    cases = {
        "sgd": {"opt": "sgd", "lr": LR_SGD, "batches": [G, G_fill],
                "refs": [{"sgd": SGD_TOL}, {"fill": SGD_TOL}]},
        "adamw": {"opt": "adamw", "lr": LR_ADAM, "batches": [G, G_nan, G],
                  "refs": [{"adamw": ADAM_TOL, "jax": ADAM_TOL}, {}, {}]}}
    yield {"payload": {"model": MODEL, "refs": str(ref_path), "cases": cases},
           "losses": losses, "refs": refs, "model": model}
    ref_path.unlink()


@pytest.fixture(scope="module", params=[2, 4])
def job(request, setup, tmp_path_factory):
    world = request.param
    return world, run_job("ddp", tmp_path_factory.mktemp(f"ddp{world}"), world,
                          setup["payload"], threads=2)


def _same_on_every_rank(res, case):
    for r in res[1:]:
        assert r[case]["hashes"] == res[0][case]["hashes"], case
        np.testing.assert_equal(r[case]["losses"], res[0][case]["losses"], err_msg=case)


def test_ranks_rebuild_the_seeded_model(job, setup):
    """Each rank builds the recipe it was sent to the weights this process
    built from it, bit for bit."""
    world, res = job
    want = digest(setup["model"].state_dict())
    for r in res:
        assert r["models"] == [(MODEL, want)]


@pytest.mark.parametrize("case,i", [("sgd", 0), ("fill", 1)])
def test_sgd_step_matches_one_process(job, setup, case, i):
    world, res = job
    r0 = res[0]["sgd"]
    _same_on_every_rank(res, "sgd")
    for ref, (worst, name) in r0["worst"][i].items():
        assert worst <= 1.0, (ref, worst, name)
    got = r0["losses"][i]
    assert got["valid"] == 1.0 and r0["skipped"] == 0
    for k in KEYS:
        np.testing.assert_allclose(got[k], setup["losses"][case][k], rtol=1e-5, err_msg=k)
    # the gradients all-reduced once a step: every parameter, float32
    n_params = sum(p.numel() for p in setup["model"].parameters())
    assert r0["allreduce_bytes"] == 4 * n_params


def test_adamw_step_matches_jax_and_one_process(job, setup):
    world, res = job
    _same_on_every_rank(res, "adamw")
    for ref, (worst, name) in res[0]["adamw"]["worst"][0].items():
        assert worst <= 1.0, (ref, worst, name)
    got = res[0]["adamw"]["losses"][0]
    for k in KEYS:
        np.testing.assert_allclose(got[k], setup["losses"]["jax"][k], rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], setup["losses"]["adamw"][k], rtol=1e-5, err_msg=k)


def test_batchnorm_buffers_equal_on_every_rank(job, setup):
    world, res = job
    stats = [k for k in setup["refs"]["sgd"] if "running_" in k]
    assert len(stats) >= 8
    init = setup["model"].state_dict()
    for case in ("sgd", "adamw"):
        for r in res[1:]:
            for h, h0 in zip(r[case]["hashes"], res[0][case]["hashes"]):
                assert all(h[k] == h0[k] for k in stats)
    # they moved; against the one-process run they are in each step's
    # worst ratio above (every buffer of the state_dict is compared)
    assert any(not torch.equal(setup["refs"]["sgd"][k], init[k]) for k in stats)


def test_nan_on_one_rank_skips_on_every_rank(job):
    world, res = job
    r0 = res[0]["adamw"]
    for r in res:
        assert r["adamw"]["valid"] == [1.0, 0.0, 1.0]
        assert (r["adamw"]["skipped"], r["adamw"]["step"]) == (1, 3)
        assert r["adamw"]["adam_steps"] == [2]   # the skipped step left AdamW's count
    assert r0["hashes"][1] == r0["hashes"][0]  # bit-identical across the skip
    assert r0["hashes"][2] != r0["hashes"][1]


def test_worst_ratio_flags_a_difference(setup):
    sd = setup["refs"]["sgd"]
    key = next(iter(sd))
    bad = dict(sd, **{key: sd[key] + 1e-3})
    assert worst_ratio(sd, sd, *SGD_TOL) == (0.0, "")
    worst, name = worst_ratio(bad, sd, *SGD_TOL)
    assert worst > 1.0 and name == key


@pytest.mark.parametrize("model_cls", [STTran, DSGDETR])
def test_unused_parameters_under_the_width0_union(model_cls):
    """The parameters DDP must be told about: under the width-0 union (no
    union-feature provider) the union projection's weight gets no gradient
    (its bias is broadcast), in both models; nothing else."""
    e = make_synthetic_entry(np.random.default_rng(2), n_frames=3, objs_per_frame=2,
                             bucket_boxes=NB, bucket_rels=NR, feat_dim=FEAT)
    e = e.replace(union_feat=e.union_feat[..., :0])
    kw = {"enc_layer_num": 1, "dec_layer_num": 1}
    model = model_cls(mode="sgdet", feat_dim=FEAT, dropout=0.0, device="cpu", **kw)
    from nl_vsgg_tpu_torch.models.losses import sttran_losses

    batch = stack_entries([e])
    g = torch.Generator().manual_seed(0)
    sttran_losses(model(batch, train=True, generator=g), batch, g)["total"].sum().backward()
    assert [n for n, p in model.named_parameters() if p.grad is None] == ["union_func1.weight"]
