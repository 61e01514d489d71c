"""The model axis as tensor parallel (nl_vsgg_tpu_torch/parallel/tensor.py,
mesh.py, the train step and the clip under it), in 2 and 4 gloo ranks on
the CPU (tests/_torch_dist_worker.py), against dense modules, the port's
one-process step and the JAX package's step on a ('data', 'model') mesh
(the layout against JAX's `param_shardings`: tests/test_torch_tp_layout.py):

- the collectives: copy-in / gather-out over 2 ranks against one dense
  nn.Linear (and the packed q/k/v form, 3 blocks): outputs and the input,
  weight and bias gradients, float32 within 1e-6 of their magnitude,
  bfloat16 (gathered as bytes, its gradient all-reduced in float32) within
  2^-7;
- the steps: STTran sgdet at 1x2 and 2x2, dropout off, on a 4-video
  global batch, against the one-process steps: 2 SGD steps (lr 1e-3;
  losses rtol 1e-5, parameters rtol 1e-5 + atol 1e-5: a sliced GEMM sums
  in another order, which SGD passes on unmagnified) and 2 clipped AdamW
  steps (lr 1e-5; losses rtol 1e-5, parameters 1e-3 + 2 lr a step, as
  tests/test_torch_train.py: Adam's first steps move an element whose
  gradient is rounding noise a full lr either way); at 2x2 the first AdamW
  step also against the JAX step on make_mesh(data=2, model=2) at that
  test's tolerance for one step (losses 4e-4, parameters 1e-3 + 2 lr); the
  clip's global norm at 1x2 against the one-process norm (5e-4: float32
  norms summed in another order); one DSG-DETR sgdet step (SGD) at 1x2;
  one SGD step with dropout on at 1x2 (the ranks draw the one process's
  masks, SGD_TOL); a NaN in the last data block, then a NaN in one rank's gradient slice
  alone, each skipped on every rank, the state bit-identical across the
  skips; a one-rank checkpoint restored into the slices gathers back to
  itself. Every rank's gathered state is bit-identical after every step.
"""

import copy
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.models.convert_ref import convert_sttran
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.parallel.mesh import make_mesh as j_make_mesh
from nl_vsgg_tpu.parallel.mesh import batch_sharding, param_shardings, replicated
from nl_vsgg_tpu.train import create_train_state as j_create
from nl_vsgg_tpu.train import make_optimizer as j_optimizer
from nl_vsgg_tpu.train import make_train_step as j_make_step
from nl_vsgg_tpu.train import stack_entries as j_stack
from nl_vsgg_tpu_torch.data.entry import stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.convert import sttran_from_jax
from nl_vsgg_tpu_torch.models.losses import sttran_losses
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step
from nl_vsgg_tpu_torch.utils.checkpoint import save_checkpoint, state_payload
from tests._torch_dist_worker import build_model, digest, model_recipe, run_job
from tests.test_torch_sttran import to_jax_entry

FEAT, NB, NR = 64, 24, 16
LR, LR_SGD = 1e-5, 1e-3
SGD_TOL = (1e-5, 1e-5)            # (rtol, atol) against the one-process SGD steps
ADAM_TOL = [(1e-3, 2 * LR), (1e-3, 4 * LR)]   # after AdamW step 1 and 2
JAX_TOL = (1e-3, 2 * LR)          # tests/test_torch_train.py, one step
LOSS_RTOL, JAX_LOSS_RTOL = 1e-5, 4e-4
CLIP_RTOL = 5e-4
KEYS = ("object_loss", "attention_relation_loss", "spatial_relation_loss",
        "contact_relation_loss", "total")
NAN_PARAM = "glocal_transformer.local_attention.layers.0.linear1.weight"
# the seeded models, as the ranks rebuild them (tests/_torch_dist_worker.py)
MODEL = model_recipe("STTran", 21, mode="sgdet", feat_dim=FEAT, dec_layer_num=1, dropout=0.0)
# dropout on: every rank of a model group draws the one process's masks
DROPPED = dict(MODEL, dropout=0.1)
DSG = model_recipe("DSGDETR", 22, mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=1,
                   dropout=0.0)


def _videos(n=4, seed=5):
    rng = np.random.default_rng(seed)
    vids = [make_synthetic_entry(rng, n_frames=4, objs_per_frame=2, bucket_boxes=NB,
                                 bucket_rels=NR, feat_dim=FEAT) for _ in range(n)]
    vids[1] = vids[1].replace(rel_mask=vids[1].rel_mask & (vids[1].im_idx == 0))
    return vids


def _one_process(model, batches, opt="adamw"):
    """The port's one-process steps: the state_dict and losses after each."""
    model = copy.deepcopy(model)
    st = (create_train_state(model, optimizer=torch.optim.SGD(model.parameters(), lr=LR_SGD))
          if opt == "sgd" else create_train_state(model, lr=LR))
    step = make_train_step(model, st.optimizer)
    out = []
    for entries in batches:
        st, met = step(st, stack_entries(entries), torch.Generator().manual_seed(0))
        assert float(met["valid"]) == 1.0
        out.append(({k: v.clone() for k, v in model.state_dict().items()},
                    {k: float(met[k]) for k in KEYS}))
    return out


def _jax_mesh_step(model, G):
    """One JAX step over the global batch on a 2 x 2 ('data', 'model') mesh,
    dropout off, as tests/test_train.py:184 builds it."""
    with pytest.MonkeyPatch.context() as mp:
        import flax.linen as nn
        mp.setattr(nn.Dropout, "__call__",
                   lambda self, inputs, deterministic=None, rng=None: inputs)
        params, stats, unused = convert_sttran(copy.deepcopy(model).state_dict())
        assert unused == []
        jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)
        jentries = [to_jax_entry(e) for e in G]
        state, tx = j_create(jm, jentries[0], jax.random.key(0),
                             tx=j_optimizer(LR, weight_decay=1e-2, grad_clip_norm=5.0))
        mesh = j_make_mesh(data=2, model=2, devices=jax.devices()[:4])
        rep = replicated(mesh)
        params = jax.tree.map(jnp.array, params)
        state = state.replace(
            params=jax.tree.map(jax.device_put, params, param_shardings(mesh, params)),
            batch_stats=jax.tree.map(lambda x: jax.device_put(jnp.array(x), rep), stats),
            opt_state=jax.tree.map(lambda x: jax.device_put(x, rep)
                                   if hasattr(x, "shape") else x, state.opt_state),
            step=jax.device_put(state.step, rep), skipped=jax.device_put(state.skipped, rep))
        batch = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), batch_sharding(mesh)),
                             j_stack(jentries))
        with mesh:
            state, met = jax.jit(j_make_step(jm, tx, bce=True))(state, batch, jax.random.key(0))
        assert float(met["valid"]) == 1.0
    sd = sttran_from_jax(jax.device_get(state.params), jax.device_get(state.batch_stats))
    return ({k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")},
            {k: float(met[k]) for k in KEYS})


def _linear_cases():
    g = torch.Generator().manual_seed(3)
    cases = {}
    for blocks in (1, 3):
        for dname in ("float32", "bfloat16"):
            cases[blocks, dname] = (torch.randn(blocks * 8, 6, generator=g),
                                    torch.randn(blocks * 8, generator=g),
                                    torch.randn(2, 3, 6, generator=g),
                                    torch.randn(2, 3, blocks * 8, generator=g))
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    G = _videos()
    G_nan = list(G)
    G_nan[3] = dataclasses.replace(G[3], features=G[3].features.clone())
    G_nan[3].features[0, 0] = float("nan")
    model, dropped, dsg = (build_model(r) for r in (MODEL, DROPPED, DSG))
    digests = [(r, digest(m.state_dict())) for r, m in ((MODEL, model), (DROPPED, dropped),
                                                        (DSG, dsg))]
    refs, losses = {}, {}
    ((refs["s1"], losses["s1"]), (refs["s2"], losses["s2"])) = _one_process(model, [G, G])
    ((refs["sgd1"], losses["sgd1"]), (refs["sgd2"], losses["sgd2"])) = _one_process(
        model, [G, G], "sgd")
    ((refs["dsg"], losses["dsg"]),) = _one_process(dsg, [G], "sgd")
    ((refs["drop"], losses["drop"]),) = _one_process(dropped, [G], "sgd")
    refs["jax"], losses["jax"] = _jax_mesh_step(model, G)
    work = tmp_path_factory.mktemp("tp_refs")
    torch.save(refs, work / "refs.pt")

    # the clip's norm on the dense model, and a one-rank checkpoint after a step
    clip_model = copy.deepcopy(model)
    st = create_train_state(clip_model, lr=LR)
    batch = stack_entries(G)
    gen = torch.Generator().manual_seed(0)
    sttran_losses(clip_model(batch, train=True, generator=gen), batch,
                  gen)["total"].sum().backward()
    clip_norm = float(st.optimizer.clip_())
    ck_model = copy.deepcopy(model)
    st = create_train_state(ck_model, lr=LR)
    st, _ = make_train_step(ck_model, st.optimizer)(st, batch, torch.Generator().manual_seed(0))
    save_checkpoint(str(work / "ckpt"), 0, st)
    saved = state_payload(st)
    ckpt = (digest(saved["model"]), {i: digest({k: v for k, v in s.items() if k != "step"})
                                     for i, s in saved["optimizer"]["state"].items()})

    adamw = {"model": MODEL, "opt": "adamw", "lr": LR}
    cases = {
        "sgd": {"model": MODEL, "opt": "sgd", "lr": LR_SGD, "batches": [G, G],
                "refs": [{"sgd1": SGD_TOL}, {"sgd2": SGD_TOL}]},
        "adamw": dict(adamw, batches=[G, G], refs=[{"s1": ADAM_TOL[0]}, {"s2": ADAM_TOL[1]}]),
        # a NaN in the last data block, then one in a rank's gradient slice alone
        "nan": dict(adamw, batches=[G_nan, G, G], nan_slice=(1,), nan_param=NAN_PARAM,
                    refs=[{}, {}, {"s1": ADAM_TOL[0]}])}
    payloads = {
        (1, 2): {"data": 1, "model": 2, "refs": str(work / "refs.pt"), "linear": _linear_cases(),
                 "cases": dict(cases, dsg={"model": DSG, "opt": "sgd", "lr": LR_SGD,
                                           "batches": [G], "refs": [{"dsg": SGD_TOL}]},
                               drop={"model": DROPPED, "opt": "sgd", "lr": LR_SGD,
                                     "batches": [G], "refs": [{"drop": SGD_TOL}]}),
                 "clip": {"model": MODEL, "batch": G},
                 "ckpt": {"model": MODEL, "dir": str(work / "ckpt")}},
        (2, 2): {"data": 2, "model": 2, "refs": str(work / "refs.pt"),
                 "cases": dict(cases, adamw=dict(cases["adamw"],
                                                 refs=[{"s1": ADAM_TOL[0], "jax": JAX_TOL},
                                                       {"s2": ADAM_TOL[1]}]))}}
    yield {"payloads": payloads, "losses": losses, "model": model, "clip_norm": clip_norm,
           "ckpt": ckpt, "digests": digests}
    shutil.rmtree(work, ignore_errors=True)   # the references and the checkpoint, about 2 GB


def _run(setup, tmp_path_factory, data, model):
    return run_job("tp", tmp_path_factory.mktemp(f"tp{data}x{model}"), data * model,
                   setup["payloads"][data, model], threads=4 // (data * model))


@pytest.fixture(scope="module")
def job12(setup, tmp_path_factory):
    return _run(setup, tmp_path_factory, 1, 2)


@pytest.fixture(scope="module")
def job22(setup, tmp_path_factory):
    return _run(setup, tmp_path_factory, 2, 2)


@pytest.fixture(params=["1x2", "2x2"])
def job(request):
    """((data, model), the ranks' results) of either mesh."""
    data, model = map(int, request.param.split("x"))
    return (data, model), request.getfixturevalue(f"job{data}{model}")


# ------------------------------------------------------------ 2 and 4 ranks
def _same_on_every_rank(res, case):
    for r in res[1:]:
        assert r[case]["digests"] == res[0][case]["digests"], case
        np.testing.assert_equal(r[case]["losses"], res[0][case]["losses"], err_msg=case)


def test_mesh_indices(job):
    (data, model), res = job
    for r, x in enumerate(res):
        assert x["backend"] == "gloo"
        assert x["mesh"] == (r // model, r % model, data, r // model, r % model)


def test_ranks_rebuild_the_seeded_models(job, setup):
    """Each rank builds the recipes it was sent to the weights this process
    built from them, bit for bit."""
    (data, model), res = job
    want = {tuple(sorted(r.items())): d for r, d in setup["digests"]}
    for x in res:
        assert x["models"]
        for recipe, d in x["models"]:
            assert d == want[tuple(sorted(recipe.items()))], recipe


def test_collectives_against_a_dense_linear(job12):
    for (blocks, dname), (w, b, x, gy) in _linear_cases().items():
        dt = getattr(torch, dname)
        wd, bd = w.to(dt).requires_grad_(), b.to(dt).requires_grad_()
        xd = x.to(dt).requires_grad_()
        y = torch.nn.functional.linear(xd, wd, bd)
        (y.float() * gy).sum().backward()
        want = (y.detach().float(), xd.grad.float(), wd.grad.float(), bd.grad.float())
        for r in job12:
            for name, got, ref in zip(("y", "dx", "dw", "db"), r["linear"][blocks, dname], want):
                tol = 1e-6 if dname == "float32" else 2.0 ** -7
                scale = float(ref.abs().max())
                assert float((got - ref).abs().max()) <= tol * scale, (blocks, dname, name)


@pytest.mark.parametrize("case,refs", [("sgd", ("sgd1", "sgd2")), ("adamw", ("s1", "s2"))])
def test_steps_match_one_process(job, setup, case, refs):
    (data, model), res = job
    _same_on_every_rank(res, case)
    r0 = res[0][case]
    for i, worst in enumerate(r0["worst"]):
        for ref, (ratio, name) in worst.items():
            assert ratio <= 1.0, (i, ref, ratio, name)
    for i, ref in enumerate(refs):
        got = r0["losses"][i]
        assert got["valid"] == 1.0
        for k in KEYS:
            np.testing.assert_allclose(got[k], setup["losses"][ref][k], rtol=LOSS_RTOL,
                                       err_msg=k)
    assert (r0["skipped"], r0["step"]) == (0, 2)
    n_full = sum(p.numel() for p in setup["model"].parameters())
    assert r0["local_params"] < n_full * 0.6             # most of STTran is sharded
    assert r0["comm"]["gathers"] > 0 and r0["comm"]["allreduces"] > 0


def test_2x2_step_matches_jax_mesh_step(job22, setup):
    worst = job22[0]["adamw"]["worst"][0]
    assert worst["jax"][0] <= 1.0, worst["jax"]
    for k in KEYS:
        np.testing.assert_allclose(job22[0]["adamw"]["losses"][0][k], setup["losses"]["jax"][k],
                                   rtol=JAX_LOSS_RTOL, atol=1e-6, err_msg=k)


def test_a_nan_is_skipped_on_every_rank(job):
    """A NaN in the last data block's features (every gradient NaN after the
    all-reduce), then a NaN in the last model index's gradient slice of one
    weight alone (finite losses): both steps skipped on every rank, the
    state bit-identical across them, then the first real step."""
    (data, model), res = job
    for r in res:
        assert [x["valid"] for x in r["nan"]["losses"]] == [0.0, 0.0, 1.0]
        assert np.isfinite(r["nan"]["losses"][1]["total"])
        assert (r["nan"]["skipped"], r["nan"]["step"]) == (2, 3)
        assert r["nan"]["adam_steps"] == [1]      # the skipped steps left AdamW's count
        assert r["nan"]["digests"][1] == r["nan"]["digests"][0]
    assert res[0]["nan"]["worst"][2]["s1"][0] <= 1.0
    _same_on_every_rank(res, "nan")


def test_dsg_detr_step_and_clip_norm_at_1x2(job12, setup):
    _same_on_every_rank(job12, "dsg")
    assert job12[0]["dsg"]["worst"][0]["dsg"][0] <= 1.0
    for k in KEYS:
        np.testing.assert_allclose(job12[0]["dsg"]["losses"][0][k], setup["losses"]["dsg"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
    # float32 norms of the slices accumulate in another order: the dense
    # float32 norm of these gradients is itself 1.7e-4 from their float64 norm
    for r in job12:
        np.testing.assert_allclose(r["clip_norm"], setup["clip_norm"], rtol=CLIP_RTOL)


def test_dropout_on_draws_the_one_process_masks(job12, setup):
    """Dropout 0.1: the ranks of the model group draw from one generator
    seed, on the gathered full tensors, so they stay bit-identical and step
    as the one process does (SGD, SGD_TOL)."""
    _same_on_every_rank(job12, "drop")
    assert job12[0]["drop"]["worst"][0]["drop"][0] <= 1.0
    for k in KEYS:
        np.testing.assert_allclose(job12[0]["drop"]["losses"][0][k], setup["losses"]["drop"][k],
                                   rtol=LOSS_RTOL, err_msg=k)


def test_one_rank_checkpoint_restores_into_the_slices(job12, setup):
    model_digest, moments = setup["ckpt"]
    for r in job12:
        assert r["ckpt"] == (model_digest, moments, 1)
