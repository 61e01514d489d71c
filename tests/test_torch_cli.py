"""The port's entry points against the JAX tools on a micro Action Genome
(4 videos x 4 frames, feat 64) with a narrow model (1 + 1 layers):

- `run_training`, 2 epochs of 2 steps, against the JAX tool's
  `run_training` (its mesh {data: 1, model: 1}, the single-device path;
  dropout off on both sides; the port starts from the JAX tool's initial
  weights through `models/convert.sttran_from_jax`), at lr 1e-3 so that
  4 Adam steps move the weights far past float32 drift: each step's four
  losses and total, recorded from both tools' `make_train_step`, within
  4e-4 relative (tests/test_torch_train.py's tolerance), which holds the
  loop to the same batches in the same order and the same updates; the lr
  after each epoch, `step` and `skipped` equal; each epoch's mean R@20
  within 0.5 points (tools/acceptance.py's GATE_PTS); each tensor's
  training change (final - initial) within 1e-2 of the JAX tool's change
  in L2 norm, relative to that change's norm (Adam gives an element whose
  gradient is rounding noise a full step of either sign, so an elementwise
  bound would not hold), and the port's own weights moved. The one
  exception is the bias of a Linear that feeds a train-mode BatchNorm
  directly: its gradient is zero but for rounding, so both tools move it
  by noise, each by less than one Adam step (lr);
- resume, port only: 1 epoch then a resumed run to 2 equals a straight
  2-epoch run exactly on the CPU (parameters, AdamW's moments and step
  counts, `step`, the scheduler's state), dropout on, the device Entry
  store filled and gathered;
- `evaluate_sgcls` against the JAX tool's with the same stand-in GT-box
  builder (numpy features): STTran, and DSG-DETR with the tracker's group
  ids; every R@K row within 1e-6, each stage's object logits and relation
  heads within 1e-4 (float32 through a few layers);
- `predict` against the JAX tools/predict.py on the same features and
  weights: the same videos and objects, triplet ranking scores within 1e-5;
- `convert_relation_ckpt` on a reference-style {'state_dict': ...} of a
  port model, then `test_sttran` on its output;
- the refusals, and a missing cv2 failing when a frame reader is built.
"""

import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from nl_vsgg_tpu.data.gt_entry import build_gt_entry as j_build_gt_entry
from nl_vsgg_tpu.data.entry import pick_bucket as j_pick_bucket
from nl_vsgg_tpu.models.dsg_detr import DSGDETR as JDSGDETR
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.utils.checkpoint import save_checkpoint as j_save_checkpoint
from nl_vsgg_tpu.utils.config import load_config as j_load_config
from nl_vsgg_tpu_torch.data import schema
from nl_vsgg_tpu_torch.data.entry import pick_bucket
from nl_vsgg_tpu_torch.data.gt_entry import build_gt_entry
from nl_vsgg_tpu_torch.models.convert import dsg_detr_from_jax, sttran_from_jax
from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.tools import convert_relation_ckpt as conv
from nl_vsgg_tpu_torch.tools import predict, test_dsg_detr, test_sttran, train_dsg_detr
from nl_vsgg_tpu_torch.tools import train_sttran as ts
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.utils.checkpoint import load_meta, load_state, save_checkpoint
from nl_vsgg_tpu_torch.utils.config import load_config
from tests.fixtures import build_micro_ag, load_tool
from tests.test_torch_gt_entry import classify_fn, feature_fn, union_fn

FEAT, VIDEOS = 64, 4
GATE_PTS = 0.5          # tools/acceptance.py:65, in R@20 points
LR, STEPS = 1e-3, 4      # the config's lr; 2 steps an epoch
LOSS_RTOL = 4e-4        # tests/test_torch_train.py: float32 reduction-order drift
DELTA_TOL = 1e-2        # of the L2 norm of each tensor's training change
BN_FED = ("object_classifier.decoder_lin.0.bias",)  # Linear -> train-mode BatchNorm
LOSSES = ("object_loss", "attention_relation_loss", "spatial_relation_loss",
          "contact_relation_loss", "total")


class _Args:
    max_videos = 0
    model_path = None
    device = "cpu"


def _overrides(ag, save_path, **kw):
    return dict({
        "mode": "sgdet", "data_path": ag, "feat_dim": FEAT, "enc_layer": 1, "dec_layer": 1,
        "lr": LR, "nepoch": 2, "batch_videos": 2, "num_workers": 1, "seed": 7,
        "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
        "frame_features_path": os.path.join(ag, "frame_features"), "save_path": save_path,
        "buckets": {"max_boxes": [16, 32], "max_rels": [8, 16]}}, **kw)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint of these models is a few hundred MB: none is kept."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    return build_micro_ag(str(tmp_path_factory.mktemp("ag")), n_videos=VIDEOS, n_frames=4,
                          feat_dim=FEAT)


@pytest.fixture(scope="module")
def jtools():
    return {n: load_tool(n) for n in ("train_STTran", "test_STTran", "train_DSG_DETR",
                                      "test_DSG_DETR", "predict")}


def _no_flax_dropout(mp):
    import flax.linen as nn
    mp.setattr(nn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)


def _epoch_records(save_path):
    with open(os.path.join(save_path, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "epoch" in r]


@pytest.fixture(scope="module")
def jax_run(micro, jtools, tmp_path_factory):
    """The JAX tool's run_training, its initial weights captured."""
    jtool = jtools["train_STTran"]
    out = str(tmp_path_factory.mktemp("jrun"))
    jcfg = j_load_config(None, _overrides(micro, out, mesh={"data": 1, "model": 1}))
    init, losses = {}, []
    real = jtool.create_train_state
    real_step = jtool.make_train_step

    def recording_step(model, tx, bce=True):
        step = real_step(model, tx, bce=bce)

        def wrapped(state, batch, rng):
            state, m = step(state, batch, rng)
            jax.debug.callback(lambda m: losses.append({k: float(v) for k, v in m.items()}),
                               {k: m[k] for k in LOSSES}, ordered=True)
            return state, m
        return wrapped

    def capture(model, sample, rng, tx=None):
        state, tx = real(model, sample, rng, tx=tx)
        init.update(params=jax.device_get(state.params), stats=jax.device_get(state.batch_stats))
        return state, tx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtool, "create_train_state", capture)
        mp.setattr(jtool, "make_train_step", recording_step)
        _no_flax_dropout(mp)
        state = jtool.run_training(jcfg, _Args(), jtool.build_model)
    records = _epoch_records(out)
    shutil.rmtree(out, ignore_errors=True)
    return dict(init, state=state, records=records, losses=losses)


def _jax_weights(params, stats):
    def build(cfg, tax, device):
        m = STTran(mode="sgdet", obj_classes=tuple(tax.object_classes), enc_layer_num=1,
                   dec_layer_num=1, feat_dim=FEAT, dropout=0.0, device=device)
        m.load_state_dict(sttran_from_jax(params, stats), strict=True)
        return m
    return build


def test_run_training_matches_jax(micro, jax_run, tmp_path, monkeypatch):
    out = str(tmp_path / "run")
    cfg = load_config(None, _overrides(micro, out))
    losses = []
    real_step = ts.make_train_step

    def recording_step(model, optimizer, bce=True):
        step = real_step(model, optimizer, bce=bce)

        def wrapped(state, batch, generator):
            state, m = step(state, batch, generator)
            losses.append({k: float(m[k]) for k in LOSSES})
            return state, m
        return wrapped

    monkeypatch.setattr(ts, "make_train_step", recording_step)
    st = ts.run_training(cfg, _Args(), _jax_weights(jax_run["params"], jax_run["stats"]))
    ref_losses = jax_run["losses"]
    assert len(losses) == len(ref_losses) == STEPS
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        for k in LOSSES:
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    ours, ref = _epoch_records(out), jax_run["records"]
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in ref] == [0, 1]
    for a, b in zip(ours, ref):
        assert a["lr"] == b["lr"] and a["step"] == b["step"]
        assert abs(a["mean_r20"] - b["mean_r20"]) * 100 <= GATE_PTS, (a, b)
    jst = jax_run["state"]
    assert st.step == int(jst.step) == STEPS and st.skipped == int(jst.skipped) == 0
    want = sttran_from_jax(jax.device_get(jst.params), jax.device_get(jst.batch_stats))
    start = sttran_from_jax(jax_run["params"], jax_run["stats"])
    got = st.model.state_dict()
    moved = 0
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        d_want, d_got = v - start[k], got[k] - start[k]
        if k in BN_FED:
            assert float(d_want.abs().max()) < LR and float(d_got.abs().max()) < LR, k
            continue
        scale = float(d_want.norm())
        assert float((d_got - d_want).norm()) <= DELTA_TOL * scale, k
        moved += scale > 0 and not torch.equal(got[k], start[k])
    assert moved > 50  # the port's weights trained


def _read_log(records):
    class _Cap(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    return _Cap()


def test_resume_equals_straight_run(micro, tmp_path):
    ov = _overrides(micro, "", device_entry_store_gb=1.0, device_eval_promote=True,
                    device_eval_burnin=2)
    straight = ts.run_training(load_config(None, dict(ov, save_path=str(tmp_path / "b"))),
                               _Args(), ts.build_model)
    a_path = str(tmp_path / "a")
    ts.run_training(load_config(None, dict(ov, save_path=a_path, nepoch=1)), _Args(),
                    ts.build_model)
    records = []
    cap = _read_log(records)
    logging.getLogger("nl_vsgg_tpu_torch").addHandler(cap)
    try:
        resumed = ts.run_training(load_config(None, dict(ov, save_path=a_path)), _Args(),
                                  ts.build_model)
    finally:
        logging.getLogger("nl_vsgg_tpu_torch").removeHandler(cap)
    assert any("resumed from checkpoint epoch 0 (step 2)" in m for m in records), records
    assert not any("------------Inference in Epoch (0)" in m for m in records)
    assert (resumed.step, resumed.skipped) == (straight.step, straight.skipped) == (4, 0)
    a, b = resumed.model.state_dict(), straight.model.state_dict()
    for k in b:
        assert torch.equal(a[k], b[k]), k
    oa, ob = resumed.optimizer.adamw.state_dict(), straight.optimizer.adamw.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, s in ob["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa["state"][i][k], s[k]), (i, k)
    meta = load_meta(os.path.join(a_path, "ckpt"))
    assert meta is not None and meta == load_meta(str(tmp_path / "b" / "ckpt"))
    assert [r["step"] for r in _epoch_records(a_path)] == [2, 4]


@pytest.mark.parametrize("overrides,match", [
    ({"mode": "sgcls"}, "not a shipped NL-VSGG recipe"),
    ({"mode": "predcls"}, "not a shipped NL-VSGG recipe"),
    ({"is_wks": False}, "not a shipped NL-VSGG recipe"),
    ({"mesh": {"data": 1, "model": 2}}, "Queue 1 item 1a"),
    ({"remat": True}, "Queue 1 item 3"),
])
def test_run_training_refuses(overrides, match, tmp_path):
    cfg = load_config(None, dict({"save_path": str(tmp_path / "out")}, **overrides))
    with pytest.raises(ValueError, match=match):
        ts.run_training(cfg, _Args(), ts.build_model)
    assert not os.path.exists(tmp_path / "out")  # refused before any work


def test_missing_cv2_fails_when_the_reader_is_built(micro, tmp_path, monkeypatch):
    ckpt = tmp_path / "vinvl.pth"
    ckpt.write_bytes(b"")
    cfg = load_config(None, _overrides(micro, str(tmp_path), union_box_feature=True,
                                       vinvl_ckpt=str(ckpt), ckpt=str(ckpt), mode="predcls"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        ts.make_union_provider(cfg, logging.getLogger("test"), device="cpu")
    with pytest.raises(ImportError, match="cv2"):
        test_sttran.make_gt_entry_builder(cfg, device="cpu")
    # an injected reader needs no cv2
    assert ts.make_union_provider(cfg, logging.getLogger("test"), read_frames=lambda d, i: None,
                                  device="cpu") is not None


# ---------------------------------------------------------------- sgcls flow

HEADS = ("attention_distribution", "spatial_distribution", "contacting_distribution")
MODEL_TOL = 1e-4        # float32 models through 2-4 layers, both packages

def _gt_classifier(gt):
    """OpenImages logits that favour, for each GT box in build_gt_entry's
    order, a class the OI -> AG map sends to its AG class alone."""
    oi_to_ag, _ = schema.load_oi_ag_maps()
    oi_of = {v[0]: k for k, v in sorted(oi_to_ag.items()) if len(v) == 1}
    labels = [1 if "person_bbox" in m else int(m["class"]) for f in gt for m in f]

    def classify(feats):
        logits = classify_fn(feats) * 0.1
        logits[np.arange(len(labels)), [oi_of[a] for a in labels]] += 8.0
        return logits
    return classify


def _stub_builder(build, pick, mode):
    def builder(ds, idx, buckets, return_union_fn=False):
        gt = ds.gt_annotations[idx]
        n = sum(len(f) for f in gt)
        e = build(gt, mode, pick(buckets.max_boxes, n), pick(buckets.max_rels, n), feature_fn,
                  classify_fn=_gt_classifier(gt), feat_dim=FEAT, rng=np.random.default_rng(idx))
        return (e, union_fn) if return_union_fn else e
    return builder


@pytest.mark.parametrize("family", ["sttran", "dsg_detr"])
def test_evaluate_sgcls_matches_jax(micro, jtools, family, monkeypatch, tmp_path):
    jtest = jtools["test_STTran"]
    ov = _overrides(micro, str(tmp_path), mode="sgcls")
    cfg, jcfg = load_config(None, ov), j_load_config(None, ov)
    init = {}
    real = jtest.create_train_state

    def capture(model, sample, rng, tx=None):
        state, tx = real(model, sample, rng, tx=tx)
        init.update(params=jax.device_get(state.params), stats=jax.device_get(state.batch_stats))
        return state, tx

    monkeypatch.setattr(jtest, "create_train_state", capture)
    monkeypatch.setattr(jtest, "make_gt_entry_builder",
                        lambda c: _stub_builder(j_build_gt_entry, j_pick_bucket, "sgcls"))
    monkeypatch.setattr(test_sttran, "make_gt_entry_builder",
                        lambda c, read_frames=None, device=None:
                        _stub_builder(build_gt_entry, pick_bucket, "sgcls"))
    # both flows' stage-1 logits (into sgcls_assign) and stage-2 outputs
    # (into entry_to_eval_pred), recorded
    import nl_vsgg_tpu.data.grounding as jgrounding
    import nl_vsgg_tpu.models.sgcls_infer as jsgcls
    seen = {"jax": [], "port": []}

    def record(side, kind, fn):
        def wrapped(*a):
            seen[side].append((kind, [np.asarray(x, np.float64) for x in a[:1]] if kind == 1
                               else {k: np.asarray(a[1][k], np.float64) for k in HEADS}))
            return fn(*a)
        return wrapped

    monkeypatch.setattr(jsgcls, "sgcls_assign", record("jax", 1, jsgcls.sgcls_assign))
    monkeypatch.setattr(jgrounding, "entry_to_eval_pred",
                        record("jax", 2, jgrounding.entry_to_eval_pred))
    monkeypatch.setattr(test_sttran, "sgcls_assign", record("port", 1, test_sttran.sgcls_assign))
    monkeypatch.setattr(test_sttran, "entry_to_eval_pred",
                        record("port", 2, test_sttran.entry_to_eval_pred))
    log = logging.getLogger("test_evaluate_sgcls")
    if family == "sttran":
        jev = jtest.evaluate_sgcls(jcfg, _Args(), log, build_model_fn=lambda c, t: JSTTran(
            mode="sgcls", feat_dim=FEAT, dec_layer_num=1))

        def build(c, tax, device):
            m = STTran(mode="sgcls", feat_dim=FEAT, dec_layer_num=1, device=device)
            m.load_state_dict(sttran_from_jax(init["params"], init["stats"]), strict=True)
            return m
        ev = test_sttran.evaluate_sgcls(cfg, _Args(), log, build_model_fn=build)
    else:
        jdsg = jtools["test_DSG_DETR"]
        jev = jtest.evaluate_sgcls(jcfg, _Args(), log, build_model_fn=lambda c, t: JDSGDETR(
            mode="sgcls", feat_dim=FEAT, dec_layer_num=1), group_id_fn=jdsg.sgcls_group_ids)

        def build(c, tax, device):
            m = DSGDETR(mode="sgcls", feat_dim=FEAT, dec_layer_num=1, device=device)
            m.load_state_dict(dsg_detr_from_jax(init["params"], init["stats"]), strict=True)
            return m
        ev = test_sttran.evaluate_sgcls(cfg, _Args(), log, build_model_fn=build,
                                        group_id_fn=test_dsg_detr.sgcls_group_ids)
    for name in ("recall", "recall_nogc", "semi_recall"):
        for k in (10, 20, 50):
            a, b = getattr(ev, name)[k], getattr(jev, name)[k]
            assert len(a) == len(b) == VIDEOS * 4, (name, k)
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f"{name}@{k}")
    assert len(seen["port"]) == len(seen["jax"]) == 2 * VIDEOS
    for (kind, a), (jkind, b) in zip(seen["port"], seen["jax"]):
        assert kind == jkind
        if kind == 1:   # stage 1: the object logits of the valid boxes
            np.testing.assert_allclose(a[0], b[0], atol=MODEL_TOL, rtol=MODEL_TOL)
        else:           # stage 2: the relation heads
            for h in HEADS:
                n = len(b[h])
                np.testing.assert_allclose(a[h][:n], b[h], atol=MODEL_TOL, rtol=MODEL_TOL,
                                           err_msg=h)


# ------------------------------------------------------------------ predict

def test_predict_matches_jax(micro, jtools, tmp_path, monkeypatch):
    ov = _overrides(micro, str(tmp_path))
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.dump({k: v for k, v in ov.items()}, f)
    jtool = jtools["train_STTran"]
    jcfg = j_load_config(cfg_path)
    sample = jtool.ground_video(jtool.AGTrain(micro, remove_one_frame_video=False), 0, jcfg,
                                True, jcfg.buckets)
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)
    state, _ = jtool.create_train_state(jm, sample, jax.random.key(5))
    j_save_checkpoint(str(tmp_path / "jckpt"), 0, state)
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, device="cpu")
    model.load_state_dict(sttran_from_jax(jax.device_get(state.params),
                                          jax.device_get(state.batch_stats)), strict=True)
    save_checkpoint(str(tmp_path / "ckpt"), 0, create_train_state(model))
    ff = os.path.join(micro, "frame_features")
    os.makedirs(os.path.join(ff, "empty.mp4"))  # a directory without frames: skipped
    try:
        args = ["--cfg", cfg_path, "--features_dir", ff, "--batch", "3", "--topk", "1000"]
        monkeypatch.setattr(sys, "argv", ["predict.py", *args, "--model_path",
                                          str(tmp_path / "jckpt"), "--out",
                                          str(tmp_path / "j.jsonl")])
        jtools["predict"].main()
        n = predict.main([*args, "--model_path", str(tmp_path / "ckpt"), "--out",
                          str(tmp_path / "t.jsonl"), "--device", "cpu"])
    finally:
        os.rmdir(os.path.join(ff, "empty.mp4"))
    ours = {g["video"]: g for g in map(json.loads, open(tmp_path / "t.jsonl"))}
    ref = {g["video"]: g for g in map(json.loads, open(tmp_path / "j.jsonl"))}
    assert n == VIDEOS and sorted(ours) == sorted(ref) == [f"vid{i:03d}.mp4"
                                                           for i in range(VIDEOS)]
    for vid, g in ours.items():
        r = ref[vid]
        assert g["num_frames"] == r["num_frames"] and g["objects"] == r["objects"]
        key = lambda t: (t["frame"], t["subject"], t["object"], t["predicate"])  # noqa: E731
        a = {key(t): t["ranking_score"] for t in g["triplets"]}
        b = {key(t): t["ranking_score"] for t in r["triplets"]}
        assert sorted(a) == sorted(b) and len(a) == 8 * 24
        np.testing.assert_allclose([a[k] for k in sorted(a)], [b[k] for k in sorted(a)],
                                   atol=1e-5, rtol=0, err_msg=vid)


# ---------------------------------------------------------------- converter

@pytest.mark.parametrize("family", ["sttran", "dsg_detr"])
def test_convert_relation_ckpt(micro, family, tmp_path):
    cfg = load_config(None, _overrides(micro, str(tmp_path)))
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    if family == "sttran":
        model = STTran(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=2,
                       device="cpu", generator=torch.Generator().manual_seed(3))
    else:
        model = DSGDETR(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=2,
                        device="cpu", generator=torch.Generator().manual_seed(3))
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    sd["teacher.extra.weight"] = torch.zeros(2)  # a key of no module of the model
    torch.save({"state_dict": sd}, tmp_path / "ref.tar")
    path = conv.main(["--ckpt", str(tmp_path / "ref.tar"), "--out", str(tmp_path / "conv"),
                      "--cfg", cfg_path, "--device", "cpu"])
    assert path == str(tmp_path / "conv" / "0")
    assert conv.detect({k.removeprefix("module."): v for k, v in sd.items()}) == \
        (family, 1, 2, FEAT)
    got = load_state(str(tmp_path / "conv"))
    assert got["step"] == 0 and got["optimizer"]["state"] == {}
    for k, v in model.state_dict().items():
        assert torch.equal(got["model"][k], v), k
    snap = json.load(open(tmp_path / "conv" / "configs.json"))
    assert (snap["enc_layer"], snap["dec_layer"], snap["feat_dim"]) == (1, 2, FEAT)
    if family == "sttran":  # the converted checkpoint serves the test CLI
        ev = test_sttran.main(["--model_path", str(tmp_path / "conv"), "--device", "cpu",
                               "--max_videos", "2"])
        assert 0 < ev.mean_score(20) <= 1
    # one key removed: the conversion raises, naming it
    gone = "module.subj_fc.bias"
    torch.save({"state_dict": {k: v for k, v in sd.items() if k != gone}},
               tmp_path / "bad.tar")
    with pytest.raises(ValueError, match=r"missing=\['subj_fc.bias'\]"):
        conv.main(["--ckpt", str(tmp_path / "bad.tar"), "--out", str(tmp_path / "bad"),
                   "--cfg", cfg_path, "--device", "cpu"])


def test_train_dsg_detr_cli(micro, tmp_path):
    ov = _overrides(micro, str(tmp_path / "out"), nepoch=1)
    cfg_path = str(tmp_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.dump(ov, f)
    st = train_dsg_detr.main(["--cfg", cfg_path, "--device", "cpu"])
    assert isinstance(st.model, DSGDETR) and st.step == 2 and st.skipped == 0
    assert os.path.isfile(tmp_path / "out" / "ckpt" / "0" / "state.pt")
    ev = test_dsg_detr.main(["--model_path", str(tmp_path / "out" / "ckpt"), "--device", "cpu",
                             "--device_eval"])
    assert 0 < ev.mean_score(20) <= 1


def test_entry_points_need_a_card_unless_asked(micro, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.main(["--nepoch", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--model_path", str(tmp_path), "--features_dir", str(tmp_path)])
