"""The port's process group, batcher, per-rank Entry store, sharded and
merged evaluation and multi-process `run_training`
(nl_vsgg_tpu_torch/parallel/distributed.py, data/device_store.py,
tools/train_sttran.py), in 2 and 4 gloo ranks on the CPU
(tests/_torch_dist_worker.py), against the JAX package's
parallel/distributed.py on the 8-device CPU mesh:

- `init_distributed`'s contract (cfg over the NL_VSGG_* environment, a
  rendezvous URL, the backend rule), and the one-process forms;
- `allgather_obj` in rank order; `merge_evaluators` after each rank scored
  range(rank, n, world): every per-video list equal to the JAX evaluator's
  over the whole split in that order (no tolerance);
- `DistributedBatcher`: the ranks' blocks, concatenated, equal to the JAX
  batcher's global batches field by field (agreed buckets, a failed
  grounding as a fill slot, the ragged tail dropped; no tolerance); the
  per-rank store filled from them plans the same warm batches on every
  rank, and each gather returns the rank's rows bit for bit;
- `run_training` with mesh.data 2 (it starts its own 2 ranks) on the micro
  Action Genome of tests/test_distributed.py (4 videos x 3 frames, feat
  32, 2 epochs, device store 1 GB): the primary alone writes the log,
  metrics and checkpoints, the warm epoch is gathered from the ranks'
  stores, and the merged mean R@20 equals one evaluation of the saved
  checkpoint over the whole split; and with a coordinator (ranks started
  here), 1 epoch then a resume to 2 equal to a straight 2-epoch run
  exactly.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax

from nl_vsgg_tpu.eval.recall import SceneGraphEvaluator as JEvaluator
from nl_vsgg_tpu.parallel.distributed import DistributedBatcher as JBatcher
from nl_vsgg_tpu.parallel.mesh import make_mesh as j_make_mesh
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.parallel import distributed as D
from nl_vsgg_tpu_torch.parallel.mesh import Mesh, make_mesh
from tests._torch_dist_worker import DIST_TIMEOUT_S, JOIN_TIMEOUT_S, run_job
from tests.fixtures import build_micro_ag
from tests.test_eval_recall import _random_video
from tests.test_torch_sttran import to_jax_entry

B, FEAT = 4, 32
ORDER = [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]     # two batches and a ragged tail
WARM = [5, 2, 7, 0, 3, 6, 1, 4]
FAIL = {3}


def _entries():
    out = []
    for i in range(8):
        bb = 16 if i % 2 == 0 else 32
        out.append(make_synthetic_entry(np.random.default_rng(100 + i), n_frames=3,
                                        objs_per_frame=2, bucket_boxes=bb, bucket_rels=bb,
                                        feat_dim=FEAT))
    return out


@pytest.fixture(scope="module")
def gather_setup():
    rng = np.random.default_rng(7)
    videos = [_random_video(rng, n_frames=3 + v % 3, n_objs=2 + v % 2) for v in range(10)]
    return {"mode": "sgdet", "videos": videos, "entries": _entries(), "fail": FAIL,
            "order": ORDER, "warm_order": WARM, "B": B, "feat": FEAT}


@pytest.fixture(scope="module", params=[2, 4])
def gather_job(request, gather_setup, tmp_path_factory):
    world = request.param
    return world, run_job("gather", tmp_path_factory.mktemp(f"gather{world}"), world,
                          gather_setup)


# ------------------------------------------------------------ one process
def test_backend_rule_and_rendezvous():
    assert D.choose_backend(["a", "a"], [2, 2], "cuda") == "nccl"      # a card each
    assert D.choose_backend(["a", "a"], [1, 1], "cuda") == "gloo"      # two share one
    assert D.choose_backend(["a", "b"], [1, 1], "cuda") == "nccl"      # two hosts
    assert D.choose_backend(["a", "a", "b"], [2, 2, 1], "cuda") == "nccl"
    assert D.choose_backend(["a", "a"], [0, 0], "cpu") == "gloo"
    assert D.rendezvous_url("10.0.0.1:1234") == "tcp://10.0.0.1:1234"
    assert D.rendezvous_url("file:///x/store") == "file:///x/store"


def test_not_configured_is_one_process(monkeypatch):
    for k in (D.ENV_COORD, D.ENV_NPROC, D.ENV_PID):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed(types.SimpleNamespace(distributed=False)) is False
    assert not D.initialized() and D.rank() == 0 and D.world_size() == 1 and D.is_primary()
    assert D.allgather_obj({"x": 1}) == [{"x": 1}]
    D.barrier()
    ev = JEvaluator("sgdet")
    D.merge_evaluators(ev)
    assert make_mesh() == Mesh(1, 1, 0, torch.device("cuda"))
    assert D.data_size() == 1 and D.data_index() == D.model_index() == 0
    # a model axis needs as many ranks as it is wide (tests/test_torch_tp.py
    # runs it over 2 and 4 ranks) and at least one
    with pytest.raises(ValueError, match="1x2 != 1 ranks"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="at least 1 rank"):
        make_mesh(1, 0)
    with pytest.raises(ValueError, match="2x1 != 1 ranks"):
        make_mesh(2, 1)


def test_env_contract_one_rank(monkeypatch, tmp_path):
    """The environment starts a group; the cfg's fields win over it."""
    monkeypatch.setenv(D.ENV_COORD, f"file://{tmp_path / 'store'}")
    monkeypatch.setenv(D.ENV_NPROC, "1")
    monkeypatch.setenv(D.ENV_PID, "0")
    try:
        assert D.init_distributed(None, device="cpu", timeout_s=DIST_TIMEOUT_S) is False
        assert D.initialized() and D.backend() == "gloo" and D.world_size() == 1
        assert D._GROUP.timeout.total_seconds() == DIST_TIMEOUT_S
        assert D.describe().startswith("distributed: process 0/1, backend gloo, device cpu")
        assert D.allgather_obj(3) == [3]
        assert D.init_distributed(None) is False  # a second call: the same group
    finally:
        D.shutdown()
    assert not D.initialized()
    cfg = types.SimpleNamespace(distributed=True, coordinator_address="", num_processes=2,
                                process_id=5)
    with pytest.raises(ValueError, match="process 5 of 2"):
        D.init_distributed(cfg, device="cpu")


def test_batcher_one_process_matches_jax():
    entries = _entries()
    ours = list(D.DistributedBatcher(lambda i: None if i in FAIL else entries[i], ORDER, B,
                                     feat_dim=FEAT, zero_union=True, device="cpu"))
    mesh = j_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    jentries = [to_jax_entry(e) for e in entries]
    ref = list(JBatcher(lambda i: None if i in FAIL else jentries[i], ORDER, B, mesh,
                        feat_dim=FEAT, zero_union=True))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        for k, v in vars(a).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(b, k)), err_msg=k)
    with pytest.raises(ValueError, match="data axis"):
        D.DistributedBatcher(lambda i: None, [0, 1], 2, Mesh(4, 1, 0, torch.device("cpu")),
                             device="cpu")


# ------------------------------------------------------------ 2 and 4 ranks
def test_allgather_in_rank_order(gather_job):
    world, res = gather_job
    for r in res:
        assert r["backend"] == "gloo"
        assert [g["rank"] for g in r["gathered"]] == list(range(world))
        assert r["gathered"][-1]["payload"] == list(range(world))


def test_merged_evaluators_equal_the_whole_split(gather_job, gather_setup):
    world, res = gather_job
    videos = gather_setup["videos"]
    ref = JEvaluator("sgdet")
    for r in range(world):  # rank order: rank 0's videos, then rank 1's, ...
        for i in range(r, len(videos), world):
            ref.evaluate_scene_graph(*videos[i])
    for r in res:
        for name, sink in r["sinks"].items():
            assert sink == getattr(ref, name), name
        assert r["collect"] == (ref.mean_recall.collect, ref.ng_mean_recall.collect)
        assert r["mean_r20"] == ref.mean_score(20)


def test_batcher_blocks_equal_jax_global_batches(gather_job, gather_setup):
    world, res = gather_job
    mesh = j_make_mesh(data=4, model=1, devices=jax.devices()[:4])
    entries = gather_setup["entries"]
    jentries = [to_jax_entry(e) for e in entries]
    ref = list(JBatcher(lambda i: None if i in FAIL else jentries[i], ORDER, B, mesh,
                        feat_dim=FEAT, zero_union=True, yield_indices=True))
    assert [len(r["blocks"]) for r in res] == [len(ref)] * world == [2] * world
    for t, (idxs, jb) in enumerate(ref):
        assert all(r["blocks"][t][0] == idxs for r in res)
        for k in vars(jb):
            got = np.concatenate([r["blocks"][t][1][k] for r in res])
            np.testing.assert_array_equal(got, np.asarray(getattr(jb, k)), err_msg=k)
    assert "multiple of the process count" in res[0]["bad_batch"]


def test_store_plans_the_same_batches_on_every_rank(gather_job):
    world, res = gather_job
    plan = res[0]["plan"]
    assert all(r["plan"] == plan and r["misses"] == res[0]["misses"] for r in res)
    # every warm video is planned once or streamed
    planned = [i for b in plan for i in b]
    assert sorted(planned + res[0]["misses"]) == sorted(WARM)
    assert len(set(planned)) == len(planned)
    assert all(len(b) == B for b in plan) and len(plan) >= 1
    # each rank holds its own blocks only
    assert sum(r["store_bytes"] for r in res) > 0
    assert len({r["store_bytes"] for r in res}) == 1  # equal shares of equal buckets


def test_comm_collectives_direct_and_through_host(gather_job):
    """parallel/comm.py on bf16 and bool tensors, and its exchange through
    host memory (what gloo ranks on a card take), equal."""
    world, res = gather_job
    for r, x in enumerate(res):
        direct, staged = x["comm"]["direct"], x["comm"]["staged"]
        assert direct["gather"] == [[float(q + 1)] * 3 for q in range(world) for _ in range(2)]
        assert direct["gather_bool"] == [v for q in range(world) for v in (q % 2 == 0, True)]
        assert direct["right"] == ([[0.0] * 3] * 2 if r == 0 else [[float(r)] * 3] * 2)
        assert direct["left"] == ([False, False] if r == world - 1
                                  else [(r + 1) % 2 == 0, True])
        assert direct["staged"] == 0 and staged["staged"] > 0
        assert {k: v for k, v in staged.items() if k != "staged"} == \
            {k: v for k, v in direct.items() if k != "staged"}


# ------------------------------------------------------------ run_training
CFG = {"mode": "sgdet", "lr": 1e-4, "nepoch": 2, "enc_layer": 1, "dec_layer": 1,
       "feat_dim": FEAT, "bce_loss": True, "batch_videos": 2, "num_workers": 1, "seed": 3}


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = tmp_path_factory.mktemp("ag")
    ag = build_micro_ag(str(root), n_videos=4, n_frames=3, feat_dim=FEAT)
    yield ag
    shutil.rmtree(root, ignore_errors=True)


def _cfg(ag, save_path, **kw):
    return dict(CFG, data_path=ag, save_path=save_path,
                pseudo_localized_SG_path=os.path.join(ag, "final_ag_data_w_neg.pkl"),
                frame_features_path=os.path.join(ag, "frame_features"), **kw)


def test_run_training_starts_its_ranks(micro, tmp_path, monkeypatch):
    from nl_vsgg_tpu_torch.data.action_genome import AGTest
    from nl_vsgg_tpu_torch.eval.epoch import evaluate_epoch, grounded_batches
    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.utils.config import load_config

    monkeypatch.setenv("NL_VSGG_DIST_TIMEOUT_S", str(DIST_TIMEOUT_S))
    monkeypatch.setenv("NL_VSGG_JOIN_TIMEOUT_S", str(JOIN_TIMEOUT_S))
    for k in (D.ENV_COORD, D.ENV_NPROC, D.ENV_PID):
        monkeypatch.delenv(k, raising=False)
    out = str(tmp_path / "run")
    cfg = load_config(None, _cfg(micro, out, device_entry_store_gb=1.0,
                                 mesh={"data": 2, "model": 1}))
    try:
        st = ts.run_training(cfg, types.SimpleNamespace(max_videos=0, device="cpu"),
                             ts.build_model)
        assert (st.step, st.skipped) == (4, 0)          # 2 epochs of 2 global batches
        assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
            "0", "0.meta.json", "1", "1.meta.json", "configs.json"]
        with open(os.path.join(out, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "epoch" in r]
        assert [r["epoch"] for r in epochs] == [0, 1]   # written once, by the primary
        log = open(os.path.join(out, "log.txt")).read()
        assert "distributed: process 0/2, backend gloo, device cpu, 2 ranks" in log
        assert "process 1/2" not in log
        assert "device entry store sharded over 2 ranks" in log
        assert "device entry store: 2 gathered batches this epoch" in log
        # the merged R@20 = one evaluation of the saved weights over the split
        ds_test = AGTest(os.path.join(micro, "annotations"))
        batches = grounded_batches(
            lambda i: ts.ground_video(ds_test, i, cfg, False, cfg.buckets), ds_test.gt_annotations,
            range(len(ds_test)), cfg.batch_videos, 1)
        ev = evaluate_epoch(st.model, batches, device="cpu", zero_union=True)
        assert ev.mean_score(20) == pytest.approx(epochs[1]["mean_r20"], rel=1e-12, abs=1e-12)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)


def test_run_training_resume_across_ranks(micro, tmp_path):
    from nl_vsgg_tpu_torch.utils.checkpoint import load_state

    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    runs = [("straight", _cfg(micro, straight)), ("first", _cfg(micro, resumed, nepoch=1)),
            ("resume", _cfg(micro, resumed))]
    try:
        res = run_job("train", tmp_path, 2, {"runs": runs}, threads=2)
        for r in res:
            assert r["steps"] == {"straight": (4, 0), "first": (2, 0), "resume": (4, 0)}
        a, b = (load_state(os.path.join(p, "ckpt")) for p in (straight, resumed))
        assert (a["step"], a["skipped"]) == (b["step"], b["skipped"]) == (4, 0)
        for k in a["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), k
        for i, s in a["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s[k], b["optimizer"]["state"][i][k]), (i, k)
        with open(os.path.join(resumed, "metrics.jsonl")) as f:
            assert [r["epoch"] for r in map(json.loads, f) if "epoch" in r] == [0, 1]
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
