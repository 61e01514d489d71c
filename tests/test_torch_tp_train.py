"""`run_training` with a model axis (tools/train_sttran.py under
cfg.mesh {data: 1, model: 2}) in 2 gloo ranks on the CPU
(tests/_torch_dist_worker.py `train` mode), on the micro Action Genome of
tests/test_torch_distributed.py (4 videos x 3 frames, feat 32, 2 epochs):

- the ranks of the one model group step the same global batches: 4 steps,
  no skip; the primary alone writes the metrics and the checkpoints, which
  hold the one-rank layout;
- the 2-rank mean R@20 equals one evaluation of the saved checkpoint in a
  1x1 model over the whole split (the checkpoint restored by
  `restore_checkpoint` into a model that was never sharded);
- 1 epoch and a resume to 2 equal a straight 2-epoch run exactly (the
  weights and AdamW's moments);

and, in one process, how many ranks `run_training` starts for a mesh.
"""

import json
import os
import shutil

import pytest
import torch

from nl_vsgg_tpu_torch.tools import train_sttran as ts
from nl_vsgg_tpu_torch.utils.config import load_config
from tests._torch_dist_worker import run_job
from tests.fixtures import build_micro_ag
from tests.test_torch_distributed import FEAT, _cfg

MESH = {"data": 1, "model": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ag")
    ag = build_micro_ag(str(root / "ag"), n_videos=4, n_frames=3, feat_dim=FEAT)
    straight, resumed = str(root / "straight"), str(root / "resumed")
    # 2 prefetch workers: the model group's ranks must batch the test videos
    # in one order whatever the workers' timing
    res = run_job("train", root, 2, {"runs": [
        ("straight", _cfg(ag, straight, mesh=MESH, num_workers=2)),
        ("first", _cfg(ag, resumed, mesh=MESH, nepoch=1, num_workers=2)),
        ("resume", _cfg(ag, resumed, mesh=MESH, num_workers=2))]}, threads=2)
    yield {"res": res, "ag": ag, "straight": straight, "resumed": resumed}
    shutil.rmtree(root, ignore_errors=True)


def _epochs(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "epoch" in r]


def test_ranks_step_and_the_primary_writes(runs):
    for r in runs["res"]:
        assert r["steps"] == {"straight": (4, 0), "first": (2, 0), "resume": (4, 0)}
    out = runs["straight"]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "0", "0.meta.json", "1", "1.meta.json", "configs.json"]
    assert [r["epoch"] for r in _epochs(out)] == [0, 1]
    log = open(os.path.join(out, "log.txt")).read()
    assert "distributed: process 0/2, backend gloo, device cpu" in log
    assert "model axis: 2 ranks a replica, this rank data index 0, model index 0" in log
    assert "process 1/2" not in log


def test_checkpoint_evaluates_in_a_1x1_model_to_the_same_r20(runs):
    from nl_vsgg_tpu_torch.data import schema
    from nl_vsgg_tpu_torch.data.action_genome import AGTest
    from nl_vsgg_tpu_torch.eval.epoch import evaluate_epoch, grounded_batches
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.utils.checkpoint import load_state, restore_checkpoint

    cfg = load_config(None, _cfg(runs["ag"], runs["straight"], mesh=MESH, num_workers=2))
    model = ts.build_model(cfg, schema.load_taxonomy(), "cpu")
    st = restore_checkpoint(os.path.join(runs["straight"], "ckpt"), create_train_state(model))
    saved = load_state(os.path.join(runs["straight"], "ckpt"))
    # the one-rank layout: every tensor at the unsharded model's shape
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    ds_test = AGTest(os.path.join(runs["ag"], "annotations"))
    batches = grounded_batches(lambda i: ts.ground_video(ds_test, i, cfg, False, cfg.buckets),
                               ds_test.gt_annotations, range(len(ds_test)), cfg.batch_videos, 1)
    ev = evaluate_epoch(st.model, batches, device="cpu", zero_union=True)
    assert ev.mean_score(20) == pytest.approx(_epochs(runs["straight"])[1]["mean_r20"],
                                              rel=1e-12, abs=1e-12)


def test_resume_equals_a_straight_run(runs):
    from nl_vsgg_tpu_torch.utils.checkpoint import load_state

    a, b = (load_state(os.path.join(p, "ckpt")) for p in (runs["straight"], runs["resumed"]))
    assert (a["step"], a["skipped"]) == (b["step"], b["skipped"]) == (4, 0)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, s in a["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], b["optimizer"]["state"][i][k]), (i, k)
    assert [r["epoch"] for r in _epochs(runs["resumed"])] == [0, 1]


@pytest.mark.parametrize("mesh,want", [({"data": 1, "model": 2}, 2), ({"data": 2, "model": 2}, 4),
                                       ({"data": -1, "model": 2}, 2), ({"data": 3, "model": 1}, 3)])
def test_local_ranks_of_a_mesh(mesh, want, monkeypatch):
    from nl_vsgg_tpu_torch.parallel import distributed as D

    for k in (D.ENV_COORD, D.ENV_NPROC, D.ENV_PID):
        monkeypatch.delenv(k, raising=False)
    cfg = load_config(None, {"mesh": mesh})
    assert ts.local_ranks(cfg, torch.device("cpu")) == want
