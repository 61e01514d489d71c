"""The port's acceptance runbook (nl_vsgg_tpu_torch/tools/acceptance.py) on
the CPU, on stand-in artifacts: a synthetic VinVL state dict with the real
key names and shapes (tests/fixtures.make_vinvl_state_dict) saved as a
.pth, a reference-layout STTran .tar saved from the port's module (feat 32,
1 + 1 layers) and the micro Action Genome (tests/fixtures.build_micro_ag):

- the oracle stage's `run_oracle` against the JAX tool's on 3 videos x 3
  frames: R@10/20/50 and mR@K within 1e-9;
- validate -> convert -> oracle -> train_e2e 2 -> convert_relation -> eval,
  every stage PASS; the eval's R@K rows equal `tools.test_sttran.main` run
  directly on the converted checkpoint with the same overrides; then the
  parity gate: an expected.json of the eval's own numbers gives rc 0, one
  moved by 1 point gives rc 1 and "FAILED stages: parity_gate";
- `--ref_baseline` without the reference checkout records "not mounted",
  with a checkpoint directory instead of a .tar "torch .tar", both rc 1;
  on a stub reference checkout it runs the reference in a child process,
  whose stubs and patched `torch.device` do not reach the eval after it;
- an eval that returns None records a FAIL stage, rc 1
  (tests/test_acceptance.py:178-214).

np.savez_compressed is np.savez here, as in tests/test_torch_preprocess.py:
compressing 146 M random weights takes about 30 s and is not under test.
A converted checkpoint of the 1936-wide model is about 1.2 GB: the module's
runbook directory and each test's are deleted after use.
"""

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from nl_vsgg_tpu.utils.config import load_config as j_load_config
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.tools import acceptance, test_sttran
from nl_vsgg_tpu_torch.utils.config import load_config
from tests.fixtures import build_micro_ag, load_tool, make_vinvl_state_dict

FEAT = 32
KS = (10, 20, 50)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module, restored after it: beside the
    suite's other workers more oversubscribe the cores (on 8 cores beside
    five busy test workers, 8 threads made this file and its neighbour 2.7x
    slower and the other workers 1.2x)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(root, ag, **kw):
    cfg = dict({"mode": "sgdet", "feat_dim": FEAT, "data_path": ag,
                "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
                "frame_features_path": os.path.join(ag, "frame_features"),
                "save_path": str(root / "out"), "enc_layer": 1, "dec_layer": 1,
                "batch_videos": 2, "num_workers": 2, "union_box_feature": False,
                "entry_cache": str(root / "ecache"),
                "buckets": {"max_frames": [3], "max_boxes": [16], "max_rels": [16]}}, **kw)
    path = str(root / "cfg.yml")
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return path


def _stages(text):
    return dict(re.findall(r"\[acceptance\] (\w+)\s+(PASS|FAIL)", text))


def test_oracle_matches_jax(tmp_path):
    ag = build_micro_ag(str(tmp_path), n_videos=3, n_frames=3, feat_dim=FEAT)
    over = {"data_path": ag, "feat_dim": FEAT,
            "frame_features_path": os.path.join(ag, "frame_features")}
    ev, n = acceptance.run_oracle(load_config(None, over), 3)
    jev, jn = load_tool("acceptance").run_oracle(j_load_config(None, over), 3)
    assert n == jn == 3
    assert ev.mean_score(20) > 0
    for k in KS:
        np.testing.assert_allclose(ev.mean_score(k), jev.mean_score(k), rtol=0, atol=1e-9)
        np.testing.assert_allclose(ev.mean_recall.mean_recall[k],
                                   jev.mean_recall.mean_recall[k], rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def runbook(tmp_path_factory):
    """The whole runbook once, through `run`: its stages and its eval's
    evaluator."""
    root = tmp_path_factory.mktemp("acc")
    ag = build_micro_ag(str(root), n_videos=4, n_frames=3, feat_dim=FEAT)
    vinvl = str(root / "vinvl_synth.pth")
    torch.save({"model": {k: torch.as_tensor(v) for k, v in
                          make_vinvl_state_dict(np.random.default_rng(0)).items()}}, vinvl)
    model = STTran(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=1, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    tar = str(root / "sttran_ref.tar")
    torch.save({"state_dict": model.state_dict(), "epoch": 1}, tar)
    del model
    cfg = _cfg(root, ag)
    out = str(root / "acc1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "savez_compressed", np.savez)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, stages = acceptance.run(["--cfg", cfg, "--vinvl", vinvl, "--relation_ckpt", tar,
                                         "--out_dir", out, "--oracle_videos", "3",
                                         "--train_e2e", "2", "--device", "cpu"])
    ev = next((st.data["evaluator"] for st in stages if st.name == "eval"), None)
    yield {"root": root, "ag": ag, "cfg": cfg, "out": out, "tar": tar, "rc": rc,
           "stages": stages, "text": buf.getvalue(), "ev": ev}
    shutil.rmtree(root, ignore_errors=True)


def test_runbook_stages_pass(runbook):
    text = runbook["text"]
    names = ("validate_vinvl", "convert_vinvl", "oracle_grounding", "train_e2e",
             "convert_relation", "eval")
    assert runbook["rc"] == 0, text
    assert _stages(text) == {s: "PASS" for s in names}, text
    assert [(st.name, st.ok) for st in runbook["stages"]] == [(s, True) for s in names]
    assert all(st.wall_s > 0 for st in runbook["stages"])
    assert "epoch 1 (warm)" in text and "all executed stages passed" in text
    by = {st.name: st.data for st in runbook["stages"]}
    assert by["oracle_grounding"]["videos"] == 3 and by["oracle_grounding"]["r20"] > 0
    epochs = by["train_e2e"]["epochs"]   # 4 videos in batches of 2: cold streams, warm stores
    assert [(e["videos"], e["stored"], e["streamed"]) for e in epochs] == [(4, 0, 2), (4, 2, 0)]
    assert all(e["frames"] > 0 and e["finite"] and not e["skipped"] for e in epochs)
    with open(os.path.join(runbook["out"], "relation_ckpt", "family.json")) as f:
        assert json.load(f) == {"family": "sttran"}
    # the converted VinVL .npz reached the eval's config
    with open(os.path.join(runbook["out"], "eval_config.json")) as f:
        snap = json.load(f)
    assert snap["ckpt"] == snap["vinvl_ckpt"] == os.path.join(runbook["out"],
                                                              "vinvl_converted.npz")


def test_eval_equals_test_sttran_run_directly(runbook, tmp_path):
    over = {"vinvl_ckpt": os.path.join(runbook["out"], "vinvl_converted.npz")}
    over["ckpt"] = over["vinvl_ckpt"]
    snap = str(tmp_path / "cfg.json")
    with open(snap, "w") as f:
        f.write(load_config(runbook["cfg"], over).to_json())
    ev = test_sttran.main(["--cfg", snap, "--model_path",
                           os.path.join(runbook["out"], "relation_ckpt"), "--device", "cpu"])
    ours = runbook["ev"]
    assert ours is not None and len(ours.recall[20]) > 0
    for k in KS:   # the rows come in the prefetch workers' order: compare them sorted
        assert sorted(ours.recall[k]) == sorted(ev.recall[k]), k
        assert sorted(ours.recall_nogc[k]) == sorted(ev.recall_nogc[k]), k
        assert ours.mean_recall.mean_recall[k] == pytest.approx(ev.mean_recall.mean_recall[k],
                                                                rel=1e-12, abs=1e-12), k
    m = re.search(r"eval\s+PASS\s+R@20 ([0-9.]+) R@50 ([0-9.]+)", runbook["text"])
    assert m and float(m[1]) == pytest.approx(ev.mean_score(20), abs=5e-5)


@pytest.mark.parametrize("moved", [0.0, 0.01])
def test_parity_gate(runbook, tmp_path, capsys, moved):
    """Expected = the eval's own numbers (rc 0), or each moved 1 point (rc 1)."""
    ev = runbook["ev"]
    expected = {"recall": {str(k): float(np.mean(ev.recall[k])) + moved for k in KS},
                "recall_nogc": {str(k): float(np.mean(ev.recall_nogc[k])) + moved for k in KS},
                "mean_recall": {str(k): float(v) + moved
                                for k, v in ev.mean_recall.mean_recall.items()}}
    exp = str(tmp_path / "expected.json")
    with open(exp, "w") as f:
        json.dump(expected, f)
    rc = acceptance.main(["--cfg", runbook["cfg"], "--relation_ckpt",
                          os.path.join(runbook["out"], "relation_ckpt"), "--out_dir",
                          str(tmp_path / "acc"), "--oracle_videos", "0", "--expected_json", exp,
                          "--device", "cpu"])
    text = capsys.readouterr().out
    if moved:
        assert rc == 1 and "FAILED stages: parity_gate" in text, text
        assert _stages(text) == {"eval": "PASS", "parity_gate": "FAIL"}
    else:
        assert rc == 0, text
        assert _stages(text) == {"eval": "PASS", "parity_gate": "PASS"}


def _no_eval(monkeypatch):
    """The eval stage stubbed to return None (an empty directory cannot
    evaluate): the stages under test run before it."""
    monkeypatch.setattr(test_sttran, "main", lambda argv, build_model_fn=None,
                        read_frames=None: None)


@pytest.mark.parametrize("where", ["unset", "a directory"])
def test_ref_baseline_guard(tmp_path, monkeypatch, capsys, where):
    ag = build_micro_ag(str(tmp_path), n_videos=1, n_frames=3, feat_dim=8)
    cfg = _cfg(tmp_path, ag, feat_dim=8)
    ckpt_dir = tmp_path / "port_ckpt"
    ckpt_dir.mkdir()
    _no_eval(monkeypatch)
    ref = [] if where == "unset" else ["--ref_root", str(tmp_path)]
    rc = acceptance.main(["--cfg", cfg, "--relation_ckpt", str(ckpt_dir), "--out_dir",
                          str(tmp_path / "acc"), "--oracle_videos", "0", "--ref_baseline",
                          "--device", "cpu", *ref])
    text = capsys.readouterr().out
    assert rc == 1 and "FAILED stages" in text
    line = next(s for s in text.splitlines() if s.startswith("[acceptance] ref_baseline"))
    assert "FAIL" in line
    assert ("not mounted" if where == "unset" else "torch .tar") in line


STUB_REFERENCE = {
    "lib/__init__.py": "",
    "lib/assign_pseudo_label.py": "import torch\n",
    "lib/sttran.py": """
import torch


class STTran(torch.nn.Module):
    def __init__(self, **kw):
        super().__init__()

    def forward(self, entry):
        return entry
""",
    "lib/object_detector.py": """
import torch


class detector(torch.nn.Module):
    def __init__(self, train, object_classes, use_SUPPLY, conf):
        super().__init__()

    def forward(self, gt, video, a, b):
        return {"device": torch.device("cuda").type}
""",
    "lib/evaluation_recall.py": """
class SceneGraphEvaluator:
    def __init__(self, mode, **kw):
        self.mode = mode

    def register_container(self):
        self.result_dict = {self.mode + "_recall": {10: [], 20: [], 50: []},
                            self.mode + "_recall_nogc": {10: [], 20: [], 50: []}}

    def evaluate_scene_graph(self, gt, pred):
        hit = 0.25 if pred["device"] == "cpu" else 0.0   # the reference's device patch held
        for group in ("_recall", "_recall_nogc"):
            for k in (10, 20, 50):
                self.result_dict[self.mode + group][k].append(hit)

    def calculate_mean_recall(self):
        self.result_dict[self.mode + "_mean_recall"] = {10: 0.5, 20: 0.5, 50: 0.5}
""",
    "dataloader/__init__.py": "",
    "dataloader/wk_action_genome.py": """
class AG_Test:
    def __init__(self, split, log, data_path=None):
        self.object_classes = ["class%d" % i for i in range(36)]
        self.attention_relationships = ["a0", "a1", "a2"]
        self.spatial_relationships = ["s%d" % i for i in range(6)]
        self.contacting_relationships = ["c%d" % i for i in range(17)]
        self.relationship_classes = (self.attention_relationships
                                     + self.spatial_relationships
                                     + self.contacting_relationships)
        self.video_list = [["v0/f0.png"], ["v1/f0.png"]]
        self.gt_annotations = [[{}], [{}]]

    def __len__(self):
        return len(self.video_list)
""",
}


def test_ref_baseline_runs_in_its_own_process(runbook, tmp_path, monkeypatch, capsys):
    """--ref_baseline on a stub reference checkout: the reference runs in a
    child process with its own torch.device patch (its detector sees the
    CPU), writes expected.json, and leaves this process's torch and
    modules as they were, so the eval after it resolves the device it was
    asked for."""
    ref = tmp_path / "reference"
    for name, text in STUB_REFERENCE.items():
        (ref / name).parent.mkdir(parents=True, exist_ok=True)
        (ref / name).write_text(text)
    before = (sys.modules.get("torchvision"), torch.nn.MultiheadAttention.forward,
              torch.Tensor.cuda)
    seen = {}

    def eval_sees(argv, build_model_fn=None, read_frames=None):
        seen["cuda"] = torch.device("cuda", 0).type
        seen["device"] = isinstance(torch.device("cpu"), torch.device)
        return None
    monkeypatch.setattr(test_sttran, "main", eval_sees)
    out = tmp_path / "acc"
    rc, stages = acceptance.run(["--cfg", runbook["cfg"], "--relation_ckpt", runbook["tar"],
                                 "--out_dir", str(out), "--oracle_videos", "0",
                                 "--ref_baseline", "--ref_root", str(ref), "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 1, text
    assert [(st.name, st.ok) for st in stages] == [
        ("convert_relation", True), ("ref_baseline", True), ("eval", False)], text
    assert "2 videos  ref R@20 0.2500" in text
    with open(out / "expected.json") as f:
        expected = json.load(f)
    assert expected["recall"] == expected["recall_nogc"] == {"10": 0.25, "20": 0.25, "50": 0.25}
    assert expected["mean_recall"] == {"10": 0.5, "20": 0.5, "50": 0.5}
    assert seen == {"cuda": "cuda", "device": True}
    assert "lib" not in sys.modules and "dataloader" not in sys.modules
    assert (sys.modules.get("torchvision"), torch.nn.MultiheadAttention.forward,
            torch.Tensor.cuda) == before
    shutil.rmtree(out, ignore_errors=True)


def test_eval_returning_none_is_a_fail_stage(tmp_path, monkeypatch, capsys):
    ag = build_micro_ag(str(tmp_path), n_videos=1, n_frames=3, feat_dim=8)
    cfg = _cfg(tmp_path, ag, feat_dim=8)
    ckpt_dir = tmp_path / "port_ckpt"
    ckpt_dir.mkdir()
    with open(ckpt_dir / "family.json", "w") as f:
        json.dump({"family": "sttran"}, f)
    _no_eval(monkeypatch)
    rc = acceptance.main(["--cfg", cfg, "--relation_ckpt", str(ckpt_dir), "--out_dir",
                          str(tmp_path / "acc"), "--oracle_videos", "0", "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 1
    assert "eval               FAIL  no evaluator returned" in text
    assert "FAILED stages: eval" in text


def test_sgcls_eval_takes_the_config_and_the_family(tmp_path, monkeypatch):
    """sgcls runs `evaluate_sgcls` on the config with the overrides, with
    DSG-DETR's builder and tracker ids for that family."""
    seen = {}

    def evaluate_sgcls(cfg, args, logger, build_model_fn=None, group_id_fn=None,
                       read_frames=None):
        seen.update(cfg=cfg, args=args, build=build_model_fn, group=group_id_fn)
        return None

    monkeypatch.setattr(test_sttran, "evaluate_sgcls", evaluate_sgcls)
    cfg = load_config(None, {"mode": "sgcls", "ckpt": "x.npz"})
    args = argparse.Namespace(max_videos=3, device="cpu", out_dir=str(tmp_path))
    assert acceptance._evaluate(cfg, str(tmp_path / "cfg.json"), args, "ckpt_dir", "dsg_detr",
                                None) is None
    from nl_vsgg_tpu_torch.tools import test_dsg_detr, train_dsg_detr
    assert seen["cfg"].ckpt == "x.npz" and seen["args"].model_path == "ckpt_dir"
    assert (seen["args"].max_videos, seen["args"].device) == (3, "cpu")
    assert seen["build"] is train_dsg_detr.build_model
    assert seen["group"] is test_dsg_detr.sgcls_group_ids
