"""One-command acceptance runbook for the real NL-VSGG artifacts (port of
tools/acceptance.py):

    python -m nl_vsgg_tpu_torch.tools.acceptance --cfg configs/nl_vsgg_config.yml \
        --vinvl vinvl_vg_x152c4.pth --clip LLM_cp.pt --relation_ckpt model_best.tar \
        --out_dir out/acceptance [--expected_json expected.json] [--oracle_videos 50] \
        [--max_videos 0] [--train_e2e N] [--ref_baseline --ref_root REFERENCE] \
        [--device cpu]

or from Python, `rc, stages = run(argv)`: each stage's verdict, detail,
wall and numbers (`Stage`).

The R@K gate (R@20/50 within 0.5 points of the PyTorch reference) needs
three artifacts: the VinVL `vinvl_vg_x152c4.pth`, DAC's `LLM_cp.pt` and a
trained relation checkpoint (the reference's torch .tar). Stages, each
printing `[acceptance] <stage> PASS|FAIL`, then a summary:

  validate_vinvl   `tools.validate_ckpt.validate_vinvl`: stem, C2-C5, RPN
                   and predictor of the port against a functional torch
                   evaluation of the checkpoint's own tensors;
  convert_vinvl    `detector.convert.load_checkpoint` + `save_npz`; the
                   .npz becomes cfg.ckpt and cfg.vinvl_ckpt for the rest;
  validate_clip    `pipelines.clip.validate_checkpoint`, both towers;
  oracle_grounding `--oracle_videos` test videos grounded by
                   `tools.train_sttran.ground_video(..., is_train=True)`
                   and scored as oracle predictions
                   (`data.grounding.entry_to_pred`): the grounding's R@K
                   ceiling, which must reach `--oracle_min`;
  train_e2e        `--train_e2e N` epochs of `tools.train_e2e.
                   run_train_e2e_loop` over the train split (epoch 0 cold,
                   the rest from the device Entry store); an exception is
                   recorded as a FAIL, the runbook goes on;
  convert_relation the .tar -> a port checkpoint directory
                   (`tools.convert_relation_ckpt`, the family detected
                   from the keys with `--family auto`, recorded in a
                   family.json beside it); an existing port checkpoint
                   directory is read as it is, its family from that file;
  ref_baseline     `--ref_baseline`: the live PyTorch reference's eval on
                   the same videos (the reference checkout at
                   `--ref_root`), in a process of its own
                   (`tools.ref_baseline`), written to expected.json;
  eval             `tools.test_sttran.main` (`evaluate_sgcls` for sgcls;
                   DSG-DETR's build_model and tracker ids for that family), the
                   stage-1 overrides in its config;
  parity_gate      |ours - expected| <= 0.5 points on every expected
                   metric (`--expected_json`, else the ref_baseline's).

Exit code 0 only if every executed stage passed. Models and checks run on
`--device` (default: the GPU, which raises without one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from ..data import schema
from ..data.action_genome import AGTrain
from ..data.grounding import entry_to_pred
from ..data.pipeline import TruncationCounter
from ..eval.recall import SceneGraphEvaluator
from ..utils.config import load_config
from ..utils.logging import setup_logger
from . import convert_relation_ckpt, test_dsg_detr, test_sttran, train_dsg_detr, train_sttran

GATE_PTS = 0.5  # R@K acceptance tolerance, in percentage points
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass
class Stage:
    """One stage's verdict: `wall_s` the seconds since the previous
    verdict (since the run's start for the first), `data` its numbers
    (oracle_grounding: videos, r20, r50; train_e2e: videos and one dict a
    epoch; eval: the evaluator)."""
    name: str
    ok: bool
    detail: str
    wall_s: float
    data: dict


class Stages(list):
    """The run's verdicts in order; `add` prints each one's line."""

    def __init__(self):
        super().__init__()
        self.mark = time.perf_counter()

    def add(self, name: str, ok, detail: str = "", **data) -> bool:
        now = time.perf_counter()
        self.append(Stage(name, bool(ok), detail, now - self.mark, data))
        self.mark = now
        print(f"[acceptance] {name:<18} {'PASS' if ok else 'FAIL'}  {detail}", flush=True)
        return bool(ok)


def convert_vinvl(vinvl_path: str, out_dir: str) -> tuple[str, int]:
    """.pth -> .npz by `tools.convert_vinvl` (`detector.convert.
    load_checkpoint` + `save_npz`)."""
    from . import convert_vinvl as tool

    dst = os.path.join(out_dir, "vinvl_converted.npz")
    return dst, tool.main([vinvl_path, dst])


def run_oracle(cfg, n_videos: int):
    """The grounding's R@K ceiling over the first n test videos: the eval
    split grounded with the GT relation labels attached (is_train=True),
    scored as predictions."""
    ds = train_sttran.ag_test_split(cfg)
    ev = SceneGraphEvaluator(mode="sgdet", taxonomy=schema.load_taxonomy())
    n = min(n_videos, len(ds)) if n_videos else len(ds)
    for i in range(n):
        e = train_sttran.ground_video(ds, i, cfg, True, cfg.buckets)
        ev.evaluate_scene_graph(ds.gt_annotations[i], entry_to_pred(e))
    ev.calculate_mean_recall()
    return ev, n


def parity_table(evaluator, expected, log=print) -> bool:
    """Print ours against expected; True when every expected entry is
    within the gate."""
    ok = True
    rows = []
    ours = {
        "recall": {k: float(np.mean(v)) if v else 0.0 for k, v in evaluator.recall.items()},
        "recall_nogc": {k: float(np.mean(v)) if v else 0.0
                        for k, v in evaluator.recall_nogc.items()},
        "mean_recall": {k: float(v) for k, v in evaluator.mean_recall.mean_recall.items()},
    }
    for group, vals in ours.items():
        for k, v in sorted(vals.items(), key=lambda kv: int(kv[0])):
            exp = (expected or {}).get(group, {}).get(str(k))
            if exp is None:
                rows.append((f"{group}@{k}", v, None, None, ""))
                continue
            delta_pts = abs(v - float(exp)) * 100.0
            within = delta_pts <= GATE_PTS
            ok &= within
            rows.append((f"{group}@{k}", v, float(exp), delta_pts, "ok" if within else "FAIL"))
    log(f"{'metric':<16} {'ours':>8} {'expected':>9} {'|Δ| pts':>8}  gate")
    for name, v, exp, dpts, verdict in rows:
        exp_s = f"{exp:9.4f}" if exp is not None else "        —"
        d_s = f"{dpts:8.3f}" if dpts is not None else "       —"
        log(f"{name:<16} {v:8.4f} {exp_s} {d_s}  {verdict}")
    return ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NL-VSGG acceptance runbook")
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--vinvl", default=None, help="vinvl_vg_x152c4.pth")
    p.add_argument("--clip", default=None, help="DAC LLM_cp.pt")
    p.add_argument("--relation_ckpt", default=None,
                   help="trained relation checkpoint: the reference's torch .tar (converted "
                        "here) or an existing port checkpoint directory")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--oracle_videos", type=int, default=50)
    p.add_argument("--oracle_min", type=float, default=0.3,
                   help="minimum grounding-ceiling R@20: a mostly broken grounding engine "
                        "yields a tiny nonzero ceiling, which must fail here, not at the "
                        "parity gate")
    p.add_argument("--family", choices=["auto", "sttran", "dsg_detr"], default="auto",
                   help="relation-model family; 'auto' detects it from a .tar's keys or "
                        "reads the family.json beside a converted directory")
    p.add_argument("--max_videos", type=int, default=0,
                   help="cap the videos of train_e2e and eval (0 = the whole split)")
    p.add_argument("--train_e2e", type=int, default=0, metavar="EPOCHS",
                   help="also run the composed training loop for this many epochs on the "
                        "train split (epoch 0 cold, the rest warm; "
                        "tools.train_e2e.run_train_e2e_loop)")
    p.add_argument("--expected_json", default=None,
                   help='the PyTorch baseline (fractions): {"recall": {"20": 0.26, '
                        '"50": 0.33}, ...}')
    p.add_argument("--ref_baseline", action="store_true",
                   help="run the live PyTorch reference's eval on the same videos and write "
                        "expected.json for the parity gate; needs --relation_ckpt as a torch "
                        ".tar; --expected_json takes precedence")
    p.add_argument("--ref_root", default=None, help="the reference checkout")
    p.add_argument("--atol", type=float, default=1e-3,
                   help="validate_ckpt's per-stage relative threshold")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def _train_e2e_stage(results: Stages, cfg, args) -> None:
    from .train_e2e import run_train_e2e_loop

    ds = AGTrain(cfg.data_path, pseudo_label_path=cfg.pseudo_localized_SG_path,
                 remove_one_frame_video=cfg.remove_one_frame_video)
    trunc = TruncationCounter()
    epochs: list[dict] = []

    def ground(i):
        return train_sttran.ground_video(ds, int(i), cfg, True, cfg.buckets,
                                         on_truncate=trunc.add)

    n_vid = min(args.max_videos, len(ds)) if args.max_videos else len(ds)
    n_vid -= n_vid % cfg.batch_videos   # whole batches only
    res = run_train_e2e_loop(cfg, ds, ground, n_videos=n_vid, epochs=args.train_e2e,
                             batch_videos=cfg.batch_videos, log=lambda s: print("  " + s),
                             device=args.device, counts=epochs)
    tv, tb, tr = trunc.take()
    print(f"  train_e2e   truncation: {tv} videos, {tb} boxes, {tr} rels dropped across "
          f"all epochs")
    warm = res[1:] or res
    wfs = sum(r[2] for r in warm) / len(warm)
    for e, (_, wall, fps, host) in zip(epochs, res):
        e.update(wall_s=wall, frames_per_s=fps, host_s=host)
    results.add("train_e2e", np.isfinite(wfs) and wfs > 0,
                f"{n_vid} videos  cold {res[0][2]:,.0f} f/s -> warm {wfs:,.0f} f/s "
                f"(mean of {len(warm)} epochs)", videos=n_vid, epochs=epochs)


def _relation_family(results: Stages, args) -> tuple[str, str]:
    """(checkpoint directory, family) of --relation_ckpt, converting a .tar."""
    if os.path.isfile(args.relation_ckpt):
        family = args.family
        if family == "auto":
            family = convert_relation_ckpt.detect(
                convert_relation_ckpt.load_state_dict(args.relation_ckpt))[0]
        model_path = os.path.join(args.out_dir, "relation_ckpt")
        convert_relation_ckpt.main(
            ["--ckpt", args.relation_ckpt, "--out", model_path, "--cfg", args.cfg_file,
             "--family", family] + (["--device", args.device] if args.device else []))
        with open(os.path.join(model_path, "family.json"), "w") as f:
            json.dump({"family": family}, f)   # reruns against the directory keep it
        results.add("convert_relation", True, f"family={family} -> {model_path}")
        return model_path, family
    if args.family != "auto":
        return args.relation_ckpt, args.family
    sidecar = os.path.join(args.relation_ckpt, "family.json")
    if os.path.isfile(sidecar):
        with open(sidecar) as f:
            return args.relation_ckpt, json.load(f)["family"]
    print(f"[acceptance] WARNING: no family.json next to {args.relation_ckpt}; assuming "
          f"family=sttran (pass --family dsg_detr for a DSG-DETR checkpoint)")
    return args.relation_ckpt, "sttran"


def _ref_baseline_stage(results: Stages, cfg_json: str, args, family: str):
    """The expected dict the reference gave, or None (a FAIL recorded).
    The reference runs in a child process (`tools.ref_baseline`): its
    stubs and its patched torch.device end with it."""
    if not args.ref_root or not os.path.isdir(args.ref_root):
        results.add("ref_baseline", False,
                    f"{args.ref_root or 'the reference checkout (--ref_root)'} not mounted")
        return None
    if not os.path.isfile(args.relation_ckpt):
        results.add("ref_baseline", False,
                    "--ref_baseline needs the torch .tar checkpoint (a port checkpoint directory "
                    "cannot drive the reference model)")
        return None
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [PACKAGE_ROOT] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    proc = subprocess.run(
        [sys.executable, "-m", "nl_vsgg_tpu_torch.tools.ref_baseline", "--cfg", cfg_json,
         "--relation_ckpt", args.relation_ckpt, "--ref_root", args.ref_root, "--family", family,
         "--out_dir", args.out_dir, "--max_videos", str(args.max_videos)],
        env=env, capture_output=True, text=True)
    for line in proc.stdout.splitlines():
        print("  " + line)
    if proc.returncode != 0:
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        results.add("ref_baseline", False, f"rc {proc.returncode}: {last}")
        return None
    exp_path = os.path.join(args.out_dir, "expected.json")
    with open(exp_path) as f:
        expected = json.load(f)
    n_ref = proc.stdout.strip().splitlines()[-1].split()[-1]
    results.add("ref_baseline", True,
                f"{n_ref} videos  ref R@20 {expected['recall'].get('20', 0.0):.4f} "
                f"R@50 {expected['recall'].get('50', 0.0):.4f} -> {exp_path}")
    return expected


def _evaluate(cfg, cfg_json, args, model_path, family, read_frames):
    """The eval CLI's evaluator on the converted checkpoint, `cfg` (the
    stage-1 overrides in it) given as its config snapshot `cfg_json`."""
    build = train_dsg_detr.build_model if family == "dsg_detr" else train_sttran.build_model
    if cfg.mode == "sgcls":   # the two-stage reassignment flow takes cfg directly
        ns = argparse.Namespace(model_path=model_path, max_videos=args.max_videos,
                                device=args.device)
        group_fn = test_dsg_detr.sgcls_group_ids if family == "dsg_detr" else None
        return test_sttran.evaluate_sgcls(cfg, ns, setup_logger(), build_model_fn=build,
                                          group_id_fn=group_fn, read_frames=read_frames)
    argv = ["--cfg", cfg_json, "--model_path", model_path]
    if args.max_videos:
        argv += ["--max_videos", str(args.max_videos)]
    if args.device:
        argv += ["--device", args.device]
    return test_sttran.main(argv, build_model_fn=build, read_frames=read_frames)


def run(argv=None, read_frames=None) -> tuple[int, Stages]:
    """(exit code, the stages run). `read_frames(ds, idx)` replaces the cv2
    frame reader of the eval's union features and GT-box entries."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    results = Stages()
    overrides = {}

    # ---- VinVL validate + convert ----
    if args.vinvl:
        import torch

        from .validate_ckpt import validate_vinvl

        ckpt = torch.load(args.vinvl, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
        diffs = validate_vinvl(sd, atol=args.atol, log=lambda s: print("  " + s.strip()),
                               device=args.device)
        del ckpt, sd
        results.add("validate_vinvl", diffs.pop("_ok") == 1.0,
                    f"worst stage |Δ| {max(diffs.values()):.2e}")
        npz, n_arrays = convert_vinvl(args.vinvl, args.out_dir)
        results.add("convert_vinvl", True, f"{n_arrays} arrays -> {npz}")
        overrides["vinvl_ckpt"] = npz
        overrides["ckpt"] = npz
    if args.clip:
        from ..pipelines.clip import validate_checkpoint

        cdiffs = validate_checkpoint(args.clip, log=lambda s: print("  " + s.strip()),
                                     device=args.device)
        results.add("validate_clip", cdiffs.pop("_ok") == 1.0,
                    f"worst tower |Δ| {max(cdiffs.values()):.2e}")

    cfg = load_config(args.cfg_file, overrides)
    cfg_json = os.path.join(args.out_dir, "eval_config.json")   # the stage-1 overrides in it
    with open(cfg_json, "w") as f:
        f.write(cfg.to_json())

    # ---- the grounding's R@K ceiling ----
    if args.oracle_videos:
        ev, n = run_oracle(cfg, args.oracle_videos)
        r20, r50 = ev.mean_score(20), ev.mean_score(50)
        results.add("oracle_grounding", r20 >= args.oracle_min,
                    f"{n} videos  ceiling R@20 {r20:.4f}  R@50 {r50:.4f}  "
                    f"(gate >= {args.oracle_min})", videos=n, r20=r20, r50=r50)

    # ---- the composed training loop on the train split ----
    if args.train_e2e:
        try:
            _train_e2e_stage(results, cfg, args)
        except Exception as exc:  # record FAIL, keep the runbook going
            results.add("train_e2e", False, f"{type(exc).__name__}: {exc}")

    # ---- relation checkpoint, reference baseline, eval, parity gate ----
    if args.relation_ckpt:
        model_path, family = _relation_family(results, args)
        ref_expected = _ref_baseline_stage(results, cfg_json, args, family) \
            if args.ref_baseline else None
        evaluator = _evaluate(cfg, cfg_json, args, model_path, family, read_frames)
        # an eval path returning None records a FAIL stage, not a crash
        detail = ("no evaluator returned" if evaluator is None else
                  f"R@20 {evaluator.mean_score(20):.4f} R@50 {evaluator.mean_score(50):.4f}")
        results.add("eval", evaluator is not None, detail, evaluator=evaluator)
        if evaluator is not None:
            expected = ref_expected
            if args.expected_json:
                with open(args.expected_json) as f:
                    expected = json.load(f)
            gate_ok = parity_table(evaluator, expected)
            if expected:
                results.add("parity_gate", gate_ok,
                            f"|Δ| <= {GATE_PTS} pts on every expected metric")

    print("\n[acceptance] summary:")
    for st in results:
        print(f"  {'PASS' if st.ok else 'FAIL'}  {st.name:<18} {st.detail}")
    failed = [st.name for st in results if not st.ok]
    if failed:
        print(f"[acceptance] FAILED stages: {', '.join(failed)}")
        return 1, results
    print("[acceptance] all executed stages passed")
    return 0, results


def main(argv=None, read_frames=None) -> int:
    """The exit code of `run`."""
    return run(argv, read_frames)[0]


if __name__ == "__main__":
    sys.exit(main())
