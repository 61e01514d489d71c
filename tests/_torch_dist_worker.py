"""One rank of a multi-process job for the port's parallel-layer tests
(tests/test_torch_distributed.py, test_torch_ddp.py, test_torch_sp.py).

    python -m tests._torch_dist_worker <mode> <payload.pt> <out_dir>

The rank, the world size and the rendezvous come from NL_VSGG_COORDINATOR
(a file:// store in the test's tmp_path) / NL_VSGG_NUM_PROCESSES /
NL_VSGG_PROCESS_ID, the contract of `parallel.distributed.init_distributed`.
Each rank runs on the CPU over gloo, with collective timeouts of
NL_VSGG_DIST_TIMEOUT_S (60 s in the tests), and writes its result to
<out_dir>/rank<r>.pt. This module imports torch, numpy and the port only:
the JAX references run in the test's own process. `run_job` starts the
ranks and collects their results.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120
DIST_TIMEOUT_S = 60


def run_job(mode: str, tmp_path, world: int, payload: dict, threads: int = 1) -> list:
    """Start `world` ranks of `mode` on `payload`; returns their results in
    rank order. A rank that fails or outlives JOIN_TIMEOUT_S fails the
    test with every rank's output."""
    import torch

    job = tmp_path / f"{mode}_{world}"
    job.mkdir(parents=True, exist_ok=True)
    torch.save(payload, job / "payload.pt")
    env = dict(os.environ)
    env.update({"NL_VSGG_COORDINATOR": f"file://{job / 'store'}",
                "NL_VSGG_NUM_PROCESSES": str(world), "NL_VSGG_DIST_TIMEOUT_S": str(DIST_TIMEOUT_S),
                "NL_VSGG_JOIN_TIMEOUT_S": str(JOIN_TIMEOUT_S), "OMP_NUM_THREADS": str(threads),
                "NL_VSGG_TEST_THREADS": str(threads), "PYTHONPATH": REPO})
    procs = []
    for r in range(world):
        env["NL_VSGG_PROCESS_ID"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist_worker", mode, str(job / "payload.pt"),
             str(job)], cwd=REPO, env=dict(env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0].decode("utf-8", "replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} rc={procs[r].returncode}\n{logs[r][-3000:]}"
                              for r in bad)
    out = [torch.load(job / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(job, ignore_errors=True)  # payloads hold models of a few hundred MB
    return out


# ---------------------------------------------------------------- the ranks
def digest(sd: dict) -> dict:
    """A CRC-32 of each tensor's bytes: equal digests on every rank."""
    import zlib

    return {k: zlib.crc32(v.detach().reshape(-1).numpy().view("u1")) for k, v in sd.items()}


def worst_ratio(sd: dict, ref: dict, rtol: float, atol: float) -> tuple[float, str]:
    """max |a - b| / (atol + rtol |b|) over every tensor of `ref`."""
    worst, name = 0.0, ""
    for k, b in ref.items():
        a, b = sd[k].float(), b.float()
        r = float(((a - b).abs() / (atol + rtol * b.abs())).max()) if b.numel() else 0.0
        if not r <= worst:  # NaN counts as the worst
            worst, name = (r if r == r else float("inf")), k
    return worst, name


def mode_gather(payload: dict) -> dict:
    import numpy as np

    from nl_vsgg_tpu_torch.data.device_store import DeviceEntryStore
    from nl_vsgg_tpu_torch.eval.recall import SceneGraphEvaluator
    from nl_vsgg_tpu_torch.parallel import distributed as D

    r, n = D.rank(), D.world_size()
    out: dict = {"gathered": D.allgather_obj({"rank": r, "payload": list(range(r + 1))})}
    ev = SceneGraphEvaluator(payload["mode"])
    videos = payload["videos"]
    for i in range(r, len(videos), n):
        ev.evaluate_scene_graph(*videos[i])
    D.merge_evaluators(ev)
    out["sinks"] = {name: dict(getattr(ev, name)) for name in
                    ("recall", "recall_nogc", "semi_recall")}
    out["collect"] = (ev.mean_recall.collect, ev.ng_mean_recall.collect)
    out["mean_r20"] = ev.mean_score(20)

    entries = payload["entries"]
    ground = (lambda i: None if i in payload["fail"] else entries[i])
    blocks = []
    store = DeviceEntryStore(budget_bytes=None, device="cpu")
    for idxs, batch in D.DistributedBatcher(ground, payload["order"], payload["B"],
                                            feat_dim=payload["feat"], zero_union=True,
                                            num_workers=2, yield_indices=True, device="cpu"):
        blocks.append((idxs, {k: v.numpy() for k, v in vars(batch).items()}))
        assert store.add_batch(idxs, batch)
    out["blocks"] = blocks
    # a warm epoch from the per-rank store: the plan is the same on every
    # rank and each gather returns this rank's rows of the cold blocks
    plan, misses = store.plan_batches(payload["warm_order"], payload["B"])
    out["plan"], out["misses"] = plan, misses
    rows = {}
    for idxs, b in blocks:
        per = len(idxs) // n
        for j, vid in enumerate(idxs[r * per:(r + 1) * per]):
            rows[vid] = {k: v[j] for k, v in b.items()}
    per = payload["B"] // n
    for idxs in plan:
        got = store.gather(idxs)
        for j, vid in enumerate(idxs[r * per:(r + 1) * per]):
            for k, v in vars(got).items():
                assert np.array_equal(v[j].numpy(), rows[vid][k]), (vid, k)
    out["store_bytes"] = store.bytes
    out["comm"] = _comm_checks(r, n)
    try:
        D.DistributedBatcher(ground, [0], n + 1, device="cpu")
    except ValueError as e:
        out["bad_batch"] = str(e)
    return out


def _comm_checks(r: int, n: int) -> dict:
    """parallel/comm.py's all-gather and point-to-point exchange on bf16
    and bool tensors, the exchange both direct and through host memory
    (its CUDA-under-gloo path, forced on the CPU)."""
    import torch

    from nl_vsgg_tpu_torch.parallel import comm

    out = {}
    real = comm._staged
    for how, staged in (("direct", real), ("staged", lambda t: True)):
        comm._staged = staged
        comm.reset_staged()
        x = torch.full((2, 3), float(r + 1), dtype=torch.bfloat16)
        b = torch.tensor([r % 2 == 0, True])
        out[how] = {
            "gather": comm.all_gather(x).float().tolist(),
            "gather_bool": comm.all_gather(b).tolist(),
            "right": comm.shift(x, 1).float().tolist(),
            "left": comm.shift(b, -1).tolist(),
            "staged": comm.STAGED["bytes"]}
    comm._staged = real
    return out


def mode_ddp(payload: dict) -> dict:
    import copy

    import torch

    from nl_vsgg_tpu_torch.data.entry import stack_entries
    from nl_vsgg_tpu_torch.parallel import distributed as D
    from nl_vsgg_tpu_torch.parallel.mesh import ALLREDUCE, data_parallel
    from nl_vsgg_tpu_torch.train.state import create_train_state, make_optimizer
    from nl_vsgg_tpu_torch.train.step import make_train_step

    r, n = D.rank(), D.world_size()
    refs = torch.load(payload["refs"], mmap=True, weights_only=False)
    out = {}
    for name, case in payload["cases"].items():
        model = copy.deepcopy(payload["model"])
        opt = (torch.optim.SGD(model.parameters(), lr=case["lr"]) if case["opt"] == "sgd"
               else make_optimizer(model.parameters(), case["lr"], 1e-2, 5.0))
        st = create_train_state(model, optimizer=opt)
        step = make_train_step(data_parallel(model), opt)
        res = {"losses": [], "valid": [], "hashes": [], "worst": []}
        for entries, step_refs in zip(case["batches"], case["refs"]):
            per = len(entries) // n
            block = stack_entries(entries[r * per:(r + 1) * per])
            ALLREDUCE["bytes"] = 0
            st, met = step(st, block, torch.Generator().manual_seed(0))
            res["losses"].append({k: float(v) for k, v in met.items()})
            res["valid"].append(float(met["valid"]))
            res["hashes"].append(digest(model.state_dict()))
            res["allreduce_bytes"] = ALLREDUCE["bytes"]
            res["worst"].append({ref: worst_ratio(model.state_dict(), refs[ref], *tol)
                                 for ref, tol in step_refs.items()} if r == 0 else {})
        res["skipped"], res["step"] = st.skipped, st.step
        if case["opt"] != "sgd":
            res["adam_steps"] = sorted({int(s["step"]) for s in opt.adamw.state.values()})
        out[name] = res
    return out


def mode_sp(payload: dict) -> dict:
    from nl_vsgg_tpu_torch.parallel import comm
    from nl_vsgg_tpu_torch.parallel import distributed as D
    from nl_vsgg_tpu_torch.parallel.dsg_detr_sp import dsg_detr_transformer_sharded
    from nl_vsgg_tpu_torch.parallel.sequence import windowed_attention_sharded
    from nl_vsgg_tpu_torch.parallel.sttran_sp import sttran_transformer_sharded

    r, n = D.rank(), D.world_size()
    seq = payload["seq"]
    Fl = seq["tokens"].shape[0] // n
    out = {"seq": windowed_attention_sharded(seq["tokens"][r * Fl:(r + 1) * Fl],
                                             seq["valid"][r * Fl:(r + 1) * Fl], seq["params"],
                                             seq["pos"], seq["heads"])}
    st = payload["sttran"]
    out["sttran"] = [sttran_transformer_sharded(st["module"], *case)
                     for case in st["cases"]]
    dg = payload["dsg"]
    out["dsg"] = dsg_detr_transformer_sharded(dg["model"], *dg["inputs"])
    out["staged"] = comm.STAGED["bytes"]
    return out


def mode_train(payload: dict) -> dict:
    """run_training three times in one group: straight to 2 epochs, then 1
    epoch and a resume to 2 in another directory."""
    import argparse

    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.utils.config import load_config

    args = argparse.Namespace(max_videos=0, device="cpu")
    steps = {}
    for name, over in payload["runs"]:
        st = ts.run_training(load_config(None, over), args, ts.build_model)
        steps[name] = (st.step, st.skipped)
    return {"steps": steps}


def main() -> None:
    import torch

    from nl_vsgg_tpu_torch.parallel import distributed as D

    mode, payload_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(int(os.environ.get("NL_VSGG_TEST_THREADS", "1")))
    D.init_distributed(None, device="cpu", timeout_s=DIST_TIMEOUT_S)
    payload = torch.load(payload_path, weights_only=False)
    out = {"mode_gather": mode_gather, "mode_ddp": mode_ddp, "mode_sp": mode_sp,
           "mode_train": mode_train}["mode_" + mode](payload)
    out["backend"] = D.backend()
    torch.save(out, os.path.join(out_dir, f"rank{D.rank()}.pt"))
    D.shutdown()


if __name__ == "__main__":
    main()
