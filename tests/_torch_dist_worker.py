"""One rank of a multi-process job for the port's parallel-layer tests
(tests/test_torch_distributed.py, test_torch_ddp.py, test_torch_sp.py,
test_torch_tp.py, test_torch_tp_train.py).

    python -m tests._torch_dist_worker <mode> <payload.pt> <out_dir>

The rank, the world size and the rendezvous come from NL_VSGG_COORDINATOR
(a file:// store in the test's tmp_path) / NL_VSGG_NUM_PROCESSES /
NL_VSGG_PROCESS_ID, the contract of `parallel.distributed.init_distributed`.
Each rank runs on the CPU over gloo, with collective timeouts of
NL_VSGG_DIST_TIMEOUT_S (60 s in the tests), and writes its result to
<out_dir>/rank<r>.pt. This module imports torch, numpy and the port only:
the JAX references run in the test's own process. `run_job` starts the
ranks and collects their results. A rank reads its payload before the
rendezvous, so no peer's clock runs meanwhile. Seeded models travel as
recipes (`model_recipe`), which each rank rebuilds (`build_model`),
instead of as pickled weights.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a job's wall, all its ranks: the tp job at 1x2 takes about 30 s alone on 8 cores; beside
# the rest of the suite under `-n 6` the slowest jobs took 142-188 s (train x2, tp x2, on
# an overloaded 8-core machine), past the 120 s this limit once was. A rank hung in a
# collective ends at DIST_TIMEOUT_S; any other hang ends here
JOIN_TIMEOUT_S = 400
DIST_TIMEOUT_S = 60


def model_recipe(cls: str, seed: int, **kwargs) -> dict:
    """A seeded model as the ranks rebuild it: `cls` "STTran" or "DSGDETR",
    its constructor's keyword arguments, the weights drawn from a
    torch.Generator seeded `seed` (on the CPU)."""
    return dict(kwargs, cls=cls, seed=seed)


def build_model(recipe: dict):
    """The model of `model_recipe`, bit-identical in every process."""
    import torch

    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR
    from nl_vsgg_tpu_torch.models.sttran import STTran

    kw = dict(recipe)
    cls = {"STTran": STTran, "DSGDETR": DSGDETR}[kw.pop("cls")]
    return cls(device="cpu", generator=torch.Generator().manual_seed(kw.pop("seed")), **kw)


def run_job(mode: str, tmp_path, world: int, payload: dict, threads: int = 1) -> list:
    """Start `world` ranks of `mode` on `payload`; returns their results in
    rank order. A rank that fails, or a job that outlives JOIN_TIMEOUT_S
    (one deadline for all its ranks), fails the test with each failed
    rank's output. The job's wall is printed (`pytest -rP` shows it)."""
    import torch

    job = tmp_path / f"{mode}_{world}"
    job.mkdir(parents=True, exist_ok=True)
    torch.save(payload, job / "payload.pt")
    env = dict(os.environ)
    env.update({"NL_VSGG_COORDINATOR": f"file://{job / 'store'}",
                "NL_VSGG_NUM_PROCESSES": str(world), "NL_VSGG_DIST_TIMEOUT_S": str(DIST_TIMEOUT_S),
                "NL_VSGG_JOIN_TIMEOUT_S": str(JOIN_TIMEOUT_S), "OMP_NUM_THREADS": str(threads),
                "NL_VSGG_TEST_THREADS": str(threads), "PYTHONPATH": REPO})
    procs, logs = [], []
    t0 = time.monotonic()
    for r in range(world):
        env["NL_VSGG_PROCESS_ID"] = str(r)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tests._torch_dist_worker", mode, str(job / "payload.pt"),
             str(job)], cwd=REPO, env=dict(env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            left = max(t0 + JOIN_TIMEOUT_S - time.monotonic(), 0.1)
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pass   # the ranks still running are killed and reported below
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs += [p.communicate()[0] for p in procs[len(logs):]]
    print(f"run_job {mode} x{world}: {time.monotonic() - t0:.1f} s (limit {JOIN_TIMEOUT_S} s)")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(
        f"rank {r} rc={procs[r].returncode}\n{logs[r].decode('utf-8', 'replace')[-3000:]}"
        for r in bad)
    out = [torch.load(job / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(job, ignore_errors=True)  # payloads hold models of a few hundred MB
    return out


# ---------------------------------------------------------------- the ranks
class Models:
    """A rank's models, each recipe built once: `get(recipe)` returns a
    fresh copy of it; `digests()` the built weights' digests, by recipe,
    for the test to hold against its own model's."""

    def __init__(self):
        self.built: dict = {}

    def get(self, recipe: dict):
        import copy

        key = tuple(sorted(recipe.items()))
        if key not in self.built:
            self.built[key] = build_model(recipe)
        return copy.deepcopy(self.built[key])

    def digests(self) -> list:
        return [(dict(key), digest(m.state_dict())) for key, m in self.built.items()]


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
    import torch

    from nl_vsgg_tpu_torch.data.entry import stack_entries
    from nl_vsgg_tpu_torch.parallel import distributed as D
    from nl_vsgg_tpu_torch.parallel.mesh import ALLREDUCE, data_parallel
    from nl_vsgg_tpu_torch.train.state import create_train_state, make_optimizer
    from nl_vsgg_tpu_torch.train.step import make_train_step

    r, n = D.rank(), D.world_size()
    refs = torch.load(payload["refs"], mmap=True, weights_only=False)
    models = Models()
    out = {}
    for name, case in payload["cases"].items():
        model = models.get(payload["model"])
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
    out["models"] = models.digests()
    return out


def _tp_linear(mesh, cases: dict) -> dict:
    """parallel/tensor.column_linear on the rank's rows of each full
    (weight, bias, input, output gradient): the output, the input's
    gradient and the gathered weight and bias gradients."""
    import torch

    from nl_vsgg_tpu_torch.parallel import tensor as T

    tp = T.TP(mesh.model_group, mesh.model_index, mesh.model)
    out = {}
    for (blocks, dname), (w, b, x, gy) in cases.items():
        dt = getattr(torch, dname)
        wl = T.take_shard(w, tp, blocks).to(dt).requires_grad_()
        bl = T.take_shard(b, tp, blocks).to(dt).requires_grad_()
        xx = x.to(dt).requires_grad_()
        y = T.column_linear(xx, wl, bl, tp, blocks)
        (y.float() * gy).sum().backward()
        out[blocks, dname] = (y.detach().float(), xx.grad.float(),
                              T.gather_shard(wl.grad, tp, blocks).float(),
                              T.gather_shard(bl.grad, tp, blocks).float())
    return out


def mode_tp(payload: dict) -> dict:
    """The model axis (parallel/tensor.py) on a data x model mesh of the
    ranks: the collectives on one Linear, then each case's train steps on
    the rank's data block with the model sharded over its model group; the
    gathered one-rank state after each step, digested on every rank and
    held against the references on rank 0. A case's `nan_slice` steps put
    a NaN in the last model index's gradient slice of `nan_param` alone."""
    import torch

    from nl_vsgg_tpu_torch.data.entry import stack_entries
    from nl_vsgg_tpu_torch.models.losses import sttran_losses
    from nl_vsgg_tpu_torch.parallel import distributed as D
    from nl_vsgg_tpu_torch.parallel import tensor as T
    from nl_vsgg_tpu_torch.parallel.mesh import data_parallel, make_mesh
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step
    from nl_vsgg_tpu_torch.utils.checkpoint import restore_checkpoint, state_payload

    mesh = make_mesh(payload["data"], payload["model"], device="cpu")
    models = Models()
    out = {"mesh": (mesh.data_index, mesh.model_index, D.data_size(), D.data_index(),
                    D.model_index())}
    if "linear" in payload:
        out["linear"] = _tp_linear(mesh, payload["linear"])
    refs = torch.load(payload["refs"], mmap=True, weights_only=False)
    for name, case in payload["cases"].items():
        model = T.shard_module(models.get(case["model"]), mesh)
        st = (create_train_state(model, optimizer=torch.optim.SGD(model.parameters(),
                                                                  lr=case["lr"]))
              if case["opt"] == "sgd" else create_train_state(model, lr=case["lr"]))
        step = make_train_step(data_parallel(model, mesh), st.optimizer)
        res = {"losses": [], "digests": [], "worst": [],
               "local_params": sum(p.numel() for p in model.parameters())}
        for i, (entries, step_refs) in enumerate(zip(case["batches"], case["refs"])):
            per = len(entries) // mesh.data
            block = stack_entries(entries[mesh.data_index * per:(mesh.data_index + 1) * per])
            hook = None
            if i in case.get("nan_slice", ()) and mesh.model_index == mesh.model - 1:
                hook = dict(model.named_parameters())[case["nan_param"]].register_hook(
                    lambda g: g * float("nan"))
            T.reset_comm()
            st, met = step(st, block, torch.Generator().manual_seed(0))
            if hook is not None:
                hook.remove()
            res["comm"] = dict(T.COMM)
            res["losses"].append({k: float(v) for k, v in met.items()})
            full = T.full_state_dict(model)
            res["digests"].append(digest(full))
            res["worst"].append({ref: worst_ratio(full, refs[ref], *tol)
                                 for ref, tol in step_refs.items()} if D.rank() == 0 else {})
        res["skipped"], res["step"] = st.skipped, st.step
        if case["opt"] != "sgd":
            res["adam_steps"] = sorted({int(s["step"])
                                        for s in st.optimizer.adamw.state.values()})
        out[name] = res
    if "clip" in payload:   # the clip's global norm over whole arrays
        c = payload["clip"]
        model = T.shard_module(models.get(c["model"]), mesh)
        st = create_train_state(model, lr=1e-5)
        batch = stack_entries(c["batch"])
        g = torch.Generator().manual_seed(0)
        sttran_losses(model(batch, train=True, generator=g), batch, g)["total"].sum().backward()
        out["clip_norm"] = float(st.optimizer.clip_())
    if "ckpt" in payload:   # a one-rank checkpoint restored into the rank's slices
        c = payload["ckpt"]
        model = T.shard_module(models.get(c["model"]), mesh)
        st = restore_checkpoint(c["dir"], create_train_state(model, lr=1e-5))
        back = state_payload(st)
        out["ckpt"] = (digest(back["model"]),
                       {i: digest({k: v for k, v in s.items() if k != "step"})
                        for i, s in back["optimizer"]["state"].items()}, st.step)
    out["models"] = models.digests()
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
    # the payload before the rendezvous: no peer's collective clock runs
    # while this rank reads it
    payload = torch.load(payload_path, weights_only=False)
    D.init_distributed(None, device="cpu", timeout_s=DIST_TIMEOUT_S)
    out = {"mode_gather": mode_gather, "mode_ddp": mode_ddp, "mode_sp": mode_sp,
           "mode_train": mode_train, "mode_tp": mode_tp}["mode_" + mode](payload)
    out["backend"] = D.backend()
    torch.save(out, os.path.join(out_dir, f"rank{D.rank()}.pt"))
    D.shutdown()


if __name__ == "__main__":
    main()
