"""The port's composed training loop (nl_vsgg_tpu_torch/tools/train_e2e.py::
run_train_e2e_loop) on the micro Action Genome (4 videos x 3 frames, feat
32, STTran 1 + 1 layers, batches of 2, 2 epochs, the device Entry store on,
the CPU):

- each epoch's videos, frames and stored / streamed batch counts equal the
  JAX package's host plan on the same config: the JAX loop's epoch order
  (`np.random.default_rng(seed + epoch).permutation`), the JAX tool's
  `ground_video`, the JAX `bucket_events` and `place_entries` for the
  streamed videos, the JAX `DeviceEntryStore.add_batch` / `plan_batches`
  for the stored ones. The JAX loop itself (tools/bench_suite.py::
  run_train_e2e_loop) compiles a train step of the 1936-wide model on the
  CPU, which costs more than a minute of one worker; the host plan is what
  decides these counts in it;
- the loop's final weights equal the port's `make_train_step` applied to
  the same batches in the loop's order (the warm-up batch, then each
  epoch's, placed by `place_entries`) with the same generators, bitwise on
  the CPU: the store's gathers are the placed batches;
- the returned rows keep the JAX loop's shape and host keys; the epoch
  lines print the counts the loop hands its `counts` list.
"""

import os
import re

import numpy as np
import pytest
import torch

from nl_vsgg_tpu.data.action_genome import AGTrain as JAGTrain
from nl_vsgg_tpu.data.device_store import DeviceEntryStore as JDeviceEntryStore
from nl_vsgg_tpu.data.pipeline import bucket_events as j_bucket_events
from nl_vsgg_tpu.train import place_entries as j_place_entries
from nl_vsgg_tpu.utils.config import load_config as j_load_config
from nl_vsgg_tpu_torch.data import schema
from nl_vsgg_tpu_torch.data.action_genome import AGTrain
from nl_vsgg_tpu_torch.data.pipeline import bucket_events
from nl_vsgg_tpu_torch.tools import train_e2e as e2e
from nl_vsgg_tpu_torch.tools import train_sttran as ts
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries
from nl_vsgg_tpu_torch.utils.config import load_config
from tests.fixtures import build_micro_ag, load_tool

FEAT, VIDEOS, BATCH, EPOCHS = 32, 4, 2, 2
LINE = re.compile(r"epoch (\d) \((cold|warm)\).*\((\d+) videos;.*; (\d+) frames, (\d+) stored "
                  r"and (\d+) streamed batches, (\d+) skipped steps, losses (finite|NOT finite)")


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


def _over(ag, cache):
    return {"mode": "sgdet", "feat_dim": FEAT, "data_path": ag,
            "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
            "frame_features_path": os.path.join(ag, "frame_features"),
            "enc_layer": 1, "dec_layer": 1, "batch_videos": BATCH, "num_workers": 2,
            "entry_cache": cache,
            "buckets": {"max_frames": [3], "max_boxes": [16], "max_rels": [16]}}


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The port's loop, with its model and each step's generator key
    recorded."""
    root = tmp_path_factory.mktemp("e2e_loop")
    ag = build_micro_ag(str(root), n_videos=VIDEOS, n_frames=3, feat_dim=FEAT)
    cfg = load_config(None, _over(ag, str(root / "ecache")))
    ds = AGTrain(ag, pseudo_label_path=cfg.pseudo_localized_SG_path,
                 remove_one_frame_video=cfg.remove_one_frame_video)
    lines, keys, models, counts = [], [], [], []
    real_make, real_gen = e2e.make_train_step, ts.step_generator

    def make_train_step(model, *a, **kw):
        models.append(model)
        return real_make(model, *a, **kw)

    def step_generator(seed, step, device, rank=None):
        keys.append(step)
        return real_gen(seed, step, device, rank)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(e2e, "make_train_step", make_train_step)
        mp.setattr(ts, "step_generator", step_generator)
        res = e2e.run_train_e2e_loop(
            cfg, ds, lambda i: ts.ground_video(ds, int(i), cfg, True, cfg.buckets),
            n_videos=VIDEOS, epochs=EPOCHS, batch_videos=BATCH, log=lines.append, device="cpu",
            counts=counts)
    assert len(models) == 1
    return {"ag": ag, "cfg": cfg, "ds": ds, "res": res, "lines": lines, "keys": keys,
            "counts": counts, "final": models[0].state_dict(), "root": root}


def _printed(lines):
    out = []
    for line in lines:
        m = LINE.search(line)
        if m:
            out.append({"videos": int(m[3]), "frames": int(m[4]), "stored": int(m[5]),
                        "streamed": int(m[6]), "skipped": int(m[7]), "finite": m[8] == "finite"})
    return out


def _jax_plan(ag, cache):
    """Each epoch's (videos, frames, stored, streamed batches) by the JAX
    loop's host plan (tools/bench_suite.py:583-606)."""
    jtool = load_tool("train_STTran")
    jcfg = j_load_config(None, _over(ag, cache))
    jds = JAGTrain(ag, pseudo_label_path=jcfg.pseudo_localized_SG_path,
                   remove_one_frame_video=jcfg.remove_one_frame_video)
    store = JDeviceEntryStore(budget_bytes=int(10e9), rel_bf16=False)
    frames_of, out = {}, []
    for epoch in range(EPOCHS):
        order = np.random.default_rng(jcfg.seed + epoch).permutation(len(jds))[:VIDEOS]
        batches, misses = store.plan_batches(order.tolist(), BATCH)
        got = {"videos": sum(map(len, batches)), "stored": len(batches), "streamed": 0,
               "frames": sum(frames_of[i] for b in batches for i in b)}
        pairs = ((i, jtool.ground_video(jds, i, jcfg, True, jcfg.buckets)) for i in misses)
        for kind, payload in j_bucket_events(pairs, BATCH):
            if kind == "skip":
                continue
            batch = j_place_entries([e for _, e in payload], zero_union=True, rel_bf16=False)
            got["streamed"] += 1
            got["videos"] += len(payload)
            for i, e in payload:
                frames_of[int(i)] = int(e.num_frames)
                got["frames"] += int(e.num_frames)
            if not store.overflow:
                store.add_batch([int(i) for i, _ in payload], batch)
        out.append(got)
    return out


def test_epoch_counts_equal_the_jax_host_plan(loop):
    ours = loop["counts"]
    assert len(ours) == EPOCHS and _printed(loop["lines"]) == ours
    want = _jax_plan(loop["ag"], str(loop["root"] / "ecache_jax"))
    assert [{k: e[k] for k in ("videos", "frames", "stored", "streamed")} for e in ours] == want
    assert want[0]["stored"] == 0 and want[1]["streamed"] == 0   # cold, then all stored
    assert all(e["skipped"] == 0 and e["finite"] for e in ours)
    for (epoch, wall, fps, host), e in zip(loop["res"], ours):
        assert wall > 0 and fps == pytest.approx(e["frames"] / wall)
        assert sorted(host) == ["ground", "place", "store"]
    assert [r[0] for r in loop["res"]] == list(range(EPOCHS))
    assert any(line.startswith("train_e2e   summary: cold") and line.endswith("on cpu")
               for line in loop["lines"])


def test_weights_equal_the_ports_own_steps(loop):
    """The warm-up step on the first groundable video, then each epoch's
    batches in the loop's order, through make_train_step: bitwise the
    loop's final weights (both on the CPU, same batches, same
    generators)."""
    cfg, ds = loop["cfg"], loop["ds"]
    keys = loop["keys"]
    assert keys == [e2e.WARMUP_STEP] + list(range(len(keys) - 1))
    ground = lambda i: ts.ground_video(ds, int(i), cfg, True, cfg.buckets)  # noqa: E731
    model = ts.build_model(cfg, schema.load_taxonomy(), "cpu")
    st = create_train_state(model, cfg.lr, cfg.weight_decay, cfg.grad_clip_norm)
    step = make_train_step(model, st.optimizer, bce=True)
    sample = next(e for e in map(ground, range(len(ds))) if e is not None)
    batches = [[sample] * BATCH]
    for epoch in range(EPOCHS):
        order = np.random.default_rng(cfg.seed + epoch).permutation(len(ds))[:VIDEOS]
        batches += [[e for _, e in payload] for kind, payload in
                    bucket_events(((i, ground(i)) for i in order), BATCH) if kind == "batch"]
    assert len(batches) == len(keys)
    for entries, key in zip(batches, keys):
        st, _ = step(st, place_entries(entries, zero_union=True, device="cpu"),
                     ts.step_generator(cfg.seed, key, torch.device("cpu")))
    assert st.skipped == 0
    for k, v in model.state_dict().items():
        assert torch.equal(loop["final"][k], v), k
