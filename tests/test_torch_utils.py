"""The entry points' utilities against the JAX package: `MetricWriter`
records (the same keys and values; `time` is the wall clock and is left
out), `SmoothedValue`, `PhaseTimer`'s summary, `setup_logger`, the
`torch.profiler` trace scope, `DoubleBuffer`, and
`place_entries(cast_bf16=True)` against the JAX function (exact: the same
casts of the same values)."""

import json
import os

import numpy as np
import torch

from nl_vsgg_tpu.data.pipeline import DoubleBuffer as JDoubleBuffer
from nl_vsgg_tpu.train import place_entries as j_place_entries
from nl_vsgg_tpu.utils import logging as jlog
from nl_vsgg_tpu.utils import profiling as jprof
from nl_vsgg_tpu_torch.data.pipeline import DoubleBuffer
from nl_vsgg_tpu_torch.train.step import place_entries
from nl_vsgg_tpu_torch.utils import logging as tlog
from nl_vsgg_tpu_torch.utils import profiling as tprof
from tests.test_torch_data_pipeline import _entries, assert_same_batch, to_jax_entry


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_writer_records_match_jax(tmp_path):
    ours, ref = tlog.MetricWriter(str(tmp_path / "t")), jlog.MetricWriter(str(tmp_path / "j"))
    for w in (ours, ref):
        w.write(100, total=np.float32(1.25), object_loss=0.5)
        w.write(np.int64(200), epoch=1, mean_r20=0.3125, lr=1e-5)
        w.write(201, truncated_videos=3, truncated_boxes=7, truncated_rels=2)
        w.close()
    a, b = _records(ours.path), _records(ref.path)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert list(x) == list(y) and x.pop("time") > 0 and y.pop("time") > 0
        assert x == y
    # append-only: a second writer (a resumed run) adds to the same file
    tlog.MetricWriter(str(tmp_path / "t")).write(300, lr=5e-6)
    assert [r["step"] for r in _records(ours.path)] == [100, 200, 201, 300]


def test_smoothed_value_matches_jax():
    ours, ref = tlog.SmoothedValue(4), jlog.SmoothedValue(4)
    for v in (3.0, 1.0, 4.0, 1.5, 9.0, 2.5):
        ours.update(v)
        ref.update(v)
        assert (ours.median, ours.avg, ours.global_avg) == (ref.median, ref.avg, ref.global_avg)
    assert ours.series == ref.series and ours.count == ref.count == 6


def test_phase_timer_summary_matches_jax():
    ours, ref = tprof.PhaseTimer(), jprof.PhaseTimer()
    for t in (ours, ref):
        with t("grounding(host)"):
            pass
        t.totals.update({"grounding(host)": 1.5, "train_step": 3.25})
        t.counts.update({"grounding(host)": 4, "train_step": 2})
    assert ours.summary() == ref.summary()
    assert ours.summary().splitlines()[0] == "train_step: total 3.25s, 2 calls, avg 1625.0ms"


def test_setup_logger_writes_its_file_once(tmp_path):
    name = "test_torch_utils_logger"
    log = tlog.setup_logger(name, save_dir=str(tmp_path))
    try:
        assert tlog.setup_logger(name, save_dir=str(tmp_path)) is log
        assert len(log.handlers) == 2 and not log.propagate
        log.info("resumed from checkpoint epoch 0")
        for h in log.handlers:
            h.flush()
        assert "resumed from checkpoint epoch 0" in open(tmp_path / "log.txt").read()
    finally:
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, tprof.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_double_buffer_matches_jax():
    ours, ref = DoubleBuffer(), JDoubleBuffer()
    seq = [ours.push(i) for i in range(4)] + [ours.flush(), ours.flush()]
    want = [ref.push(i) for i in range(4)] + [ref.flush(), ref.flush()]
    assert seq == want == [None, 0, 1, 2, 3, None]


def test_place_entries_cast_bf16_matches_jax():
    es = _entries(21, 3)
    for kw in ({"cast_bf16": True}, {"cast_bf16": True, "zero_union": True}):
        ours = place_entries(es, device="cpu", **kw)
        assert ours.features.dtype == ours.union_feat.dtype == ours.spatial_masks.dtype \
            == torch.bfloat16
        assert_same_batch(ours, j_place_entries([to_jax_entry(e) for e in es], **kw))


def test_ordered_prefetcher_yields_in_index_order():
    """`GroundingPrefetcher(ordered=True)` (the training stream) yields in
    the order given however the workers finish; the default yields in
    completion order. Both yield every index once."""
    import random
    import time

    from nl_vsgg_tpu_torch.data.pipeline import GroundingPrefetcher

    order = random.Random(0).sample(range(40), 40)
    delay = {i: random.Random(i).random() * 2e-3 for i in order}

    def ground(i):
        time.sleep(delay[i])
        return i * 10

    got = list(GroundingPrefetcher(ground, order, num_workers=6, prefetch=4, ordered=True))
    assert got == [(i, i * 10) for i in order]
    free = list(GroundingPrefetcher(ground, order, num_workers=6))
    assert sorted(free) == sorted(got)


def test_ordered_prefetcher_holds_at_most_prefetch_behind_a_slow_video():
    """Ordered, a slow video at the head of the stream stalls it, and the
    workers do not ground the rest of the epoch meanwhile: at most
    `prefetch` positions are started and not yet yielded at any time."""
    import threading
    import time

    from nl_vsgg_tpu_torch.data.pipeline import GroundingPrefetcher

    prefetch, lock = 3, threading.Lock()
    held = {"now": 0, "peak": 0}

    def ground(i):
        with lock:
            held["now"] += 1
            held["peak"] = max(held["peak"], held["now"])
        time.sleep(0.3 if i in (0, 10) else 1e-3)
        return i

    got = []
    for idx, e in GroundingPrefetcher(ground, range(20), num_workers=6, prefetch=prefetch,
                                      ordered=True):
        got.append(e)
        with lock:
            held["now"] -= 1
    assert got == list(range(20))
    assert held["peak"] == prefetch
