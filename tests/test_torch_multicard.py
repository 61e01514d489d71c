"""chip_smoke.py phase 19 (the parallel layer with one rank a card, run by
`chip_smoke.py --cards N`) on the CPU.

Its rank body (`chip_smoke.p19_body`) runs on 4 gloo ranks through
`tests/_torch_dist_worker.py` at a narrow width (STTran and DSG-DETR sgdet
with 1 + 1 layers, feat 64, 8 videos of 8 frames, one AdamW step where the
card takes three), and `p19_verdicts` holds
parts (a)-(c) against the one-process references with the tolerances and
checks of the card's run: the DDP steps at mesh 4 x 1, a NaN skipped on
every rank, the DSG-DETR step, the gradient's all-reduce, the sharded
forwards against the dense modules with nothing staged through the host,
the sliced steps at 2 x 2 (and 1 x 4 where the widths admit it). On the
CPU the ranks run gloo and launch no kernel, and the checks expect that.
`--cards N` with fewer cards visible exits 1 before any phase.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from tests._torch_dist_worker import run_job

RANKS, VIDEOS, FRAMES, FEAT = 4, 8, 8, 64
NB, NR = FRAMES * (chip_smoke.OBJS + 1), FRAMES * chip_smoke.OBJS   # every box and relation


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    rng = np.random.default_rng(1000)
    entries = [make_synthetic_entry(rng, n_frames=FRAMES, objs_per_frame=chip_smoke.OBJS,
                                    bucket_boxes=NB, bucket_rels=NR, feat_dim=FEAT)
               for _ in range(VIDEOS)]
    payload = chip_smoke.p19_payload(entries)
    conf = dict(chip_smoke.p19_conf("cpu"), feat=FEAT, frames=FRAMES, dec=1, steps=1,
                ar_reps=1)
    # the ranks run while this process computes the one-process references
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_job, "multicard", tmp_path_factory.mktemp("p19"), RANKS,
                          dict(payload, conf=conf), 2)
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            refs = chip_smoke.p19_references(torch.device("cpu"), conf, payload)
        finally:
            torch.set_num_threads(threads)
        res = ranks.result()
    return res, chip_smoke.p19_verdicts(res, refs, conf), refs, conf


@pytest.mark.parametrize("part", ["(ranks)", "(a)", "(b)", "(c)"])
def test_rank_body_passes_the_cards_checks(job, part):
    bad = [b for b in job[1] if b.startswith(part)]
    assert not bad, bad


def test_rank_body_ran_every_mesh(job):
    res = job[0]
    assert [x["backend"] for x in res] == ["gloo"] * RANKS
    meshes = res[0]["c"]
    assert set(meshes) == {"2x2", "1x4"} and "refused" not in meshes["2x2"]
    assert [x["c"]["2x2"]["mesh"] for x in res] == [(0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2),
                                                   (1, 1, 2, 2)]
    # the gradient's bytes crossed on both groups, the sums right
    assert all(x["a"]["ar"]["ok"] and x["a"]["grad_bytes"] > 0 for x in res)


def test_verdicts_flag_a_fault_in_each_part(job):
    """A rank on another backend, a parameter one step off, bytes staged
    through the host, a rank whose gathered 2 x 2 state differs: each part
    fails."""
    import copy

    res, _, refs, conf = job
    bad = copy.deepcopy(res)
    bad[1]["backend"] = "nccl"
    name = next(k for k, v in bad[0]["a"]["state"].items() if v.is_floating_point()
                and "running_" not in k)
    bad[0]["a"]["state"][name] = bad[0]["a"]["state"][name] + 10 * conf["lr"]
    bad[2]["b"]["staged"] = 64
    bad[3]["c"]["2x2"]["digest"] = "another"
    parts = {b.split(":")[0] for b in chip_smoke.p19_verdicts(bad, refs, conf)}
    assert parts == {"(ranks)", "(a)", "(b)", "(c)"}, parts


@pytest.mark.parametrize("seen", [0, 2])
def test_cards_refused_below_the_count(seen, monkeypatch, capsys):
    """--cards 4 with fewer cards visible (none here, or two): exit 1
    naming the count, before the build."""
    from nl_vsgg_tpu_torch.ops import _build

    def no_build(*a, **kw):
        raise AssertionError("the build ran")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: seen)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: seen > 0)
    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--cards", "4"])
    with pytest.raises(SystemExit) as e:
        chip_smoke.main()
    assert e.value.code == 1
    out = capsys.readouterr()
    assert f"--cards 4: {seen} CUDA card(s) visible" in out.err and out.out == ""
