"""The launch-overhead probe's port (`nl_vsgg_tpu_torch.tools.probe_overhead`)
on the CPU: the copy and matmul kernels' plain versions (what the CPU takes)
against the JAX probe's math on the same numpy inputs, the two-point timing
with a stub clock, the build cache's header hashing, and the CLI.

Tolerances: the copy is exact (doubling is exact in float32 and bfloat16).
The matmul: both sides sum the same bf16 products in float32 and round once
to bf16, so they may differ by one bf16 ulp (2^-7 relative, + 1e-3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu_torch.ops import _build
from nl_vsgg_tpu_torch.ops import probe_copy as pc
from nl_vsgg_tpu_torch.ops import probe_matmul as pm
from nl_vsgg_tpu_torch.tools import probe_overhead, timing

BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-3)


def _steady_wall_clock(fn, n):
    """Runs the n calls as `timing.wall_clock` does, but reports a steady
    1 ms a call: a loaded CPU's timing noise can make the real clock retry
    or raise, which is not what these tests check."""
    for _ in range(n):
        fn()
    return None, 1e-3 * n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 128), (8, 40, 64, 128), (1001,)])
def test_copy_matches_jax(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray((jnp.asarray(x, dtype) * 2.0).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pc.reset_launches()
    for units in (1, 8):
        got = pc.probe_copy(tx, units)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_array_equal(got.float().numpy(), ref)
    assert pc.LAUNCHES["probe_copy"] == 0       # the CPU runs the plain version


def test_copy_rejects_bad_arguments():
    with pytest.raises(TypeError):
        pc.probe_copy(torch.zeros(4, dtype=torch.float16))
    with pytest.raises(ValueError, match="units"):
        pc.probe_copy(torch.zeros(4), 0)


def test_matmul_matches_jax():
    rng = np.random.default_rng(0)                 # the probe's draws
    x = rng.standard_normal((20480, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 128)) * 0.05).astype(np.float32)
    ref = jnp.dot(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                  preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    got = pm.probe_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (20480, 128)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), **BF16_ULP)


def test_matmul_rejects_bad_arguments():
    x = torch.zeros(16, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected x"):
        pm.probe_matmul(x, torch.zeros(64, 128, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        pm.probe_matmul(x.float(), torch.zeros(128, 128))


def _stub_clock(device_per_call, host_per_call, log):
    def clock(fn, n):
        log.append(n)
        dev = None if device_per_call is None else 1e-4 + n * device_per_call
        return dev, 1e-4 + n * host_per_call
    return clock


def test_timed_delta_differences_the_fixed_cost():
    log, made = [], []
    t = timing.timed_delta(lambda: made.append(1), iters=10,
                           clock=_stub_clock(2e-5, 3e-6, log), k=3, reps=3, warmup=2)
    assert t.device_s == pytest.approx(2e-5, rel=1e-9)
    assert t.host_s == pytest.approx(3e-6, rel=1e-9)
    assert log == [10, 10, 10, 30, 30, 30]
    assert len(made) == 2 and t.calls == 2 + 3 * 4 * 10


def test_timed_delta_host_only_and_medians():
    log = []
    seq = iter([9.0, 0.5, 0.5, 1.5, 1.5, 0.0])      # one outlier in each window's three

    def clock(fn, n):
        log.append(n)
        return None, next(seq)
    t = timing.timed_delta(lambda: None, iters=5, clock=clock, warmup=0)
    assert t.device_s is None
    assert t.host_s == pytest.approx((1.5 - 0.5) / 10)


def test_timed_delta_raises_after_three_unstable_pairs():
    log = []

    def clock(fn, n):
        log.append(n)
        return 1.0, 1.0 + n * 1e-3                   # the device time does not grow with n
    with pytest.raises(RuntimeError, match="unstable after 3 attempts"):
        timing.timed_delta(lambda: None, iters=4, clock=clock, reps=2)
    assert len(log) == 3 * 2 * 2


def test_timed_delta_retries_an_unstable_pair():
    answers = iter([1.0, 1.0, 1.0, 1.0] + [1.0, 1.0, 3.0, 3.0])

    def clock(fn, n):
        return None, next(answers)
    t = timing.timed_delta(lambda: None, iters=1, clock=clock, reps=2, warmup=0)
    assert t.host_s == pytest.approx(1.0) and t.calls == 2 * (2 * 4 * 1)


def test_wall_clock_with_a_stub_clock():
    ticks = iter([10.0, 10.25])
    made = []
    dev, host = timing.wall_clock(lambda: made.append(1), 5, now=lambda: next(ticks))
    assert dev is None and host == 0.25 and len(made) == 5


def test_bound():
    t, by = timing.bound_s(3.35e12, 0.0, torch.bfloat16)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = timing.bound_s(1.0, 989e12 * 2, torch.bfloat16)
    assert t == pytest.approx(2.0) and by == "operations"


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\nint k;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert sorted(_build._sources("k")) == ["g.cuh", "h.cuh", "k.cu"]
    first = _build.library_path("k")
    (tmp_path / "g.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first      # an edited nested header rebuilds
    (tmp_path / "g.cuh").write_text("// v1\n")
    assert _build.library_path("k") == first


def test_new_sources_are_built_with_the_others():
    for name in ("probe_copy", "probe_matmul", "grouped_conv_ablate"):
        assert name in _build.SOURCES
    assert "mma_bf16.cuh" in _build._sources("probe_matmul")
    assert "mma_bf16.cuh" in _build._sources("grouped_conv_ablate")
    assert _build._sources("probe_copy") == ["probe_copy.cu"]


def test_run_on_cpu_at_a_small_size(monkeypatch):
    monkeypatch.setattr(timing, "wall_clock", _steady_wall_clock)
    lines = []
    rows = probe_overhead.run(iters=2, device="cpu", slab=(2, 6, 16, 128), mm_rows=256,
                              conv=(2, 6, 16, 256), log=lines.append)
    assert [r["name"] for r in rows] == ["tiny-copy", "slab-copy", "slab-copy-g8", "mm-kernel",
                                         "mm-torch", "conv-cudnn(g2)"]
    for r in rows:
        assert r["device_us"] is None and r["kernel"] is None
        assert r["host_us"] == pytest.approx(1e3)
        assert r["bound_us"] > 0 and r["calls"] == 1 + 3 * 4 * 2
    assert len(lines) == 7 and "cpu" in lines[0]


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(timing, "wall_clock", _steady_wall_clock)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_overhead.main(["--iters", "1"])
    assert probe_overhead.main(["--iters", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "tiny-copy" in out and "conv-cudnn(g8)" in out
