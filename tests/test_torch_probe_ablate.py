"""The grouped-conv ablation probe's port (`nl_vsgg_tpu_torch.ops.
grouped_conv_ablate`, `nl_vsgg_tpu_torch.tools.probe_ablate`) on the CPU: each
variant's plain version (what the CPU takes) against the JAX probe's math on
the same numpy inputs, the block-major layout functions against the probe's
reshapes, and the CLI.

`full` and `bt-full` are held against `lax.conv_general_dilated` (VALID in
H, SAME in W, one group per 128 channels); `mm-only`, `mm1-only`,
`add-only` and `bt-mm1` against jnp transcriptions of the probe's kernel
bodies (tools/probe_pallas_ablate.py:47-84, :111-130) at one image a grid
step. Tolerances: float32 sums of up to 9 * 128 products in another order,
1e-5 of the output's largest magnitude (1e-6 absolute for add-only's sums of
0.001); bfloat16 inputs with fp32 sums rounded once on each side, one bf16
ulp (2^-7 relative, + 1e-3)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from nl_vsgg_tpu_torch.ops import grouped_conv_ablate as ga
from nl_vsgg_tpu_torch.tools import probe_ablate, timing

CB = 128
GEOMETRIES = [(2, 8, 16, 256), (1, 4, 8, 1024)]   # (N, H, W, C): 2 and 8 super-groups


def _steady_wall_clock(fn, n):
    """Runs the n calls as `timing.wall_clock` does, but reports a steady
    1 ms a call: a loaded CPU's timing noise can make the real clock retry
    or raise, which is not what these tests check."""
    for _ in range(n):
        fn()
    return None, 1e-3 * n


def _inputs(N, H, W, C, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H + 2, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, CB, C)) * 0.05).astype(np.float32)
    return x, w


def _assert_close(got, ref, dtype, rel=1e-5, atol=None):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=atol if atol is not None else rel * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-3)


def _probe_body(variant, xb, wb, hc, W):
    """The probe's kernel body for one grid step at tn = 1: xb (1, hc+2, W,
    cb) and wb (3, 3, cb, cb) -> (1, hc, W, cb) float32 (`make` for the NHWC
    variants, `make_bt` for bt-mm1)."""
    tn, cb = 1, xb.shape[-1]
    xf = xb.reshape(tn * (hc + 2) * W, cb)
    taps = [(1, 0)] + [(dh, dw) for dh in (0, 1, 2) for dw in (-1, 0, 1) if (dh, dw) != (1, 0)]
    if variant == "add-only":
        one = jnp.full((tn, hc + 2, W, cb), 0.001, jnp.float32)
        acc = None
        for dh, dw in taps:
            ow0, ow1 = max(0, -dw), W - max(0, dw)
            iw0, iw1 = max(0, dw), W - max(0, -dw)
            if (dh, dw) == (1, 0):
                acc = one[:, 1:1 + hc]
            else:
                acc = acc.at[:, :, ow0:ow1, :].add(one[:, dh:dh + hc, iw0:iw1, :])
        return acc
    if variant in ("mm-only", "mm1-only"):
        acc = jnp.zeros((xf.shape[0], cb), jnp.float32)
        for t in range(9 if variant == "mm-only" else 1):
            acc = acc + jnp.dot(xf, wb[t // 3, t % 3], preferred_element_type=jnp.float32)
        return acc[:tn * hc * W].reshape(tn, hc, W, cb)
    if variant == "bt-mm1":
        taps = taps[:1]
    acc = None
    for dh, dw in taps:                                     # full, bt-mm1
        p4 = jnp.dot(xf, wb[dh, dw + 1], preferred_element_type=jnp.float32).reshape(
            tn, hc + 2, W, cb)
        ow0, ow1 = max(0, -dw), W - max(0, dw)
        iw0, iw1 = max(0, dw), W - max(0, -dw)
        src = p4[:, dh:dh + hc, iw0:iw1, :]
        acc = src if (dh, dw) == (1, 0) else acc.at[:, :, ow0:ow1, :].add(src)
    return acc


def _probe_nhwc(variant, x, w, dtype):
    """The probe's kernel over its grid (N / tn, C / cb) at tn = 1, NHWC."""
    N, Hx, W, C = x.shape
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    out = [[_probe_body(variant, xj[n:n + 1, :, :, b * CB:(b + 1) * CB],
                        wj[..., b * CB:(b + 1) * CB], Hx - 2, W) for b in range(C // CB)]
           for n in range(N)]
    return jnp.concatenate([jnp.concatenate(row, -1) for row in out], 0).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_full_and_bt_full_match_lax_conv(geometry, dtype):
    N, H, W, C = geometry
    x, w = _inputs(*geometry)
    ref = lax.conv_general_dilated(jnp.asarray(x, dtype), jnp.asarray(w, dtype), (1, 1),
                                   ((0, 0), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   feature_group_count=C // CB,
                                   preferred_element_type=jnp.float32).astype(dtype)
    tx, tw = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w).to(
        getattr(torch, dtype))
    got = ga.grouped_conv_ablate(tx, tw, "full", tile_rows=2)
    assert got.shape == (N, H, W, C) and got.dtype == tx.dtype and got.is_contiguous()
    _assert_close(got, ref, dtype)
    xt, wt = ga.to_block_major(tx, tw)
    bt = ga.grouped_conv_ablate_bt(xt, wt, "bt-full")
    assert bt.shape == (C // CB, N, H, W, CB)
    _assert_close(ga.from_block_major(bt), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["full", "mm-only", "mm1-only", "add-only", "bt-mm1"])
def test_variants_match_the_probe_bodies(variant, dtype):
    N, H, W, C = GEOMETRIES[0]
    x, w = _inputs(N, H, W, C, seed=1)
    ref = _probe_nhwc(variant, x, w, dtype)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    if variant == "bt-mm1":
        xt, wt = ga.to_block_major(tx, tw)
        got = ga.from_block_major(ga.grouped_conv_ablate_bt(xt, wt, variant))
    else:
        got = ga.grouped_conv_ablate(tx, tw, variant)
    assert got.shape == (N, H, W, C)
    _assert_close(got, ref, dtype, atol=1e-6 if variant == "add-only" else None)


def test_add_only_counts_the_taps_in_bounds():
    x, w = (torch.from_numpy(a) for a in _inputs(1, 3, 8, 128))
    got = ga.grouped_conv_ablate(x, w, "add-only")
    np.testing.assert_allclose(got[0, 0, :, 0].numpy(), [0.006] + [0.009] * 6 + [0.006],
                               rtol=1e-6)
    assert (got == got[:, :, :, :1]).all()


def test_layouts_match_the_probe():
    N, H, W, C = GEOMETRIES[1]
    x, w = _inputs(N, H, W, C)
    nb = C // CB
    xt = np.asarray(jnp.asarray(x).reshape(N, H + 2, W, nb, CB).transpose(3, 0, 1, 2, 4))
    wt = np.asarray(jnp.asarray(w).reshape(3, 3, CB, nb, CB).transpose(0, 1, 3, 2, 4))
    gx, gw = ga.to_block_major(torch.from_numpy(x), torch.from_numpy(w))
    assert gx.is_contiguous() and gw.is_contiguous()
    np.testing.assert_array_equal(gx.numpy(), xt)
    np.testing.assert_array_equal(gw.numpy(), wt)
    out = np.asarray(jnp.asarray(xt).transpose(1, 2, 3, 0, 4).reshape(N, H + 2, W, C))
    np.testing.assert_array_equal(ga.from_block_major(gx).numpy(), out)
    np.testing.assert_array_equal(out, x)


def test_rejects_bad_arguments():
    x, w = (torch.from_numpy(a) for a in _inputs(1, 2, 8, 256))
    with pytest.raises(ValueError, match="variant"):
        ga.grouped_conv_ablate(x, w, "bt-full")
    with pytest.raises(ValueError, match="variant"):
        ga.grouped_conv_ablate_bt(*ga.to_block_major(x, w), "full")
    with pytest.raises(ValueError, match="expected x"):
        ga.grouped_conv_ablate(x[..., :200], w, "full")
    with pytest.raises(ValueError, match="halo"):
        ga.grouped_conv_ablate(x[:, :2], w, "full")
    with pytest.raises(TypeError):
        ga.grouped_conv_ablate(x, w.bfloat16(), "full")


def test_shared_memory_of_a_block():
    assert ga.smem_bytes(torch.bfloat16, 2, 64) == 2 * 136 * (128 + 4 * 66)
    assert ga.smem_bytes(torch.float32, 2, 64) <= ga.SMEM_LIMIT
    assert ga.smem_bytes(torch.float32, 4, 64) > ga.SMEM_LIMIT   # refused before launch
    for th in probe_ablate.TILE_ROWS:
        assert ga.smem_bytes(torch.bfloat16, th, 64) <= ga.SMEM_LIMIT


def test_run_on_cpu_at_a_small_size(monkeypatch):
    monkeypatch.setattr(timing, "wall_clock", _steady_wall_clock)
    lines = []
    rows = probe_ablate.run(iters=2, device="cpu", N=1, H=4, W=16, C=256, tile_rows=(1, 2),
                            log=lines.append)
    names = [r["name"] for r in rows]
    assert names[:6] == ["full rows1", "mm-only rows1", "mm1-only rows1", "add-only rows1",
                         "bt-full rows1", "bt-mm1 rows1"]
    assert len(names) == 2 * 6 + 3 and names[-3:] == ["row5-conv(g8)", "cudnn(g8)", "cudnn(g2)"]
    for r in rows:
        assert r["device_ms"] is None and r["rate"] is None and r["kernel"] is None
        assert r["host_ms"] == pytest.approx(1.0) and r["calls"] == 1 + 3 * 4 * 2
    by = {r["name"]: r for r in rows}
    assert by["full rows1"]["bound_ms"] > by["mm1-only rows1"]["bound_ms"] > \
        by["add-only rows1"]["bound_ms"] > 0
    assert len(lines) == len(rows) + 1


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(timing, "wall_clock", _steady_wall_clock)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_ablate.main(["--iters", "1"])
    run = probe_ablate.run
    monkeypatch.setattr(probe_ablate, "run", lambda iters, device: run(
        iters, device, N=1, H=2, W=8, C=128, tile_rows=(2,)))
    assert probe_ablate.main(["--iters", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "full rows2" in out and "bt-mm1 rows2" in out and "cudnn(g1)" in out
