"""The probe kernels' launch plans on the CPU: the copy's unit-to-block
mapping (`ops.probe_copy.copy_plan`) and the packed conv's route and tiles
(`ops.grouped_conv_ablate.kernel_plan`), which the wrappers compute on the
host and hand to `csrc/probe_copy.cu` and `csrc/grouped_conv_ablate.cu`.

Each plan is walked here as its kernel walks it, and every element must be
written exactly once: the copy's thread g of a unit's T threads takes
vectors v0 + g + j T (j < DEPTH) and strides by DEPTH T, the tail past the
last vector going to the last unit's first block; the ring's block
(part, n, b) takes output rows [part * ceil(H / parts), ...) in tiles of
tile_rows, a warpgroup 64 pixels of a tile. The constants the
plans mirror are read back from the CUDA sources. The index arithmetic
mirrors the kernels'."""

import re

import numpy as np
import pytest
import torch

from nl_vsgg_tpu_torch.detector import attr_rcnn
from nl_vsgg_tpu_torch.ops import _build
from nl_vsgg_tpu_torch.ops import grouped_conv_ablate as ga
from nl_vsgg_tpu_torch.ops import probe_copy as pc
from nl_vsgg_tpu_torch.tools import probe_ablate

H100_SMS = 132


def _source(name):
    with open(f"{_build.CSRC}/{name}.cu") as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ------------------------------------------------------------- the copy
def test_copy_constants_mirror_the_kernel():
    src = _source("probe_copy")
    assert _constant(src, "THREADS") == pc.THREADS
    assert _constant(src, "DEPTH") == pc.DEPTH
    assert pc.CHUNK == pc.THREADS * pc.DEPTH
    assert re.search(r"constexpr bool BULK = false;", src) and pc.ROUTE == "loads"


def _copy_writes(n, dtype, units, plan):
    """How often the kernel's walk writes each element."""
    e, per, bpu = plan["elements_per_vector"], plan["per_unit"], plan["blocks_per_unit"]
    nvec = n // e
    hits = np.zeros(n, dtype=np.int64)
    t_all = bpu * pc.THREADS
    for u in range(units):
        v0 = per * u
        v1 = min(nvec, v0 + per)                        # a unit past the vectors: empty
        g = np.arange(t_all)
        for i0 in range(v0, v1, plan["depth"] * t_all):   # the strided passes
            for j in range(plan["depth"]):
                i = i0 + g + j * t_all
                i = i[i < v1]
                np.add.at(hits, (i[:, None] * e + np.arange(e)).ravel(), 1)
    tail = np.arange(nvec * e, n)                       # the last unit's first block
    assert len(tail) < e
    np.add.at(hits, tail, 1)
    return hits


@pytest.mark.parametrize("shape,dtype", [
    ((1,), torch.float32), ((7,), torch.bfloat16), ((1001,), torch.float32),
    ((1001,), torch.bfloat16), ((256, 128), torch.float32), ((8, 40, 64, 128), torch.bfloat16),
    ((3, 1000), torch.float32)])
@pytest.mark.parametrize("units", [1, 3, 8])
def test_copy_plan_writes_every_element_once(shape, dtype, units):
    n = int(np.prod(shape))
    plan = pc.copy_plan(n, dtype, units, H100_SMS)
    assert plan["grid"] == (plan["blocks_per_unit"], units)
    assert 1 <= plan["blocks_per_unit"] <= H100_SMS * pc.BLOCKS_PER_SM // units or \
        plan["blocks_per_unit"] == 1
    assert plan["tail"] == n % plan["elements_per_vector"]
    assert (_copy_writes(n, dtype, units, plan) == 1).all()


def test_copy_plan_at_the_probes_rows():
    """tiny-copy: at least a block an SM's share, one vector a thread;
    slab-copy and slab-copy-g8: DEPTH vectors a thread, the 8 units of g8
    together as many blocks as slab-copy's one."""
    tiny = pc.copy_plan(256 * 128, torch.float32, 1, H100_SMS)
    assert tiny["vectors"] == 8192 and tiny["blocks_per_unit"] == 8192 // pc.THREADS
    assert tiny["depth"] == 1
    slab = pc.copy_plan(8 * 40 * 64 * 128, torch.bfloat16, 1, H100_SMS)
    g8 = pc.copy_plan(8 * 40 * 64 * 128, torch.bfloat16, 8, H100_SMS)
    assert slab["blocks_per_unit"] == 327680 // pc.CHUNK and slab["depth"] == g8["depth"] == 2
    assert g8["per_unit"] == 40960 and 8 * g8["blocks_per_unit"] == slab["blocks_per_unit"]
    for plan in (tiny, slab, g8):
        assert plan["route"] == pc.ROUTE
        assert plan["units"] * plan["blocks_per_unit"] <= H100_SMS * pc.BLOCKS_PER_SM


def test_copy_plan_n_below_one_chunk_and_more_units_than_vectors():
    plan = pc.copy_plan(10, torch.float32, 8, H100_SMS)    # 2 vectors and a tail of 2
    assert plan["vectors"] == 2 and plan["per_unit"] == 1 and plan["tail"] == 2
    assert plan["blocks_per_unit"] == 1
    assert (_copy_writes(10, torch.float32, 8, plan) == 1).all()
    with pytest.raises(ValueError, match="units"):
        pc.copy_plan(10, torch.float32, 0, H100_SMS)
    with pytest.raises(ValueError, match="units"):
        pc.copy_plan(10, torch.float32, pc.MAX_UNITS + 1, H100_SMS)


# ------------------------------------------------------ the packed conv
def test_conv_constants_mirror_the_kernel():
    src = _source("grouped_conv_ablate")
    assert _constant(src, "WG_PIXELS") == ga.WG_PIXELS
    assert _constant(src, "RING_MAX_PIXELS") == ga.RING_MAX_PIXELS
    assert _constant(src, "MAX_W_STAGES") == ga.MAX_W_STAGES
    assert _constant(src, "SMEM_MAX") == ga.SMEM_LIMIT
    assert re.search(r"constexpr bool RING_BODY = true;", src)


def _ring_writes(N, H, W, C, plan):
    """How often the ring's blocks store each output (n, h, w, channel
    block of 128) of every image and super-group."""
    hits = np.zeros((N, H, W, C // ga.CB), dtype=np.int64)
    parts, th = plan["parts"], plan["tile_rows"]
    per_part = -(-H // parts)
    assert per_part == plan["rows_per_part"]
    groups = th * W // ga.WG_PIXELS                # warpgroups
    assert plan["threads"] == groups * 128
    for part in range(parts):
        r0, r1 = part * per_part, min(H, part * per_part + per_part)
        assert r0 < r1                                  # no part left empty
        for h0 in range(r0, r1, th):
            q = np.arange(groups * ga.WG_PIXELS)   # the warpgroups' pixels
            h, w = h0 + q // W, q % W
            keep = h < r1
            for n in range(N):
                for b in range(C // ga.CB):
                    np.add.at(hits, (n, h[keep], w[keep], b), 1)
    return hits


PROBE = (8, 38, 64, 1024)
EDGES = [(2, 7, 64, 512), (1, 7, 32, 512), (1, 38, 64, 256), (3, 5, 128, 256),
         (1, 1, 64, 128), (64, 9, 64, 256)]   # more images x super-groups than SMs


@pytest.mark.parametrize("geometry", [PROBE] + EDGES)
@pytest.mark.parametrize("tile_rows", [1, 2, 3, 4, 8])
def test_ring_plans_fit_and_write_every_output_once(geometry, tile_rows):
    N, H, W, C = geometry
    try:
        plan = ga.kernel_plan(torch.bfloat16, N, H, W, C, tile_rows, H100_SMS)
    except ValueError:                                  # neither route takes it
        assert (tile_rows * W) % 32 or tile_rows * W > 256
        return
    assert plan["smem"] <= ga.SMEM_LIMIT
    if plan["route"] != "ring":
        assert ((tile_rows * W) % 64 or W % 8
                or ga.ring_smem_bytes(tile_rows, W, 2) > ga.SMEM_LIMIT)
        return
    assert plan["smem"] == ga.ring_smem_bytes(tile_rows, W, plan["stages"]["taps"])
    assert plan["stages"]["rows"] == 2 * tile_rows + 2
    assert plan["grid"] == (plan["parts"], N, C // ga.CB)
    assert plan["parts"] * N * (C // ga.CB) <= max(H100_SMS, N * (C // ga.CB))
    assert (_ring_writes(N, H, W, C, plan) == 1).all()


def test_ring_plans_at_the_probes_tiles():
    """The probe's sweep runs on the ring, at most one block an SM (2 parts
    of 19 rows for 8 images x 8 super-groups), 3 tap slots where they fit."""
    N, H, W, C = PROBE
    for th in probe_ablate.TILE_ROWS:
        plan = ga.kernel_plan(torch.bfloat16, N, H, W, C, th, H100_SMS)
        assert plan["route"] == "ring" and plan["parts"] == 2
        assert plan["rows_per_part"] == 19 and 19 % th          # tiles that do not divide
        assert plan["threads"] == 2 * th * W      # a warpgroup a 64 pixels
        assert plan["stages"]["taps"] == (3 if th < 4 else 2)
    assert ga.kernel_plan(torch.bfloat16, N, H, W, C, 4, H100_SMS)["smem"] == (
        2 * 32768 + 10 * 64 * 256 + 256 + (2 * 2 + 2) * 8)


@pytest.mark.parametrize("dtype,tile_rows,W,route", [
    (torch.float32, 1, 64, "tile"), (torch.float32, 2, 64, "tile"),
    (torch.bfloat16, 1, 32, "tile"), (torch.bfloat16, 3, 32, "tile"),
    (torch.bfloat16, 2, 128, "tile"), (torch.bfloat16, 1, 128, "ring"),
    (torch.bfloat16, 2, 32, "ring"), (torch.bfloat16, 4, 32, "ring"),
    (torch.bfloat16, 3, 64, "ring"), (torch.bfloat16, 4, 64, "ring")])
def test_route_choice(dtype, tile_rows, W, route):
    x = torch.zeros(2, 9, W, 256, dtype=dtype)
    assert ga.route(x, tile_rows) == route
    xt, _ = ga.to_block_major(x, torch.zeros(3, 3, 128, 256, dtype=dtype))
    assert ga.route(xt, tile_rows, block_major=True) == route


def test_shapes_neither_route_takes_are_refused():
    with pytest.raises(ValueError, match="multiple of 32"):
        ga.kernel_plan(torch.bfloat16, 1, 7, 24, 256, 1, H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        ga.kernel_plan(torch.float32, 1, 7, 64, 256, 4, H100_SMS)
    with pytest.raises(ValueError, match="tile_rows"):
        ga.kernel_plan(torch.bfloat16, 1, 7, 64, 256, 0, H100_SMS)


@pytest.mark.parametrize("tile_rows", [1, 2])    # the tile route, then the ring
def test_misaligned_storage_is_refused_before_launch(monkeypatch, tile_rows):
    """A view 2 bytes into its storage is refused before any CUDA call."""
    monkeypatch.setattr(_build, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(ga, "_fn", lambda: pytest.fail("the kernel was reached"))
    flat = torch.zeros(1 + 2 * 12 * 32 * 128, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ga._launch(flat[1:].view(2, 12, 32, 128), w, "full", tile_rows, False)


# ---------------------------------------------------- preprocess's device
def test_preprocess_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 48, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attr_rcnn.preprocess(img)
    out, _, _ = attr_rcnn.preprocess(img, device="cpu")
    assert out.device.type == "cpu"
