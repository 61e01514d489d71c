"""The bf16 grouped-conv kernel's tile plan (`ops.grouped_conv.tile_plan`),
which the wrapper computes on the host and hands to `csrc/grouped_conv.cu`
as ints: at every geometry class of the detector path and at the edge
shapes, it fits a block's shared memory, and the kernel's walk over it
(blocks of a slab taking tiles b, b + per_slab, ...; a tile's pixel q at
image q // (TH TW), row q // TW % TH, column q % TW of its origin; pixels
outside the map not stored) writes every output pixel of every channel
exactly once. The index arithmetic mirrors the kernel's `tile_origin` and
epilogue."""

import numpy as np
import pytest

from nl_vsgg_tpu_torch.ops import grouped_conv as gc

H100_SMS = 132

SHAPES = [  # (N, H, W, C), groups 32
    (32, 152, 256, 256),    # stage 2, c = 8
    (32, 76, 128, 512),     # stage 3, c = 16
    (32, 38, 64, 1024),     # stage 4, c = 32
    (9600, 7, 7, 2048),     # C5 head crops, c = 64
    (1201, 7, 7, 2048),     # a crop count not a multiple of the tile's crops
    (2, 38, 50, 1024),      # a width not a multiple of the tile's columns
    (5, 9, 13, 256),        # small whole images, several a tile
    (2, 1, 70, 512),        # one row, a ragged column block
    (1, 300, 2, 2048),      # a tall narrow map: the plan shrinks to fit
]


def _writes(N, H, W, C, plan):
    """How often the kernel's walk stores each (n, h, w) of one slab, and
    the blocks' tile counts."""
    TH, TW, NB, tiles, per_slab = (plan[k] for k in ("TH", "TW", "NB", "tiles", "per_slab"))
    tiles_w, tiles_h = -(-W // TW), -(-H // TH)
    walked = [list(range(b, tiles, per_slab)) for b in range(per_slab)]
    t = np.concatenate([np.asarray(ts, dtype=np.int64) for ts in walked])
    q = np.arange(NB * TH * TW, dtype=np.int64)
    w0 = (t % tiles_w) * TW
    h0 = ((t // tiles_w) % tiles_h) * TH
    n0 = (t // tiles_w // tiles_h) * NB
    n = n0[:, None] + q[None] // (TH * TW)
    h = h0[:, None] + (q[None] // TW) % TH
    w = w0[:, None] + q[None] % TW
    keep = (n < N) & (h < H) & (w < W)
    count = np.zeros((N, H, W), dtype=np.int64)
    np.add.at(count, (n[keep], h[keep], w[keep]), 1)
    return count, [len(ts) for ts in walked]


@pytest.mark.parametrize("N,H,W,C", SHAPES)
def test_plan_fits_and_covers_every_output_once(N, H, W, C):
    c = C // 32
    plan = gc.tile_plan(N, H, W, C, c, H100_SMS)
    assert plan["smem"] == gc.tile_smem_bytes(c, plan["TH"], plan["TW"], plan["NB"])
    assert plan["smem"] <= gc.SMEM_LIMIT
    assert plan["TH"] * plan["TW"] * plan["NB"] <= gc.TILE_PIXELS
    assert plan["TW"] <= gc.TILE_COLS
    # a slab's blocks and the slabs share the SMs: one wave of persistent blocks
    assert 1 <= plan["per_slab"] <= plan["tiles"]
    assert plan["per_slab"] * (C // gc.BLOCK_C) <= max(H100_SMS, C // gc.BLOCK_C)
    count, per_block = _writes(N, H, W, C, plan)
    assert (count == 1).all()
    assert max(per_block) - min(per_block) <= 1      # the tiles split evenly
    # the slabs of BLOCK_C channels cover C once
    assert C % gc.BLOCK_C == 0


def test_plan_shapes_at_the_path_geometry():
    """The tiles the source note names: 4 x 64 strips in the trunk, 5 whole
    7x7 crops in the head, and one block an SM (132 / slabs)."""
    got = {c: gc.tile_plan(N, H, W, C, c, H100_SMS) for N, H, W, C, c in
           ((32, 152, 256, 256, 8), (32, 76, 128, 512, 16), (32, 38, 64, 1024, 32),
            (9600, 7, 7, 2048, 64))}
    assert [(p["TH"], p["TW"], p["NB"]) for p in got.values()] == \
        [(4, 64, 1), (4, 64, 1), (4, 64, 1), (7, 7, 5)]
    assert [p["per_slab"] for p in got.values()] == [33, 16, 8, 4]
    # weights: 9 c rows (c = 8 padded to 80) of 72 bf16
    assert [gc.tile_smem_bytes(c, 1, 1, 0) for c in (8, 16, 32, 64)] == \
        [80 * 144, 144 * 144, 288 * 144, 576 * 144]


@pytest.mark.parametrize("name", ["grouped_conv", "probe_matmul"])
def test_kernels_hash_the_shared_staging_header(name):
    """Both cp.async-staged kernels include `csrc/cp_async.cuh`, which includes
    `csrc/mma_bf16.cuh`: an edit to either header rebuilds them."""
    from nl_vsgg_tpu_torch.ops import _build
    assert {"cp_async.cuh", "mma_bf16.cuh"} <= set(_build._sources(name))
