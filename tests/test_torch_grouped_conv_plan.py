"""The grouped-conv kernels' tile plans (`ops.grouped_conv.tile_plan` for
the bf16 route, `tf32_plan` for the float32 "3xtf32" route), which the
wrapper computes on the host and hands to `csrc/grouped_conv.cu` as ints:
at every geometry class of the detector path and at the edge shapes, each
fits a block's shared memory, and the kernel's walk over it (blocks of a
slab taking tiles b, b + per_slab, ...; a tile's pixel q at image q // (TH
TW), row q // TW % TH, column q % TW of its origin; pixels outside the map
not stored) writes every output pixel of every channel exactly once. The
index arithmetic mirrors the kernel's `tile_origin` and epilogue.
`conv_route` picks the route as the C entries take them, and the 3xtf32
kernel's swizzled staging, fragment addresses and epilogue, emulated lane
by lane in numpy, compute the convolution and read shared memory without
bank conflicts."""

import os
import re

import numpy as np
import pytest
import torch

from nl_vsgg_tpu_torch.ops import _build, grouped_conv as gc

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


PATH = ((32, 152, 256, 256, 8), (32, 76, 128, 512, 16), (32, 38, 64, 1024, 32),
        (9600, 7, 7, 2048, 64))


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
    assert {"cp_async.cuh", "mma_bf16.cuh"} <= set(_build._sources(name))


@pytest.mark.parametrize("name", ["grouped_conv", "masked_attention"])
def test_kernels_hash_the_shared_tf32_header(name):
    """The grouped conv's 3xtf32 route and the attention's tiled and
    resident routes take their TF32 helpers from `csrc/mma_tf32.cuh`: an
    edit to it rebuilds both libraries, and neither source keeps its own
    copy."""
    assert "mma_tf32.cuh" in _build._sources(name)
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        src = f.read()
    assert "void split_tf32(" not in src and "void mma_tf32(" not in src


# ------------------------------------------------------------ 3xtf32 route
def _source():
    with open(os.path.join(_build.CSRC, "grouped_conv.cu")) as f:
        return f.read()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tf32_constants_match_the_source():
    """The plan's constants and rules, read back from the kernel source."""
    src = _source()
    assert _constant(src, "TF_ROW") == gc.TF32_ROW
    assert _constant(src, "STAGES") == gc.STAGES
    assert _constant(src, "SMEM_MAX") == gc.SMEM_LIMIT
    assert "return c == 64 ? 32 : SLAB;" in src and gc.BLOCK_C == _constant(src, "SLAB")
    assert "return 32 * 8 / (tf_block_c(c) / 32);" in src
    assert [gc.tf32_tile_pixels(c) for c in (8, 16, 32, 64)] == [128, 128, 128, 256]


@pytest.mark.parametrize("N,H,W,C", SHAPES)
def test_tf32_plan_fits_and_covers_every_output_once(N, H, W, C):
    c = C // 32
    plan = gc.tf32_plan(N, H, W, C, c, H100_SMS)
    whole = (plan["TH"], plan["TW"]) == (H, W)
    assert plan["smem"] == gc.tf32_smem_bytes(c, plan["TH"], plan["TW"], plan["NB"], whole)
    assert plan["smem"] <= gc.SMEM_LIMIT
    assert plan["TH"] * plan["TW"] * plan["NB"] <= gc.tf32_tile_pixels(c)
    assert plan["TW"] <= gc.TF32_TILE_COLS
    slabs = C // gc.tf32_block_channels(c)
    assert 1 <= plan["per_slab"] <= plan["tiles"]
    assert plan["per_slab"] * slabs <= max(H100_SMS, slabs)
    count, per_block = _writes(N, H, W, C, plan)
    assert (count == 1).all()
    assert max(per_block) - min(per_block) <= 1


def test_tf32_plan_at_the_path_geometry():
    """8 x 16 tiles in the trunk; in the head, half a group's channels a
    block and five whole 7x7 crops a tile (245 of 256 rows), staged without
    their zero border; one block an SM."""
    got = [gc.tf32_plan(N, H, W, C, c, H100_SMS) for N, H, W, C, c in PATH]
    assert [(p["TH"], p["TW"], p["NB"]) for p in got] == \
        [(8, 16, 1), (8, 16, 1), (8, 16, 1), (7, 7, 5)]
    assert [p["per_slab"] for p in got] == [33, 16, 8, 2]
    assert [p["tiles"] for p in got] == [32 * 19 * 16, 32 * 10 * 8, 32 * 5 * 4, 1920]
    assert [p["smem"] for p in got] == [110848, 129280, 166144, 199424]
    # a 64-channel block at c = 64 fits two stages of 2 crops (98 of its
    # 128 rows), not of 5
    assert 4 * (9 * 64 * 64 + 64 * (1 + 2 * 2 * 49)) <= gc.SMEM_LIMIT < \
        4 * (9 * 64 * 64 + 64 * (1 + 2 * 5 * 49))


def _on_cpu(shape, dtype, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype,C,c,offset,want", [
    (torch.bfloat16, 256, 8, 0, "tc"), (torch.bfloat16, 2048, 64, 0, "tc"),
    (torch.float32, 256, 8, 0, "3xtf32"), (torch.float32, 512, 16, 0, "3xtf32"),
    (torch.float32, 1024, 32, 0, "3xtf32"), (torch.float32, 2048, 64, 0, "3xtf32"),
    (torch.float32, 128, 4, 0, "fma"),          # a group width the tensor-core routes lack
    (torch.float32, 4096, 128, 0, "fma"),
    (torch.float32, 96, 8, 0, "fma"),           # C not a whole number of 64-channel slabs
    (torch.float32, 1024, 32, 1, "fma"),        # storage 4 bytes off 16-byte alignment
])
def test_conv_route(dtype, C, c, offset, want):
    x = _on_cpu((2, 5, 6, C), dtype, offset)
    w = _on_cpu((3, 3, c, C), dtype)
    assert gc.conv_route(x, w) == want


def _emulate_3xtf32(x, w, bias, plan, relu=True):
    """The 3xtf32 kernel, lane by lane: every block of the grid
    (`tf_block_c` channels, its tiles), `stage_tile_f32`'s swizzled copies
    (halo'd tiles, or whole images and the zero pixel), the lanes' A and B
    fragment addresses (`a_off`, `taps`, `row`, `sw`, `col`, `b_off`,
    `wk`), the m16n8k8 products in float64 and the epilogue. Returns (out,
    conflicts): conflicts counts shared-memory wavefronts beyond one for
    the A loads (8 bytes a lane, a half-warp a wavefront) and the B loads
    (4 bytes, the warp)."""
    N, H, W, C = x.shape
    CG = w.shape[2]
    BC = gc.tf32_block_channels(CG)
    WN = BC // 32
    WM = 8 // WN
    TH, TW, NB, tiles = plan["TH"], plan["TW"], plan["NB"], plan["tiles"]
    whole = (TH, TW) == (H, W)
    halo = 0 if whole else 1
    WT, HT = TW + 2 * halo, TH + 2 * halo
    tiles_w, tiles_h = -(-W // TW), -(-H // TH)
    KPT, GW = CG // 8, (32 // CG if CG < 32 else 1)
    NPG = 4 // GW
    KR = 9 * CG
    ZP = KR * BC
    lane = np.arange(32)
    g, tq = lane >> 2, lane & 3
    out = np.full((N, H, W, C), np.nan)
    conflicts = 0
    w2 = w.reshape(KR, C)

    def banks(addr, width):
        words = (addr[:, None] + np.arange(width)[None]) % 32
        return np.bincount(words.ravel(), minlength=32).max() - 1

    for by in range(C // BC):
        cs0 = by * BC
        xc0 = cs0 & ~63
        smem = np.full(ZP + 64 + NB * HT * WT * 64, np.nan)
        for r in range(KR):
            for v in range(BC // 4):
                dst = r * BC + ((v * 4) ^ (((r >> 1) & 3) << 3))
                smem[dst:dst + 4] = w2[r, cs0 + v * 4:cs0 + v * 4 + 4]
        smem[ZP:ZP + 64] = 0.0
        for t in range(tiles):
            w0 = (t % tiles_w) * TW
            h0 = ((t // tiles_w) % tiles_h) * TH
            n0 = (t // tiles_w // tiles_h) * NB
            sb = ZP + 64
            smem[sb:] = np.nan
            for px in range(NB * HT * WT):
                xx, yy, nb = px % WT, (px // WT) % HT, px // (WT * HT)
                n, h, ww = n0 + nb, h0 - halo + yy, w0 - halo + xx
                ok = n < N and 0 <= h < H and 0 <= ww < W
                sw = ((xx + (nb * TH + yy) * TW) & 3) << 3
                for v in range(16):
                    dst = sb + px * 64 + ((v * 4) ^ sw)
                    smem[dst:dst + 4] = x[n, h, ww, xc0 + v * 4:xc0 + v * 4 + 4] if ok else 0.0
            tile_px = NB * TH * TW
            for warp in range(8):
                wm, wn = warp % WM, warp // WM
                lc = 2 * tq + (wn * 32 if CG < 64 else 0)
                a_off = np.zeros((2, 2, 32), dtype=np.int64)
                taps = np.full((2, 2, 32), 0x1FF)
                for mi in range(2):
                    for hh in range(2):
                        q = wm * 32 + mi * 16 + hh * 8 + g
                        q = np.where(q >= tile_px, 0, q)
                        nb, r, col = q // (TH * TW), (q // TW) % TH, q % TW
                        a_off[mi, hh] = ((nb * HT + r) * WT + col
                                         - (WT + 1 if whole else 0)) * 64 + lc
                        if whole:
                            for tap in range(9):
                                y, xx = r + tap // 3 - 1, col + tap % 3 - 1
                                out_of = (y < 0) | (y >= TH) | (xx < 0) | (xx >= TW)
                                taps[mi, hh] &= np.where(out_of, ~(1 << tap), -1)
                b_off = [2 * tq * BC + (((wn * 32 + ni * 8) ^ (tq << 3)) + g)
                         for ni in range(4)]
                acc = np.zeros((2, 4, 16, 8))
                for tap in range(9):
                    dy, dx = tap // 3, tap % 3
                    shift = sb + (dy * WT + dx) * 64
                    sw = ((g + dx + dy * TW - (TW + 1 if whole else 0)) & 3) << 3
                    row = np.where((taps >> tap) & 1 == 1, a_off + shift, ZP + lc)
                    for gi in range(GW):
                        for kk in range(KPT):
                            col = (gi * CG + kk * 8) ^ sw
                            A = np.zeros((2, 16, 8))
                            for mi in range(2):
                                for hh in range(2):
                                    addr = row[mi, hh] + col
                                    for half in (0, 1):
                                        conflicts += banks(addr[16 * half:16 * half + 16], 2)
                                    A[mi, g + 8 * hh, tq] = smem[addr]          # column t: k 2t
                                    A[mi, g + 8 * hh, tq + 4] = smem[addr + 1]  # t + 4: k 2t + 1
                            wk = (tap * KPT + kk) * 8 * BC
                            for nn in range(NPG):
                                ni = gi * NPG + nn
                                B = np.zeros((8, 8))
                                for k, rr in ((tq, 0), (tq + 4, BC)):
                                    addr = wk + b_off[ni] + rr
                                    conflicts += banks(addr, 1)
                                    B[k, g] = smem[addr]
                                for mi in range(2):
                                    acc[mi, ni] += A[mi] @ B
                for mi in range(2):
                    for half in range(2):
                        q = wm * 32 + mi * 16 + half * 8 + g
                        for L in range(32):
                            if q[L] >= tile_px:
                                continue
                            n = n0 + q[L] // (TH * TW)
                            h, ww = h0 + (q[L] // TW) % TH, w0 + q[L] % TW
                            if n >= N or h >= H or ww >= W:
                                continue
                            for ni in range(4):
                                ch = cs0 + wn * 32 + tq[L] * 2 + ni * 8
                                v = acc[mi, ni, g[L] + 8 * half, 2 * tq[L]:2 * tq[L] + 2] \
                                    + bias[ch:ch + 2]
                                out[n, h, ww, ch:ch + 2] = np.maximum(v, 0) if relu else v
    return out, conflicts


@pytest.mark.parametrize("N,H,W,c", [(1, 10, 20, 8), (1, 9, 16, 16), (1, 8, 16, 32),
                                     (1, 5, 6, 32), (6, 7, 7, 64), (1, 9, 3, 64)])
def test_tf32_kernel_indexing_computes_the_conv(N, H, W, c):
    """The kernel's index arithmetic, emulated at C = 64 (one slab; two
    half-group blocks at c = 64): every output written once with the
    convolution of its group (float64 sums against the plain version's
    float32, 1e-5 of the max), on halo'd tiles (a ragged trunk-like map at
    each width, a tall narrow map at c = 64) and on whole-image tiles (six
    7x7 crops: a tile of five and one of one; 5x6 images); no bank
    conflicts where a tile's pixel rows are whole (8 x 16 tiles, 7x7
    crops)."""
    C = 64
    rng = np.random.default_rng(c)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, C)) * (9 * c) ** -0.5).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    plan = gc.tf32_plan(N, H, W, C, c, H100_SMS)
    out, conflicts = _emulate_3xtf32(x, w, bias, plan)
    ref = gc.grouped_conv3x3_reference(torch.from_numpy(x), torch.from_numpy(w), C // c,
                                       torch.from_numpy(bias), relu=True).numpy()
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if (H, W) in ((10, 20), (9, 16), (8, 16), (7, 7)):
        assert conflicts == 0
