"""The host-side choices the wrappers make before a launch, on the CPU:
RoIAlign's kernel plan (`ops.roi_align.kernel_plan`: its route and the
shared memory a block takes, which holds the roi's axis samples and not its
map window, so the worst window, a roi over the whole 38 x 64 C4 map, takes
no more than any other), the attention kernels' routes (`dq_route`,
`fwd_route`, `dkv_route` on two rules: `staged_layout`, the staged routes
for the serving and training paths' 16-byte aligned bf16 column blocks of
the fused projection; `resident_layout`, the forward's resident route for
float32 ones with Lk and D up to 128, any number of heads, CLIP's towers;
`tiled_layout`, the tiled routes for float32 ones up to D = 320, DSG-DETR's
tracklet heads of 297; the per-element routes for offset views, bf16 odd
head dims, rows that are not whole 16-byte pieces and more than 8 heads),
the tiled and resident rules against the ones the CUDA source states, the
staged forward's and dK/dV's block plans (`fwd_plan`, `dkv_plan`: shared
memory within a block's limit, 16-row tiles and head groups covering every
row and head once), the tiled and resident plans, and the tiled kernels'
row order (`row_order`)."""

import os
import re

import numpy as np
import pytest
import torch

from nl_vsgg_tpu_torch.ops import masked_attention as ma
from nl_vsgg_tpu_torch.ops import roi_align as ra

SM_SHARED = 233472          # an H100 SM's shared memory (228 KB)
BLOCK_RESERVED = 1024       # reserved by the system for each resident block


@pytest.mark.parametrize("output_size,S", [((14, 14), 2), ((14, 14), 4), ((7, 7), 1),
                                           ((7, 7), 4), ((64, 64), 4)])
def test_roi_align_plan_fits_at_the_whole_map(output_size, S):
    plan = ra.kernel_plan(1024, output_size, S)
    assert plan["fits"] and plan["route"] == "vec8"
    ph, pw = output_size
    assert plan["smem"] == ra.BIN_BYTES * (ph + pw) <= ra.TAP_SMEM_MAX
    # at least two blocks an SM by shared memory, threads allowing
    assert SM_SHARED // (plan["smem"] + BLOCK_RESERVED) >= 2
    assert 2048 // plan["threads"] >= 2


def test_roi_align_plan_routes_and_limits():
    assert ra.kernel_plan(1020, (14, 14), 2)["route"] == "scalar"     # C % 8 != 0
    assert ra.kernel_plan(1000, (14, 14), 2)["route"] == "vec8"       # 1000 = 125 x 8
    assert ra.kernel_plan(1024, (14, 14), 2, aligned=False)["route"] == "scalar"
    assert ra.kernel_plan(8, (7, 7), 2)["route"] == "vec8"
    assert not ra.kernel_plan(1024, (14, 14), 5)["fits"]              # S > 4
    assert not ra.kernel_plan(1024, (14, 14), 0)["fits"]
    assert not ra.kernel_plan(1024, (361, 362), 1)["fits"]            # table > 48 KB
    assert ra.kernel_plan(1024, (361, 361), 1)["fits"]


def _fused(B, L, H, D, dtype=torch.bfloat16, pad=0):
    """q, k, v as column blocks of a (B, L, 3 H D + pad) projection."""
    E = H * D
    x = torch.zeros(B, L, 3 * E + pad, dtype=dtype)
    return tuple(x[..., pad + i * E:pad + (i + 1) * E].unflatten(-1, (H, D)) for i in range(3))


def test_dq_route_staged_on_the_path_column_blocks():
    for lq, lk in ((96, 96), (192, 192), (96, 192)):
        q, _, _ = _fused(4, lq, 8, 242)
        _, k, v = _fused(4, lk, 8, 242)
        g = torch.zeros(4, lq, 8, 242, dtype=torch.bfloat16)
        assert ma.dq_route(q, k, v, g) == "staged"
    assert ma.dq_staged_smem_bytes(192, 8, 242) == 39488 <= ma.STAGED_SMEM_MAX


@pytest.mark.parametrize("case", ["offset-view", "odd-D", "odd-D-odd-row", "fp32", "16-heads",
                                  "odd-row", "long-Lk"])
def test_dq_route_per_element(case):
    H, D, dtype, pad, lk = 8, 242, torch.bfloat16, 0, 192
    if case == "offset-view":
        pad = 1                       # every row starts 2 bytes past 16
    elif case == "odd-D":
        D = 241                       # a head's slice off 4 bytes (its bf16 pairs)
    elif case == "odd-D-odd-row":
        H, D = 4, 241                 # rows of 964 bf16: not whole 16-byte pieces
    elif case == "fp32":
        dtype = torch.float32
    elif case == "16-heads":
        H, D = 16, 64
    elif case == "odd-row":
        H = 3                         # 3 * 242 * 2 bytes is not whole 16-byte pieces
    else:
        lk = 32768                    # the key list overflows two blocks an SM
    q, k, v = _fused(2, lk, H, D, dtype, pad)
    g = torch.zeros(q.shape, dtype=dtype)
    # the staged route refuses each; float32 column blocks go to the tiled one
    assert ma.dq_route(q, k, v, g) == ("tiled" if case == "fp32" else "per-element")


@pytest.mark.parametrize("H,D", [(3, 64), (8, 240), (5, 80)])
def test_dq_route_staged_where_whole_rows_line_up(H, D):
    """A head's slice need not start on 16 bytes: 3 heads of 64, 8 of 240,
    5 of 80 (rows of whole 16-byte pieces, even D) still stage whole rows."""
    q, k, v = _fused(2, 20, H, D)
    assert ma.dq_route(q, k, v, torch.zeros(q.shape, dtype=torch.bfloat16)) == "staged"


_ROUTES = {"fwd": lambda q, k, v, g: ma.fwd_route(q, k, v), "dkv": ma.dkv_route,
           "dq": ma.dq_route}


@pytest.mark.parametrize("kind", ["fwd", "dkv"])
@pytest.mark.parametrize("lq,lk", [(96, 96), (192, 192), (96, 192)])
def test_staged_routes_on_the_path_column_blocks(kind, lq, lk):
    q, _, _ = _fused(4, lq, 8, 242)
    _, k, v = _fused(4, lk, 8, 242)
    g = torch.zeros(4, lq, 8, 242, dtype=torch.bfloat16)
    assert _ROUTES[kind](q, k, v, g) == "staged"


@pytest.mark.parametrize("kind", ["fwd", "dkv"])
@pytest.mark.parametrize("case", ["offset-view", "odd-D", "odd-D-odd-row", "fp32", "16-heads",
                                  "odd-row", "3-heads", "tracklet-297", "even-298"])
def test_staged_routes_per_element(kind, case):
    """The forward and dK/dV staged routes refuse what the dQ one refuses
    (one rule, `staged_layout`): offset views, odd D, rows that are not
    whole 16-byte pieces, fp32 (which the tiled routes take), more than 8
    heads, D above 256 (DSG-DETR's tracklet heads of 297; 298 is even but
    past the staged kernels' 16 k-steps)."""
    H, D, dtype, pad = 8, 242, torch.bfloat16, 0
    if case == "offset-view":
        pad = 1
    elif case == "odd-D":
        D = 241
    elif case == "odd-D-odd-row":
        H, D = 4, 241
    elif case == "fp32":
        dtype = torch.float32
    elif case == "16-heads":
        H, D = 16, 64
    elif case in ("odd-row", "3-heads"):
        H = 3
    elif case == "tracklet-297":
        D = 297
    elif case == "even-298":
        D = 298
    q, k, v = _fused(2, 96, H, D, dtype, pad)
    g = torch.zeros(q.shape, dtype=dtype)
    want = "tiled" if case == "fp32" else "per-element"
    assert _ROUTES[kind](q, k, v, g) == want
    assert ma.dq_route(q, k, v, g) == want


@pytest.mark.parametrize("kind", ["fwd", "dkv"])
@pytest.mark.parametrize("H,D", [(3, 64), (8, 240), (5, 80)])
def test_staged_routes_where_whole_rows_line_up(kind, H, D):
    q, k, v = _fused(2, 20, H, D)
    assert _ROUTES[kind](q, k, v, torch.zeros(q.shape, dtype=torch.bfloat16)) == "staged"


@pytest.mark.parametrize("plan", ["fwd", "dkv"])
@pytest.mark.parametrize("L", [1, 96, 97, 192, 256])
@pytest.mark.parametrize("H,D", [(8, 242), (8, 256), (3, 64), (5, 80)])
def test_tile_plans_fit_shared_memory(plan, L, H, D):
    """Every plan at Lq, Lk in {1, 96, 97, 192, 256} fits a block's shared
    memory (227 KB), and its tiles cover every row exactly once, the last
    one short where the 16-row tile does not divide L; its head groups
    cover every head once."""
    for other in (1, 96, 97, 192, 256):
        p = ma.fwd_plan(L, other, H, D) if plan == "fwd" else ma.dkv_plan(other, L, H, D)
        assert p["fits"] and p["smem"] + p["static_smem"] <= ma.BLOCK_SMEM_MAX == 232448
        assert p["rows"] == ma.TILE_ROWS == 16 and p["threads"] <= 1024
        covered = [0] * L
        for t in range(p["tiles"]):
            for row in range(t * p["rows"], min(L, (t + 1) * p["rows"])):
                covered[row] += 1
        assert covered == [1] * L
        heads = [h for grp in range(p["head_groups"])
                 for h in range(grp * ma.HEAD_GROUP, min(H, (grp + 1) * ma.HEAD_GROUP))]
        assert heads == list(range(H))


def test_plans_at_the_path_shapes_and_overflow():
    """At the path's shapes the forward's blocks (4 warps a head) and dK/dV's
    (2 warps a head) fit three an SM with their partial sums (4 KB each); a
    key list or per-query table past a block's shared memory takes the
    per-element route."""
    fwd, dkv = ma.fwd_plan(192, 192, 8, 242), ma.dkv_plan(192, 192, 8, 242)
    row = 504 * 2                 # 2 heads of 242 and 8 elements, rounded to 8 mod 16
    assert fwd["smem"] == 48 * row + 192 * 6 and fwd["static_smem"] == 256 * 16 + 8 * 4
    assert dkv["smem"] == 64 * row + 192 * 2 * 12 + 192 * 6
    assert dkv["static_smem"] == 128 * 2 * 16 + 4 * 4
    for p in (fwd, dkv):
        assert 3 * (p["smem"] + p["static_smem"] + BLOCK_RESERVED) <= SM_SHARED
    assert (fwd["tiles"], fwd["head_groups"], fwd["threads"], dkv["threads"]) == (12, 4, 256, 128)
    assert not ma.fwd_plan(96, 65536, 8, 242)["fits"]     # the key list overflows
    assert not ma.dkv_plan(8192, 96, 8, 242)["fits"]      # the per-query stats overflow
    q, k, v = _fused(1, 8192, 8, 242)
    assert ma.dkv_route(q, k, v, torch.zeros(q.shape, dtype=torch.bfloat16)) == "per-element"


@pytest.mark.parametrize("density", ["same-class", "all"])
def test_plans_hold_a_dense_union(density):
    """DSG-DETR's global layers at 96x96: every 16-row tile's union of
    allowed keys (queries) is the whole 96 (a key of each class lies in
    every tile), and about 32 keys a row. The plans reserve a list slot and
    a 16-bit row word for each of the Lk keys (Lq queries) whatever the
    density, so a dense union is listed whole, and chunks of CHUNK_ROWS
    walk it in ceil(96 / 8) steps."""
    L, H, D = 96, 8, 242
    cls = torch.arange(L) % 3
    allow = cls[:, None] == cls[None, :]
    if density == "all":
        allow = torch.ones(L, L, dtype=torch.bool)
    tiles = allow.unflatten(0, (L // ma.TILE_ROWS, ma.TILE_ROWS))
    unions = tiles.any(1).sum(-1)
    assert (unions == L).all() and ma.TILE_ROWS <= 16
    eg = ma._shared_row(H, D)
    for plan, ring in ((ma.fwd_plan(L, L, H, D), ma.TILE_ROWS + 2 * ma.FWD_CHUNKS * ma.CHUNK_ROWS),
                       (ma.dkv_plan(L, L, H, D),
                        2 * ma.TILE_ROWS + 2 * ma.DKV_CHUNKS * ma.CHUNK_ROWS)):
        assert plan["fits"]
        rest = plan["smem"] - ring * eg * 2     # what is left past the staged rows
        assert rest >= L * (4 + 2)              # an int32 slot and a row word a key
    assert ma.dq_staged_smem_bytes(L, H, D) >= L * 4


# ------------------------------------------------------------ tiled routes
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("case,H,D,dtype,pad,L,route", [
    ("tracklet-8-heads-of-297", 8, 297, torch.float32, 0, 128, "tiled"),
    ("2-heads-of-320", 2, 320, torch.float32, 0, 96, "tiled"),
    ("odd-D-8-heads-of-241", 8, 241, torch.float32, 0, 97, "tiled"),
    ("fp32-path-heads-of-242", 8, 242, torch.float32, 0, 192, "tiled"),
    ("one-row", 8, 297, torch.float32, 0, 1, "tiled"),
    ("bf16-297", 8, 297, torch.bfloat16, 0, 128, "per-element"),
    ("misaligned-view", 8, 297, torch.float32, 1, 128, "per-element"),
    ("16-heads", 16, 64, torch.float32, 0, 96, "per-element"),
    ("odd-row-3-heads-of-297", 3, 297, torch.float32, 0, 96, "per-element"),
    ("long-L", 8, 297, torch.float32, 0, 32768, "per-element")])
def test_tiled_route_choices(kind, case, H, D, dtype, pad, L, route):
    """The tiled routes take float32 column blocks of a fused projection up
    to D = 320, odd D too (the tracklet encoder's: a token stride of 3 x
    2376 floats, blocks 9504 bytes apart); not bfloat16 (the staged or
    per-element route), a view 4 bytes off 16, rows that are not whole
    16-byte pieces, more than 8 heads, or a column list past a block's
    shared memory."""
    q, k, v = _fused(2, L, H, D, dtype, pad)
    g = torch.zeros(q.shape, dtype=dtype)
    if case == "16-heads" and kind == "fwd":
        route = "resident"            # the forward's resident route takes any number of heads
    assert _ROUTES[kind](q, k, v, g) == route
    if case.startswith("tracklet"):
        assert q.stride(1) == 3 * 2376 and (k.data_ptr() - q.data_ptr()) == 9504


def _cu_source():
    with open(os.path.join(os.path.dirname(ma._build.CSRC), "csrc", "masked_attention.cu")) as f:
        return f.read()


def _cu_int(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tiled_constants_match_the_kernel():
    """The wrapper's tiled constants are the CUDA source's."""
    src = _cu_source()
    assert _cu_int(src, "TT") == ma.TILED_ROWS
    assert _cu_int(src, "TCK") == ma.TILED_CHUNK
    assert _cu_int(src, "TSTAGES") == ma.TILED_CHUNKS
    assert _cu_int(src, "TPARTS") == ma.TILED_PARTS
    assert _cu_int(src, "WT_LD") == ma._WT_LD
    assert _cu_int(src, "WARPS") == ma.TILED_MAX_HEADS
    assert _cu_int(src, "DMAX") == ma._MAX_HEAD_DIM
    # a staged row, as `tiled_row`: the widest window, 4 mod 8 floats
    assert "return ((D + 6) & ~3) | 4;" in src
    for D in (1, 64, 241, 242, 297, 298, 320):
        w = ma.tiled_row(D)
        assert w % 8 == 4 and w >= D + 3 and w >= ((D + 6) & ~3) >= w - 4


def _kernel_refuses(src, name="tiled_refuses"):
    """`name` (`tiled_refuses` or `resident_refuses`) of the CUDA source as a
    Python function of (dtype code, B, Lq, Lk, H, D, pointer offsets, or-ed
    strides): its return expression evaluated with the source's `bad_shape`
    and its integer constants."""
    body = re.search(rf"bool {name}\(.*?\{{(.*?)\n\}}", src, re.S).group(1)
    expr = re.search(r"return (.*?);", body, re.S).group(1)
    expr = " ".join(expr.split()).replace("||", " or ").replace("!=", " != ")
    bad = re.search(r"bool bad_shape\(.*?\{\s*return (.*?);", src, re.S).group(1)
    bad = " ".join(bad.split()).replace("||", " or ")
    consts = {n: int(x) for n, x in re.findall(r"constexpr int (\w+) = (\d+);", src)}

    def refuses(dtype, B, Lq, Lk, H, D, ptrs, strides):
        env = dict(consts, dtype=dtype, B=B, Lq=Lq, Lk=Lk, H=H, D=D, strides=strides,
                   off=any(p % 16 for p in ptrs))
        env["bad_shape"] = lambda B, Lq, Lk, H, D: eval(bad, {}, dict(env, B=B, Lq=Lq, Lk=Lk,
                                                                      H=H, D=D))
        return bool(eval(expr, {}, env))
    return refuses


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [0, 1, 4])
def test_tiled_rule_agrees_with_the_kernel(dtype, pad):
    """`tiled_layout` takes exactly what the kernel's `tiled_refuses` does
    not, over head counts, head dims (odd, up to 320) and views: the rule
    in Python and the one the CUDA entries apply are the same."""
    refuses = _kernel_refuses(_cu_source())
    checked = 0
    for H in (1, 2, 3, 4, 8, 9, 16):
        for D in (1, 2, 63, 64, 241, 242, 255, 297, 298, 320):
            q, k, v = _fused(2, 5, H, D, dtype, pad)
            tensors = (q, k, v)
            strides = 0
            for t in tensors:
                strides |= t.stride(0) | t.stride(1)
            code = ma._DTYPES[dtype]
            # strides in elements on both sides: the kernel's % 4 is on float offsets
            kernel_takes = not refuses(code, 2, 5, 5, H, D, [t.data_ptr() for t in tensors],
                                       strides)
            assert ma.tiled_layout(tensors) == kernel_takes, (H, D, pad, dtype)
            checked += kernel_takes
    assert (checked > 0) == (dtype == torch.float32 and pad % 4 == 0)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("L", [1, 96, 97, 128, 256])
@pytest.mark.parametrize("D", [64, 241, 297, 320])
def test_tiled_plans_fit_and_cover(kind, L, D):
    """Each tiled plan (4 warps a block) fits a block's shared memory at L
    in {1, 96, 97, 128, 256}, with room for the forward's 5 and the
    backward's 3 resident blocks an SM at the tracklet shapes, and its
    tiles take every place of the row order exactly once, the last one
    short where 16 does not divide L."""
    for other in (1, 96, 97, 128, 256):
        lq, lk = (L, other) if kind != "dkv" else (other, L)
        p = ma.tiled_plan(kind, lq, lk, D)
        assert p["fits"] and p["smem"] + p["static_smem"] <= ma.BLOCK_SMEM_MAX
        assert p["threads"] == 128
        covered = [0] * L
        for t in range(p["tiles"]):
            for place in range(t * p["rows"], min(L, (t + 1) * p["rows"])):
                covered[place] += 1
        assert covered == [1] * L
    p = ma.tiled_plan(kind, 128, 128, 297)
    blocks = 5 if kind == "fwd" else 3
    assert blocks * (p["smem"] + p["static_smem"] + BLOCK_RESERVED) <= SM_SHARED
    ring = 8 * 300 * 4 * 2            # 1 stage of 8 columns' two 300-float rows
    tile = 16 * 300 * 4 * (1 if kind == "fwd" else 2)
    assert p["smem"] == ring + tile + 128 * 6 + (128 * 12 if kind == "dkv" else 0)
    sums = 1 if kind == "fwd" else 2
    assert p["static_smem"] == 16 + 64 + sums * (128 * 16 + 4 * 16 * 12 * 4)


def test_tiled_plans_refuse_an_overflowing_list():
    assert not ma.tiled_plan("fwd", 96, 65536, 297)["fits"]
    assert not ma.tiled_plan("dq", 96, 65536, 297)["fits"]
    assert not ma.tiled_plan("dkv", 16384, 96, 297)["fits"]     # the per-query stats
    assert ma.tiled_plan("dkv", 96, 16384, 297)["fits"]         # key rows are tiles


def _tracklet_mask(rng, B, L, groups):
    """Same-group masks: each valid row of a video in one of `groups`
    groups, drawn at random places (rows of a group are not neighbours),
    some rows padding (allowed nothing)."""
    gid = rng.integers(0, groups, (B, L))
    valid = rng.random((B, L)) < 0.9
    allow = (gid[:, :, None] == gid[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    return torch.from_numpy(allow), gid, valid


@pytest.mark.parametrize("L,groups", [(128, 4), (97, 3), (16, 1), (40, 40)])
def test_row_order_groups_rows(L, groups):
    """`row_order` is a permutation of each video's rows; rows with the
    same first allowed column are neighbours, in their own order (stable);
    rows that allow nothing come last; the tiles of 16 places take every
    row once, and on same-group masks every tile's union of allowed columns
    is at most its rows' groups: a tile of one group stages that group's
    columns and nothing else."""
    rng = np.random.default_rng(L + groups)
    B = 3
    allow, gid, valid = _tracklet_mask(rng, B, L, groups)
    order = ma.row_order(allow)
    assert order.shape == (B, L) and order.dtype == torch.int64
    for b in range(B):
        o = order[b].tolist()
        assert sorted(o) == list(range(L))
        a = allow[b].numpy()
        first = [int(np.argmax(a[i])) if a[i].any() else L for i in o]
        assert first == sorted(first)                        # grouped by first column
        for i, j in zip(o, o[1:]):
            if first[o.index(i)] == first[o.index(j)]:
                assert i < j                                 # stable
        n_empty = int((~a.any(1)).sum())
        assert all(not a[i].any() for i in o[L - n_empty:])  # empty rows last
        covered = [0] * L
        for t in range(-(-L // ma.TILED_ROWS)):
            rows = o[t * ma.TILED_ROWS:(t + 1) * ma.TILED_ROWS]
            for i in rows:
                covered[i] += 1
            union = a[rows].any(0)
            tile_groups = {gid[b, i] for i in rows if valid[b, i]}
            members = valid[b] & np.isin(gid[b], list(tile_groups))
            assert (union <= members).all() and (union == members).all()
        assert covered == [1] * L


def test_row_order_on_the_tracklet_masks_fills_tiles_with_one_tracklet():
    """The tracklet encoder's masks (`chip_smoke.py` phase 12's shape: 128
    boxes, a person and 3 objects in each of 32 frames, boxes of one slot
    in one group): the order puts 16 rows of one group in each tile, so
    each tile's union is exactly its group's 32 columns and every staged
    column serves all 16 rows."""
    L = 128
    gid = torch.arange(L) % 4
    allow = (gid[:, None] == gid[None, :]).expand(2, L, L).clone()
    order = ma.row_order(allow)
    for t in range(L // ma.TILED_ROWS):
        rows = order[0, t * 16:(t + 1) * 16]
        assert len(set(gid[rows].tolist())) == 1
        assert int(allow[0, rows].any(0).sum()) == 32
        assert bool(allow[0, rows][:, allow[0, rows].any(0)].all())


# ---------------------------------------------------------- resident route
def _clip_heads(B, L, heads, width=None):
    """q, k, v as CLIP's MaskedMHA gives them: the (B, L, H, 64) column
    blocks of its fused float32 in-projection."""
    from nl_vsgg_tpu_torch.models.layers import MaskedMHA
    mha = MaskedMHA(heads * 64, heads)
    with torch.no_grad():
        return mha.heads(*(torch.zeros(B, L, heads * 64),) * 3)


@pytest.mark.parametrize("tower,B,L,heads,dq_dkv", [
    ("vision", 32, 50, 12, "per-element"),    # ViT-B/32: 12 heads of 64 over 50 tokens
    ("text", 3, 77, 8, "tiled")])             # the text tower: 8 heads of 64 over 77
def test_resident_route_at_clips_layouts(tower, B, L, heads, dq_dkv):
    """The forward takes the resident route at both CLIP towers' real
    layouts (token stride 3 x H x 64 floats); dQ and dK/dV keep theirs."""
    q, k, v = _clip_heads(B, L, heads)
    assert q.shape == (B, L, heads, 64) and q.stride(1) == 3 * heads * 64
    assert ma.fwd_route(q, k, v) == "resident"
    g = torch.zeros(q.shape)
    assert ma.dq_route(q, k, v, g) == ma.dkv_route(q, k, v, g) == dq_dkv


@pytest.mark.parametrize("case,H,D,dtype,pad,lq,lk,fwd,bwd", [
    ("D-129", 4, 129, torch.float32, 0, 64, 64, "tiled", "tiled"),
    ("Lk-129", 8, 64, torch.float32, 0, 64, 129, "tiled", "tiled"),
    ("Lk-129-12-heads", 12, 64, torch.float32, 0, 50, 129, "per-element", "per-element"),
    ("bf16-8-heads", 8, 64, torch.bfloat16, 0, 77, 77, "staged", "staged"),
    ("bf16-12-heads", 12, 64, torch.bfloat16, 0, 50, 50, "per-element", "per-element"),
    ("misaligned-view", 12, 64, torch.float32, 1, 50, 50, "per-element", "per-element"),
    ("odd-row-3-heads-of-63", 3, 63, torch.float32, 0, 50, 50, "per-element", "per-element"),
    ("tracklet-8-heads-of-297", 8, 297, torch.float32, 0, 128, 128, "tiled", "tiled"),
    ("sttran-bf16-8-heads-of-242", 8, 242, torch.bfloat16, 0, 192, 192, "staged", "staged"),
    ("fp32-path-heads-of-242", 8, 242, torch.float32, 0, 192, 192, "tiled", "tiled"),
    ("edge-16-heads-of-128", 16, 128, torch.float32, 0, 200, 128, "resident", "per-element"),
    ("odd-D-4-heads-of-127", 4, 127, torch.float32, 0, 9, 128, "resident", "tiled")])
def test_resident_route_choices(case, H, D, dtype, pad, lq, lk, fwd, bwd):
    """The resident rule refuses D = 129, Lk = 129, bfloat16 (staged where
    that takes it), a view 4 bytes off 16 and rows that are not whole
    16-byte pieces; the tracklet heads of 297, STTran's bf16 heads of 242
    and float32 heads of 242 keep their routes; dQ and dK/dV never take it."""
    q, _, _ = _fused(2, lq, H, D, dtype, pad)
    _, k, v = _fused(2, lk, H, D, dtype, pad)
    g = torch.zeros(q.shape, dtype=dtype)
    assert ma.fwd_route(q, k, v) == fwd
    assert ma.resident_layout((q, k, v)) == (fwd == "resident")
    assert ma.dq_route(q, k, v, g) == ma.dkv_route(q, k, v, g) == bwd


@pytest.mark.parametrize("lq,lk,D", [(50, 50, 64), (77, 77, 64), (200, 128, 128),
                                     (1, 1, 1), (128, 128, 128), (65, 9, 127)])
def test_resident_plan_fits_and_covers(lq, lk, D):
    """The plan fits a block's shared memory up to Lk = D = 128, its tiles of
    64 rows take every query row once (16 a warp), and its shared memory is
    the kernel's sum: v and k windows for Lk rounded up to 8, 64 q windows."""
    p = ma.resident_plan(lq, lk, D)
    assert p["fits"] and p["smem"] + p["static_smem"] <= ma.BLOCK_SMEM_MAX
    assert p["threads"] == 32 * ma.RESIDENT_PARTS == 128
    assert p["rows"] == ma.RESIDENT_ROWS == ma.RESIDENT_PARTS * ma.TILED_ROWS
    assert p["smem"] == (2 * (-(-lk // 8) * 8) + 64) * ma.tiled_row(D) * 4
    assert p["static_smem"] == 4 * 16 * 12 * 4
    covered = [0] * lq
    for t in range(p["blocks"]):
        for row in range(t * p["rows"], min(lq, (t + 1) * p["rows"])):
            covered[row] += 1
    assert covered == [1] * lq
    clip = ma.resident_plan(50, 50, 64)     # the image tower's blocks: 45 KB, 384 of them
    assert clip["blocks"] == 1 and clip["smem"] == (112 + 64) * 68 * 4
    assert not ma.resident_plan(50, 129, 64)["fits"]
    assert not ma.resident_plan(50, 128, 129)["fits"]


def test_resident_constants_match_the_kernel():
    """The wrapper's resident constants and shared-memory sum are the CUDA
    source's."""
    src = _cu_source()
    assert _cu_int(src, "RESIDENT_MAX_KEYS") == ma.RESIDENT_MAX_KEYS
    assert _cu_int(src, "RESIDENT_MAX_HEAD_DIM") == ma.RESIDENT_MAX_HEAD_DIM
    assert _cu_int(src, "RROWS") == ma.RESIDENT_ROWS
    assert _cu_int(src, "RPARTS") == ma.RESIDENT_PARTS
    assert "((size_t)2 * ((Lk + 7) & ~7) + RROWS) * tiled_row(D) * sizeof(float)" in src
    assert "(size_t)RPARTS * TT * WT_LD * sizeof(float)" in src
    assert ma._FWD_ENTRY["resident"] == "masked_mha_fwd_resident"
    assert 'extern "C" int masked_mha_fwd_resident(' in src
    assert len(ma.entry_argtypes("masked_mha_fwd_resident")) == len(
        ma.entry_argtypes("masked_mha_fwd"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [0, 1, 4])
def test_resident_rule_agrees_with_the_kernel(dtype, pad):
    """`resident_layout` takes exactly what the kernel's `resident_refuses`
    does not, over head counts (past 8 too), head dims and key counts
    around 128, and views."""
    refuses = _kernel_refuses(_cu_source(), "resident_refuses")
    checked = 0
    for H in (1, 3, 8, 12, 16):
        for D in (1, 63, 64, 127, 128, 129):
            for lk in (5, 128, 129):
                q, _, _ = _fused(2, 5, H, D, dtype, pad)
                _, k, v = _fused(2, lk, H, D, dtype, pad)
                tensors = (q, k, v)
                strides = 0
                for t in tensors:
                    strides |= t.stride(0) | t.stride(1)
                kernel_takes = not refuses(ma._DTYPES[dtype], 2, 5, lk, H, D,
                                           [t.data_ptr() for t in tensors], strides)
                assert ma.resident_layout(tensors) == kernel_takes, (H, D, lk, pad, dtype)
                checked += kernel_takes
    assert (checked > 0) == (dtype == torch.float32 and pad % 4 == 0)
