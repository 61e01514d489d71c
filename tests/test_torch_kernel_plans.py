"""The host-side choices the wrappers make before a launch, on the CPU:
RoIAlign's kernel plan (`ops.roi_align.kernel_plan`: its route and the
shared memory a block takes, which holds the roi's axis samples and not its
map window, so the worst window, a roi over the whole 38 x 64 C4 map, takes
no more than any other), the attention kernels' routes (`dq_route`,
`fwd_route`, `dkv_route` on one rule, `staged_layout`: the staged routes
for the serving and training paths' 16-byte aligned column blocks of the
fused projection, the per-element routes for offset views, odd head dims,
rows that are not whole 16-byte pieces, fp32 and more than 8 heads) and the
staged forward's and dK/dV's block plans (`fwd_plan`, `dkv_plan`: shared
memory within a block's limit, 16-row tiles and head groups covering every
row and head once)."""

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
    assert ma.dq_route(q, k, v, g) == "per-element"


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
    """The forward and dK/dV routes refuse what the dQ route refuses (one
    rule, `staged_layout`): offset views, odd D, rows that are not whole
    16-byte pieces, fp32, more than 8 heads, D above 256 (DSG-DETR's
    tracklet heads of 297; 298 is even but past the staged kernels' 16
    k-steps)."""
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
    assert _ROUTES[kind](q, k, v, g) == "per-element"
    assert ma.dq_route(q, k, v, g) == "per-element"


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
