"""The host-side choices the wrappers make before a launch, on the CPU:
RoIAlign's kernel plan (`ops.roi_align.kernel_plan`: its route and the
shared memory a block takes, which holds the roi's axis samples and not its
map window, so the worst window, a roi over the whole 38 x 64 C4 map, takes
no more than any other) and the dQ kernel's route (`ops.masked_attention.
dq_route`: the staged route for the training path's 16-byte aligned column
blocks of the fused projection, the per-element route for offset views, odd
head dims, rows that are not whole 16-byte pieces, fp32 and more than 8
heads)."""

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
