"""The port's CUDA kernels on a card: each against its plain version, and a
few train steps through them. Every test carries the `cuda` marker and
skips without a GPU.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_gpu.py

Tolerances: float32 sums in another order (1e-4 on outputs, 2e-4 + 1e-5
|ref| on gradients); bfloat16 one rounding of an fp32 result on each side
(one bf16 ulp, 2^-7 relative, + 1e-3). The detector kernels (RoIAlign, the
grouped conv, and the grouped conv's bf16-in fp32-out epilogue) are held at
1e-5 relative to the output's largest magnitude in float32 (at most 9 * 64 products summed in another order; cuDNN's TF32
is off for the plain conv), one bf16 ulp in bfloat16. The probe kernels: the
copy exactly (doubling is exact); the mma matmul and the packed conv variants
one bf16 ulp; the packed conv's float32 instantiation against cuDNN's
groups-8 conv at 1e-5 of the output's largest magnitude (9 * 128 products).
"""

import os

import numpy as np
import pytest
import torch

from nl_vsgg_tpu_torch.data.entry import stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.ops import grouped_conv as gc
from nl_vsgg_tpu_torch.ops import grouped_conv_ablate as ga
from nl_vsgg_tpu_torch.ops import masked_attention as ma
from nl_vsgg_tpu_torch.ops import probe_copy as pc
from nl_vsgg_tpu_torch.ops import probe_matmul as pm
from nl_vsgg_tpu_torch.ops import roi_align as ra
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc; chip_smoke.py runs these checks on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def test_kernel_matches_plain_on_gpu(gpu):
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.randn(3, n, 8, 242, device="cuda", generator=gpu).to(dtype)
                   for n in (40, 70, 70))
        allow = torch.rand(3, 40, 70, device="cuda", generator=gpu) < 0.3
        allow[:, ::5] = False
        out = ma.masked_mha(q, k, v, allow, 242 ** -0.5)
        torch.cuda.synchronize()
        ref = ma.masked_mha_reference(q, k, v, allow, 242 ** -0.5)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
        assert (out[:, ::5] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_on_gpu(gpu, dtype, rate):
    rtol, atol = (1e-5, 2e-4) if dtype == torch.float32 else (2 ** -7, 1e-3)
    q, k, v = (torch.randn(3, n, 8, 242, device="cuda", generator=gpu).to(dtype)
               .requires_grad_() for n in (40, 70, 70))
    allow = torch.rand(3, 40, 70, device="cuda", generator=gpu) < 0.3
    allow[:, ::5] = False
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32, device="cuda") if rate else None
    out = ma.masked_mha(q, k, v, allow, 242 ** -0.5, rate, seeds)
    ref_out = ma.masked_mha_reference(q.detach(), k.detach(), v.detach(), allow, 242 ** -0.5,
                                      rate, seeds)
    w = torch.randn_like(out)
    out.backward(w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.detach().float(), ref_out.float(), rtol=rtol, atol=atol)
    ref = ma.masked_mha_bwd_reference(q.detach(), k.detach(), v.detach(), allow, 242 ** -0.5,
                                      w, rate, seeds)
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad.float(), r.float(), rtol=rtol, atol=atol)
    assert (q.grad[:, ::5] == 0).all()


def test_train_steps_launch_the_kernels(gpu):
    """Two small train steps on the card: finite losses, no skip, and one
    forward, dQ and dK/dV launch per attention call (one encoder and one
    rectangular decoder layer)."""
    rng = np.random.default_rng(0)
    batch = stack_entries([make_synthetic_entry(rng, n_frames=4, objs_per_frame=2,
                                                bucket_boxes=16, bucket_rels=12, feat_dim=64)
                           for _ in range(3)]).to("cuda")
    model = STTran(feat_dim=64, dec_layer_num=1, dtype=torch.bfloat16)
    state = create_train_state(model, lr=1e-4)
    step = make_train_step(model, state.optimizer)
    ma.reset_launches()
    for _ in range(2):
        state, metrics = step(state, batch, gpu)
        assert torch.isfinite(metrics["total"]) and float(metrics["valid"]) == 1.0
    assert state.skipped == 0
    assert ma.LAUNCHES == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}


def _roi_case(gen, F_, H, W, C, R):
    fmap = torch.randn(F_, H, W, C, device="cuda", generator=gen)
    xy = torch.rand(R, 2, device="cuda", generator=gen) * torch.tensor([W * 16.0, H * 16.0],
                                                                     device="cuda")
    wh = torch.rand(R, 2, device="cuda", generator=gen) * 300
    rois = torch.cat([xy - 40, xy + wh], 1)
    rois[:4] = torch.tensor([[0, 0, 0, 0], [-500, -500, -400, -400],     # degenerate, outside
                             [0, 0, W * 16 - 1, H * 16 - 1], [W * 16 - 8, H * 16 - 8,
                                                              W * 16 + 40, H * 16 + 40]],
                            device="cuda")
    fidx = torch.randint(0, F_, (R,), device="cuda", generator=gen, dtype=torch.int32)
    return fmap, rois, fidx


@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_matches_plain_on_gpu(gpu, dtype, out_size):
    fmap, rois, fidx = _roi_case(gpu, 3, 38, 64, 1024, 300)
    fmap = fmap.to(dtype)
    ra.reset_launches()
    out = ra.roi_align(fmap, rois, fidx, out_size, 1 / 16)
    torch.cuda.synchronize()
    assert ra.LAUNCHES["roi_align"] == 1 and out.dtype == dtype
    ref = ra.roi_align_reference(fmap, rois, fidx, out_size, 1 / 16)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    assert (out[1] == 0).all()
    out16 = ra.roi_align(fmap.float(), rois, fidx, out_size, 1 / 16, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16


def _edge_rois(H, W):
    w, h = W * 16.0, H * 16.0
    return torch.tensor([[0, 0, w - 1, h - 1], [-16, -16, w + 15, h + 15],
                         [-500, -500, -400, -400], [w + 40, 10, w + 90, 50],   # outside: 2-5
                         [10, h + 40, 50, h + 90], [10, -90, 50, -40],
                         [0, 0, 0, 0], [30, 20, 29, 19], [w - 8, h - 8, w + 40, h + 40],
                         [5, 33, w - 5, 34], [-30, 20, 40, 60], [w - 40, 20, w + 30, 60],
                         [20, -30, 60, 40], [20, h - 40, 60, h + 30]], device="cuda")


@pytest.mark.parametrize("case", ["S1", "S2", "S4", "fp32", "C1020", "C1020-fp32", "C1000",
                                  "misaligned", "R1"])
def test_roi_align_edges_match_plain_on_gpu(gpu, case):
    """The whole-map, outside, degenerate and border rois beside random ones
    in random frame order: S = 1, 2, 4; the scalar route (C = 1020, or a
    map 2 bytes off 16-byte alignment); C = 1000 (a multiple of 8, the
    vector route); a single roi."""
    C, dtype, S, off = 1024, torch.bfloat16, 2, 0
    if case in ("S1", "S4"):
        S = int(case[1])
    elif case == "fp32":
        dtype = torch.float32
    elif case.startswith("C"):
        C = int(case[1:5])
        dtype = torch.float32 if case.endswith("fp32") else dtype
    elif case == "misaligned":
        off = 1
    fmap, rois, fidx = _roi_case(gpu, 3, 38, 64, 8, 300)
    rois = torch.cat([_edge_rois(38, 64), rois])
    fidx = torch.randint(0, 3, (rois.shape[0],), device="cuda", generator=gpu, dtype=torch.int32)
    if case == "R1":
        rois, fidx = rois[:1], fidx[:1]
    n = 3 * 38 * 64 * C
    fmap = torch.randn(n + 8, device="cuda", generator=gpu).to(dtype)[off:off + n].view(
        3, 38, 64, C)
    want = "scalar" if C % 8 or off else "vec8"
    assert ra.kernel_plan(C, (14, 14), S, fmap.data_ptr() % 16 == 0)["route"] == want
    ra.reset_launches()
    out = ra.roi_align(fmap, rois, fidx, (14, 14), 1 / 16, S)
    torch.cuda.synchronize()
    assert ra.LAUNCHES["roi_align"] == 1
    ref = ra.roi_align_reference(fmap, rois, fidx, (14, 14), 1 / 16, S)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    if case != "R1":
        assert (out[2:6] == 0).all()


_DTYPE = {"bf16": torch.bfloat16, "fp32": torch.float32}
# kernel against plain: out, and lse and gradients (rtol, atol)
_OUT_TOL = {"bf16": dict(rtol=2 ** -7, atol=1e-3), "fp32": dict(rtol=0, atol=1e-4)}
_GRAD_TOL = {"bf16": dict(rtol=2 ** -7, atol=1e-3), "fp32": dict(rtol=1e-5, atol=2e-4)}


@pytest.mark.parametrize("case,L,H,D,pad,dtype,route", [
    ("full-and-empty-rows", 192, 8, 242, 0, "bf16", "staged"),
    ("misaligned-view", 96, 8, 242, 1, "bf16", "per-element"),
    ("odd-D-8-heads", 96, 8, 241, 0, "bf16", "per-element"),
    ("8-heads-of-240", 96, 8, 240, 0, "bf16", "staged"),
    ("odd-D-4-heads", 96, 4, 241, 0, "bf16", "per-element"),
    ("3-heads-of-242", 96, 3, 242, 0, "bf16", "per-element"),
    ("3-heads-of-64", 96, 3, 64, 0, "bf16", "staged"),
    ("tracklet-heads-of-297", 128, 8, 297, 0, "bf16", "per-element"),
    ("8-heads-of-298", 96, 8, 298, 0, "bf16", "per-element"),
    ("2-heads-of-320", 96, 2, 320, 0, "bf16", "per-element"),
    ("fp32-full-and-empty-rows", 192, 8, 242, 0, "fp32", "tiled"),
    ("fp32-tracklet-heads-of-297", 128, 8, 297, 0, "fp32", "tiled"),
    ("fp32-2-heads-of-320", 96, 2, 320, 0, "fp32", "tiled"),
    ("fp32-odd-D-8-heads", 96, 8, 241, 0, "fp32", "tiled"),
    ("fp32-misaligned-view", 96, 8, 297, 1, "fp32", "per-element"),
    ("fp32-odd-row", 96, 3, 297, 0, "fp32", "per-element")])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dq_routes_match_plain_on_gpu(gpu, case, L, H, D, pad, dtype, route, rate):
    """The dQ kernel on column blocks of a fused projection, 3% of pairs
    allowed with some rows fully allowed (more keys than a cp.async chunk)
    and some empty, on the route the wrapper picks; dq and r against the
    plain version, empty rows exactly 0."""
    E = H * D
    x = torch.randn(4, L, 3 * E + pad, device="cuda", generator=gpu).to(_DTYPE[dtype])[..., pad:]
    q, k, v = (x[..., i * E:(i + 1) * E].unflatten(-1, (H, D)) for i in range(3))
    gout = torch.randn(4, L, H, D, device="cuda", generator=gpu).to(_DTYPE[dtype])
    allow = torch.rand(4, L, L, device="cuda", generator=gpu) < 0.03
    allow[:, ::9] = True
    allow[:, 4::9] = False
    seeds = torch.tensor([5, -6, 7, 8], dtype=torch.int32, device="cuda") if rate else None
    assert ma.dq_route(q, k, v, gout) == route
    scale = D ** -0.5
    _, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, seeds)
    ma.reset_launches()
    dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, seeds)
    torch.cuda.synchronize()
    assert ma.LAUNCHES["bwd_dq"] == 1
    ref_dq, ref_r = ma.masked_mha_bwd_dq_reference(q, k, v, allow, scale, gout, rate, seeds)
    torch.testing.assert_close(dq.float(), ref_dq.float(), **_GRAD_TOL[dtype])
    torch.testing.assert_close(r, ref_r, **_GRAD_TOL[dtype])
    assert (dq[:, 4::9] == 0).all()


def path_mask(B, lq, lk, device):
    """The path's mask structure: query i in frame i // 3, key j in window
    (j // 3) mod ceil(lq / 3), allowed when the two agree (the spatial
    mask at lq = lk, windows of two frames' keys at lk = 2 lq, queries with
    no window at lq > lk)."""
    fq = torch.arange(lq, device=device) // 3
    fk = (torch.arange(lk, device=device) // 3) % -(-lq // 3)
    return (fq[:, None] == fk[None, :]).expand(B, lq, lk).clone()


def _attention_case(gen, lq, lk, H, D, pad, mask, rate, dtype="bf16"):
    """q from a fused (B, lq, 3 H D + pad) projection, k and v from a (B,
    lk, ...) one (column blocks, `pad` elements off 16 bytes), g, the mask
    ("frames": `path_mask`; "classes": token i of class i mod 3, the same
    class allowed, a third of the pairs, as DSG-DETR's global layers on a
    clip that follows three objects, a few rows and key columns allowed
    nothing; "random": 3% with some query rows fully allowed, some empty,
    and some key columns empty, so that a tile of the tiled route's row
    order meets a large union of keys; "all": every pair, as CLIP's image
    tower; "causal": key j allowed to query i >= j, as its text tower) and
    the seeds."""
    B, E, dt = 4, H * D, _DTYPE[dtype]
    xq = torch.randn(B, lq, 3 * E + pad, device="cuda", generator=gen).to(dt)[..., pad:]
    xk = torch.randn(B, lk, 3 * E + pad, device="cuda", generator=gen).to(dt)[..., pad:]
    q = xq[..., :E].unflatten(-1, (H, D))
    k, v = (xk[..., i * E:(i + 1) * E].unflatten(-1, (H, D)) for i in (1, 2))
    gout = torch.randn(B, lq, H, D, device="cuda", generator=gen).to(dt)
    if mask == "frames":
        allow = path_mask(B, lq, lk, "cuda")
    elif mask == "classes":
        cq, ck = torch.arange(lq, device="cuda") % 3, torch.arange(lk, device="cuda") % 3
        allow = (cq[:, None] == ck[None, :]).expand(B, lq, lk).clone()
        if dtype == "fp32":
            allow[:, 7::31] = False
            allow[:, :, 11::37] = False
    elif mask in ("all", "causal"):
        allow = torch.ones(B, lq, lk, dtype=torch.bool, device="cuda")
        if mask == "causal":
            allow = allow.tril()
    else:
        allow = torch.rand(B, lq, lk, device="cuda", generator=gen) < 0.03
        allow[:, ::9] = True
        allow[:, 4::9] = False
        allow[:, :, 5::11] = False
    seeds = torch.tensor([5, -6, 7, 8], dtype=torch.int32, device="cuda") if rate else None
    return q, k, v, gout, allow, seeds


_ROUTE_CASES = [
    ("frames-96x96", 96, 96, 8, 242, 0, "frames", "staged"),
    ("frames-192x192", 192, 192, 8, 242, 0, "frames", "staged"),
    ("frames-96x192", 96, 192, 8, 242, 0, "frames", "staged"),
    ("frames-192x96", 192, 96, 8, 242, 0, "frames", "staged"),
    ("random-192x192", 192, 192, 8, 242, 0, "random", "staged"),
    ("random-97x101", 97, 101, 8, 242, 0, "random", "staged"),
    ("random-1x5", 1, 5, 8, 242, 0, "random", "staged"),
    ("3-heads-of-64", 96, 96, 3, 64, 0, "random", "staged"),
    ("misaligned-view", 96, 96, 8, 242, 1, "random", "per-element"),
    ("odd-D", 97, 96, 8, 241, 0, "random", "per-element"),
    ("3-heads-of-242", 96, 96, 3, 242, 0, "random", "per-element"),
    ("same-class-96x96", 96, 96, 8, 242, 0, "classes", "staged"),
    ("same-class-heads-of-297", 128, 128, 8, 297, 0, "classes", "per-element"),
    ("random-heads-of-297", 128, 128, 8, 297, 0, "random", "per-element"),
    ("8-heads-of-298", 96, 96, 8, 298, 0, "random", "per-element"),
    ("2-heads-of-320", 96, 96, 2, 320, 0, "classes", "per-element"),
    ("fp32-same-class-heads-of-297", 128, 128, 8, 297, 0, "classes", "tiled"),
    ("fp32-random-heads-of-297", 128, 128, 8, 297, 0, "random", "tiled"),
    ("fp32-2-heads-of-320", 96, 96, 2, 320, 0, "classes", "tiled"),
    ("fp32-odd-D", 97, 96, 8, 241, 0, "random", "tiled"),
    ("fp32-frames-96x192", 96, 192, 8, 242, 0, "frames", "tiled"),
    ("fp32-random-1x5", 1, 5, 8, 297, 0, "random", "tiled"),
    ("fp32-misaligned-view", 96, 96, 8, 297, 1, "classes", "per-element"),
    ("fp32-3-heads-of-297", 96, 96, 3, 297, 0, "classes", "per-element"),
    ("fp32-clip-vision-12-heads-of-64", 50, 50, 12, 64, 0, "all", "resident"),
    ("fp32-clip-text-8-heads-of-64", 77, 77, 8, 64, 0, "causal", "resident"),
    ("fp32-random-200x128-16-heads-of-128", 200, 128, 16, 128, 0, "random", "resident")]
# the backward routes of the resident cases (a route of the forward only)
_RESIDENT_BWD = {"fp32-clip-vision-12-heads-of-64": "per-element",
                 "fp32-clip-text-8-heads-of-64": "tiled",
                 "fp32-random-200x128-16-heads-of-128": "per-element"}


def _dtype_of(case):
    return "fp32" if case.startswith("fp32-") else "bf16"


@pytest.mark.parametrize("case,lq,lk,H,D,pad,mask,route", _ROUTE_CASES)
@pytest.mark.parametrize("rate,with_lse", [(0.0, False), (0.0, True), (0.1, False), (0.1, True)])
def test_fwd_routes_match_plain_on_gpu(gpu, case, lq, lk, H, D, pad, mask, route, rate,
                                       with_lse):
    """The forward on the route the wrapper picks, eval (no lse) and train
    (lse), dropout off and on: out to one bf16 ulp (float32: 1e-4), lse to
    2e-4 + 1e-5 |ref|, rows with no allowed key exactly 0 and LSE_EMPTY,
    one launch."""
    dtype = _dtype_of(case)
    q, k, v, _, allow, seeds = _attention_case(gpu, lq, lk, H, D, pad, mask, rate, dtype)
    assert ma.fwd_route(q, k, v) == route
    scale = D ** -0.5
    ma.reset_launches()
    out, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, seeds, with_lse)
    torch.cuda.synchronize()
    assert ma.LAUNCHES["fwd"] == 1
    ref = ma.masked_mha_reference(q, k, v, allow, scale, rate, seeds)
    torch.testing.assert_close(out.float(), ref.float(), **_OUT_TOL[dtype])
    empty = ~allow.any(-1)
    assert (out[empty] == 0).all()
    if with_lse:
        ref_lse = ma.masked_mha_lse_reference(q, k, allow, scale)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=2e-4)
        assert (lse.transpose(1, 2)[empty] == ma.LSE_EMPTY).all()
    else:
        assert lse is None


@pytest.mark.parametrize("case,lq,lk,H,D,pad,mask,route", _ROUTE_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dkv_routes_match_plain_on_gpu(gpu, case, lq, lk, H, D, pad, mask, route, rate):
    """The dK/dV kernel on the route the wrapper picks, dropout off and on,
    from the dQ kernel's r: dk and dv to one bf16 ulp (float32: 2e-4 +
    1e-5 |ref|), key rows no query may see exactly 0, one launch."""
    dtype = _dtype_of(case)
    q, k, v, gout, allow, seeds = _attention_case(gpu, lq, lk, H, D, pad, mask, rate, dtype)
    assert ma.dkv_route(q, k, v, gout) == _RESIDENT_BWD.get(case, route)
    scale = D ** -0.5
    _, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, seeds)
    _, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, seeds)
    ma.reset_launches()
    dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow.transpose(1, 2).contiguous(), scale, gout,
                                   lse, r, rate, seeds)
    torch.cuda.synchronize()
    assert ma.LAUNCHES["bwd_dkv"] == 1
    ref_dk, ref_dv = ma.masked_mha_bwd_dkv_reference(q, k, v, allow, scale, gout, r, rate,
                                                     seeds)
    torch.testing.assert_close(dk.float(), ref_dk.float(), **_GRAD_TOL[dtype])
    torch.testing.assert_close(dv.float(), ref_dv.float(), **_GRAD_TOL[dtype])
    unseen = ~allow.any(1)
    assert (dk[unseen] == 0).all() and (dv[unseen] == 0).all()


@pytest.mark.parametrize("heads,length,mask,bwd", [(12, 50, "all", "per-element"),
                                                   (8, 77, "causal", "tiled")])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_after_a_resident_forward_on_gpu(gpu, heads, length, mask, bwd, rate):
    """masked_mha with gradients at CLIP's head layouts: the forward on the
    resident route writes the lse that the dQ and dK/dV kernels (per-element
    at 12 heads, tiled at 8) read; out and the gradients against the plain
    version's (float32: 1e-4; gradients 2e-4 + 1e-5 |ref|), one launch of
    each kernel."""
    q, k, v, gout, allow, seeds = _attention_case(gpu, length, length, heads, 64, 0, mask,
                                                  rate, "fp32")
    assert ma.fwd_route(q, k, v) == "resident"
    assert ma.dq_route(q, k, v, gout) == ma.dkv_route(q, k, v, gout) == bwd
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    ma.reset_launches()
    out = ma.masked_mha(q, k, v, allow, 0.125, rate, seeds)
    out.backward(gout)
    torch.cuda.synchronize()
    assert dict(ma.LAUNCHES) == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    ref_out = ma.masked_mha_reference(q.detach(), k.detach(), v.detach(), allow, 0.125, rate,
                                      seeds)
    torch.testing.assert_close(out.detach(), ref_out, **_OUT_TOL["fp32"])
    ref = ma.masked_mha_bwd_reference(q.detach(), k.detach(), v.detach(), allow, 0.125, gout,
                                      rate, seeds)
    for t, r in zip((q, k, v), ref):
        torch.testing.assert_close(t.grad, r, **_GRAD_TOL["fp32"])


def test_resident_entry_refuses_what_the_rule_refuses_on_gpu(gpu):
    """The resident C entry returns cudaErrorInvalidValue, launching
    nothing, for what `resident_layout` refuses (bfloat16, a view 4 bytes
    off 16, rows that are not whole 16-byte pieces, D = 129, Lk = 129) and
    launches on what it takes (any number of heads)."""
    def launch(q, k, v, allow):
        B, Lq, H, D = q.shape
        out = torch.empty(B, Lq, H, D, dtype=q.dtype, device="cuda")
        fn = ma._fn("masked_mha_fwd_resident")
        return fn(ma._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  allow.data_ptr(), None, out.data_ptr(), None, B, Lq, k.shape[1], H, D,
                  q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                  D ** -0.5, 0, 1.0, torch.cuda.current_stream().cuda_stream)

    for H, D, pad, dtype, lk in ((12, 64, 0, torch.float32, 50), (12, 64, 0, torch.bfloat16, 50),
                                 (12, 64, 1, torch.float32, 50), (3, 63, 0, torch.float32, 50),
                                 (4, 129, 0, torch.float32, 50), (8, 64, 0, torch.float32, 129),
                                 (16, 128, 0, torch.float32, 128)):
        x = torch.randn(2, 16, 3 * H * D + pad, device="cuda", generator=gpu).to(dtype)[..., pad:]
        y = torch.randn(2, lk, 3 * H * D + pad, device="cuda", generator=gpu).to(dtype)[..., pad:]
        q = x[..., :H * D].unflatten(-1, (H, D))
        k, v = (y[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)) for i in (1, 2))
        allow = torch.ones(2, 16, lk, dtype=torch.bool, device="cuda")
        takes = ma.resident_layout((q, k, v))
        assert (launch(q, k, v, allow) == 0) == takes, (H, D, pad, dtype, lk)
        assert takes == (dtype == torch.float32 and pad == 0 and H * D % 4 == 0 and D <= 128
                         and lk <= 128)
    torch.cuda.synchronize()


def test_tiled_entries_refuse_what_the_rule_refuses_on_gpu(gpu):
    """The tiled C entries return cudaErrorInvalidValue, launching nothing,
    for what `tiled_layout` refuses (bfloat16, a view 4 bytes off 16, rows
    that are not whole 16-byte pieces, more than 8 heads) and launch on what
    it takes, so the wrapper's rule and the kernel's agree."""
    def launch(q, k, v, allow):
        B, Lq, H, D = q.shape
        out = torch.empty(B, Lq, H, D, dtype=q.dtype, device="cuda")
        order = ma.row_order(allow)
        fn = ma._fn("masked_mha_fwd_tiled")
        return fn(ma._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  allow.data_ptr(), order.data_ptr(), None, out.data_ptr(), None, B, Lq,
                  k.shape[1], H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                  v.stride(0), v.stride(1), D ** -0.5, 0, 1.0,
                  torch.cuda.current_stream().cuda_stream)

    allow = torch.ones(2, 16, 16, dtype=torch.bool, device="cuda")
    for H, D, pad, dtype in ((8, 297, 0, torch.float32), (8, 297, 0, torch.bfloat16),
                             (8, 297, 1, torch.float32), (3, 297, 0, torch.float32),
                             (16, 64, 0, torch.float32), (2, 320, 0, torch.float32)):
        x = torch.randn(2, 16, 3 * H * D + pad, device="cuda", generator=gpu).to(dtype)[..., pad:]
        q, k, v = (x[..., i * H * D:(i + 1) * H * D].unflatten(-1, (H, D)) for i in range(3))
        takes = ma.tiled_layout((q, k, v))
        assert (launch(q, k, v, allow) == 0) == takes, (H, D, pad, dtype)
        assert takes == (dtype == torch.float32 and pad == 0 and H * D % 4 == 0 and H <= 8)
    torch.cuda.synchronize()


@pytest.mark.parametrize("N,H,W,C", [(2, 152, 256, 256), (2, 76, 128, 512), (3, 38, 64, 1024),
                                     (300, 7, 7, 2048), (5, 9, 13, 256),
                                     (1201, 7, 7, 2048),     # crops not a multiple of the tile's 5
                                     (2, 38, 50, 1024),      # width not a multiple of 64 columns
                                     (2, 1, 70, 512)])       # one row, a ragged column block
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_conv_matches_plain_on_gpu(gpu, dtype, N, H, W, C):
    torch.backends.cudnn.allow_tf32 = False
    c = C // 32
    x = torch.randn(N, H, W, C, device="cuda", generator=gpu).to(dtype)
    w = (torch.randn(3, 3, c, C, device="cuda", generator=gpu) * c ** -0.5).to(dtype)
    bias = torch.randn(C, device="cuda", generator=gpu)
    route = "3xtf32" if dtype == torch.float32 else "tc"
    assert gc.conv_route(x, w) == route
    for b, relu in ((None, False), (bias, True)):
        gc.reset_launches()
        out = gc.grouped_conv3x3(x, w, 32, b, relu)
        torch.cuda.synchronize()
        assert gc.launches() == 1 and out.dtype == dtype
        assert gc.ROUTE_LAUNCHES == {**dict.fromkeys(gc.ROUTES, 0), route: 1}
        ref = gc.grouped_conv3x3_reference(x, w, 32, b, relu)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
        else:
            torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("N,H,W,C", [(32, 152, 256, 256), (32, 76, 128, 512),
                                     (32, 38, 64, 1024), (9600, 7, 7, 2048)])
def test_grouped_conv_fp32_path_classes_on_gpu(gpu, N, H, W, C):
    """Each class at the shape a 32-frame float32 detect_video gives it, on
    the 3xtf32 route, with the bias + ReLU epilogue and a bf16 output too:
    within 1e-5 of the plain version's largest magnitude (TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    c = C // 32
    x = torch.randn(N, H, W, C, device="cuda", generator=gpu)
    w = torch.randn(3, 3, c, C, device="cuda", generator=gpu) * (9 * c) ** -0.5
    bias = torch.randn(C, device="cuda", generator=gpu)
    gc.reset_launches()
    out = gc.grouped_conv3x3(x, w, 32, bias, True)
    out16 = gc.grouped_conv3x3(x, w, 32, bias, True, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert gc.ROUTE_LAUNCHES["3xtf32"] == 2 and gc.launches() == 2
    ref = gc.grouped_conv3x3_reference(x, w, 32, bias, True)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(out16.float(), ref, rtol=2 ** -7, atol=1e-3)


def test_grouped_conv_fp32_fma_route_on_gpu(gpu):
    """float32 the 3xtf32 route does not take runs the first kernel ("fma"):
    c = 4 and c = 128, and storage 4 bytes off 16-byte alignment; the 3xtf32
    C entry refuses c = 4 and the misaligned view without launching."""
    torch.backends.cudnn.allow_tf32 = False
    base = torch.randn(1 + 2 * 9 * 13 * 4096, device="cuda", generator=gpu)
    for C, off in ((128, 0), (4096, 0), (1024, 1)):
        c = C // 32
        x = base[off:off + 2 * 9 * 13 * C].view(2, 9, 13, C)
        w = torch.randn(3, 3, c, C, device="cuda", generator=gpu) * (9 * c) ** -0.5
        assert gc.conv_route(x, w) == "fma"
        if C != 4096:
            y = torch.empty_like(x)
            rc = gc._fn("3xtf32")(0, x.data_ptr(), w.data_ptr(), None, y.data_ptr(), 2, 9, 13, C,
                                  c, 0, 8, 13, 1, 1, torch.cuda.current_stream().cuda_stream)
            assert rc != 0, (C, off)
        gc.reset_launches()
        out = gc.grouped_conv3x3(x, w, 32, None, True)
        torch.cuda.synchronize()
        assert gc.ROUTE_LAUNCHES["fma"] == 1
        ref = gc.grouped_conv3x3_reference(x, w, 32, None, True)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("C", [256, 512, 1024, 2048])
def test_grouped_conv_bf16_in_fp32_out_on_gpu(gpu, C):
    """bf16 inputs with a float32 output: the tensor-core kernel's fp32
    epilogue, held to the plain version's float32 result (sums in another
    order over at most 9 * 64 bf16 products)."""
    torch.backends.cudnn.allow_tf32 = False
    c = C // 32
    x = torch.randn(2, 9, 70, C, device="cuda", generator=gpu).bfloat16()
    w = (torch.randn(3, 3, c, C, device="cuda", generator=gpu) * c ** -0.5).bfloat16()
    bias = torch.randn(C, device="cuda", generator=gpu)
    out = gc.grouped_conv3x3(x, w, 32, bias, True, out_dtype=torch.float32)
    torch.cuda.synchronize()
    ref = gc.grouped_conv3x3_reference(x, w, 32, bias, True, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_grouped_conv_refuses_misaligned_storage_on_gpu(gpu):
    """The bf16 kernel stages x and w by 16-byte cp.async copies: a view 2
    bytes into its storage is refused before launch, the same data aligned
    is not."""
    flat = torch.randn(1 + 2 * 5 * 6 * 256, device="cuda", generator=gpu).bfloat16()
    w = torch.zeros(3, 3, 8, 256, device="cuda", dtype=torch.bfloat16)
    x = flat[1:].view(2, 5, 6, 256)
    gc.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        gc.grouped_conv3x3(x, w, 32)
    wflat = torch.zeros(1 + w.numel(), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        gc.grouped_conv3x3(x.clone(), wflat[1:].view(3, 3, 8, 256), 32)
    assert gc.launches() == 0
    gc.grouped_conv3x3(x.clone(), w, 32)
    assert gc.launches() == 1


@pytest.mark.parametrize("shape", [(256, 128), (8, 40, 64, 128), (1001,), (1,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_copy_matches_plain_on_gpu(gpu, dtype, shape):
    """Exact at the probes' shapes, a tail past the last vector (1001) and a
    single element, at the probes' unit counts (1 and 8) and an uneven 3."""
    x = torch.randn(shape, device="cuda", generator=gpu).to(dtype)
    pc.reset_launches()
    for units in (1, 8, 3):
        y = pc.probe_copy(x, units)
        torch.cuda.synchronize()
        assert torch.equal(y, pc.probe_copy_reference(x))
    assert pc.LAUNCHES["probe_copy"] == 3


@pytest.mark.parametrize("M", [20480, 1000, 5, 1, 4255])   # 4255: not a multiple of 32 rows
def test_probe_matmul_matches_plain_on_gpu(gpu, M):
    x = torch.randn(M, 128, device="cuda", generator=gpu).bfloat16()
    w = (torch.randn(128, 128, device="cuda", generator=gpu) * 0.05).bfloat16()
    pm.reset_launches()
    y = pm.probe_matmul(x, w)
    torch.cuda.synchronize()
    assert pm.LAUNCHES["probe_matmul"] == 1 and y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), pm.probe_matmul_reference(x, w).float(),
                               rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("tile_rows,W,route", [
    (1, 64, "ring"), (2, 64, "ring"), (4, 64, "ring"), (3, 64, "ring"), (2, 32, "ring"),
    (8, 32, "ring"), (1, 128, "ring"), (2, 128, "tile"), (1, 32, "tile"), (3, 32, "tile"),
    (4, 32, "ring")])
def test_grouped_conv_ablate_matches_plain_on_gpu(gpu, tile_rows, W, route):
    """Every variant and layout at H = 7 (no tile_rows above 1 divides it)
    on the route `kernel_plan` picks: the ring at 64 to 256 pixels a tile,
    the tile route where the ring refuses (32 or 96 pixels; 256 pixels of
    W = 128, whose row ring does not fit shared memory)."""
    x = torch.randn(2, 9, W, 512, device="cuda", generator=gpu).bfloat16()   # H = 7
    w = (torch.randn(3, 3, 128, 512, device="cuda", generator=gpu) * 0.05).bfloat16()
    xt, wt = ga.to_block_major(x, w)
    assert ga.route(x, tile_rows) == ga.route(xt, tile_rows, block_major=True) == route
    ga.reset_launches()
    for v in ga.VARIANTS + ga.BT_VARIANTS:
        bt = v in ga.BT_VARIANTS
        out = (ga.grouped_conv_ablate_bt(xt, wt, v, tile_rows) if bt
               else ga.grouped_conv_ablate(x, w, v, tile_rows))
        torch.cuda.synchronize()
        ref = (ga.grouped_conv_ablate_bt_reference(xt, wt, v) if bt
               else ga.grouped_conv_ablate_reference(x, w, v))
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
    assert ga.LAUNCHES == {"grouped_conv_ablate": 4, "grouped_conv_ablate_bt": 2}


@pytest.mark.parametrize("tile_rows,route", [(2, "ring"), (3, "ring"), (4, "ring")])
def test_grouped_conv_ablate_ring_at_the_probe_height_on_gpu(gpu, tile_rows, route):
    """The probe's H = 38 and W = 64 (the ring's parts of 19 rows: no tile of
    2, 3 or 4 rows divides them), every variant and layout, one image."""
    x = torch.randn(1, 40, 64, 256, device="cuda", generator=gpu).bfloat16()
    w = (torch.randn(3, 3, 128, 256, device="cuda", generator=gpu) * 0.05).bfloat16()
    xt, wt = ga.to_block_major(x, w)
    assert ga.route(x, tile_rows) == route
    for v in ga.VARIANTS + ga.BT_VARIANTS:
        bt = v in ga.BT_VARIANTS
        out = (ga.grouped_conv_ablate_bt(xt, wt, v, tile_rows) if bt
               else ga.grouped_conv_ablate(x, w, v, tile_rows))
        torch.cuda.synchronize()
        ref = (ga.grouped_conv_ablate_bt_reference(xt, wt, v) if bt
               else ga.grouped_conv_ablate_reference(x, w, v))
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("tile_rows", [1, 2])
def test_grouped_conv_ablate_fp32_matches_cudnn_on_gpu(gpu, tile_rows):
    torch.backends.cudnn.allow_tf32 = False
    x = torch.randn(2, 12, 64, 1024, device="cuda", generator=gpu)
    w = torch.randn(3, 3, 128, 1024, device="cuda", generator=gpu) * 0.05
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                     padding=(0, 1), groups=8).permute(0, 2, 3, 1)
    out = ga.grouped_conv_ablate(x, w, "full", tile_rows)
    bt = ga.from_block_major(ga.grouped_conv_ablate_bt(*ga.to_block_major(x, w), "bt-full",
                                                       tile_rows))
    torch.cuda.synchronize()
    tol = 1e-5 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(bt, ref, rtol=0, atol=tol)
    with pytest.raises(ValueError, match="shared memory"):
        ga.grouped_conv_ablate(x, w, "full", 4)


def test_probe_kernels_refuse_misaligned_storage_on_gpu(gpu):
    """The kernels load 16 bytes at a time; a view 2 bytes into its storage
    is refused before launch."""
    flat = torch.randn(1 + 2 * 12 * 32 * 128, device="cuda", generator=gpu).bfloat16()
    w = torch.zeros(3, 3, 128, 128, device="cuda", dtype=torch.bfloat16)
    for tile_rows in (1, 2):                     # the tile route, then the ring
        with pytest.raises(ValueError, match="aligned"):
            ga.grouped_conv_ablate(flat[1:].view(2, 12, 32, 128), w, "full", tile_rows)
    with pytest.raises(ValueError, match="aligned"):
        pm.probe_matmul(flat[1:1 + 64 * 128].view(64, 128), w[0, 0])
    with pytest.raises(ValueError, match="aligned"):
        pc.probe_copy(flat[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tracklet_head_dim_297_on_gpu(gpu, dtype, rate):
    """DSG-DETR's tracklet encoder: 8 heads of 297 (float32 on the tiled
    route, bfloat16 on the per-element route, 10 dims a lane) on a
    same-class mask with a few rows allowed nothing; the forward (with and
    without lse), dQ and dK/dV against their plain versions (float32 1e-4
    on out, 2e-4 + 1e-5 |ref| on lse and gradients; bfloat16 one bf16
    ulp), empty rows exactly 0, and D = 321 refused."""
    B, L, H, D = 3, 128, 8, 297
    q, k, v, gout = (torch.randn(B, L, H, D, device="cuda", generator=gpu).to(dtype)
                     for _ in range(4))
    cls = torch.arange(L, device="cuda") % 5
    allow = (cls[:, None] == cls[None, :]).expand(B, L, L).clone()
    allow[:, 7::31] = False
    seeds = torch.tensor([3, -4, 9], dtype=torch.int32, device="cuda") if rate else None
    f32 = dtype == torch.float32
    assert (ma.fwd_route(q, k, v) == ma.dq_route(q, k, v, gout) == ma.dkv_route(q, k, v, gout)
            == ("tiled" if f32 else "per-element"))
    scale = D ** -0.5
    out_tol = dict(rtol=0, atol=1e-4) if f32 else dict(rtol=2 ** -7, atol=1e-3)
    grad_tol = dict(rtol=1e-5, atol=2e-4) if f32 else dict(rtol=2 ** -7, atol=1e-3)
    ref = ma.masked_mha_reference(q, k, v, allow, scale, rate, seeds)
    for with_lse in (False, True):
        out, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, seeds, with_lse)
        torch.testing.assert_close(out.float(), ref.float(), **out_tol)
        assert (out[:, 7::31] == 0).all()
    torch.testing.assert_close(lse, ma.masked_mha_lse_reference(q, k, allow, scale), **grad_tol)
    dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, seeds)
    dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow.transpose(1, 2).contiguous(), scale, gout,
                                   lse, r, rate, seeds)
    torch.cuda.synchronize()
    ref_dq, ref_r = ma.masked_mha_bwd_dq_reference(q, k, v, allow, scale, gout, rate, seeds)
    ref_dk, ref_dv = ma.masked_mha_bwd_dkv_reference(q, k, v, allow, scale, gout, ref_r, rate,
                                                     seeds)
    for got, want in ((dq, ref_dq), (r, ref_r), (dk, ref_dk), (dv, ref_dv)):
        torch.testing.assert_close(got.float(), want.float(), **grad_tol)
    assert (dq[:, 7::31] == 0).all()
    with pytest.raises(ValueError):
        x = torch.zeros(1, 4, 1, 321, device="cuda", dtype=dtype)
        ma.masked_mha(x, x, x, torch.ones(1, 4, 4, dtype=torch.bool, device="cuda"), 1.0)


def test_dsg_detr_train_steps_on_gpu(gpu):
    """Two bf16 DSG-DETR sgdet train steps and one sgcls forward through
    the kernels (4 + 4 + 4 launches a step; the float32 tracklet head's 3
    on the tiled route), finite losses, no skip."""
    from nl_vsgg_tpu_torch.models.dsg_detr import DSGDETR

    rng = np.random.default_rng(0)
    entries = [make_synthetic_entry(rng, n_frames=6, objs_per_frame=3, bucket_boxes=32,
                                    bucket_rels=24) for _ in range(4)]
    batch = place_entries(entries, rel_bf16=True, device="cuda")
    model = DSGDETR(mode="sgdet", dtype=torch.bfloat16, device="cuda")
    st = create_train_state(model, lr=1e-5)
    step = make_train_step(model, st.optimizer)
    ma.reset_launches()
    for _ in range(2):
        st, met = step(st, batch, gpu)
        assert torch.isfinite(met["total"])
    assert st.skipped == 0
    assert dict(ma.LAUNCHES) == {"fwd": 8, "bwd_dq": 8, "bwd_dkv": 8}
    sg = DSGDETR(mode="sgcls", dtype=torch.bfloat16, device="cuda")
    ma.reset_launches()
    with torch.inference_mode():
        out = sg(batch)
    assert dict(ma.LAUNCHES) == {"fwd": 7, "bwd_dq": 0, "bwd_dkv": 0}
    assert out["distribution"].isfinite().all()


def test_device_store_gather_equals_place_entries_on_gpu(gpu):
    """The Entry store on the card: batches adopted from place_entries
    (width-0 union, bf16 relation arrays, as the train loop places them)
    and gathered in another order equal place_entries over the same videos,
    bit for bit."""
    from nl_vsgg_tpu_torch.data.device_store import DeviceEntryStore
    rng = np.random.default_rng(12)
    es = [make_synthetic_entry(rng, n_frames=8, objs_per_frame=3, bucket_boxes=32,
                               bucket_rels=24, feat_dim=2048) for _ in range(6)]
    store = DeviceEntryStore()
    for lo in (0, 3):
        batch = place_entries(es[lo:lo + 3], zero_union=True, rel_bf16=True)
        assert batch.features.is_cuda and store.add_batch(range(lo, lo + 3), batch)
    idx = [5, 0, 3, 2]
    got = store.gather(idx)
    want = place_entries([es[i] for i in idx], zero_union=True, rel_bf16=True)
    for f in ("boxes", "box_frame", "box_mask", "labels", "scores", "distribution", "features",
              "pair_idx", "im_idx", "rel_mask", "union_feat", "spatial_masks", "attention_gt",
              "spatial_gt", "contacting_gt", "num_frames"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    assert store.bytes > 0 and store.gather([0, 99]) is None


def test_native_grounding_equals_python_on_the_gpu_host(gpu, tmp_path):
    """The native engine, built with the card machine's g++, grounds every
    Entry field equal to the python path, in train and in test mode."""
    from nl_vsgg_tpu_torch.data import grounding as gr
    from nl_vsgg_tpu_torch.data import schema
    from nl_vsgg_tpu_torch.utils import native_io
    assert native_io.get_lib() is not None
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps()
    person = sorted(ag_to_oi[1])
    mapped = [k for k, v in oi_to_ag.items() if v and k not in set(person)]
    rng = np.random.default_rng(13)
    paths, gt = [], []
    for f in range(6):
        d = tmp_path / f"f{f}"
        d.mkdir()
        cls = [person[0]] + [int(c) for c in rng.choice(mapped, 5)]
        dets = [{"class": c, "conf": np.float32(rng.random()),
                 "rect": rng.uniform(0, 400, 4).astype(np.float32)} for c in cls]
        np.save(d / "dets.npy", np.asarray(dets, object), allow_pickle=True)
        np.save(d / gr.DETS_F32, gr.dets_to_f32(dets))
        np.save(d / "feat.npy", rng.standard_normal((len(cls), 64)).astype(np.float32))
        paths.append(str(d))
        gt.append([{"person_bbox": np.zeros(4)}] + [
            {"class": a, "attention_relationship": np.array([0]),
             "spatial_relationship": np.array([1]), "contacting_relationship": np.array([2])}
            for c in cls[1:] for a in oi_to_ag[c]])
    for is_train in (True, False):
        nat = gr.wk_forward_native(paths, gt, is_train, (32, 64), (32, 64), feat_dim=64)
        py = gr.wk_forward(gr.load_frame_features(paths, use_native=False, feat_dim=64), gt,
                           is_train, (32, 64), (32, 64), feat_dim=64,
                           compute_spatial_masks=False)
        assert nat is not None and nat is not gr._NATIVE_UNAVAILABLE
        for f in ("boxes", "box_frame", "box_mask", "labels", "scores", "distribution",
                  "features", "pair_idx", "im_idx", "rel_mask", "union_feat", "spatial_masks",
                  "attention_gt", "spatial_gt", "contacting_gt", "num_frames"):
            a, b = getattr(nat, f), getattr(py, f)
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), f


def test_run_training_one_epoch_on_gpu(gpu, tmp_path):
    """`tools.train_sttran.run_training` on the card at a narrow width: a
    synthetic Action Genome split of 4 videos (chip_smoke.write_synthetic_ag),
    1 epoch of bf16 STTran (1 + 1 layers, feat 64) through the attention
    kernels, the device Entry store, the epoch eval and a checkpoint."""
    import types

    from chip_smoke import write_synthetic_ag
    from nl_vsgg_tpu_torch.tools import train_sttran as ts
    from nl_vsgg_tpu_torch.utils.checkpoint import latest_step
    from nl_vsgg_tpu_torch.utils.config import load_config

    ag = write_synthetic_ag(str(tmp_path), 4, 4, 64, 2, 6, 3)
    cfg = load_config(None, {
        "data_path": ag, "frame_features_path": os.path.join(ag, "frame_features"),
        "pseudo_localized_SG_path": os.path.join(ag, "final_ag_data_w_neg.pkl"),
        "save_path": str(tmp_path / "out"), "feat_dim": 64, "enc_layer": 1, "dec_layer": 1,
        "dtype": "bfloat16", "batch_videos": 2, "num_workers": 2, "nepoch": 1,
        "device_entry_store_gb": 1.0, "remove_one_frame_video": False,
        "buckets": {"max_boxes": [16], "max_rels": [8]}})
    ma.reset_launches()
    st = ts.run_training(cfg, types.SimpleNamespace(max_videos=0, device=None), ts.build_model)
    assert next(st.model.parameters()).is_cuda and st.step == 2 and st.skipped == 0
    # 2 train steps of 2 attention layers, then the eval's 2 forwards
    assert dict(ma.LAUNCHES) == {"fwd": 2 * 2 + 2 * 2, "bwd_dq": 2 * 2, "bwd_dkv": 2 * 2}
    assert latest_step(str(tmp_path / "out" / "ckpt")) == 0


@pytest.mark.parametrize("width,heads,length,causal,route", [
    (768, 12, 50, False, "resident"),        # the CLIP vision tower's blocks
    (512, 8, 77, True, "resident"),          # the CLIP text tower's blocks, causal
])
def test_clip_block_on_its_attention_route_on_gpu(gpu, width, heads, length, causal, route):
    """A CLIP residual block in float32 through the attention kernel against
    the plain path (1e-4, TF32 off), on the route its tower takes."""
    from nl_vsgg_tpu_torch.pipelines import clip
    torch.manual_seed(0)
    fused = clip.ResidualBlock(width, heads).cuda().eval()
    plain = clip.ResidualBlock(width, heads, fused=False).cuda().eval()
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(4, length, width, device="cuda", generator=gpu)
    allow = clip.allow_mask(4, length, causal, "cuda")
    h = fused.ln_1(x)
    q, k, v = fused.attn.heads(h, h, h)
    assert ma.fwd_route(q, k, v) == route
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ma.reset_launches()
            out = fused(x, allow)
            assert ma.LAUNCHES["fwd"] == 1
            ref = plain(x, allow)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
