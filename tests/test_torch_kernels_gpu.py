"""The port's CUDA kernels on a card: each against its plain version, and a
few train steps through them. Every test carries the `cuda` marker and
skips without a GPU.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_gpu.py

Tolerances: float32 sums in another order (1e-4 on outputs, 2e-4 + 1e-5
|ref| on gradients); bfloat16 one rounding of an fp32 result on each side
(one bf16 ulp, 2^-7 relative, + 1e-3). The detector kernels (RoIAlign, the
grouped conv) are held at 1e-5 relative to the output's largest magnitude
in float32 (at most 9 * 64 products summed in another order; cuDNN's TF32
is off for the plain conv), one bf16 ulp in bfloat16.
"""

import numpy as np
import pytest
import torch

from nl_vsgg_tpu_torch.data.entry import stack_entries
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.ops import grouped_conv as gc
from nl_vsgg_tpu_torch.ops import masked_attention as ma
from nl_vsgg_tpu_torch.ops import roi_align as ra
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step

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


@pytest.mark.parametrize("N,H,W,C", [(2, 152, 256, 256), (2, 76, 128, 512), (3, 38, 64, 1024),
                                     (300, 7, 7, 2048), (5, 9, 13, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_conv_matches_plain_on_gpu(gpu, dtype, N, H, W, C):
    torch.backends.cudnn.allow_tf32 = False
    c = C // 32
    x = torch.randn(N, H, W, C, device="cuda", generator=gpu).to(dtype)
    w = (torch.randn(3, 3, c, C, device="cuda", generator=gpu) * c ** -0.5).to(dtype)
    bias = torch.randn(C, device="cuda", generator=gpu)
    for b, relu in ((None, False), (bias, True)):
        gc.reset_launches()
        out = gc.grouped_conv3x3(x, w, 32, b, relu)
        torch.cuda.synchronize()
        assert gc.LAUNCHES["grouped_conv3x3"] == 1 and out.dtype == dtype
        ref = gc.grouped_conv3x3_reference(x, w, 32, b, relu)
        if dtype == torch.float32:
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
        else:
            torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-3)
