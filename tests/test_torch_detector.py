"""The port's VinVL detector (`nl_vsgg_tpu_torch.detector`) against the JAX
package's (`nl_vsgg_tpu.detector`) on the CPU: the residual blocks at narrow
widths, anchors and proposal / detection selection, both weight converters,
the cv2-free preprocess, and the slice as a whole at full width (detect and
RoI features of a 96x128 image through the full ResNeXt-152-C4, RPN and C5
head on the same weights).

Tolerances, each with its reason:
  * blocks at narrow widths, unit-scale inputs: 1e-5 (float32 convs summed
    in another order);
  * full width: relative to each tensor's largest magnitude, 1e-4: the
    same float32 math through 50 residual blocks in another order (the JAX
    side computes grouped convs through the EFF_GROUPS block-diagonal
    packing, the port through native groups);
  * detections at full width: continuous outputs compared at given
    proposals; the final lists matched by label and box, and every one of
    the JAX package's valid detections must find its match: the
    candidates' scores lie further apart than the float32 noise, so no
    threshold or NMS decision flips. Random weights give boxes a fraction
    of a pixel wide, on which IoU is ill-conditioned (0.004 px moves it by
    9%), so boxes match when every corner agrees to 0.05 px (4e-4 of the
    image); scores to 1e-3 relative (a softmax of logits that agree to
    1e-4);
  * preprocess against cv2's uint8 resize: at most 1.0 pixel unit (cv2's
    fixed-point bilinear weights; the port rounds its float resize to the
    same uint8 grid).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nl_vsgg_tpu.detector import anchors as janchors
from nl_vsgg_tpu.detector.attr_rcnn import AttrRCNNJax
from nl_vsgg_tpu.detector.attr_rcnn import compute_scale as jax_compute_scale
from nl_vsgg_tpu.detector.attr_rcnn import preprocess as jax_preprocess
from nl_vsgg_tpu.detector.convert import convert_state_dict
from nl_vsgg_tpu.detector.resnet import Bottleneck as JBottleneck
from nl_vsgg_tpu.detector.resnet import Stage as JStage
from nl_vsgg_tpu.detector.resnet import pack_grouped_kernel
from nl_vsgg_tpu.detector.roi_box import postprocess_detections as jax_postprocess
from nl_vsgg_tpu.detector.rpn import decode_boxes as jax_decode
from nl_vsgg_tpu.detector.rpn import select_proposals as jax_select
from nl_vsgg_tpu_torch.detector import anchors as tanchors
from nl_vsgg_tpu_torch.detector.attr_rcnn import (AttrRCNNTorch, compute_scale, preprocess,
                                                  resize_hw)
from nl_vsgg_tpu_torch.detector.convert import (from_jax_variables, from_maskrcnn_state_dict,
                                                unpack_grouped_kernel)
from nl_vsgg_tpu_torch.detector.resnet import Bottleneck, Stage
from nl_vsgg_tpu_torch.detector.roi_box import postprocess_detections
from nl_vsgg_tpu_torch.detector.rpn import decode_boxes, select_proposals
from tests.fixtures import make_vinvl_state_dict

REL = 1e-4


def rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _randomize_bn(params, rng):
    for k, v in params.items():
        if isinstance(v, dict):
            _randomize_bn(v, rng)
        elif k in ("scale", "bias"):
            params[k] = (rng.uniform(0.5, 1.5, v.shape) if k == "scale"
                         else rng.standard_normal(v.shape) * 0.1).astype(np.float32)


def _port_params(variables, prefix, groups):
    sd = from_jax_variables(variables, groups)
    return {k.removeprefix(prefix): v for k, v in sd.items()}


# ------------------------------------------------------- residual blocks
@pytest.mark.parametrize("stride,downsample", [(1, False), (1, True), (2, True)])
def test_bottleneck_matches_jax(stride, downsample):
    rng = np.random.default_rng(stride + 2 * downsample)
    cin, mid, cout, groups = (32 if downsample else 64), 64, 64, 8
    x = rng.standard_normal((2, 9, 10, cin)).astype(np.float32)
    jb = JBottleneck(mid, cout, stride=stride, groups=groups, has_downsample=downsample)
    params = jax.tree.map(np.asarray, jb.init(jax.random.key(0), jnp.asarray(x)))["params"]
    _randomize_bn(params, rng)
    ref = np.asarray(jb.apply({"params": params}, jnp.asarray(x)))
    tb = Bottleneck(cin, mid, cout, stride, groups, downsample)
    tb.load_state_dict(_port_params({"params": {"b": params}}, "b.", groups))
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_stage_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    js = JStage(3, 64, 64, 2, groups=16)
    params = jax.tree.map(np.asarray, js.init(jax.random.key(1), jnp.asarray(x)))["params"]
    _randomize_bn(params, rng)
    ref = np.asarray(js.apply({"params": params}, jnp.asarray(x)))
    ts = Stage(3, 32, 64, 64, 2, groups=16)
    ts.load_state_dict(_port_params({"params": {"s": params}}, "s.", 16))
    with torch.no_grad():
        got = ts(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- anchors and selection
def test_anchors_and_decode_match_jax():
    np.testing.assert_array_equal(tanchors.grid_anchors(5, 7), janchors.grid_anchors(5, 7))
    rng = np.random.default_rng(0)
    a = tanchors.grid_anchors(3, 4)
    d = (rng.standard_normal((a.shape[0], 4)) * 2).astype(np.float32)   # some dw/dh clipped
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(decode_boxes(torch.from_numpy(a), torch.from_numpy(d), w),
                                   np.asarray(jax_decode(jnp.asarray(a), jnp.asarray(d), w)),
                                   rtol=1e-6, atol=1e-4)


def test_select_proposals_matches_jax():
    rng = np.random.default_rng(1)
    anchors = tanchors.grid_anchors(6, 8)                 # 720 anchors
    obj = rng.standard_normal((2, anchors.shape[0])).astype(np.float32)
    obj[:, 100:110] = obj[:, 50:51]                         # exact ties in the top-k
    deltas = (rng.standard_normal((2, anchors.shape[0], 4)) * 0.3).astype(np.float32)
    im_hw = np.array([[96.0, 128.0], [80.0, 112.0]], np.float32)
    got, ok = select_proposals(torch.from_numpy(anchors), torch.from_numpy(obj),
                               torch.from_numpy(deltas), torch.from_numpy(im_hw),
                               pre_nms_top_n=400, post_nms_top_n=60)
    for f in range(2):
        ref, rok = jax_select(jnp.asarray(anchors), jnp.asarray(obj[f]), jnp.asarray(deltas[f]),
                              jnp.asarray(im_hw[f]), pre_nms_top_n=400, post_nms_top_n=60)
        np.testing.assert_array_equal(ok[f].numpy(), np.asarray(rok))
        np.testing.assert_allclose(got[f].numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("sharp", [False, True])
def test_postprocess_matches_jax(sharp):
    """`sharp` puts many candidates above the 0.2 threshold; otherwise the
    10-detection fallback fills the list."""
    rng = np.random.default_rng(2 + sharp)
    F_, n, c = 2, 24, 31
    logits = (rng.standard_normal((F_, n, c)) * (6.0 if sharp else 0.5)).astype(np.float32)
    deltas = (rng.standard_normal((F_, n, 4 * c)) * 0.5).astype(np.float32)
    xy = rng.uniform(0, 80, (F_, n, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 40, (F_, n, 2))], -1).astype(np.float32)
    pvalid = rng.uniform(size=(F_, n)) > 0.1
    im_hw = np.array([[96.0, 128.0], [90.0, 120.0]], np.float32)
    got = postprocess_detections(*(torch.from_numpy(a) for a in (logits, deltas, props, pvalid,
                                                                 im_hw)), max_dets=20)
    for f in range(F_):
        ref = jax_postprocess(jnp.asarray(logits[f]), jnp.asarray(deltas[f]),
                              jnp.asarray(props[f]), jnp.asarray(pvalid[f]),
                              jnp.asarray(im_hw[f]), max_dets=20)
        for key in ("labels", "box_index", "valid"):
            np.testing.assert_array_equal(got[key][f].numpy(), np.asarray(ref[key]), key)
        for key in ("boxes", "scores"):
            np.testing.assert_allclose(got[key][f].numpy(), np.asarray(ref[key]),
                                       rtol=1e-5, atol=1e-4, err_msg=key)
    assert int(got["valid"].sum(1).min()) >= 10


# ------------------------------------------------------------- converters
def test_unpack_inverts_pack():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 8, 256)).astype(np.float32)
    for eff in (1, 4, 8, 32):
        np.testing.assert_array_equal(unpack_grouped_kernel(pack_grouped_kernel(w, 32, eff)), w)


@pytest.fixture(scope="module")
def vinvl():
    """A full-size VinVL checkpoint-layout state dict with folded-BN
    statistics, its JAX variables and the port's state_dict from each path."""
    sd = make_vinvl_state_dict(np.random.default_rng(11), randomize_bn=True)
    variables = convert_state_dict(sd)
    return sd, variables, from_maskrcnn_state_dict(sd), from_jax_variables(variables)


def test_converters_agree(vinvl):
    _, _, port_sd, via_jax = vinvl
    assert port_sd.keys() == via_jax.keys()
    for k in port_sd:
        assert port_sd[k].shape == via_jax[k].shape, k
        torch.testing.assert_close(port_sd[k], via_jax[k], rtol=0, atol=0, msg=k)
    assert not any("attribute" in k for k in port_sd)
    assert port_sd["backbone.layer1.block0.conv2.weight"].shape == (256, 8, 3, 3)
    from nl_vsgg_tpu_torch.detector.attr_rcnn import AttrRCNNModule
    assert port_sd.keys() == AttrRCNNModule().state_dict().keys()


# --------------------------------------------------------------- preprocess
def test_preprocess_matches_cv2_within_one_unit():
    rng = np.random.default_rng(4)
    for h, w in ((240, 320), (500, 333), (600, 800), (120, 500)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ref, ref_scale, ref_hw = jax_preprocess(img)
        got, scale, hw = preprocess(img)
        assert hw == ref_hw == resize_hw(h, w) and got.shape == ref.shape
        np.testing.assert_array_equal(scale, ref_scale)
        assert float(np.abs(got.numpy() - ref).max()) <= 1.0
        assert compute_scale(h, w) == jax_compute_scale(h, w)


# ----------------------------------------------------- the slice, full width
@pytest.fixture(scope="module")
def detectors(vinvl):
    """Both packages' full-width detectors on the same weights, scaled so
    activations stay finite and moderate through 50 random residual blocks
    (convs at fan-in scale, bn3 / downsample scales 0.2)."""
    sd = dict(vinvl[0])
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 4:
            sd[k] = (v / 0.05 * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
        elif k.endswith(("bn3.weight", "downsample.1.weight")):
            sd[k] = v * np.float32(0.2)
    jdet = AttrRCNNJax(convert_state_dict(sd), max_proposals=50, max_dets=20)
    tdet = AttrRCNNTorch(from_maskrcnn_state_dict(sd), max_proposals=50, max_dets=20,
                         device="cpu")
    # a preprocessed (mean-subtracted) 96x128 image fed to both packages
    img = np.random.default_rng(6).uniform(-120, 140, (96, 128, 3)).astype(np.float32)
    return jdet, tdet, img


def test_full_width_features_rpn_and_box_head(detectors):
    jdet, tdet, img = detectors
    ap = jdet._apply
    c4j = np.asarray(ap(jdet.variables, jnp.asarray(img)[None], method="features"))
    with torch.inference_mode():
        c4t = tdet.module.features(torch.from_numpy(img)[None])
    assert c4t.shape == c4j.shape == (1, 6, 8, 1024)
    assert rel_err(c4t, c4j) < REL
    lj, dj = ap(jdet.variables, jnp.asarray(c4j), method="rpn")
    with torch.inference_mode():
        lt, dt = tdet.module.rpn(torch.from_numpy(c4j.copy()))
    assert rel_err(lt.view(np.asarray(lj).shape), lj) < REL
    assert rel_err(dt.reshape(np.asarray(dj).shape), dj) < REL
    boxes = np.array([[5, 5, 60, 60], [20, 10, 110, 80], [0, 0, 127, 95], [50, 40, 50, 40],
                      [-30, -30, 10, 10]], np.float32)
    cj, bj, fj = ap(jdet.variables, jnp.asarray(c4j[0]), jnp.asarray(boxes), method="box")
    with torch.inference_mode():
        ct, bt, ft = tdet.module.box(torch.from_numpy(c4j.copy()), torch.from_numpy(boxes))
    for got, ref in ((ct, cj), (bt, bj), (ft, fj)):
        assert rel_err(got, ref) < REL
    feats = tdet.extract_box_features(img, boxes, preprocessed=True)
    assert feats.shape == (5, 7, 7, 2048)
    assert rel_err(feats, jdet.extract_box_features(img, boxes, preprocessed=True)) < REL


def test_full_width_detect(detectors):
    jdet, tdet, img = detectors
    fh, fw = img.shape[0] // 16, img.shape[1] // 16
    im_hw = np.array([96.0, 128.0], np.float32)
    ref = np.asarray(jdet._detect(jdet.variables, jnp.asarray(img)[None],
                                  jnp.asarray(janchors.grid_anchors(fh, fw)),
                                  jnp.asarray(im_hw)))
    got = tdet.detect_packed(torch.from_numpy(img)[None], torch.from_numpy(im_hw)[None])[0]
    assert got.shape == ref.shape == (20, 8 + 2048)
    assert np.isfinite(got.numpy()).all()
    rvalid, gvalid = ref[:, 7] > 0.5, got[:, 7].numpy() > 0.5
    assert rvalid.sum() >= 10 and gvalid.sum() == rvalid.sum()
    rb, gb = torch.from_numpy(ref[rvalid]), got[gvalid]
    near = (rb[:, None, :4] - gb[None, :, :4]).abs().amax(-1) < 0.05
    match = near & (rb[:, None, 5] == gb[None, :, 5])
    assert bool(match.any(1).all()), "a JAX detection has no match in the port's list"
    j = match.float().argmax(1)
    np.testing.assert_allclose(got[gvalid][j, 4].numpy(), ref[rvalid, 4], rtol=1e-3)
    assert rel_err(got[gvalid][j, 8:], ref[rvalid, 8:]) < REL


def test_video_and_frame_entry_points(detectors):
    """detect_video on two frames of different sizes (shared bucket,
    per-frame extents) equals per-frame detect; frame-indexed features
    equal per-image features; make_union_feature_fn serves the same."""
    _, tdet, _ = detectors
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
              rng.integers(0, 256, (90, 128, 3), dtype=np.uint8)]
    video = tdet.detect_video(frames)
    single = tdet.detect(frames[1])
    assert len(video) == 2 and video[1]["features"].shape == (20, 2048)
    # frame 1 in the video is padded to frame 0's bucket: same extents, same clip
    np.testing.assert_array_equal(video[1]["valid"], single["valid"])
    boxes = np.array([[5, 5, 60, 60], [10, 20, 100, 70], [0, 0, 40, 30]], np.float32)
    fidx = np.array([0, 1, 1])
    feats = tdet.extract_box_features_frames(frames, boxes, fidx)
    union = tdet.make_union_feature_fn(frames)
    np.testing.assert_allclose(feats[1:], union(1, boxes[1:]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feats[:1], tdet.extract_box_features(frames[0], boxes[:1]),
                               rtol=1e-5, atol=1e-5)


def test_bf16_tracks_fp32(detectors, vinvl):
    """bf16 compute against the port's own fp32, by correlation and scale
    (as tests/test_detector.py holds the JAX bf16 mode)."""
    _, tdet, img = detectors
    t16 = AttrRCNNTorch(tdet.module.state_dict(), max_proposals=50, max_dets=20,
                        compute_dtype="bfloat16", device="cpu")
    boxes = np.array([[5, 5, 60, 60], [20, 10, 110, 80]], np.float32)
    f32 = tdet.extract_box_features(img, boxes, preprocessed=True).ravel()
    f16 = t16.extract_box_features(img, boxes, preprocessed=True).ravel()
    assert f16.dtype == np.float32 and np.isfinite(f16).all()
    assert np.corrcoef(f32, f16)[0, 1] > 0.995
    assert 0.9 < np.abs(f16).mean() / np.abs(f32).mean() < 1.1


def test_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AttrRCNNTorch({}, device=None)

