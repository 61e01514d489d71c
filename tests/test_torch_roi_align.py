"""The port's RoIAlign (`nl_vsgg_tpu_torch.ops.roi_align`, the plain version
the CPU takes) against the JAX package's `roi_align_mm`,
`roi_align_mm_frames` and the Pallas `roi_align_pallas_tiled` in interpret
mode, at 7x7 and 14x14, with degenerate, clamped and fully outside rois.

Tolerance 1e-5 absolute on maps of unit scale: both sides compute the same
separable float32 sums, in another order (the JAX matmuls at HIGHEST
precision)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.ops.pallas_roi_align import roi_align_pallas_tiled
from nl_vsgg_tpu.ops.roi_align_mm import roi_align_mm, roi_align_mm_frames
from nl_vsgg_tpu_torch.ops import roi_align as tra

TOL = dict(rtol=0, atol=1e-5)


def _rois(rng, n, H, W):
    x = np.sort(rng.uniform(-20, W * 16 + 20, (n, 2)), axis=1)
    y = np.sort(rng.uniform(-20, H * 16 + 20, (n, 2)), axis=1)
    r = np.stack([x[:, 0], y[:, 0], x[:, 1] + 1, y[:, 1] + 1], 1)
    edge = np.array([[0, 0, 0, 0],                     # zero size -> clamped to 1x1
                     [-500, -500, -400, -400],         # fully outside -> 0
                     [0, 0, W * 16 - 1, H * 16 - 1],   # the whole map
                     [W * 16 - 8, H * 16 - 8, W * 16 + 40, H * 16 + 40],  # past the edge
                     [30, 20, 29, 19]])                # inverted -> clamped
    return np.concatenate([r, edge]).astype(np.float32)


@pytest.mark.parametrize("output_size", [(7, 7), (14, 14)])
def test_matches_roi_align_mm(output_size):
    rng = np.random.default_rng(0)
    fmap = rng.standard_normal((9, 11, 16)).astype(np.float32)
    rois = _rois(rng, 12, 9, 11)
    ref = np.asarray(roi_align_mm(jnp.asarray(fmap), jnp.asarray(rois), output_size=output_size))
    got = tra.roi_align(torch.from_numpy(fmap), torch.from_numpy(rois), output_size=output_size)
    assert got.shape == (rois.shape[0], *output_size, 16)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert got[13].abs().max() == 0.0      # the fully outside roi


@pytest.mark.parametrize("output_size", [(7, 7), (14, 14)])
def test_matches_pallas_tiled_interpret(output_size):
    rng = np.random.default_rng(1)
    fmap = rng.standard_normal((6, 8, 128)).astype(np.float32)
    rois = _rois(rng, 6, 6, 8)
    ref = np.asarray(roi_align_pallas_tiled(jnp.asarray(fmap), jnp.asarray(rois),
                                            output_size=output_size, interpret=True))
    got = tra.roi_align(torch.from_numpy(fmap), torch.from_numpy(rois), output_size=output_size)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_frames_match_roi_align_mm_frames():
    rng = np.random.default_rng(2)
    fmaps = rng.standard_normal((3, 9, 10, 8)).astype(np.float32)
    rois = _rois(rng, 10, 9, 10)
    fidx = rng.integers(0, 3, rois.shape[0]).astype(np.int32)
    ref = np.asarray(roi_align_mm_frames(jnp.asarray(fmaps), jnp.asarray(rois),
                                         jnp.asarray(fidx), output_size=(14, 14)))
    got = tra.roi_align(torch.from_numpy(fmaps), torch.from_numpy(rois),
                        torch.from_numpy(fidx), output_size=(14, 14))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_bf16_map_and_output_dtype():
    """A bf16 map is sampled in fp32 and the crops rounded once: the same as
    aligning the bf16-rounded map in fp32 and casting (the JAX bf16 path)."""
    rng = np.random.default_rng(3)
    fmap = torch.from_numpy(rng.standard_normal((1, 6, 7, 8)).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 5, 6, 7))
    ref = tra.roi_align(fmap.bfloat16().float(), rois).bfloat16()
    got = tra.roi_align(fmap.bfloat16(), rois)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert tra.roi_align(fmap, rois, out_dtype=torch.bfloat16).dtype == torch.bfloat16


def test_rejects_bad_inputs():
    fm = torch.zeros(2, 4, 4, 8)
    rois = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="frame_idx"):
        tra.roi_align(fm, rois)                                 # two maps, no frame_idx
    with pytest.raises(ValueError, match="out of range"):
        tra.roi_align(fm, rois, torch.tensor([0, 1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="rois"):
        tra.roi_align(fm[0], torch.zeros(3, 5))


def _edge_rois(H, W):
    """The rois whose samples reach the kernel's edges: the whole map, wholly
    outside on each side, degenerate and inverted, past the far edge, a
    sliver one row tall, and rois straddling each border."""
    w, h = W * 16.0, H * 16.0
    return np.array([[0, 0, w - 1, h - 1], [-16, -16, w + 15, h + 15],   # whole map, beyond it
                     [-500, -500, -400, -400], [w + 40, 10, w + 90, 50],  # outside, left / right
                     [10, h + 40, 50, h + 90], [10, -90, 50, -40],        # outside, below / above
                     [0, 0, 0, 0], [30, 20, 29, 19],                      # degenerate, inverted
                     [w - 8, h - 8, w + 40, h + 40],                      # past the far edge
                     [5, 33, w - 5, 34],                                  # one row tall
                     [-30, 20, 40, 60], [w - 40, 20, w + 30, 60],         # straddling left / right
                     [20, -30, 60, 40], [20, h - 40, 60, h + 30]], np.float32)


@pytest.mark.parametrize("sampling_ratio", [1, 2, 4])
def test_edge_rois_match_roi_align_mm(sampling_ratio):
    """The whole-map, outside, degenerate and border rois at S = 1, 2, 4 and
    an odd channel count (the kernel's scalar route), against the JAX
    package; wholly outside rois give exact zeros."""
    rng = np.random.default_rng(4)
    H, W = 9, 11
    fmap = rng.standard_normal((H, W, 5)).astype(np.float32)
    rois = _edge_rois(H, W)
    ref = np.asarray(roi_align_mm(jnp.asarray(fmap), jnp.asarray(rois), output_size=(14, 14),
                                  sampling_ratio=sampling_ratio))
    got = tra.roi_align(torch.from_numpy(fmap), torch.from_numpy(rois), output_size=(14, 14),
                        sampling_ratio=sampling_ratio)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert (got[2:6] == 0).all()
