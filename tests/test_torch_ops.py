"""The port's box geometry and union-mask rasterizer against nl_vsgg_tpu.ops
on random and degenerate boxes, to 1e-6 (float32 on both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.ops import boxes as jb
from nl_vsgg_tpu.ops import union_masks as jum
from nl_vsgg_tpu_torch.ops import boxes as tb
from nl_vsgg_tpu_torch.ops import union_masks as tum

TOL = dict(rtol=1e-6, atol=1e-6)


def random_boxes(rng, n, degenerate):
    xy = rng.uniform(0, 500, (n, 2))
    wh = rng.uniform(1, 200, (n, 2))
    b = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if degenerate:
        b[::3] = 0.0                      # all-zero padding boxes
        b[1::3, 2:] = b[1::3, :2]         # zero-area boxes
    return b


def close(t_out, j_out):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
def test_pairwise_boxes(degenerate, plus_one):
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 7, degenerate), random_boxes(rng, 5, degenerate)
    ta, tb_, ja, jb_ = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    close(tb.iou(ta, tb_, plus_one), jb.iou(ja, jb_, plus_one))
    close(tb.intersection_ratio(ta, tb_, plus_one), jb.intersection_ratio(ja, jb_, plus_one))
    close(tb.box_area(ta, plus_one), jb.box_area(ja, plus_one))
    close(tb.generalized_iou(ta, tb_), jb.generalized_iou(ja, jb_))


@pytest.mark.parametrize("degenerate", [False, True])
def test_conversions_and_union(degenerate):
    rng = np.random.default_rng(1)
    a = random_boxes(rng, 9, degenerate)
    ta, ja = torch.from_numpy(a), jnp.asarray(a)
    for name in ("center_size", "xyxy_to_cxcywh", "cxcywh_to_xyxy", "xyxy_to_xywh",
                 "xywh_to_cxcywh"):
        close(getattr(tb, name)(ta), getattr(jb, name)(ja))
    pair = rng.integers(0, 9, (6, 2)).astype(np.int32)
    close(tb.union_boxes(ta, torch.from_numpy(pair)), jb.union_boxes(ja, jnp.asarray(pair)))


def test_batched_pairwise():
    rng = np.random.default_rng(2)
    a = np.stack([random_boxes(rng, 4, True) for _ in range(3)])
    close(tb.iou(torch.from_numpy(a), torch.from_numpy(a)), jb.iou(jnp.asarray(a), jnp.asarray(a)))


@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("as_nchw", [False, True])
def test_draw_union_boxes(degenerate, as_nchw):
    rng = np.random.default_rng(3)
    rois = np.concatenate([random_boxes(rng, 10, degenerate),
                           random_boxes(rng, 10, degenerate)], -1).reshape(2, 5, 8)
    t = tum.draw_union_boxes(torch.from_numpy(rois), 27, as_nchw)
    j = jum.draw_union_boxes(jnp.asarray(rois), 27, as_nchw)
    assert tuple(t.shape) == j.shape
    assert torch.isfinite(t).all()
    close(t, j)
