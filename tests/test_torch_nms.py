"""The port's NMS ops against the JAX package's, per frame: `nms_topk` with
and without per-class suppression, padded (invalid) boxes and rows that run
out of survivors (indices and keep flags identical: both take the first
maximum among ties and compute the same float32 IoU); `nms_mask` and
`batched_nms_mask` batched over frames, with exact ties."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.ops.nms import batched_nms_mask as jax_batched_nms_mask
from nl_vsgg_tpu.ops.nms import nms_mask as jax_nms_mask
from nl_vsgg_tpu.ops.nms import nms_topk as jax_nms_topk
from nl_vsgg_tpu_torch.ops.nms import batched_nms_mask, nms_mask, nms_topk


def _case(rng, F_, n):
    xy = rng.uniform(0, 100, (F_, n, 2))
    wh = rng.uniform(5, 60, (F_, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (F_, n)).astype(np.float32)
    scores[:, ::9] = scores[:, 1::9]            # exact ties
    valid = rng.uniform(size=(F_, n)) > 0.2
    classes = rng.integers(1, 4, (F_, n)).astype(np.int32)
    return boxes, scores, valid, classes


@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("k,thresh", [(10, 0.5), (40, 0.3)])
def test_matches_jax(per_class, k, thresh):
    rng = np.random.default_rng(k)
    boxes, scores, valid, classes = _case(rng, 3, 36)
    got_idx, got_ok = nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, k,
                               valid=torch.from_numpy(valid),
                               class_ids=torch.from_numpy(classes) if per_class else None)
    assert got_idx.shape == got_ok.shape == (3, k)
    for f in range(3):
        idx, ok = jax_nms_topk(jnp.asarray(boxes[f]), jnp.asarray(scores[f]), thresh, k=k,
                               valid=jnp.asarray(valid[f]),
                               class_ids=jnp.asarray(classes[f]) if per_class else None)
        np.testing.assert_array_equal(got_ok[f].numpy(), np.asarray(ok))
        np.testing.assert_array_equal(got_idx[f].numpy(), np.asarray(idx))
    if k == 40:
        assert not got_ok[:, -1].any()          # rows ran out: padded with (0, False)
        assert (got_idx[~got_ok] == 0).all()


@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("thresh,plus_one", [(0.4, True), (0.6, False)])
def test_nms_mask_matches_jax(per_class, thresh, plus_one):
    """Greedy keep flags over 3 frames of 120 boxes in one batched call
    against JAX per frame: exact score ties (every 9th box copies its
    neighbour's score, every 5th is 0.5), invalid boxes, three classes.
    Flags must be identical: both sort stably and compute the same float32
    IoU."""
    rng = np.random.default_rng(3)
    boxes, scores, valid, classes = _case(rng, 3, 120)
    scores[:, ::5] = 0.5
    tb, ts, tv, tc = (torch.from_numpy(a) for a in (boxes, scores, valid, classes))
    if per_class:
        got = batched_nms_mask(tb, ts, tc, thresh, valid=tv, plus_one=plus_one)
    else:
        got = nms_mask(tb, ts, thresh, valid=tv, plus_one=plus_one)
    assert got.shape == (3, 120) and not got[~tv].any()
    for f in range(3):
        args = (jnp.asarray(boxes[f]), jnp.asarray(scores[f]))
        if per_class:
            ref = jax_batched_nms_mask(*args, jnp.asarray(classes[f]), thresh,
                                       valid=jnp.asarray(valid[f]), plus_one=plus_one)
        else:
            ref = jax_nms_mask(*args, thresh, valid=jnp.asarray(valid[f]), plus_one=plus_one)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(tv.sum())


def test_nms_mask_without_valid_is_all_valid():
    rng = np.random.default_rng(4)
    boxes, scores, _, _ = _case(rng, 1, 50)
    tb, ts = torch.from_numpy(boxes[0]), torch.from_numpy(scores[0])
    ref = jax_nms_mask(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.5)
    np.testing.assert_array_equal(nms_mask(tb, ts, 0.5).numpy(), np.asarray(ref))
    np.testing.assert_array_equal(nms_mask(tb, ts, 0.5).numpy(),
                                  nms_mask(tb, ts, 0.5, valid=torch.ones(50, dtype=torch.bool)).numpy())
