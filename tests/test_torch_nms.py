"""The port's batched `nms_topk` against the JAX package's, per frame, with
and without per-class suppression, padded (invalid) boxes and rows that run
out of survivors. Indices and keep flags must be identical: both take the
first maximum among ties and compute the same float32 IoU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.ops.nms import nms_topk as jax_nms_topk
from nl_vsgg_tpu_torch.ops.nms import nms_topk


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
