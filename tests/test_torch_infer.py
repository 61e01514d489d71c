"""The port's non-wks inference glue against the JAX package's on the same
seeded detections: `sgdet_assign` (the class 5/8/17 duplicates, per-class
NMS, frames with no boxes), `sgcls_assign` and `build_infer_entry` (both
spatial-mask modes, a union-feature provider, the no-pairs None).

sgdet/sgcls assignment is the same numpy code on both sides: every output
is identical. Entry fields: integers and masks identical, floats within
1e-6 (the spatial masks are rasterized by torch here and by XLA there, in
float32 on both)."""

import dataclasses

import numpy as np
import pytest

from nl_vsgg_tpu.data.infer_entry import build_infer_entry as j_build
from nl_vsgg_tpu.models.sgcls_infer import sgcls_assign as j_sgcls
from nl_vsgg_tpu.models.sgdet_infer import sgdet_assign as j_sgdet
from nl_vsgg_tpu_torch.data.entry import Entry
from nl_vsgg_tpu_torch.data.infer_entry import build_infer_entry
from nl_vsgg_tpu_torch.models.sgcls_infer import sgcls_assign
from nl_vsgg_tpu_torch.models.sgdet_infer import clean_class, sgdet_assign

FEAT = 16
FTOL = 1e-6


def detections(seed, frames=(0, 0, 0, 0, 0, 2, 2, 2, 2, 3, 3, 3)):
    """Clustered boxes (so NMS suppresses), 36-way softmax rows leaning to
    classes 5, 8 and 17 (so clean_class duplicates fire); frame 1 has no
    box."""
    r = np.random.default_rng(seed)
    frames = np.asarray(frames, np.int64)
    n = len(frames)
    centers = r.uniform(50, 200, (n, 2))
    wh = r.uniform(30, 80, (n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    logits = r.standard_normal((n, 36)).astype(np.float32)
    logits[:, [4, 7, 16]] += 1.5
    logits[::4, 0] += 3.0                       # person-like boxes
    dist = np.exp(logits)
    dist /= dist.sum(1, keepdims=True)
    feats = r.standard_normal((n, FEAT)).astype(np.float32)
    return boxes, frames, dist, feats


def assert_same_dict(ours, ref):
    assert ours.keys() == ref.keys()
    for k in ref:
        assert np.asarray(ours[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sgdet_assign_matches_jax(seed):
    boxes, frames, dist, feats = detections(seed)
    labels = dist[:, 1:].argmax(1) + 2
    assert {5, 8, 17} & set(labels.tolist())
    ours = sgdet_assign(boxes, frames, dist, feats)
    ref = j_sgdet(boxes, frames, dist, feats)
    assert_same_dict(ours, ref)
    assert 1 not in ours["im_idx"] and 1 not in ours["box_frame"]
    # clean_class appended duplicates (before NMS) for these detections
    assert sum(len(clean_class(boxes, frames, dist, feats, labels, c)[0]) - len(boxes)
               for c in (5, 8, 17)) > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_sgcls_assign_matches_jax(seed):
    r = np.random.default_rng(seed)
    frames = np.repeat(np.arange(4), 5)
    logits = r.standard_normal((20, 37)).astype(np.float32)
    logits[:, 6] += 1.0                          # duplicates of one class
    assert_same_dict(sgcls_assign(logits, frames), j_sgcls(logits, frames))


def union_fn(f, union):
    """A deterministic stand-in for the detector's union features."""
    base = union.sum(1, keepdims=True)[:, :, None, None] / 100.0 + f
    return np.broadcast_to(base, (len(union), 7, 7, FEAT)).astype(np.float32)


def assert_same_entry(ours: Entry, ref):
    for field in dataclasses.fields(Entry):
        a = getattr(ours, field.name).numpy()
        b = np.asarray(getattr(ref, field.name))
        assert a.shape == b.shape, field.name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=FTOL, rtol=0, err_msg=field.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field.name)


@pytest.mark.parametrize("masks", [True, False])
@pytest.mark.parametrize("with_union", [False, True])
def test_build_infer_entry_matches_jax_sgdet(masks, with_union):
    boxes, frames, dist, feats = detections(5)
    assign = sgdet_assign(boxes, frames, dist, feats)
    kw = dict(num_frames=4, bucket_boxes=32, bucket_rels=24, feat_dim=FEAT,
              union_feat_fn=union_fn if with_union else None, compute_spatial_masks=masks)
    ours, ref = build_infer_entry(assign, **kw), j_build(assign, **kw)
    assert_same_entry(ours, ref)
    assert ours.spatial_masks.shape[-1] == (2 if masks else 0)
    assert int(ours.rel_mask.sum()) == len(assign["pair_idx"]) > 0


def test_build_infer_entry_sgcls_and_no_pairs():
    r = np.random.default_rng(6)
    frames = np.repeat(np.arange(3), 4)
    logits = r.standard_normal((12, 37)).astype(np.float32)
    boxes = np.sort(r.uniform(0, 300, (12, 4)).astype(np.float32), axis=1)
    feats = r.standard_normal((12, FEAT)).astype(np.float32)
    assign = sgcls_assign(logits, frames)
    assign.update(boxes=boxes, box_frame=frames, features=feats)
    kw = dict(num_frames=3, bucket_boxes=16, bucket_rels=12, feat_dim=FEAT,
              compute_spatial_masks=False)
    assert_same_entry(build_infer_entry(assign, **kw), j_build(assign, **kw))
    # one box a frame: every box is its frame's human, so there is no pair
    lone = sgcls_assign(logits[:3], np.arange(3))
    lone.update(boxes=boxes[:3], box_frame=np.arange(3), features=feats[:3])
    assert len(lone["pair_idx"]) == 0
    assert build_infer_entry(lone, **kw) is None and j_build(lone, **kw) is None
