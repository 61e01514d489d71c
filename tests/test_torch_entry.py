"""The port's Entry contract against the JAX package's: the same numpy rng
gives bit-identical synthetic Entries, and padding / bucketing agree."""

import dataclasses

import numpy as np
import pytest
import torch

from nl_vsgg_tpu.data import entry as jentry
from nl_vsgg_tpu.data.synthetic import make_synthetic_entry as j_make
from nl_vsgg_tpu_torch.data import entry as tentry
from nl_vsgg_tpu_torch.data import schema as tschema
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry as t_make

FIELDS = [f.name for f in dataclasses.fields(jentry.Entry)]


def assert_same_entry(t: tentry.Entry, j: jentry.Entry):
    assert [f.name for f in dataclasses.fields(tentry.Entry)] == FIELDS
    for name in FIELDS:
        a = getattr(t, name).numpy()
        b = np.asarray(getattr(j, name))
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(n_frames=4, objs_per_frame=2, bucket_boxes=16, bucket_rels=12, feat_dim=32),
    dict(n_frames=6, objs_per_frame=3, bucket_boxes=20, bucket_rels=10, feat_dim=8),
    dict(n_frames=1, objs_per_frame=1, bucket_boxes=4, bucket_rels=4, feat_dim=16),
])
def test_synthetic_entry_bit_identical(kw):
    assert_same_entry(t_make(np.random.default_rng(11), **kw),
                      j_make(np.random.default_rng(11), **kw))


@pytest.mark.parametrize("n_boxes,n_rels", [(24, 16), (16, 12), (6, 5), (3, 8)])
def test_pad_entry_matches(n_boxes, n_rels):
    """Padding and truncation, including pair indices past a truncated box
    table (the relation is masked off and its indices zeroed)."""
    kw = dict(n_frames=4, objs_per_frame=2, bucket_boxes=12, bucket_rels=8, feat_dim=8)
    t = t_make(np.random.default_rng(2), **kw)
    j = j_make(np.random.default_rng(2), **kw)
    assert_same_entry(tentry.pad_entry(t, n_boxes, n_rels), jentry.pad_entry(j, n_boxes, n_rels))


@pytest.mark.parametrize("with_union,with_masks", [(True, True), (False, False)])
def test_empty_entry_matches(with_union, with_masks):
    assert_same_entry(tentry.empty_entry(5, 7, 16, with_union, with_masks),
                      jentry.empty_entry(5, 7, 16, with_union, with_masks))


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 200, 1000])
def test_pick_bucket_matches(n):
    sizes = (16, 64, 128, 256)
    assert tentry.pick_bucket(sizes, n) == jentry.pick_bucket(sizes, n)


@pytest.mark.parametrize("nb,nr", [(1, 1), (40, 10), (10, 90), (300, 5), (129, 129)])
def test_pick_joint_bucket_matches(nb, nr):
    boxes, rels = (32, 64, 128, 256), (16, 48, 96)
    assert (tentry.pick_joint_bucket(boxes, rels, nb, nr)
            == jentry.pick_joint_bucket(boxes, rels, nb, nr))


def test_stack_and_to():
    es = [t_make(np.random.default_rng(s), n_frames=2, objs_per_frame=1,
                 bucket_boxes=4, bucket_rels=4, feat_dim=8) for s in range(3)]
    b = tentry.stack_entries(es)
    assert b.boxes.shape == (3, 4, 4) and b.num_frames.shape == (3,)
    assert b.n_boxes == 4 and b.n_rels == 4
    moved = b.to("cpu")
    torch.testing.assert_close(moved.features, b.features)


def test_taxonomy_matches():
    from nl_vsgg_tpu.data import schema as jschema
    t, j = tschema.load_taxonomy(), jschema.load_taxonomy()
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.contacting_relationships == j.contacting_relationships
    for name in ("NUM_OBJ_CLASSES", "NUM_ATTENTION", "NUM_SPATIAL", "NUM_CONTACTING",
                 "NUM_PREDICATES"):
        assert getattr(tschema, name) == getattr(jschema, name)
