"""`data/gt_entry.build_gt_entry` against the JAX function on the micro
Action Genome's test GT, predcls (with union features, host masks and the
device-mask sentinel) and sgcls (the VinVL classifier's soft
distributions, drawn with the same generator), through the same numpy
stand-ins for the detector's feature, union and classifier functions:
every Entry field exact."""

import dataclasses
import os

import numpy as np
import pytest

from nl_vsgg_tpu.data.action_genome import AGTest as JAGTest
from nl_vsgg_tpu.data.gt_entry import build_gt_entry as j_build_gt_entry
from nl_vsgg_tpu_torch.data.action_genome import AGTest
from nl_vsgg_tpu_torch.data.entry import Entry
from nl_vsgg_tpu_torch.data.gt_entry import build_gt_entry
from tests.fixtures import build_micro_ag

FEAT = 64


@pytest.fixture(scope="module")
def ann(tmp_path_factory):
    return os.path.join(build_micro_ag(str(tmp_path_factory.mktemp("ag")), n_videos=3,
                                       n_frames=4, feat_dim=FEAT), "annotations")


def feature_fn(i, boxes):
    b = np.asarray(boxes, np.float32)
    return np.sin(b.sum(1, keepdims=True) / 97.0 + i + np.arange(FEAT, dtype=np.float32) / 7.0)


def union_fn(i, boxes):
    return np.broadcast_to(feature_fn(i, boxes)[:, None, None, :] * 0.5,
                           (len(boxes), 7, 7, FEAT)).astype(np.float32)


_W = np.random.default_rng(3).standard_normal((FEAT, 1595)).astype(np.float32)


def classify_fn(feats):
    return np.asarray(feats, np.float32) @ _W


def same_entry(ours: Entry, ref) -> None:
    for f in dataclasses.fields(Entry):
        a, b = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("mode,masks", [("predcls", True), ("predcls", False),
                                        ("sgcls", True)])
def test_build_gt_entry_matches_jax(ann, mode, masks):
    gts, jgts = AGTest(ann).gt_annotations, JAGTest(ann).gt_annotations
    assert len(gts) == 3
    for gt, jgt in zip(gts, jgts):
        kw = dict(union_feature_fn=union_fn if mode == "predcls" else None,
                  classify_fn=classify_fn if mode == "sgcls" else None, feat_dim=FEAT,
                  compute_spatial_masks=masks)
        ours = build_gt_entry(gt, mode, 16, 12, feature_fn, rng=np.random.default_rng(7), **kw)
        ref = j_build_gt_entry(jgt, mode, 16, 12, feature_fn, rng=np.random.default_rng(7),
                               **kw)
        same_entry(ours, ref)
        assert bool(ours.rel_mask.any()) and int(ours.box_mask.sum()) == 12
        if mode == "predcls":
            assert bool(ours.union_feat[ours.rel_mask].any())
            assert ours.spatial_masks.shape[-1] == (2 if masks else 0)


def test_build_gt_entry_refuses(ann):
    gt = AGTest(ann).gt_annotations[0]
    with pytest.raises(ValueError, match="predcls and sgcls"):
        build_gt_entry(gt, "sgdet", 16, 12, feature_fn, feat_dim=FEAT)
    with pytest.raises(ValueError, match="classify_fn"):
        build_gt_entry(gt, "sgcls", 16, 12, feature_fn, feat_dim=FEAT)
