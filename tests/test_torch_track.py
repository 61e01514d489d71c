"""The port's Hungarian matcher and DSG-DETR tracker against the JAX
package's, on the cases of tests/test_matcher_track.py and
tests/test_dsg_sgcls_eval.py plus seeded synthetic videos.

Tolerances: the cost matrix at 1e-6 (float32 on both sides, the same sums
in another order); assignments, clusters and group ids exactly. The
auction solver (torch here, on the CPU) must give a permutation within
rows * eps of scipy's optimum, as the JAX test holds its own, and the
JAX auction's assignment on the same costs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.data.entry import empty_entry as j_empty_entry
from nl_vsgg_tpu.models import matcher as jm
from nl_vsgg_tpu.models import track as jt
from nl_vsgg_tpu_torch.data.entry import Entry
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.models import matcher as tm
from nl_vsgg_tpu_torch.models import track as tt
from tests.fixtures import load_tool


def _pair(rng, n, m, d=16):
    out = {"boxes": rng.uniform(0, 1, (n, 4)).astype(np.float32),
           "features": rng.standard_normal((n, d)).astype(np.float32),
           "dists": rng.uniform(0, 1, (n, 37)).astype(np.float32)}
    tgt = {"boxes": rng.uniform(0, 1, (m, 4)).astype(np.float32),
           "features": rng.standard_normal((m, d)).astype(np.float32),
           "dists": rng.uniform(0, 1, (m, 37)).astype(np.float32)}
    return out, tgt


@pytest.mark.parametrize("n,m", [(7, 5), (4, 4), (3, 6), (1, 1)])
def test_cost_matrix_and_assignment(n, m):
    rng = np.random.default_rng(n * 10 + m)
    out, tgt = _pair(rng, n, m)
    args = (out["boxes"], out["features"], out["dists"],
            tgt["boxes"], tgt["features"], tgt["dists"])
    ours = tm.HungarianMatcher(0.5, 1, 1, 0.5).cost_matrix(*args)
    ref = jm.HungarianMatcher(0.5, 1, 1, 0.5).cost_matrix(*args)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    o = tm.HungarianMatcher(0.5, 1, 1, 0.5)(out, tgt)
    r = jm.HungarianMatcher(0.5, 1, 1, 0.5)(out, tgt)
    for a, b in zip(o[:2], r[:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(o[2:], r[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.cosine_cost(torch.from_numpy(out["features"]),
                                              torch.from_numpy(tgt["features"])).numpy(),
                               np.asarray(jm.cosine_cost(jnp.asarray(out["features"]),
                                                         jnp.asarray(tgt["features"]))),
                               rtol=0, atol=1e-6)


def test_solve_lsap_host_is_scipy():
    cost = np.random.default_rng(0).uniform(0, 1, (5, 7))
    for a, b in zip(tm.solve_lsap_host(cost), jm.solve_lsap_host(cost)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,m", [(6, 6), (4, 7), (1, 3)])
def test_auction_matches_scipy_and_jax(n, m):
    rng = np.random.default_rng(n + m)
    for _ in range(5):
        cost = rng.uniform(0, 1, (n, m)).astype(np.float32)
        row, col = tm.solve_lsap_host(cost)
        ours = tm.solve_lsap_auction(torch.from_numpy(cost), n_iter=400).numpy()
        ref = np.asarray(jm.solve_lsap_auction(jnp.asarray(cost), n_iter=400))
        assert (ours >= 0).all() and len(set(ours.tolist())) == n  # a permutation
        assert cost[np.arange(n), ours].sum() <= cost[row, col].sum() + n / (n + 1) + 1e-6
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        tm.solve_lsap_auction(torch.zeros(3, 2))


def test_auction_exact_on_separated_costs():
    """Small eps on a cost matrix whose optimum beats every other
    assignment by more than n * eps: scipy's assignment exactly."""
    rng = np.random.default_rng(7)
    n = 5
    perm = rng.permutation(n)
    cost = rng.uniform(0.5, 1.0, (n, n)).astype(np.float32)
    cost[np.arange(n), perm] = 0.0
    got = tm.solve_lsap_auction(torch.from_numpy(cost), n_iter=1000, eps=0.01).numpy()
    np.testing.assert_array_equal(got, tm.solve_lsap_host(cost)[1])


def test_get_sequence_groups():
    labels = np.array([1, 5, 1, 7, 5])
    dist = np.zeros((4, 37))
    dist[np.arange(4), [3, 9, 3, 12]] = 1.0
    for args in ((labels, None, "predcls"), (None, dist, "sgdet")):
        np.testing.assert_array_equal(tt.get_sequence_groups(*args),
                                      jt.get_sequence_groups(*args))
    with pytest.raises(ValueError):
        tt.get_sequence_groups(labels, None, "sgcls")


def _moving_objects(rng, F=4, D=8):
    """tests/test_matcher_track.py's case: a box drifting slowly and a
    far-away box of another class."""
    frames, boxes, feats, dists, labels = [], [], [], [], []
    fa, fb = rng.standard_normal(D), rng.standard_normal(D)
    for f in range(F):
        frames += [f, f]
        boxes += [[10 + f, 10, 60 + f, 60], [200, 200, 260, 280]]
        feats += [fa + 0.01 * rng.standard_normal(D), fb + 0.01 * rng.standard_normal(D)]
        da, db = np.zeros(37), np.zeros(37)
        da[4], db[9] = 1.0, 1.0
        dists += [da, db]
        labels += [4, 9]
    return (np.asarray(frames), np.asarray(boxes, np.float64), np.stack(feats),
            np.stack(dists), np.asarray(labels))


def _video(seed):
    """A seeded synthetic video whose object slots keep a class and drift,
    with detections of the same class nearby (the NMS clusters them)."""
    e = make_synthetic_entry(np.random.default_rng(seed), n_frames=6, objs_per_frame=3,
                             bucket_boxes=32, bucket_rels=24, feat_dim=16)
    nb = int(e.box_mask.sum())
    frames = e.box_frame[:nb].numpy()
    slot = np.arange(nb) % 4
    rng = np.random.default_rng(seed + 1)
    base = rng.uniform(0, 400, (4, 2))
    boxes = np.concatenate([base[slot] + frames[:, None] * 3.0,
                            base[slot] + 80 + frames[:, None] * 3.0], 1)
    feats = rng.standard_normal((4, 16))[slot] + 0.05 * rng.standard_normal((nb, 16))
    labels = np.where(slot == 0, 1, 2 + slot * 5)
    dist = np.full((nb, 36), 0.01)
    dist[np.arange(nb), labels - 1] = 0.7
    return (frames, boxes.astype(np.float32), feats.astype(np.float32),
            dist.astype(np.float32), labels.astype(np.int64))


@pytest.mark.parametrize("case", ["moving", "video0", "video1"])
@pytest.mark.parametrize("mode", ["sgcls", "sgdet"])
def test_track_video_clusters_equal_jax(case, mode):
    args = (_moving_objects(np.random.default_rng(0)) if case == "moving"
            else _video(int(case[-1])))
    keys = list(range(int(args[0].max()) + 1))
    ours = tt.track_video(mode, *args, frame_keys=keys, im_size=(640.0, 480.0))
    ref = jt.track_video(mode, *args, frame_keys=keys, im_size=(640.0, 480.0))
    assert ours == ref
    n = len(args[0])
    np.testing.assert_array_equal(tt.clusters_to_groups(ours, n),
                                  jt.clusters_to_groups(ref, n))
    if case == "moving" and mode == "sgcls":
        g = tt.clusters_to_groups(ours, n)
        assert len(set(g[0::2])) == 1 and len(set(g[1::2])) == 1 and g[0] != g[1]


def test_tracker_edges_equal_jax():
    """The +1-pixel NMS, the skipped last frame and the 50-frame timeout."""
    boxes = np.array([[0, 0, 4, 4], [1, 1, 5, 5]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    np.testing.assert_array_equal(tt._nms(boxes, scores, 0.4), jt._nms(boxes, scores, 0.4))
    a, b = np.random.default_rng(3).uniform(0, 50, (2, 6, 4)).cumsum(-1)
    np.testing.assert_allclose(tt._giou(a, b), jt._giou(a, b), rtol=0, atol=1e-12)
    bf = np.array([2, 2], np.int32)
    feats = np.zeros((2, 8), np.float32)
    dists = np.tile(np.array([[0.9, 0.1]], np.float32), (2, 1))
    labels = np.array([1, 1], np.int64)
    for x, y in zip(tt.clean_bbox(bf, boxes, feats, dists, labels),
                    jt.clean_bbox(bf, boxes, feats, dists, labels)):
        if isinstance(x, dict):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)
    bf = np.array([0, 60], np.int32)
    boxes = np.tile(np.array([[10, 10, 60, 60]], np.float32), (2, 1))
    feats = np.ones((2, 8), np.float32)
    kw = dict(frame_keys=list(range(61)), im_size=(480.0, 640.0))
    assert (tt.track_video("sgcls", bf, boxes, feats, dists, labels, **kw)
            == jt.track_video("sgcls", bf, boxes, feats, dists, labels, **kw))


def test_sgcls_group_ids_equal_the_tool():
    """tests/test_dsg_sgcls_eval.py's entry through the port and through
    tools/test_DSG_DETR.py: the same ids, padded rows unique."""
    dsg = load_tool("test_DSG_DETR")
    rng = np.random.default_rng(4)
    fields = dict(
        boxes=np.tile(np.array([[1, 1, 50, 50]], np.float32), (8, 1)),
        box_frame=np.array([0, 0, 1, 1, 0, 0, 0, 0], np.int32),
        box_mask=np.array([1, 1, 1, 1, 0, 0, 0, 0], bool),
        labels=np.array([1, 5, 1, 5, 0, 0, 0, 0], np.int32),
        distribution=np.tile(np.eye(36, dtype=np.float32)[4][None], (8, 1)),
        features=rng.standard_normal((8, 32)).astype(np.float32),
        num_frames=np.int32(2))
    import dataclasses
    je = dataclasses.replace(j_empty_entry(8, 8, feat_dim=32), **fields)
    te = Entry.from_numpy({f.name: getattr(je, f.name) for f in dataclasses.fields(je)})

    class DS:
        img_info = [[480.0, 640.0, 1.0]]
        video_size = [(640, 480)]

    ours = tt.sgcls_group_ids(te, (480.0, 640.0))
    np.testing.assert_array_equal(ours, dsg.sgcls_group_ids(je, DS(), 0))
    assert not set(ours[:4].tolist()) & set(ours[4:].tolist())
    assert len(set(ours[4:].tolist())) == 4

    # a seeded synthetic video: the same ids as the tool's
    e = make_synthetic_entry(np.random.default_rng(5), n_frames=5, objs_per_frame=3,
                             bucket_boxes=32, bucket_rels=24, feat_dim=16)
    je2 = type(je)(**{f.name: getattr(e, f.name).numpy() for f in dataclasses.fields(e)})
    np.testing.assert_array_equal(tt.sgcls_group_ids(e, (600.0, 1000.0)),
                                  dsg.sgcls_group_ids(je2, type("D", (), {
                                      "img_info": [[600.0, 1000.0, 1.0]]})(), 0))
