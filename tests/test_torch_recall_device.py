"""The port's on-device scorers (nl_vsgg_tpu_torch/eval/recall_device.py),
run here on the CPU, against the JAX package's (eval/recall_jax.py) and the
host evaluator, on the seeded videos of tests/test_eval_recall.py.

The port scores a stacked batch of videos in one call; the JAX functions
run per video. Rows must agree within 1e-6 (R@k is a count over a count in
float32 on both sides, and in float64 on the host). With forced exact ties
(in the sort, and straddling the no-constraint top-100 cut) the port must
agree with JAX's tie order, the stable sort and `lax.top_k`'s lower index
first; the host's numpy argsort is not stable, so it is compared only on
untied scores."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.eval import recall_jax as rj
from nl_vsgg_tpu_torch.eval import recall_device as rd
from nl_vsgg_tpu_torch.eval.recall import SceneGraphEvaluator
from tests.test_eval_recall import _random_video
from tests.test_recall_jax import _E

ATOL = 1e-6
VARIANTS = {"with": ("recall_video_with_constraint", "recall"),
            "no": ("recall_video_no_constraint", "recall_nogc"),
            "semi": ("recall_video_semi", "semi_recall")}


def tie(pred, rng):
    """Exactly tied scores everywhere: equal object scores, attention
    logits from {0, 1} and sigmoid scores from a few values."""
    p = dict(pred)
    p["pred_scores"] = np.full_like(pred["pred_scores"], 0.75)
    p["attention_distribution"] = rng.integers(0, 2, pred["attention_distribution"].shape
                                               ).astype(np.float32)
    for k in ("spatial_distribution", "contacting_distribution"):
        p[k] = rng.choice(np.float32([0.25, 0.5, 0.625, 0.75]), pred[k].shape)
    return p


def video_args(gt, pred, f_bucket=None, g_max=32):
    packed = rd.pack_gt_video(gt, SceneGraphEvaluator("sgdet"), g_max, f_bucket)
    return rd.host_args(_E(pred), pred, packed)


def port_batch(args_list):
    return [torch.from_numpy(np.stack([a[j] for a in args_list])) for j in range(12)]


def jax_args(args):
    return [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in args]


def videos(seed, n, ties=False, **kw):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt, pred = _random_video(rng, **kw)
        out.append((gt, tie(pred, rng) if ties else pred))
    return out


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_video_scorers_match_jax_and_host(variant, ties):
    """6 objects a frame: 156 no-constraint candidates, so the top-100 cut
    falls inside a frame's list."""
    fn, sink = VARIANTS[variant]
    vids = videos(11 if ties else 12, 3, ties, n_frames=3, n_objs=6)
    args = [video_args(g, p) for g, p in vids]
    got, has = getattr(rd, fn)(*port_batch(args))
    assert got.shape == (3, 3, 3) and bool(has.all())
    host = SceneGraphEvaluator("sgdet")
    for b, (gt, pred) in enumerate(vids):
        ref, ref_has = getattr(rj, fn)(*jax_args(args[b]), num_frames=3)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(has[b].numpy(), np.asarray(ref_has))
        host.evaluate_scene_graph(gt, pred)
    if not ties:
        rows = np.stack([getattr(host, sink)[k] for k in (10, 20, 50)], -1)
        np.testing.assert_allclose(got.reshape(-1, 3).numpy(), rows, atol=ATOL, rtol=0)
    assert 0 < float(got.mean()) < 1


@pytest.mark.parametrize("ties", [False, True])
def test_mean_recall_matches_jax_and_host(ties):
    vids = videos(13, 3, ties, n_frames=3, n_objs=2)
    args = [video_args(g, p) for g, p in vids]
    hits, counts = rd.mean_recall_video(*port_batch(args))
    host = SceneGraphEvaluator("sgdet")
    acc = [[[] for _ in range(26)] for _ in range(3)]
    for b, (gt, pred) in enumerate(vids):
        ref_h, ref_c = rj.mean_recall_video(*jax_args(args[b]), num_frames=3)
        np.testing.assert_allclose(hits[b].numpy(), np.asarray(ref_h), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(counts[b].numpy(), np.asarray(ref_c))
        host.evaluate_scene_graph(gt, pred)
        for f in range(3):
            for ki in range(3):
                for c in range(26):
                    if counts[b, f, c] > 0:
                        acc[ki][c].append(float(hits[b, f, ki, c] / counts[b, f, c]))
    if not ties:
        host.calculate_mean_recall()
        for ki, k in enumerate((10, 20, 50)):
            np.testing.assert_allclose([float(np.mean(a)) if a else 0.0 for a in acc[ki]],
                                       host.mean_recall.recall_list[k], atol=ATOL, rtol=0)


def test_recall_frame_matches_jax_on_ties():
    """Explicit candidates: scores from 4 values (ties inside and across
    every k), a masked-out tail, duplicates of GT triplets."""
    rng = np.random.default_rng(14)
    G, P = 12, 70
    gt_trip = rng.integers(0, 3, (G, 3)).astype(np.int64)
    gt_boxes = np.tile(rng.uniform(0, 50, (G, 1, 2)), (1, 2, 2)).reshape(G, 8)
    gt_boxes[:, 2:4] += 30
    gt_boxes[:, 6:8] += 30
    gt_mask = np.arange(G) < 10
    pick = rng.integers(0, G, P)
    pr_trip = np.where(rng.uniform(size=(P, 1)) < 0.7, gt_trip[pick], rng.integers(0, 3, (P, 3)))
    pr_boxes = (gt_boxes[pick] + rng.uniform(-6, 6, (P, 8))).astype(np.float32)
    pr_scores = rng.choice(np.float32([0.2, 0.4, 0.6, 0.8]), P)
    pr_mask = rng.uniform(size=P) < 0.85
    ks = (1, 5, 10, 20, 50, 100)
    got = rd.recall_frame(*(torch.from_numpy(a) for a in (
        gt_trip, gt_boxes.astype(np.float32), gt_mask, pr_trip, pr_boxes, pr_scores, pr_mask)),
        ks=ks)
    ref = rj.recall_frame(jnp.asarray(gt_trip, jnp.int32), jnp.asarray(gt_boxes, jnp.float32),
                          jnp.asarray(gt_mask), jnp.asarray(pr_trip, jnp.int32),
                          jnp.asarray(pr_boxes), jnp.asarray(pr_scores), jnp.asarray(pr_mask),
                          ks=ks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert len(set(got.numpy().tolist())) > 2


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_assemble_ranks_like_jax(variant):
    """Each frame's ranked candidate list (triplet, boxes, score) from the
    port's row-referenced candidates equals the one JAX's assemble + its
    sort gives, ties included."""
    vids = videos(15, 2, True, n_frames=3, n_objs=5)
    args = port_batch([video_args(g, p) for g, p in vids])
    pair_idx, im_idx, rel_mask, att, sp, con, boxes, classes, scores = args[3:]
    assemble = getattr(rd, {"with": "assemble_with_constraint", "no": "assemble_no_constraint",
                            "semi": "assemble_semi"}[variant])
    cands = assemble(pair_idx, im_idx, rel_mask, att, sp, con, scores, 3)
    pos = rd.frame_ranks(cands.score, cands.valid, cands.top_n)
    jassemble = getattr(rj, assemble.__name__)
    for b in range(2):
        sub, obj = pair_idx[b, cands.row, 0], pair_idx[b, cands.row, 1]
        sub, obj = torch.where(cands.rev, obj, sub), torch.where(cands.rev, sub, obj)
        pred = cands.pred.expand(2, -1)[b]
        trip = torch.stack([classes[b, sub], pred, classes[b, obj]], -1).numpy()
        boxes8 = torch.cat([boxes[b, sub], boxes[b, obj]], -1).numpy()
        jargs = jax_args([a[b].numpy() for a in args[3:]])
        for f in range(3):
            ranked = pos[b, f] < rd._NOT_RANKED
            order = torch.argsort(pos[b, f][ranked])
            got = [a[ranked.numpy()][order.numpy()] for a in
                   (trip, boxes8, cands.score[b].numpy())]
            jt, jb, js, jm = jassemble(jargs[0], jargs[1], jargs[2], f, *jargs[3:])
            jorder = np.argsort(np.where(np.asarray(jm), -np.asarray(js), np.inf), kind="stable")
            jm = np.asarray(jm)[jorder]
            want = [np.asarray(a)[jorder][jm] for a in (jt, jb, js)]
            assert len(got[0]) == len(want[0]) > 0
            for g_, w_ in zip(got, want):
                np.testing.assert_array_equal(g_, w_)


def test_device_eval_batch_matches_jax_and_host():
    """3 videos of one shape and 2 of another in one list: each shape group
    stacks on its own; rows equal JAX's batch scorer's and the host's."""
    rng = np.random.default_rng(16)
    vids = [_random_video(rng, n_frames=3, n_objs=2) for _ in range(3)]
    vids += [_random_video(rng, n_frames=4, n_objs=3) for _ in range(2)]
    entries, preds, gts = [_E(p) for _, p in vids], [p for _, p in vids], [g for g, _ in vids]
    ev = SceneGraphEvaluator("sgdet")
    rows = rd.device_eval_batch(entries, preds, gts, ev, f_bucket=5, device="cpu")
    ref = rj.device_eval_batch(entries, preds, gts, ev, f_bucket=5)
    host = SceneGraphEvaluator("sgdet")
    for (gt, pred), row, jrow in zip(vids, rows, ref):
        n0 = len(host.recall[10])
        host.evaluate_scene_graph(gt, pred)
        assert row["gt_dropped"] == jrow["gt_dropped"] == 0
        for name, sink in (("recall", host.recall), ("recall_nogc", host.recall_nogc),
                           ("semi", host.semi_recall)):
            np.testing.assert_allclose(row[name], jrow[name], atol=ATOL, rtol=0)
            np.testing.assert_allclose(row[name], np.stack([sink[k][n0:] for k in (10, 20, 50)],
                                                           -1), atol=ATOL, rtol=0)
    single = rd.device_eval_video(entries[3], preds[3], gts[3], ev, f_bucket=5, device="cpu")
    for name in ("recall", "recall_nogc", "semi"):
        np.testing.assert_array_equal(single[name], rows[3][name])


@pytest.mark.parametrize("f_bucket,g_max", [(3, 32), (4, 4)])
def test_gt_dropped_from_frame_and_relation_buckets(f_bucket, g_max):
    """GT past the frame bucket (4 frames into 3) or past the relation
    bucket (at most 3 objects x (1 + 2 + 2) relations into 4): the count
    equals JAX's pack and the rows cover only the bucket's frames."""
    gt, pred = videos(17, 1, n_frames=4, n_objs=3)[0]
    ev = SceneGraphEvaluator("sgdet")
    packed = rd.pack_gt_video(gt, ev, g_max, f_bucket)
    jpacked = rj.pack_gt_video(gt, ev, g_max, f_bucket)
    for a, b in zip(packed, jpacked):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    row = rd.device_eval_batch([_E(pred)], [pred], [gt], ev, g_max, f_bucket, device="cpu")[0]
    jrow = rj.device_eval_batch([_E(pred)], [pred], [gt], ev, g_max, f_bucket)[0]
    assert row["gt_dropped"] == jrow["gt_dropped"] > 0
    assert row["recall"].shape[0] <= f_bucket
    for name in ("recall", "recall_nogc", "semi"):
        np.testing.assert_allclose(row[name], jrow[name], atol=ATOL, rtol=0)


def test_device_eval_batch_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    gt, pred = videos(18, 1, n_frames=2, n_objs=1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rd.device_eval_batch([_E(pred)], [pred], [gt], SceneGraphEvaluator("sgdet"))
