"""The last host-side modules of the port against the JAX package's, fuzzed
over seeds: data/funcs.assign_relations, data/temporal_grounding
(`propagate`, `temporal_pseudo_ground`), data/pipeline.bucket_batches and
tools/tune_buckets (the DP partition, its helpers and the printed YAML
block, which the port's load_config reads) with no tolerance; ops/roi_align
`roi_pool` (a max: exact) and `roi_align_frames` (float32 rounding,
1e-5 of the output's magnitude) against the JAX functions.
"""

import contextlib
import importlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.data import funcs as jfuncs
from nl_vsgg_tpu.data import grounding as jgrounding
from nl_vsgg_tpu.data import pipeline as jpipeline
from nl_vsgg_tpu.data import temporal_grounding as jtg
from nl_vsgg_tpu_torch.data import funcs, grounding, pipeline
from nl_vsgg_tpu_torch.data import temporal_grounding as tg
from nl_vsgg_tpu_torch.tools import tune_buckets as tb
from nl_vsgg_tpu_torch.utils.config import load_config
from tests.fixtures import load_tool

# the modules, not the functions the packages' ops/__init__ export by that name
jroi = importlib.import_module("nl_vsgg_tpu.ops.roi_align")
roi = importlib.import_module("nl_vsgg_tpu_torch.ops.roi_align")
SEEDS = range(8)


def _boxes(rng, n, w=640.0, h=480.0):
    xy = rng.uniform(0, [w, h], (n, 2, 2))
    return np.concatenate([xy.min(1), xy.max(1)], -1)


@pytest.mark.parametrize("seed", SEEDS)
def test_assign_relations_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_frames = int(rng.integers(1, 6))
    gt, preds, frames = [], [], []
    for f in range(n_frames):
        recs = []
        n_gt = int(rng.integers(0, 5))
        gt_boxes = _boxes(rng, n_gt)
        for g, b in enumerate(gt_boxes):
            recs.append({"person_bbox": b[None]} if g == 0 else
                        {"bbox": b, "class": int(rng.integers(1, 36))})
        gt.append(recs)
        n_pred = int(rng.integers(0, 6))
        # predictions near some GT boxes (IoU around the threshold) and random ones
        near = gt_boxes[rng.integers(0, max(n_gt, 1), n_pred)] if n_gt else _boxes(rng, n_pred)
        preds.append(near + rng.normal(0, rng.choice([2.0, 30.0]), near.shape))
        frames.append(np.full(n_pred, f))
    pred_boxes = np.concatenate(preds) if preds else np.zeros((0, 4))
    pred_frames = np.concatenate(frames)
    ours = funcs.assign_relations(pred_boxes, pred_frames, gt)
    ref = jfuncs.assign_relations(pred_boxes, pred_frames, gt)
    assert ours[0] == ref[0]
    assert [[(r, id(rec)) for r, rec in fr] for fr in ours[1]] == \
        [[(r, id(rec)) for r, rec in fr] for fr in ref[1]]
    assert [[id(rec) for rec in fr] for fr in ours[2]] == [[id(rec) for rec in fr] for fr in ref[2]]


def _frames(rng, n, cls):
    out = []
    for _ in range(n):
        d = int(rng.integers(0, 5))
        base = _boxes(rng, 1)[0]
        rects = np.stack([base + rng.normal(0, 25, 4) for _ in range(d)]) if d else np.zeros((0, 4))
        feats = rng.standard_normal((d, 6)).astype(np.float32)
        out.append((np.full(d, cls), rng.uniform(0.1, 1, d), rects.astype(np.float32), feats))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("force", [False, True])
def test_temporal_pseudo_ground_matches_jax(seed, force):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 9))
    raw = _frames(rng, n, 5)
    ours_frames = [grounding.FrameDetections(*r) for r in raw]
    ref_frames = [jgrounding.FrameDetections(*r) for r in raw]
    known = sorted(rng.choice(n, size=int(rng.integers(1, 3)), replace=False).tolist())
    seeds = {f: [(_boxes(rng, 1)[0], float(rng.uniform(0.5, 1)), rng.standard_normal(6))]
             for f in known}
    mk = lambda cls: {f: [cls(f, r, c, ft) for r, c, ft in v] for f, v in seeds.items()}
    for thr in (0.2, 0.5):
        ours = tg.temporal_pseudo_ground(ours_frames, mk(tg.PropagatedBox), thr, force)
        ref = jtg.temporal_pseudo_ground(ref_frames, mk(jtg.PropagatedBox), thr, force)
        assert sorted(ours) == sorted(ref)
        for f in ref:
            assert len(ours[f]) == len(ref[f])
            for a, b in zip(ours[f], ref[f]):
                assert a.frame == b.frame and a.conf == b.conf
                assert np.array_equal(a.rect, b.rect) and np.array_equal(a.feat, b.feat)
        # one direction alone, from a frame's seeds
        order = list(range(n))
        one = tg.propagate(ours_frames, {0: mk(tg.PropagatedBox).get(known[0])}, order, set(),
                           thr, force)
        want = jtg.propagate(ref_frames, {0: mk(jtg.PropagatedBox).get(known[0])}, order, set(),
                             thr, force)
        assert {f: [b.conf for b in v] for f, v in one.items()} == \
            {f: [b.conf for b in v] for f, v in want.items()}


class _E:
    """An Entry stand-in: bucket_batches reads n_boxes and n_rels only."""

    def __init__(self, i, nb, nr):
        self.i, self.n_boxes, self.n_rels = i, nb, nr


@pytest.mark.parametrize("seed", SEEDS)
def test_bucket_batches_matches_jax(seed):
    rng = np.random.default_rng(seed)
    items = [(i, None if rng.random() < 0.2 else
              _E(i, int(rng.choice([16, 32])), int(rng.choice([8, 24])))) for i in range(30)]
    B = int(rng.integers(1, 5))
    ours = [[e.i for e in b] for b in pipeline.bucket_batches(iter(items), B)]
    ref = [[e.i for e in b] for b in jpipeline.bucket_batches(iter(items), B)]
    assert ours == ref and len(ours) > 1


@pytest.mark.parametrize("seed", SEEDS)
def test_tune_buckets_partition_matches_jax(seed):
    jtb = load_tool("tune_buckets")
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 300, int(rng.integers(5, 200)))
    for k in (1, 3, 5):
        for alpha, align in ((256.0, 8), (64.0, 16)):
            ours = tb.optimal_buckets(counts, k, alpha, align)
            assert ours == jtb.optimal_buckets(counts, k, alpha, align)
            assert tb.waste(counts, ours, alpha) == jtb.waste(counts, ours, alpha)
            assert tb.occupancy(counts, ours) == jtb.occupancy(counts, ours)
    for a, b in zip(tb.synthetic_ag_counts(50, seed), jtb.synthetic_ag_counts(50, seed)):
        assert np.array_equal(a, b)


def _yaml_block(text: str) -> list[str]:
    lines = text.splitlines()
    return lines[lines.index("buckets:"):]


@pytest.mark.parametrize("n,k", [(400, 3), (2000, 5)])
def test_tune_buckets_prints_the_jax_block_and_load_config_reads_it(n, k, tmp_path):
    jtb = load_tool("tune_buckets")
    argv = ["--synthetic", str(n), "-k", str(k), "--seed", "3"]
    out = {}
    for name, main in (("ours", tb.main), ("ref", jtb.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out[name] = (main(argv), buf.getvalue())
    assert out["ours"][0] == out["ref"][0]
    block = _yaml_block(out["ours"][1])
    assert block == _yaml_block(out["ref"][1]) and len(block) == 4
    path = tmp_path / "cfg.yml"
    path.write_text("\n".join(block) + "\n")
    cfg = load_config(str(path))
    bb, br = out["ours"][0]
    assert list(cfg.buckets.max_boxes) == sorted(bb)
    assert list(cfg.buckets.max_rels) == sorted(br)


def test_npy_rows_reads_the_header(tmp_path):
    p = tmp_path / "feat.npy"
    np.save(p, np.zeros((13, 4), np.float32))
    assert tb.npy_rows(str(p)) == 13


def _rois(rng, n, H, W):
    xy = rng.uniform(-40, [W * 16 + 40, H * 16 + 40], (n, 2, 2)).astype(np.float32)
    rois = np.concatenate([xy.min(1), xy.max(1)], -1)
    rois[: n // 8] = rois[: n // 8, [2, 3, 0, 1]]          # inverted rois: empty extents
    return rois


@pytest.mark.parametrize("seed", SEEDS)
def test_roi_pool_matches_jax(seed):
    rng = np.random.default_rng(seed)
    H, W, C = int(rng.integers(2, 20)), int(rng.integers(2, 30)), int(rng.integers(1, 9))
    fmap = rng.standard_normal((H, W, C)).astype(np.float32)
    rois = _rois(rng, 70, H, W)      # more than one chunk of ROI_POOL_CHUNK
    size = ((7, 7), (3, 5))[seed % 2]
    got = roi.roi_pool(torch.tensor(fmap), torch.tensor(rois), size)
    want = np.asarray(jroi.roi_pool(jnp.asarray(fmap), jnp.asarray(rois), size))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_roi_align_frames_matches_jax(seed):
    rng = np.random.default_rng(seed)
    H, W, C = int(rng.integers(2, 20)), int(rng.integers(2, 30)), int(rng.integers(1, 9))
    fmaps = rng.standard_normal((3, H, W, C)).astype(np.float32)
    rois = _rois(rng, 40, H, W)
    fidx = rng.integers(0, 3, 40)
    got = roi.roi_align_frames(torch.tensor(fmaps), torch.tensor(rois), torch.tensor(fidx))
    want = np.asarray(jroi.roi_align_frames(jnp.asarray(fmaps), jnp.asarray(rois),
                                            jnp.asarray(fidx)))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * max(float(np.abs(want).max()), 1.0)
