"""The port's host evaluator (nl_vsgg_tpu_torch/eval/recall.py) against the
JAX package's on the same seeded videos of tests/test_eval_recall.py.

Both are the same numpy code on the same inputs, so every sink, every
mean-recall list and the `print_stats` text must be identical (no
tolerance)."""

import numpy as np
import pytest
import torch

from nl_vsgg_tpu.eval.recall import SceneGraphEvaluator as JEvaluator
from nl_vsgg_tpu_torch.eval.recall import SceneGraphEvaluator
from tests.test_eval_recall import _random_video

SINKS = ("recall", "recall_nogc", "semi_recall")


def assert_identical(ours, ref):
    for name in SINKS:
        for k in (10, 20, 50):
            assert getattr(ours, name)[k] == getattr(ref, name)[k], (name, k)
    ours.calculate_mean_recall()
    ref.calculate_mean_recall()
    for name in ("mean_recall", "ng_mean_recall"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.collect == b.collect, name
        assert a.recall_list == b.recall_list, name
        assert a.mean_recall == b.mean_recall, name
    assert ours.print_stats(note="burn-in subset only") == ref.print_stats(
        note="burn-in subset only")
    assert ours.mean_score(20) == ref.mean_score(20)


@pytest.mark.parametrize("mode", ["sgdet", "sgcls", "predcls"])
def test_matches_jax_evaluator(mode):
    rng = np.random.default_rng(7)
    ours, ref = SceneGraphEvaluator(mode), JEvaluator(mode)
    for v in range(6):
        gt, pred = _random_video(rng, n_frames=3 + v % 3, n_objs=2 + v % 2)
        ours.evaluate_scene_graph(gt, pred)
        ref.evaluate_scene_graph(gt, pred)
    assert len(ours.recall[20]) == sum(3 + v % 3 for v in range(6))
    assert_identical(ours, ref)


def test_padding_rows_and_torch_inputs():
    """Masked garbage relation rows, (N, 4) boxes, pred fields as CPU torch
    tensors and GT relationship fields as numpy arrays (AG's pickles hold
    tensors; both must be read the same)."""
    rng = np.random.default_rng(8)
    ours, ref = SceneGraphEvaluator("sgdet"), JEvaluator("sgdet")
    for _ in range(3):
        gt, pred = _random_video(rng, n_frames=3, n_objs=3)
        R, pad = len(pred["im_idx"]), 5
        padded = dict(pred, boxes=pred["boxes"][:, 1:])
        padded["pair_idx"] = np.concatenate([pred["pair_idx"], np.zeros((pad, 2), np.int64)])
        padded["im_idx"] = np.concatenate([pred["im_idx"], np.zeros(pad, np.int64)])
        for k in ("attention_distribution", "spatial_distribution", "contacting_distribution"):
            padded[k] = np.concatenate([pred[k], np.full((pad, pred[k].shape[1]), 9.9,
                                                         np.float32)])
        padded["rel_mask"] = np.concatenate([np.ones(R, bool), np.zeros(pad, bool)])
        gt_np = [[{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in o.items()}
                  for o in frame] for frame in gt]
        ours.evaluate_scene_graph(gt_np, {k: torch.as_tensor(v) for k, v in padded.items()})
        ref.evaluate_scene_graph(gt, pred)
    assert_identical(ours, ref)


def test_empty_predictions():
    rng = np.random.default_rng(9)
    ours, ref = SceneGraphEvaluator("sgdet"), JEvaluator("sgdet")
    gt, pred = _random_video(rng, n_frames=2)
    gt2, _ = _random_video(rng, n_frames=3)
    for ev in (ours, ref):
        ev.evaluate_scene_graph(gt, pred)
        ev.evaluate_scene_graph(gt2, {})
    assert ours.recall[20][-3:] == [0.0, 0.0, 0.0]
    assert_identical(ours, ref)
