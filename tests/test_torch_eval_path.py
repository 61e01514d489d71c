"""The evaluation slice as a whole: a narrow STTran in both packages (JAX
init, weights carried to the port by models/convert.sttran_from_jax), the
eval step, `entry_to_eval_pred` and both host evaluators, then the port's
streaming `evaluate_epoch` with and without the device-eval promotion; and
the port's `DeviceEvalPromotion` against the JAX package's
(tools/train_STTran.py), driven through the scenarios of
tests/test_device_eval_promotion.py.

Model outputs agree within 2e-4 (tests/test_torch_sttran.py's tolerance:
float32 on both sides, sums in another order); R@K and mR@K are then equal
(no tolerance: the predictions rank and match the same)."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

import jax

from nl_vsgg_tpu.data import entry as jentry
from nl_vsgg_tpu.data.grounding import entry_to_eval_pred as j_eval_pred
from nl_vsgg_tpu.data.grounding import entry_to_pred as j_entry_to_pred
from nl_vsgg_tpu.eval.recall import SceneGraphEvaluator as JEvaluator
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.train.step import make_eval_step, stack_entries as j_stack
from nl_vsgg_tpu_torch.data.entry import Entry, stack_entries
from nl_vsgg_tpu_torch.data.grounding import entry_to_eval_pred, entry_to_pred
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry, make_synthetic_gt
from nl_vsgg_tpu_torch.eval.epoch import DeviceEvalPromotion, evaluate_epoch
from nl_vsgg_tpu_torch.eval.recall import SceneGraphEvaluator
from nl_vsgg_tpu_torch.models.convert import sttran_from_jax
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.train.step import eval_step
from tests.fixtures import load_tool
from tests.test_eval_recall import _random_video

FEAT, NB, NR = 64, 24, 16
ATOL = 2e-4
HEADS = ("attention_distribution", "spatial_distribution", "contacting_distribution",
         "distribution")
_State = collections.namedtuple("_State", "params batch_stats")


def to_jax_entry(e: Entry):
    return jentry.Entry(**{f.name: getattr(e, f.name).numpy()
                           for f in dataclasses.fields(Entry)})


@pytest.fixture(scope="module")
def slice_run():
    """6 videos of 4 frames through both packages' models and evaluators."""
    rng = np.random.default_rng(21)
    entries = [make_synthetic_entry(rng, n_frames=4, objs_per_frame=3, bucket_boxes=NB,
                                    bucket_rels=NR, feat_dim=FEAT) for _ in range(6)]
    gts = [make_synthetic_gt(e, rng) for e in entries]
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=2)
    jbatch = jax.tree.map(jax.numpy.asarray, j_stack([to_jax_entry(e) for e in entries]))
    variables = jax.device_get(jm.init({"params": jax.random.key(0),
                                        "dropout": jax.random.key(1)},
                                       jax.tree.map(lambda a: a[0], jbatch)))
    srng = np.random.default_rng(22)
    stats = jax.tree.map(lambda a: srng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                         variables["batch_stats"])
    ref = jax.device_get(jax.jit(make_eval_step(jm))(_State(variables["params"], stats), jbatch))
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=2, device="cpu")
    model.load_state_dict(sttran_from_jax(variables["params"], stats), strict=True)
    ours = eval_step(model, stack_entries(entries))
    return dict(entries=entries, gts=gts, model=model, ours=ours, ref=ref)


def test_eval_outputs_and_recall_match_jax(slice_run):
    entries, gts, ours, ref = (slice_run[k] for k in ("entries", "gts", "ours", "ref"))
    for k in HEADS:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=0,
                                   err_msg=k)
    ev, jev = SceneGraphEvaluator("sgdet"), JEvaluator("sgdet")
    for i, (e, gt) in enumerate(zip(entries, gts)):
        p = entry_to_eval_pred(e, {k: v[i] for k, v in ours.items()})
        jp = j_eval_pred(to_jax_entry(e), {k: np.asarray(v[i]) for k, v in ref.items()})
        assert p.keys() == jp.keys()
        ev.evaluate_scene_graph(gt, p)
        jev.evaluate_scene_graph(gt, jp)
    ev.calculate_mean_recall()
    jev.calculate_mean_recall()
    for name in ("recall", "recall_nogc", "semi_recall"):
        assert getattr(ev, name) == getattr(jev, name), name
    for name in ("mean_recall", "ng_mean_recall"):
        assert getattr(ev, name).mean_recall == getattr(jev, name).mean_recall, name
    assert ev.print_stats() == jev.print_stats()
    assert 0 < ev.mean_score(20) < 1


def test_evaluate_epoch_streams_like_the_host(slice_run):
    """Batches of 2 and 3 videos (two bucket batches in flight) with a
    grounding skip: the streaming loop's evaluator equals scoring each
    video directly; with a promotion whose burn-in passes, score(20) is
    the host's mean R@20 and the host evaluator stops after the burn-in."""
    model, entries, gts, ours = (slice_run[k] for k in ("model", "entries", "gts", "ours"))
    skip_gt = gts[0][:2]
    batches = [list(zip(gts[:2], entries[:2])), [(skip_gt, None)],
               list(zip(gts[2:5], entries[2:5])), list(zip(gts[5:], entries[5:]))]
    # the skip is scored as it arrives, a batch once the next one is queued
    direct = SceneGraphEvaluator("sgdet")
    direct.evaluate_scene_graph(skip_gt, {})
    for i, (e, gt) in enumerate(zip(entries, gts)):
        direct.evaluate_scene_graph(gt, entry_to_eval_pred(e, {k: v[i] for k, v in ours.items()}))
    streamed = evaluate_epoch(model, batches, device="cpu")
    for name in ("recall", "recall_nogc", "semi_recall"):
        np.testing.assert_allclose(getattr(streamed, name)[20], getattr(direct, name)[20],
                                   atol=1e-12, rtol=0, err_msg=name)

    promo, dev_rows = DeviceEvalPromotion(burnin=3, recheck_every=0), []
    ev = evaluate_epoch(model, batches, promotion=promo, device_recalls=dev_rows, device="cpu")
    assert promo.promoted and promo.checked == 3 and len(dev_rows) == 6
    assert promo.score(20) == pytest.approx(direct.mean_score(20), abs=1e-6)
    # host scoring stopped after the burn-in (3 videos + the skip's 2 frames)
    assert len(ev.recall[20]) == 3 * 4 + 2


def test_entry_to_pred_and_bf16_outputs(slice_run):
    e = slice_run["entries"][0]
    p = entry_to_pred(e)
    jp = j_entry_to_pred(to_jax_entry(e))
    assert p.keys() == jp.keys()
    for k in jp:
        np.testing.assert_array_equal(p[k], jp[k], err_msg=k)
    assert entry_to_pred(None) == {}
    # bf16 model outputs (no numpy dtype) come back as float32
    half = entry_to_eval_pred(e, {"x": torch.tensor([0.5, 2.0], dtype=torch.bfloat16)})
    assert half["x"].dtype == np.float32 and half["x"].tolist() == [0.5, 2.0]


# ---- DeviceEvalPromotion against the JAX class ----
# (burnin, recheck_every, script): "add" scores a video the way the eval loop
# does (host-compared when host_needed()), with an optional fault in the
# device row; "host_rows" records a host-scored video; "skip" a grounding
# skip.
SCENARIOS = {
    "promotes": (2, 64, ["add", "add", "add", "add"]),
    "mismatch_demotes": (2, 64, ["add", "add:semi", "add"]),
    "gt_dropped_blocks": (1, 64, ["add:dropped"]),
    "gt_dropped_after_promotion": (1, 64, ["add", "host_rows", "add"]),
    "frame_count_mismatch": (1, 64, ["add:frame"]),
    "recheck": (1, 3, ["add"] * 7),
    "recheck_mismatch": (1, 2, ["add", "add", "add:semi", "host_rows", "add"]),
    "recheck_zero": (1, 0, ["add"] * 6),
    "skips": (1, 64, ["add", "skip", "add", "skip"]),
}


def _marks(ev):
    return {"recall": len(ev.recall[10]), "recall_nogc": len(ev.recall_nogc[10]),
            "semi": len(ev.semi_recall[10])}


def _host_row(gt, pred):
    ev = SceneGraphEvaluator("sgdet")
    ev.evaluate_scene_graph(gt, pred)
    row = {"gt_dropped": 0}
    for name, sink in (("recall", ev.recall), ("recall_nogc", ev.recall_nogc),
                       ("semi", ev.semi_recall)):
        row[name] = np.stack([np.asarray(sink[k], np.float32) for k in (10, 20, 50)], -1)
    return row


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_promotion_matches_jax_class(scenario):
    jax_cls = load_tool("train_STTran").DeviceEvalPromotion
    burnin, recheck, script = SCENARIOS[scenario]
    rng = np.random.default_rng(sum(map(ord, scenario)))
    sides = [(DeviceEvalPromotion(burnin, recheck), SceneGraphEvaluator("sgdet")),
             (jax_cls(burnin, recheck), JEvaluator("sgdet"))]
    traces = [[], []]
    for step in script:
        kind, _, fault = step.partition(":")
        gt, pred = _random_video(rng, n_frames=3 + len(traces[0]) % 2, n_objs=2)
        row = _host_row(gt, pred)
        if fault == "semi":
            row["semi"] = row["semi"] + 0.25
        elif fault == "dropped":
            row["gt_dropped"] = 2
        elif fault == "frame":
            row = {k: (v[:-1] if k != "gt_dropped" else v) for k, v in row.items()}
        for (promo, ev), trace in zip(sides, traces):
            if kind == "skip":
                ev.evaluate_scene_graph(gt, {})
                promo.add_skip(gt)
            elif kind == "host_rows" or promo.host_needed():
                m = _marks(ev)
                ev.evaluate_scene_graph(gt, pred)
                if kind == "host_rows":
                    promo.add_host_rows(ev, m)
                else:
                    promo.add(row, ev, host_marks=m)
            else:
                promo.add(row, ev)
            trace.append((promo.promoted, promo.host_needed(), promo.checked, promo.ok,
                          promo.late_demoted, len(promo.rows),
                          [promo.score(k) for k in (10, 20, 50)]))
    assert traces[0] == traces[1]
    (ours, _), (ref, _) = sides
    for a, b in zip(ours.rows, ref.rows):
        for k in ("recall", "recall_nogc", "semi"):
            np.testing.assert_array_equal(a[k], b[k])
