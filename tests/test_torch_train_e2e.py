"""The data-engine slice as a whole against the JAX package: a micro Action
Genome on disk (4 videos of 4 frames, feat 64) grounded by the port's
`tools.train_sttran.ground_video` on prefetch workers, bucketed, placed with
a width-0 union and trained for 2 steps by a narrow STTran (1 + 1 layers,
dropout off), against the JAX tool's `ground_video`, `place_entries` and
train step on the same videos and weights (JAX init, carried to the port by
`models/convert.sttran_from_jax`). Per-step losses agree to rtol 4e-4
(tests/test_torch_train.py's tolerance: float32 reduction-order drift);
the grounded Entries are equal.

Also: the Entry-cache hit skips grounding and replays the truncation counts
(tests/test_entry_cache.py:140-186); live union features through the
port's detector provider equal the JAX tool's with the same extractor, and
its union cache is shared; `evaluate_epoch` fed by `grounded_batches` gives
the JAX tool's `evaluate_epoch` R@K rows within 1e-6.
"""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from nl_vsgg_tpu.data import schema as jschema
from nl_vsgg_tpu.data.action_genome import AGTest as JAGTest
from nl_vsgg_tpu.data.action_genome import AGTrain as JAGTrain
from nl_vsgg_tpu.models.sttran import STTran as JSTTran
from nl_vsgg_tpu.train import create_train_state as j_create
from nl_vsgg_tpu.train import make_optimizer as j_optimizer
from nl_vsgg_tpu.train import make_train_step as j_make_step
from nl_vsgg_tpu.train import place_entries as j_place_entries
from nl_vsgg_tpu.train.step import make_eval_step
from nl_vsgg_tpu.utils.config import load_config as j_load_config
from nl_vsgg_tpu_torch.data.action_genome import AGTest, AGTrain
from nl_vsgg_tpu_torch.data.entry import Entry
from nl_vsgg_tpu_torch.data.grounding import DETS_F32, dets_to_f32
from nl_vsgg_tpu_torch.data.pipeline import GroundingPrefetcher, bucket_events
from nl_vsgg_tpu_torch.eval.epoch import evaluate_epoch, grounded_batches
from nl_vsgg_tpu_torch.models.convert import sttran_from_jax
from nl_vsgg_tpu_torch.models.sttran import STTran
from nl_vsgg_tpu_torch.tools import train_sttran as ts
from nl_vsgg_tpu_torch.train.state import create_train_state
from nl_vsgg_tpu_torch.train.step import make_train_step, place_entries
from nl_vsgg_tpu_torch.utils.config import load_config
from tests.fixtures import build_micro_ag, load_tool

FEAT, LR, VIDEOS, BATCH = 64, 1e-5, 4, 2
_State = collections.namedtuple("_State", "params batch_stats")


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro AG with the dets_f32.npy sidecars the native engine reads."""
    ag = build_micro_ag(str(tmp_path_factory.mktemp("ag")), n_videos=VIDEOS, n_frames=4,
                        feat_dim=FEAT, n_objs=2)
    ff = os.path.join(ag, "frame_features")
    for vid in os.listdir(ff):
        for fr in os.listdir(os.path.join(ff, vid)):
            d = os.path.join(ff, vid, fr)
            dets = np.load(os.path.join(d, "dets.npy"), allow_pickle=True).tolist()
            np.save(os.path.join(d, DETS_F32), dets_to_f32(dets))
    return ag


def _overrides(ag, **kw):
    return dict({"data_path": ag, "feat_dim": FEAT, "batch_videos": BATCH, "num_workers": 1,
                 "frame_features_path": os.path.join(ag, "frame_features"),
                 "buckets": {"max_boxes": [16, 32], "max_rels": [8, 16]}}, **kw)


@pytest.fixture(scope="module")
def jtool():
    return load_tool("train_STTran")


@pytest.fixture()
def no_flax_dropout(monkeypatch):
    import flax.linen as nn
    monkeypatch.setattr(nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def _same_entry(ours: Entry, ref) -> None:
    for f in dataclasses.fields(Entry):
        a, b = getattr(ours, f.name).numpy(), np.asarray(getattr(ref, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def _models(sample):
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)
    state, tx = j_create(jm, sample, jax.random.key(0),
                         tx=j_optimizer(LR, weight_decay=1e-2, grad_clip_norm=5.0))
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, dropout=0.0, device="cpu")
    model.load_state_dict(sttran_from_jax(jax.device_get(state.params),
                                          jax.device_get(state.batch_stats)), strict=True)
    return jm, state, tx, model


@pytest.mark.parametrize("native", [True, False])
def test_grounded_train_steps_match_jax(micro, jtool, no_flax_dropout, native):
    cfg = load_config(None, _overrides(micro, use_native_grounding=native))
    jcfg = j_load_config(None, _overrides(micro, use_native_grounding=native))
    ds, jds = AGTrain(micro, remove_one_frame_video=False), \
        JAGTrain(micro, remove_one_frame_video=False)
    jm, state, tx, model = _models(jtool.ground_video(jds, 0, jcfg, True, jcfg.buckets))
    jstep = jax.jit(j_make_step(jm, tx, bce=True))
    st = create_train_state(model, lr=LR, weight_decay=1e-2, grad_clip_norm=5.0)
    step = make_train_step(model, st.optimizer, bce=True)
    gen = torch.Generator().manual_seed(0)

    pre = GroundingPrefetcher(lambda i: ts.ground_video(ds, i, cfg, True, cfg.buckets),
                              range(VIDEOS), num_workers=2)
    ours, ref = [], []
    for n, (kind, payload) in enumerate(bucket_events(iter(pre), BATCH)):
        assert kind == "batch" and len(payload) == BATCH
        jentries = [jtool.ground_video(jds, i, jcfg, True, jcfg.buckets) for i, _ in payload]
        for (_, e), je in zip(payload, jentries):
            _same_entry(e, je)
        batch = place_entries([e for _, e in payload], zero_union=True, device="cpu")
        assert batch.union_feat.shape[-1] == 0
        st, met = step(st, batch, gen)
        state, jmet = jstep(state, j_place_entries(jentries, zero_union=True),
                            jax.random.key(n))
        assert float(met["valid"]) == 1.0
        for k in ("object_loss", "attention_relation_loss", "spatial_relation_loss",
                  "contact_relation_loss"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=4e-4, atol=1e-6,
                                       err_msg=f"step {n} {k}")
        ours.append(float(met["total"]))
        ref.append(float(jmet["total"]))
    assert len(ours) == VIDEOS // BATCH and st.skipped == 0
    np.testing.assert_allclose(ours, ref, rtol=4e-4, err_msg="per-step losses")


def test_entry_cache_hit_skips_grounding(micro, tmp_path, monkeypatch):
    cfg = load_config(None, _overrides(micro, entry_cache=str(tmp_path / "ecache")))
    e1 = ts.ground_video(AGTrain(micro, remove_one_frame_video=False), 0, cfg, True,
                         cfg.buckets)
    assert e1 is not None
    monkeypatch.setattr(ts, "_ground_video_uncached", lambda *a, **k: pytest.fail(
        "a cache hit must not ground again"))
    ds2 = AGTrain(micro, remove_one_frame_video=False)     # a fresh run, the same cache
    e2 = ts.ground_video(ds2, 0, cfg, True, cfg.buckets)
    for f in dataclasses.fields(Entry):
        assert torch.equal(getattr(e1, f.name), getattr(e2, f.name)), f.name
    assert ds2._entry_cache_train.hits == 1


def test_entry_cache_replays_truncation(micro, jtool, tmp_path):
    # 4 frames x (person + 2 objects) = 12 boxes against a 4-box bucket
    ov = _overrides(micro, entry_cache=str(tmp_path / "ecache"),
                    buckets={"max_frames": [8], "max_boxes": [4], "max_rels": [4]})
    cfg, jcfg = load_config(None, ov), j_load_config(None, ov)
    cold, warm, ref = [], [], []
    e1 = ts.ground_video(AGTrain(micro, remove_one_frame_video=False), 1, cfg, True,
                         cfg.buckets, on_truncate=lambda b, r: cold.append((b, r)))
    assert e1 is not None and cold
    ts.ground_video(AGTrain(micro, remove_one_frame_video=False), 1, cfg, True, cfg.buckets,
                    on_truncate=lambda b, r: warm.append((b, r)))
    assert warm == cold
    # the JAX tool reads the port's cache file as a hit with the same counts
    je = jtool.ground_video(JAGTrain(micro, remove_one_frame_video=False), 1, jcfg, True,
                            jcfg.buckets, on_truncate=lambda b, r: ref.append((b, r)))
    assert ref == cold
    _same_entry(e1, je)


def test_evaluate_epoch_grounded_matches_jax(micro, jtool):
    ov = _overrides(micro)
    cfg, jcfg = load_config(None, ov), j_load_config(None, ov)
    ann = os.path.join(micro, "annotations")
    ds, jds = AGTest(ann), JAGTest(ann)
    assert len(ds) == VIDEOS
    sample = jtool.ground_video(jds, 0, jcfg, False, jcfg.buckets)
    jm = JSTTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1)
    variables = jax.device_get(jm.init({"params": jax.random.key(3),
                                        "dropout": jax.random.key(4)}, sample))
    srng = np.random.default_rng(5)
    stats = jax.tree.map(lambda a: srng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                         variables["batch_stats"])
    model = STTran(mode="sgdet", feat_dim=FEAT, dec_layer_num=1, device="cpu")
    model.load_state_dict(sttran_from_jax(variables["params"], stats), strict=True)

    ev = evaluate_epoch(model, grounded_batches(
        lambda i: ts.ground_video(ds, i, cfg, False, cfg.buckets), ds.gt_annotations,
        range(VIDEOS), BATCH, num_workers=1), device="cpu", zero_union=True)
    jev = jtool.evaluate_epoch(
        jcfg, jschema.load_taxonomy(), jds, VIDEOS,
        lambda i: jtool.ground_video(jds, i, jcfg, False, jcfg.buckets),
        jax.jit(make_eval_step(jm)), _State(variables["params"], stats), zero_union=True)
    for name in ("recall", "recall_nogc", "semi_recall"):
        for k in (10, 20, 50):
            a, b = getattr(ev, name)[k], getattr(jev, name)[k]
            assert len(a) == len(b) == VIDEOS * 4, (name, k)
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f"{name}@{k}")
    assert 0 < ev.mean_score(20) <= 1


class _FakeDetector:
    """Stands in for AttrRCNNTorch: a deterministic union extractor over the
    frames it is given (the detector itself is held against the JAX one in
    tests/test_torch_detector.py)."""

    device = torch.device("cpu")

    def __init__(self):
        self.c4_passes = 0

    def make_union_feature_fn(self, imgs):
        self.c4_passes += 1
        level = float(np.mean([im.mean() for im in imgs]))

        def fn(f, boxes):
            b = np.asarray(boxes, np.float32)
            base = (b.sum(1) / 1000.0 + f + level)[:, None, None, None]
            return (base + np.arange(FEAT, dtype=np.float32)) * np.ones((1, 7, 7, 1), np.float32)
        return fn


def test_union_provider_matches_jax_tool(micro, jtool, tmp_path, caplog):
    ov = _overrides(micro, union_feat_cache=str(tmp_path / "uc"))
    cfg, jcfg = load_config(None, ov), j_load_config(None, ov)
    frames = {i: [np.full((24, 32, 3), 10 * i + j, np.uint8) for j in range(4)]
              for i in range(2)}
    det = _FakeDetector()
    provider = ts.detector_union_provider(lambda: det, lambda _ds, i: frames.get(i))
    jprovider = lambda _ds, i: _FakeDetector().make_union_feature_fn(frames[i])  # noqa: E731
    ds, jds = AGTrain(micro, remove_one_frame_video=False), \
        JAGTrain(micro, remove_one_frame_video=False)
    for i in range(2):
        e = ts.ground_video(ds, i, cfg, True, cfg.buckets, union_provider=provider)
        assert e.union_feat.shape == (8, 7, 7, FEAT) and bool(e.union_feat[e.rel_mask].all())
        _same_entry(e, jtool.ground_video(jds, i, jcfg.replace(union_feat_cache=""), True,
                                          jcfg.buckets, union_provider=jprovider))
    assert det.c4_passes == 2
    # the port's union cache files are hits for both tools: no extraction
    again = ts.ground_video(ds, 1, cfg, True, cfg.buckets, union_provider=provider)
    jagain = jtool.ground_video(jds, 1, jcfg, True, jcfg.buckets, union_provider=lambda *a:
                                pytest.fail("the JAX tool re-extracted"))
    assert det.c4_passes == 2
    _same_entry(again, jagain)
    # missing frames: zeros for the video, nothing cached
    none_provider = ts.detector_union_provider(lambda: det, lambda _ds, i: None)
    e = ts.ground_video(ds, 2, cfg, True, cfg.buckets, union_provider=none_provider)
    assert not e.union_feat.any() and not os.path.exists(str(tmp_path / "uc" / "train" /
                                                          "vid002.mp4.npz"))
    # the config gate and the checkpoint loader
    import logging
    log = logging.getLogger("test_union_provider")
    assert ts.make_union_provider(cfg.replace(union_box_feature=False), log) is None
    with caplog.at_level(logging.WARNING):
        assert ts.make_union_provider(cfg, log) is None
    assert "ZEROS" in caplog.text
    with pytest.raises(ValueError, match="npz"):
        ts.load_vinvl_state_dict(str(tmp_path / "vinvl.npz"))
