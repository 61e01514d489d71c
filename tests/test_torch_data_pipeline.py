"""The port's host data engine against the JAX package, part 2: the
prefetcher and bucketing, the packed-Entry cache and its key, the config,
`place_entries` and the device Entry store (on the CPU).

All comparisons are exact: bfloat16 fields are compared after a float32
cast (the same rounding on both sides), everything else bit for bit.
"""

import dataclasses
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nl_vsgg_tpu.data import entry as jentry
from nl_vsgg_tpu.data.entry_cache import EntryCache as JEntryCache
from nl_vsgg_tpu.data.entry_cache import entry_cache_key as j_cache_key
from nl_vsgg_tpu.data.pipeline import bucket_events as j_bucket_events
from nl_vsgg_tpu.train import place_entries as j_place_entries
from nl_vsgg_tpu.utils.config import load_config as j_load_config
from nl_vsgg_tpu_torch.data.device_store import DeviceEntryStore
from nl_vsgg_tpu_torch.data.entry import Entry, empty_entry
from nl_vsgg_tpu_torch.data.entry_cache import MISS, EntryCache, entry_cache_key
from nl_vsgg_tpu_torch.data.pipeline import GroundingPrefetcher, TruncationCounter, bucket_events
from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
from nl_vsgg_tpu_torch.train.step import place_entries
from nl_vsgg_tpu_torch.utils.config import Config, load_config

CONFIG_YML = os.path.join(os.path.dirname(__file__), "..", "configs", "nl_vsgg_config.yml")


def to_jax_entry(e: Entry):
    return jentry.Entry(**{f.name: getattr(e, f.name).numpy()
                           for f in dataclasses.fields(Entry)})


def _entries(seed, n, boxes=24, rels=16, feat=32):
    rng = np.random.default_rng(seed)
    return [make_synthetic_entry(rng, n_frames=3, objs_per_frame=2, bucket_boxes=boxes,
                                 bucket_rels=rels, feat_dim=feat) for _ in range(n)]


def assert_same_batch(ours: Entry, ref) -> None:
    for f in dataclasses.fields(Entry):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), f.name
        assert tuple(a.shape) == tuple(b.shape), f.name
        np.testing.assert_array_equal(a.float().numpy() if a.is_floating_point() else a.numpy(),
                                      np.asarray(b, np.float32) if a.is_floating_point()
                                      else np.asarray(b), err_msg=f.name)


# -------------------------------------------------------------- prefetcher
def test_prefetcher_covers_all_indices_and_overlaps():
    seen = []
    pf = GroundingPrefetcher(lambda i: (time.sleep(0.002), _entries(i, 1)[0])[1],
                             list(range(20)), num_workers=4)
    for idx, e in pf:
        seen.append(idx)
        assert e is not None
    assert sorted(seen) == list(range(20))
    t0 = time.time()
    list(GroundingPrefetcher(lambda i: time.sleep(0.05), list(range(8)), num_workers=8))
    assert time.time() - t0 < 0.05 * 8 * 0.8  # in parallel, not in turn


def test_prefetcher_raises_a_workers_error():
    def boom(i):
        if i == 3:
            raise ValueError("bad video")
        return None
    with pytest.raises(ValueError, match="bad video"):
        list(GroundingPrefetcher(boom, list(range(5)), num_workers=2))


def test_bucket_events_match_jax():
    small, big = _entries(1, 5, 8, 8), _entries(2, 3, 16, 16)
    pairs = [(i, e) for i, e in enumerate(small)] + [(9, None)] \
        + [(10 + i, e) for i, e in enumerate(big)]
    order = np.random.default_rng(0).permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    ours = list(bucket_events(iter(pairs), 2))
    ref = list(j_bucket_events(iter([(i, None if e is None else to_jax_entry(e))
                                     for i, e in pairs]), 2))
    assert [(k, p if k == "skip" else [i for i, _ in p]) for k, p in ours] == \
        [(k, p if k == "skip" else [i for i, _ in p]) for k, p in ref]
    sizes = sorted((p[0][1].n_boxes, len(p)) for k, p in ours if k == "batch")
    assert sizes == [(8, 1), (8, 2), (8, 2), (16, 1), (16, 2)]


def test_truncation_counter_is_thread_safe():
    c = TruncationCounter()
    threads = [threading.Thread(target=lambda: [c.add(1, 2) for _ in range(500)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert c.take() == (4000, 4000, 8000) and c.take() == (0, 0, 0)


# ------------------------------------------------------------- Entry cache
def _rand_entry(rng, union_width=True, mask_width=False, n_rels=6, feat=16):
    e = empty_entry(8, n_rels, feat_dim=feat, with_union_feat=union_width,
                    with_spatial_masks=mask_width)
    kw = {}
    for f in dataclasses.fields(Entry):
        v = getattr(e, f.name)
        if f.name == "num_frames":
            kw[f.name] = torch.tensor(5, dtype=torch.int32)
        elif v.dtype == torch.bool:
            kw[f.name] = torch.from_numpy(rng.random(tuple(v.shape)) > 0.5)
        elif v.dtype == torch.int32:
            kw[f.name] = torch.from_numpy(rng.integers(0, 7, tuple(v.shape)).astype(np.int32))
        else:
            kw[f.name] = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
    return Entry(**kw)


def _same_cached(a: Entry, b) -> None:
    for f in dataclasses.fields(Entry):
        x, y = getattr(a, f.name), getattr(b, f.name)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("union", ["float32", "float16", "zeros", "width0"])
def test_entry_cache_round_trip_and_across_packages(tmp_path, union):
    rng = np.random.default_rng(3)
    e = _rand_entry(rng, union_width=union != "width0", n_rels=16, feat=64)
    if union == "zeros":
        e = e.replace(union_feat=torch.zeros_like(e.union_feat))
    dtype = "float16" if union == "float16" else "float32"
    ours = EntryCache(str(tmp_path), "train", "key1", union_dtype=dtype)
    ours.store("v/1.mp4", e, trunc=(3, 7))
    got, tr = ours.load("v/1.mp4")
    assert tr == (3, 7) and got.num_frames.shape == ()
    ref = e
    if union == "float16":
        ref = e.replace(union_feat=e.union_feat.half().float())
    _same_cached(got, ref)
    if union == "zeros":     # a shape marker, not 19 MB of zeros
        assert os.path.getsize(ours.path("v/1.mp4")) < 100_000
    # the JAX package reads the port's file, and the port the JAX package's
    jcache = JEntryCache(str(tmp_path), "train", "key1", union_dtype=dtype)
    jgot, jtr = jcache.load("v/1.mp4")
    assert jtr == (3, 7)
    _same_cached(got, jgot)
    jcache.store("v/2.mp4", to_jax_entry(e), trunc=(0, 1))
    got2, tr2 = ours.load("v/2.mp4")
    assert tr2 == (0, 1)
    _same_cached(got2, got)


def test_entry_cache_tombstone_stale_key_and_torn_file(tmp_path):
    rng = np.random.default_rng(4)
    a = EntryCache(str(tmp_path), "train", "pseudo@100")
    a.store("empty", None)
    assert a.load("empty") == (None, (0, 0))
    assert a.load("never") is MISS
    a.store("v", _rand_entry(rng))
    assert a.load("v") is not MISS
    b = EntryCache(str(tmp_path), "train", "pseudo@200")   # the labels changed
    assert b.load("v") is MISS
    b.store("v", None)
    assert b.load("v") == (None, (0, 0)) and a.load("v") is MISS
    with open(b.path("v"), "wb") as f:
        f.write(b"\x00garbage")
    assert b.load("v") is MISS
    assert (a.hits, a.misses, b.hits, b.misses) == (2, 2, 1, 2)


def test_entry_cache_key_matches_jax(tmp_path):
    pl = tmp_path / "pseudo.pkl"
    pl.write_bytes(b"x")
    base = {"data_path": str(tmp_path), "pseudo_localized_SG_path": str(pl),
            "frame_features_path": str(tmp_path / "ff"), "feat_dim": 32}
    for extra in ({}, {"pseudo_way": 1}, {"device_spatial_masks": False},
                  {"buckets": {"max_boxes": [16, 32], "max_rels": [8, 16]}},
                  {"union_feat_cache_dtype": "float32"}):
        ov = dict(base, **extra)
        for is_train in (True, False):
            for union_key in ("", "ckpt:123:bfloat16"):
                assert entry_cache_key(load_config(None, ov), is_train, union_key) == \
                    j_cache_key(j_load_config(None, ov), is_train, union_key)


# ------------------------------------------------------------------ config
def _asdict(cfg):
    return dataclasses.asdict(cfg)


def test_load_config_matches_jax():
    assert _asdict(Config()) == _asdict(j_load_config(None))
    assert _asdict(load_config(CONFIG_YML)) == _asdict(j_load_config(CONFIG_YML))
    ov = {"lr": 1, "nepoch": 3.0, "bce_loss": "false", "ckpt": "None", "dtype": "bfloat16",
          "buckets": {"max_boxes": [32, 16], "max_rels": [8]}, "mesh": {"model": 2},
          "feat_dim": 64, "entry_cache": 7}
    ours, ref = load_config(CONFIG_YML, ov), j_load_config(CONFIG_YML, ov)
    assert _asdict(ours) == _asdict(ref)
    assert ours.buckets.max_boxes == (16, 32) and ours.lr == 1.0 and ours.bce_loss is False
    assert ours.to_json() == ref.to_json()


@pytest.mark.parametrize("ov", [{"dtype": "bf16"}, {"vinvl_dtype": "fp32"},
                                {"union_feat_cache_dtype": "int8"}, {"prng_impl": "philox"},
                                {"no_such_key": 1}, {"buckets": {"max_box": [1]}},
                                {"buckets": [8]}, {"lr": "fast"}, {"nepoch": 2.5}])
def test_load_config_errors_match_jax(ov):
    with pytest.raises((ValueError, KeyError)) as ours:
        load_config(None, ov)
    with pytest.raises((ValueError, KeyError)) as ref:
        j_load_config(None, ov)
    assert type(ours.value) is type(ref.value) and str(ours.value) == str(ref.value)


# ----------------------------------------------------------- place_entries
@pytest.mark.parametrize("kw", [{}, {"zero_union": True}, {"rel_bf16": True},
                                {"zero_union": True, "rel_bf16": True}])
def test_place_entries_matches_jax(kw):
    es = _entries(5, 3)
    ours = place_entries(es, device="cpu", **kw)
    ref = j_place_entries([to_jax_entry(e) for e in es], **kw)
    assert_same_batch(ours, ref)
    if kw.get("zero_union"):
        assert ours.union_feat.shape == (3, 16, 7, 7, 0)


# ------------------------------------------------------------ device store
def _filled(es, chunks, **kw):
    """A store filled as the train loop fills it: one placed batch a chunk
    of consecutive videos (same bucket)."""
    store = DeviceEntryStore(device="cpu")
    for lo, hi in chunks:
        assert store.add_batch(range(lo, hi), place_entries(es[lo:hi], device="cpu", **kw))
    return store


def assert_equal_batches(got: Entry, want: Entry) -> None:
    for f in dataclasses.fields(Entry):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_store_gather_equals_place_entries():
    es = _entries(6, 6)
    store = _filled(es, [(0, 3), (3, 6)])
    idx = [4, 1, 5]
    assert_same_batch(store.gather(idx), j_place_entries([to_jax_entry(es[i]) for i in idx]))
    assert_equal_batches(store.gather(idx), place_entries([es[i] for i in idx], device="cpu"))


def test_store_keeps_zero_union_and_rel_bf16():
    es = _entries(7, 4)
    store = _filled(es, [(0, 2), (2, 4)], zero_union=True, rel_bf16=True)
    got = store.gather([2, 0])
    assert_equal_batches(got, place_entries([es[2], es[0]], zero_union=True, rel_bf16=True,
                                            device="cpu"))
    assert got.union_feat.shape == (2, 16, 7, 7, 0)
    assert got.union_feat.dtype == got.spatial_masks.dtype == torch.bfloat16


def test_store_refuses_mixed_buckets_and_unknown_videos():
    small, big = _entries(8, 3, 12, 8), _entries(9, 3, 24, 16)
    store = _filled(small + big, [(0, 3), (3, 6)])
    assert store.gather([0, 2]) is not None and store.gather([3, 5]) is not None
    assert store.gather([0, 3]) is None and store.gather([0, 99]) is None
    batches, misses = store.plan_batches([5, 0, 99, 3, 1, 4, 2], 2)
    assert batches == [[5, 3], [0, 1], [4], [2]] and misses == [99]
    assert 4 in store and 99 not in store


def test_store_budget_overflow():
    es = _entries(10, 6)
    b = place_entries(es[:2], device="cpu")
    nbytes = sum(t.numel() * t.element_size() for t in dataclasses.astuple(b))
    store = DeviceEntryStore(budget_bytes=int(nbytes * 1.5), device="cpu")
    assert store.add_batch([0, 1], b) and store.bytes == nbytes
    assert not store.add_batch([2, 3], place_entries(es[2:4], device="cpu"))
    assert store.overflow and not store.add_batch([4], place_entries(es[4:5], device="cpu"))
    assert store.bytes == nbytes and 2 not in store and 4 not in store
    assert store.gather([0, 1]) is not None and store.gather([0, 2]) is None


def test_store_adopts_batches_across_chunks():
    es = _entries(11, 8)
    store = DeviceEntryStore(device="cpu")
    b0 = place_entries(es[:3], device="cpu")
    assert store.add_batch([0, 1, 2], b0)
    assert store.gather([2, 0]).features.data_ptr() != b0.features.data_ptr()
    assert store.add_batch([3, 4], place_entries(es[3:5], device="cpu"))
    assert store.gather([4, 1]) is not None          # chunks concatenated once
    assert store.add_batch([5, 6, 7], place_entries(es[5:], device="cpu"))
    idx = [7, 4, 0, 6, 5]
    got = store.gather(idx)
    assert_equal_batches(got, place_entries([es[i] for i in idx], device="cpu"))
    # the JAX store gives the same batch for the same history
    from nl_vsgg_tpu.data.device_store import DeviceEntryStore as JStore
    js = JStore()
    for lo, hi in ((0, 3), (3, 5), (5, 8)):
        js.add_batch(list(range(lo, hi)),
                     j_place_entries([to_jax_entry(e) for e in es[lo:hi]]))
    assert_same_batch(got, js.gather(idx))
    assert js.plan_batches([7, 1, 3], 2) == store.plan_batches([7, 1, 3], 2)
    assert jnp.asarray(js.gather(idx).labels).shape == got.labels.shape
