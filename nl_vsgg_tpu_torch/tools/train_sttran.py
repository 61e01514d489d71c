"""The grounding glue of the training tool (port of tools/train_STTran.py's
`make_union_provider`, `ground_video` and their helpers, :98-301).

`ground_video(ds, idx, cfg, is_train, buckets, union_provider, on_truncate)`
turns one video of an `AGTrain` / `AGTest` split into a padded Entry (or
None when it grounds to no relation): the packed-Entry cache first
(cfg.entry_cache), then the native engine (cfg.use_native_grounding and
use_native_io) with the python path behind it when the library or the
dets_f32.npy sidecars are missing. The training loop that calls it
(`run_training`) is not ported yet.

Union features (cfg.union_box_feature) come from a provider(ds, idx) ->
union_feat_fn | None that runs the VinVL detector on the video's frames:
`make_union_provider` builds one from cfg.vinvl_ckpt, `detector_union_provider`
from any detector. The provider's card work runs under one lock on a side
stream: prefetch workers call it while the main thread queues train steps,
and its host copies then wait for its own work, not for a queued step.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

from ..data.entry_cache import MISS, EntryCache, entry_cache_key
from ..data.grounding import (_NATIVE_UNAVAILABLE, load_frame_features, pack_gt_annotation,
                              wk_forward, wk_forward_native)


def load_vinvl_state_dict(path: str) -> dict:
    """The port's detector state_dict from a VinVL checkpoint (.pth: the
    maskrcnn_benchmark layout, or a dict holding it under 'model')."""
    if path.endswith(".npz"):
        raise ValueError(f"{path}: .npz VinVL checkpoints (tools/convert_vinvl.py) are not "
                         "read by the port yet; pass the .pth checkpoint")
    from ..detector.convert import from_maskrcnn_state_dict
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_maskrcnn_state_dict(sd.get("model", sd))


def detector_union_provider(get_detector, read_frames):
    """provider(ds, idx) -> union_feat_fn | None over a detector.

    `get_detector()` returns the AttrRCNNTorch (called under the provider's
    lock, so a lazy build happens once); `read_frames(ds, idx)` returns the
    video's BGR frames, or None when they are missing (the video's union
    features then fall back to zeros and are not cached). Each video's C4
    pass and each union_feat_fn call hold the lock and run on one side
    stream of the detector's card."""
    lock = threading.Lock()
    streams: dict = {}

    def on_card(fn, *args):
        with lock:
            det = get_detector()
            ctx = contextlib.nullcontext()
            if det.device.type == "cuda":
                if det.device not in streams:
                    streams[det.device] = torch.cuda.Stream(det.device)
                ctx = torch.cuda.stream(streams[det.device])
            with ctx:
                return fn(det, *args)

    def provider(ds, idx):
        imgs = read_frames(ds, idx)
        if imgs is None:
            return None
        feat_fn = on_card(lambda det: det.make_union_feature_fn(imgs))
        return lambda f, boxes: on_card(lambda det: feat_fn(f, boxes))

    return provider


def make_union_provider(cfg, logger):
    """Live union-feature extraction, honoring cfg.union_box_feature (the
    shipped recipe extracts 2048 x 7 x 7 VinVL features at every
    person-object union box, lib/assign_pseudo_label.py:1320-1342). None
    when the flag is off or the checkpoint is missing, with a warning:
    Entry.union_feat is then zeros."""
    if not cfg.union_box_feature:
        return None
    if not cfg.vinvl_ckpt or not os.path.isfile(str(cfg.vinvl_ckpt)):
        logger.warning(
            "union_box_feature=true but cfg.vinvl_ckpt is unset or missing "
            f"({cfg.vinvl_ckpt!r}): Entry.union_feat will be ZEROS, which "
            "diverges from the shipped reference recipe")
        return None
    from ..detector.attr_rcnn import AttrRCNNTorch

    frames_root = cfg.frames_path or os.path.join(cfg.data_path, "frames")
    det_box: list = []
    warned: set = set()

    def get_detector():
        if not det_box:
            dt = None if cfg.vinvl_dtype == "float32" else cfg.vinvl_dtype
            det_box.append(AttrRCNNTorch(load_vinvl_state_dict(str(cfg.vinvl_ckpt)),
                                         compute_dtype=dt))
        return det_box[0]

    def read_frames(ds, idx):
        import cv2
        imgs = []
        for f in ds.video_list[idx]:
            img = cv2.imread(os.path.join(frames_root, f))
            if img is None:
                if "frames" not in warned:
                    warned.add("frames")
                    logger.warning(
                        f"union_box_feature=true but frame images are missing "
                        f"under {frames_root!r} (e.g. {f!r}): union features "
                        f"fall back to ZEROS for affected videos")
                return None
            imgs.append(img)
        return imgs

    return detector_union_provider(get_detector, read_frames)


def _union_provider_key(cfg, union_provider) -> str:
    """Union-feature provider identity for cache keys ('' = zeros/width-0)."""
    if union_provider is None:
        return ""
    try:
        mtime = int(os.path.getmtime(str(cfg.vinvl_ckpt)))
    except OSError:
        mtime = 0
    return f"{cfg.vinvl_ckpt}:{mtime}:{cfg.vinvl_dtype}"


def _make_union_feat_fn(ds, idx, cfg, is_train, union_provider):
    """(union_feat_fn | None, cache_path | None, cache_key) for one video."""
    if union_provider is None:
        return None, None, ""
    cache_path, cache_key = None, ""
    if cfg.union_feat_cache:
        # grounding is deterministic per video: the extraction is reusable
        # across epochs and eval re-runs
        vid = str(ds.video_ids[idx]).replace("/", "_")
        cache_path = os.path.join(cfg.union_feat_cache, "train" if is_train else "test",
                                  vid + ".npz")
        # provider identity: a re-pointed checkpoint or a dtype change
        # invalidates the cache (the union boxes are hashed too)
        cache_key = _union_provider_key(cfg, union_provider)
    lazy: list = []

    def union_feat_fn(f, boxes):
        # the provider runs only on an actual extraction (a cache hit reads
        # no frame and touches no detector); a failed provider (frames
        # missing) returns None: zeros for the video, never cached
        if not lazy:
            lazy.append(union_provider(ds, idx))
        if lazy[0] is None:
            return None
        return lazy[0](f, boxes)

    return union_feat_fn, cache_path, cache_key


def _entry_cache_for(ds, cfg, is_train, union_provider):
    """Per-dataset EntryCache, built once and kept on the dataset object;
    None when cfg.entry_cache is off."""
    if not cfg.entry_cache:
        return None
    split = "train" if is_train else "test"
    attr = f"_entry_cache_{split}"
    cache = getattr(ds, attr, None)
    if cache is None:
        cache = EntryCache(cfg.entry_cache, split,
                           entry_cache_key(cfg, is_train, _union_provider_key(cfg, union_provider)),
                           union_dtype=cfg.union_feat_cache_dtype)
        setattr(ds, attr, cache)
    return cache


def ground_video(ds, idx, cfg, is_train, buckets, union_provider=None, on_truncate=None):
    """One video of `ds` as a padded Entry of CPU tensors, or None."""
    cache = _entry_cache_for(ds, cfg, is_train, union_provider)
    if cache is not None:
        hit = cache.load(ds.video_ids[idx])
        if hit is not MISS:
            e, tr = hit
            if on_truncate is not None and any(tr):
                on_truncate(*tr)  # keep the epoch's truncation tally
            return e
        captured = []
        user_cb = on_truncate

        def on_truncate(nb, nr):  # capture the counts for the cache record
            captured.append((nb, nr))
            if user_cb is not None:
                user_cb(nb, nr)

    e = _ground_video_uncached(ds, idx, cfg, is_train, buckets, union_provider, on_truncate)
    if cache is not None:
        if union_provider is not None and e is not None \
                and e.union_feat.shape[-1] and not bool(e.union_feat.any()):
            # the union extractor fell back to zeros (frames missing): the
            # fallback must not poison the persistent cache
            return e
        cache.store(ds.video_ids[idx], e, captured[0] if captured else (0, 0))
    return e


def _ground_video_uncached(ds, idx, cfg, is_train, buckets, union_provider=None,
                           on_truncate=None):
    paths = [os.path.join(cfg.frame_features_path, f) for f in ds.video_list[idx]]
    union_feat_fn, cache_path, cache_key = _make_union_feat_fn(ds, idx, cfg, is_train,
                                                               union_provider)
    if cfg.use_native_grounding and cfg.use_native_io:
        gt_pack = None
        if is_train:
            # GT packs are static per video: built once, reused every epoch
            packs = getattr(ds, "_gt_packs", None)
            if packs is None:
                packs = ds._gt_packs = {}
            gt_pack = packs.get(idx)
            if gt_pack is None:
                gt_pack = packs[idx] = pack_gt_annotation(ds.gt_annotations[idx])
        e = wk_forward_native(
            paths, ds.gt_annotations[idx], is_train, buckets.max_boxes, buckets.max_rels,
            union_feat_fn=union_feat_fn, feat_dim=cfg.feat_dim, pseudo_way=cfg.pseudo_way,
            compute_spatial_masks=not cfg.device_spatial_masks, on_truncate=on_truncate,
            union_cache_path=cache_path, union_cache_dtype=cfg.union_feat_cache_dtype,
            union_cache_key=cache_key, gt_pack=gt_pack)
        if e is not _NATIVE_UNAVAILABLE:
            return e
        # library or dets_f32 sidecars unavailable: the python path below
    frames = load_frame_features(paths, use_native=cfg.use_native_io, feat_dim=cfg.feat_dim)
    # the ladders pass through: build_entry picks the rung from the exact
    # post-grounding counts
    return wk_forward(frames, ds.gt_annotations[idx], is_train, buckets.max_boxes,
                      buckets.max_rels, union_feat_fn=union_feat_fn, feat_dim=cfg.feat_dim,
                      pseudo_way=cfg.pseudo_way,
                      compute_spatial_masks=not cfg.device_spatial_masks,
                      on_truncate=on_truncate, union_cache_path=cache_path,
                      union_cache_dtype=cfg.union_feat_cache_dtype, union_cache_key=cache_key)
