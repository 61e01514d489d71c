"""Train STTran on Action Genome with weak supervision (port of
tools/train_STTran.py):

    python -m nl_vsgg_tpu_torch.tools.train_sttran --cfg configs/nl_vsgg_config.yml \
        [--nepoch N] [--bce_loss] [--max_videos N] [--device cpu]

`run_training(cfg, args, build_model)` is the loop; tools/train_dsg_detr.py
runs it with its own builder. Per epoch: the videos in a seeded order are
grounded on prefetch workers (`ground_video`, yielded in that order, so
the batches do not depend on the workers' timing), grouped by bucket
(`bucket_events`), placed on the card (`place_entries`) and stepped
(`train_step`, clipped AdamW with the NaN/empty skip); with
cfg.device_entry_store_gb the cold epoch's batches stay on the card
(`DeviceEntryStore.add_batch`) and warm epochs gather them from video
indices alone. Then `evaluate_epoch` scores the test split (with
cfg.device_eval / cfg.device_eval_promote), the plateau scheduler steps on
mean R@20 and a checkpoint is written to <save_path>/ckpt/<epoch>
(utils/checkpoint.py). A run whose <save_path>/ckpt holds a checkpoint
resumes from it: the TrainState, the scheduler (from the sidecar), the step
counter and the epoch. Each step's dropout generator is seeded from
(cfg.seed, step), so a resumed run draws what a straight run draws.

Data parallel over processes (parallel/): with cfg.distributed or a
coordinator (cfg.coordinator_address / num_processes / process_id, or
NL_VSGG_COORDINATOR / NL_VSGG_NUM_PROCESSES / NL_VSGG_PROCESS_ID) each
process is one rank of a torch.distributed group (`init_distributed`): the
model runs under DDP, each global batch of cfg.batch_videos is a fixed
block of the epoch order of which every rank grounds and steps its own
contiguous share (`DistributedBatcher`), the Entry store keeps each rank's
block, each rank scores range(rank, n_test, world) of the test split and
the evaluators are merged; only the primary rank writes the log file,
configs.json, metrics.jsonl and the checkpoints, and every rank resumes
from the same checkpoint. With no coordinator, cfg.mesh.data = N > 1, or
-1 on a host with more than one card, starts N local ranks itself
(`spawn_local_ranks`), one card each where the host has N cards and
sharing them where it has fewer (the ranks then talk gloo), and returns
the TrainState restored from the newest checkpoint. Each rank's step
generator is seeded from (cfg.seed, step, data index).

The model axis (cfg.mesh.model = M > 1): the ranks are cfg.mesh.data x M
(spawned as above when no coordinator is given), rank r at data index r //
M and model index r % M. Each model group of M ranks holds one replica
between them, every wide Linear sliced by its output columns
(parallel/tensor.shard_module, the JAX `_param_spec` rule); DDP, the
batcher, the store and the eval split run over the data axis, and the
ranks of a model group step the same videos with the same generator.
Checkpoints hold the one-rank layout (utils/checkpoint.state_payload
gathers, restore slices), so any mesh resumes any checkpoint. cfg.remat
recomputes the relation transformer's layers in the backward (the models'
`remat`).

Refused, each with a ValueError naming why: sgcls / predcls training and
non-wks sgdet (as the JAX tool refuses them), a model axis below 1 or one
that does not divide the width of a layer it shards.

`ground_video(ds, idx, cfg, is_train, buckets, union_provider, on_truncate)`
turns one video of an `AGTrain` / `AGTest` split into a padded Entry (or
None when it grounds to no relation): the packed-Entry cache first
(cfg.entry_cache), then the native engine (cfg.use_native_grounding and
use_native_io) with the python path behind it when the library or the
dets_f32.npy sidecars are missing.

Union features (cfg.union_box_feature) come from a provider(ds, idx) ->
union_feat_fn | None that runs the VinVL detector on the video's frames:
`make_union_provider` builds one from cfg.vinvl_ckpt and a frame reader
(by default `cv2_frame_reader`, which imports cv2 when it is built, never in
a worker), `detector_union_provider` from any detector. The provider's card
work runs under one lock on a side stream: prefetch workers call it while
the main thread queues train steps, and its host copies then wait for its
own work, not for a queued step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import tempfile
import threading
import time

import numpy as np
import torch

from ..data import schema
from ..data.action_genome import AGTest, AGTrain
from ..data.device_store import DeviceEntryStore
from ..data.entry_cache import MISS, EntryCache, entry_cache_key
from ..data.grounding import (_NATIVE_UNAVAILABLE, load_frame_features, pack_gt_annotation,
                              wk_forward, wk_forward_native)
from ..data.pipeline import GroundingPrefetcher, TruncationCounter, bucket_events
from ..device import resolve_device
from ..eval.epoch import DeviceEvalPromotion, evaluate_epoch, grounded_batches
from ..eval.recall import SceneGraphEvaluator
from ..models.sttran import STTran
from ..parallel import distributed as pdist
from ..parallel.mesh import data_parallel, make_mesh
from ..parallel.tensor import check_widths, shard_module
from ..train.state import PlateauScheduler, create_train_state, set_learning_rate
from ..train.step import make_train_step, place_entries
from ..utils.checkpoint import (latest_step, load_meta, restore_checkpoint, save_checkpoint,
                                state_payload)
from ..utils.config import load_config
from ..utils.glove import obj_edge_vectors
from ..utils.logging import MetricWriter, setup_logger
from ..utils.profiling import PhaseTimer, trace


def load_vinvl_state_dict(path: str) -> dict:
    """The port's detector state_dict from a VinVL checkpoint (.pth: the
    maskrcnn_benchmark layout, or a dict holding it under 'model')."""
    if path.endswith(".npz"):
        raise ValueError(f"{path}: .npz VinVL checkpoints (tools/convert_vinvl.py) are not "
                         "read by the port yet; pass the .pth checkpoint")
    from ..detector.convert import from_maskrcnn_state_dict
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_maskrcnn_state_dict(sd.get("model", sd))


def on_card_runner(get_detector):
    """on_card(fn, *args) -> fn(detector, *args) under one lock, on one side
    stream of the detector's card: prefetch workers share the detector
    while the main thread queues model steps on the default stream.
    `get_detector()` is called under the lock (a lazy build happens once)."""
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

    return on_card


def detector_union_provider(get_detector, read_frames):
    """provider(ds, idx) -> union_feat_fn | None over a detector.

    `get_detector()` returns the AttrRCNNTorch; `read_frames(ds, idx)`
    returns the video's BGR frames, or None when they are missing (the
    video's union features then fall back to zeros and are not cached).
    Each video's C4 pass and each union_feat_fn call run through
    `on_card_runner`."""
    on_card = on_card_runner(get_detector)

    def provider(ds, idx):
        imgs = read_frames(ds, idx)
        if imgs is None:
            return None
        feat_fn = on_card(lambda det: det.make_union_feature_fn(imgs))
        return lambda f, boxes: on_card(lambda det: feat_fn(f, boxes))

    return provider


def cv2_frame_reader(frames_root: str, logger=None):
    """read_frames(ds, idx) -> the video's BGR frames from
    <frames_root>/<frame path>, or None (with one warning) when one is
    missing. cv2 is imported here, when the reader is built: without it
    this raises, naming it, before any worker runs."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading frame images needs cv2 (opencv-python), which is not installed; "
            "install it or pass read_frames= (a function (ds, idx) -> list of BGR "
            "uint8 frames | None)") from e
    warned: set = set()

    def read_frames(ds, idx):
        imgs = []
        for f in ds.video_list[idx]:
            img = cv2.imread(os.path.join(frames_root, f))
            if img is None:
                if logger is not None and "frames" not in warned:
                    warned.add("frames")
                    logger.warning(
                        f"frame images are missing under {frames_root!r} (e.g. {f!r}): "
                        f"union features fall back to ZEROS for affected videos")
                return None
            imgs.append(img)
        return imgs

    return read_frames


def make_union_provider(cfg, logger, read_frames=None, device=None):
    """Live union-feature extraction, honoring cfg.union_box_feature (the
    shipped recipe extracts 2048 x 7 x 7 VinVL features at every
    person-object union box, lib/assign_pseudo_label.py:1320-1342). None
    when the flag is off or the checkpoint is missing, with a warning:
    Entry.union_feat is then zeros. `read_frames(ds, idx)` gives a video's
    BGR frames (None: missing); by default `cv2_frame_reader` over
    cfg.frames_path or <data_path>/frames. The detector is built on `device`
    (None: the card) at its first extraction."""
    if not cfg.union_box_feature:
        return None
    if not cfg.vinvl_ckpt or not os.path.isfile(str(cfg.vinvl_ckpt)):
        logger.warning(
            "union_box_feature=true but cfg.vinvl_ckpt is unset or missing "
            f"({cfg.vinvl_ckpt!r}): Entry.union_feat will be ZEROS, which "
            "diverges from the shipped reference recipe")
        return None
    from ..detector.attr_rcnn import AttrRCNNTorch

    if read_frames is None:
        read_frames = cv2_frame_reader(cfg.frames_path or os.path.join(cfg.data_path, "frames"),
                                       logger)
    det_box: list = []

    def get_detector():
        if not det_box:
            dt = None if cfg.vinvl_dtype == "float32" else cfg.vinvl_dtype
            det_box.append(AttrRCNNTorch(load_vinvl_state_dict(str(cfg.vinvl_ckpt)),
                                         compute_dtype=dt, device=device))
        return det_box[0]

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


# ------------------------------------------------------------------ the loop


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="weak-supervision training")
    p.add_argument("--cfg", dest="cfg_file", default=None, help="config yaml")
    p.add_argument("--bce_loss", action="store_true", default=None)
    p.add_argument("--nepoch", type=int, default=None)
    p.add_argument("--max_videos", type=int, default=0,
                   help="debug: cap videos per epoch (0 = all)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def config_from_args(args):
    overrides = {}
    if args.bce_loss:
        overrides["bce_loss"] = True
    if args.nepoch is not None:
        overrides["nepoch"] = args.nepoch
    return load_config(args.cfg_file, overrides)


def compute_dtype(cfg):
    """cfg.dtype -> the models' compute dtype (parameters stay float32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else None


def glove_tables(cfg, tax) -> tuple[np.ndarray, np.ndarray]:
    """The (36, 200) and (37, 200) class embeddings the models start from."""
    return (obj_edge_vectors(list(tax.object_classes[1:]), 200, cfg.glove_path),
            obj_edge_vectors(list(tax.object_classes), 200, cfg.glove_path))


def build_model(cfg, tax, device=None) -> STTran:
    """STTran for `cfg` on `device` (None: the card), weights drawn from a
    generator seeded cfg.seed, class embeddings from GloVe (or the fixed
    fallback vectors). 'wk' and 'org' are one implementation (org is wk
    without the empty-frame row removal, the same function on every input
    org can process); the reference's 'new' / 'seq2seq' do not exist."""
    if cfg.transformer_mode not in ("wk", "org"):
        raise ValueError(
            f"transformer_mode={cfg.transformer_mode!r} is not supported: 'wk' and 'org' "
            "share one implementation, and the reference's 'new'/'seq2seq' classes do not "
            "exist in its tree")
    g36, g37 = glove_tables(cfg, tax)
    model = STTran(mode=cfg.mode, obj_classes=tuple(tax.object_classes),
                   enc_layer_num=cfg.enc_layer, dec_layer_num=cfg.dec_layer,
                   feat_dim=cfg.feat_dim, transformer_variant=cfg.transformer_mode,
                   dtype=compute_dtype(cfg), remat=cfg.remat, device=device,
                   generator=torch.Generator().manual_seed(cfg.seed))
    with torch.no_grad():
        if cfg.mode != "predcls":
            model.object_classifier.obj_embed.weight.copy_(torch.as_tensor(g36))
        model.obj_embed.weight.copy_(torch.as_tensor(g37))
        model.obj_embed2.weight.copy_(torch.as_tensor(g37))
    return model


def check_trainable(cfg, device: torch.device) -> None:
    """The JAX tool's refusals, and what the port does not run yet."""
    if cfg.mode == "sgdet" and not cfg.is_wks:
        # the reference's non-wks sgdet needs an AG-trained detector; the
        # shipped NL-VSGG recipe is weak supervision only
        raise ValueError("is_wks=false sgdet training is not a shipped NL-VSGG recipe; "
                         "see models/sgdet_infer for the non-wks inference path")
    if cfg.mode != "sgdet":
        # the reference prints "error! we do not train predcls and sgcls
        # task!" and its GT-box train path then cannot run
        raise ValueError(
            f"mode={cfg.mode!r} training is not a shipped NL-VSGG recipe (the reference "
            "prints 'error! we do not train predcls and sgcls task!' and its GT-box train "
            "path cannot run); use tools/test_sttran for sgcls/predcls evaluation")
    if cfg.mesh.model < 1:
        raise ValueError(f"mesh model={cfg.mesh.model}: the model axis needs at least 1 rank")


def check_model_axis(cfg, build_model_fn) -> None:
    """Refuse a model axis that does not divide the output width of a layer
    it would shard, before any work: the model is built on the meta device
    (shapes only) and its widths read."""
    if cfg.mesh.model > 1:
        with torch.device("meta"):
            check_widths(build_model_fn(cfg, schema.load_taxonomy(), "meta"), cfg.mesh.model)


def step_generator(seed: int, step: int, device: torch.device,
                   rank: int | None = None) -> torch.Generator:
    """The train step's generator (dropout masks, attention seeds, label
    samples), seeded from (seed, step) alone, or from (seed, step, rank)
    on a rank of a process group."""
    key = [seed, step] if rank is None else [seed, step, rank]
    s = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def local_ranks(cfg, device: torch.device) -> int:
    """How many ranks `run_training` starts itself: cfg.mesh.data x
    cfg.mesh.model, data -1 taking the host's cards (at least one model
    group); 1 when a coordinator or cfg.distributed makes this process one
    rank of a group started elsewhere."""
    if cfg.distributed or cfg.coordinator_address or os.environ.get(pdist.ENV_COORD):
        return 1
    model = cfg.mesh.model
    if cfg.mesh.data == -1:
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        return max(cards // model, 1) * model
    return max(cfg.mesh.data, 1) * model


def _local_rank_main(r: int, n: int, url: str, cfg, args, build_model_fn) -> None:
    if resolve_device(args.device).type == "cpu":  # the host's cores split over the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    cfg = dataclasses.replace(cfg, coordinator_address=url, num_processes=n, process_id=r)
    run_training(cfg, args, build_model_fn)


def spawn_local_ranks(cfg, args, build_model_fn, n: int):
    """`run_training` in n spawned processes on this host, ranks of one
    group over a file:// rendezvous; waits for them (at most
    NL_VSGG_JOIN_TIMEOUT_S seconds when that is set) and returns the
    TrainState restored from the newest checkpoint on this process's
    device."""
    import torch.multiprocessing as mp

    child_args = argparse.Namespace(max_videos=args.max_videos, device=args.device)
    with tempfile.TemporaryDirectory(prefix="nl_vsgg_rdv_") as rdv:
        url = f"file://{os.path.join(rdv, 'store')}"
        pdist.join_processes(mp.start_processes(
            _local_rank_main, args=(n, url, cfg, child_args, build_model_fn), nprocs=n,
            join=False, start_method="spawn"))
    device = resolve_device(args.device)
    model = build_model_fn(cfg, schema.load_taxonomy(), device)
    state = create_train_state(model, cfg.lr, cfg.weight_decay, cfg.grad_clip_norm)
    return restore_checkpoint(os.path.join(cfg.save_path, "ckpt"), state)


class _NullMetrics:
    def write(self, *a, **kw) -> None:
        pass

    def close(self) -> None:
        pass


def log_device_recalls(logger, device_recalls) -> None:
    for name in ("recall", "recall_nogc", "semi"):
        r = np.concatenate([d[name] for d in device_recalls])
        logger.info("device %s: R@10 %.4f R@20 %.4f R@50 %.4f" % (name, *r.mean(0)))
    dropped = sum(d.get("gt_dropped", 0) for d in device_recalls)
    if dropped:
        logger.warning(
            f"device R@K excluded {dropped} GT relations past the frame/relation buckets; "
            f"the host numbers are the source of truth")


def ag_test_split(cfg) -> AGTest:
    """The test split's annotations under cfg.data_path."""
    return AGTest(cfg.data_path if cfg.data_path.endswith("annotations")
                  else os.path.join(cfg.data_path, "annotations"))


def run_training(cfg, args, build_model_fn):
    """The training loop (STTran and DSG-DETR differ only in
    `build_model_fn(cfg, tax, device)`). `args.device` (None: the card) is
    where the model, its batches and the Entry store live. Returns the final
    TrainState."""
    device = resolve_device(args.device)
    check_trainable(cfg, device)
    check_model_axis(cfg, build_model_fn)
    n_local = local_ranks(cfg, device)
    if n_local > 1:
        return spawn_local_ranks(cfg, args, build_model_fn, n_local)
    own_group = not pdist.initialized()
    multiproc = pdist.init_distributed(cfg, device=args.device)
    primary = pdist.is_primary()
    if pdist.initialized():
        device = pdist.rank_device()
        mesh = make_mesh(cfg.mesh.data, cfg.mesh.model)   # data must span the ranks
    logger = setup_logger(save_dir=cfg.save_path if primary else None)
    if multiproc:
        logger.info(pdist.describe())
        if not primary:  # one console log stream, not N
            logger.setLevel(logging.WARNING)
    os.makedirs(cfg.save_path, exist_ok=True)
    if primary:
        with open(os.path.join(cfg.save_path, "configs.json"), "w") as f:
            f.write(cfg.to_json())
    metrics = MetricWriter(cfg.save_path) if primary else _NullMetrics()
    tax = schema.load_taxonomy()

    logger.info("loading datasets")
    ds_train = AGTrain(cfg.data_path, pseudo_label_path=cfg.pseudo_localized_SG_path,
                       remove_one_frame_video=cfg.remove_one_frame_video,
                       auto_download=cfg.auto_download, logger=logger,
                       save_path=cfg.save_path if primary else None)
    ds_test = ag_test_split(cfg)
    logger.info(f"train videos: {len(ds_train)}, test videos: {len(ds_test)}")

    model = build_model_fn(cfg, tax, device)
    if multiproc and mesh.model > 1:   # the rank's columns of every wide Linear
        model = shard_module(model, mesh)
        logger.info(f"model axis: {mesh.model} ranks a replica, this rank data index "
                    f"{mesh.data_index}, model index {mesh.model_index}")
    union_provider = make_union_provider(cfg, logger, device=device)
    # separate counters: eval-split truncations must not read as lost
    # training labels in the next epoch's warning
    trunc, trunc_eval = TruncationCounter(), TruncationCounter()
    timer = PhaseTimer()

    def ground(ds, idx, is_train):
        with timer("grounding(host)"):
            return ground_video(ds, int(idx), cfg, is_train, cfg.buckets,
                                union_provider=union_provider,
                                on_truncate=trunc.add if is_train else trunc_eval.add)

    # the first groundable video: the split must hold one, and its features
    # must have the model's width
    sample = None
    for i in range(len(ds_train)):
        sample = ground(ds_train, i, True)
        if sample is not None:
            break
    if sample is None:
        raise ValueError("no groundable training video")
    if sample.features.shape[-1] != cfg.feat_dim:
        raise ValueError(f"features of width {sample.features.shape[-1]} for a model of "
                         f"feat_dim {cfg.feat_dim}")
    state = create_train_state(model, cfg.lr, cfg.weight_decay, cfg.grad_clip_norm)

    # auto-resume from the newest checkpoint
    ckpt_dir = os.path.join(cfg.save_path, "ckpt")
    start_epoch, resume_meta = 0, None
    resumed = latest_step(ckpt_dir)
    if resumed is not None:
        state = restore_checkpoint(ckpt_dir, state)
        resume_meta = load_meta(ckpt_dir, resumed)
        start_epoch = resumed + 1
        logger.info(f"resumed from checkpoint epoch {resumed} (step {state.step})")
    # under a group: DDP over the data axis (parameters broadcast from its
    # first rank); the ranks of one model group draw from one generator
    train_step = make_train_step(data_parallel(model, mesh) if multiproc else model,
                                 state.optimizer, bce=cfg.bce_loss)
    step_rank = pdist.data_index() if multiproc else None
    scheduler = PlateauScheduler(cfg.lr)
    if resume_meta and "scheduler" in resume_meta:
        # the decayed lr and the plateau history: without them the first
        # epoch after a resume would write cfg.lr back
        scheduler.load_state_dict(resume_meta["scheduler"])
        state = set_learning_rate(state, scheduler.lr)

    n_train = min(args.max_videos, len(ds_train)) if args.max_videos else len(ds_train)
    n_test = min(args.max_videos, len(ds_test)) if args.max_videos else len(ds_test)
    rel_bf16 = cfg.dtype == "bfloat16"
    zero_union = union_provider is None
    # the device-resident Entry store: the cold epoch adopts each placed
    # batch (no second upload); later epochs gather from video indices
    entry_store = (DeviceEntryStore(budget_bytes=int(cfg.device_entry_store_gb * 1e9),
                                    device=device) if cfg.device_entry_store_gb else None)
    if entry_store is not None and entry_store.D > 1:
        logger.info(f"device entry store sharded over {entry_store.D} ranks (each holds "
                    f"its own block of every batch)")

    def placed_buckets(stream_order):
        # in the epoch's order, whatever the workers' timing: the batches,
        # and so the run, are the same in every run of the seed
        prefetcher = GroundingPrefetcher(lambda idx: ground(ds_train, idx, True), stream_order,
                                         num_workers=cfg.num_workers, ordered=True)
        for kind, payload in bucket_events(iter(prefetcher), cfg.batch_videos):
            if kind == "skip":
                continue
            with timer("batch_build"):
                batch = place_entries([e for _, e in payload], zero_union=zero_union,
                                      rel_bf16=rel_bf16, device=device)
            yield [i for i, _ in payload], batch

    def batch_iter(order):
        stream_order = order
        n_stored = 0
        if entry_store is not None:
            stored, stream_order = entry_store.plan_batches(order, cfg.batch_videos)
            for idxs in stored:
                with timer("store_gather"):
                    batch = entry_store.gather(idxs)
                if batch is None:  # plan and store disagree: stream them
                    stream_order.extend(idxs)
                    continue
                n_stored += 1
                yield len(idxs), batch
        if multiproc:
            # fixed global blocks, each rank grounding and stepping its share;
            # the store adopts each rank's block under the global composition
            streamed = pdist.DistributedBatcher(
                lambda idx: ground(ds_train, idx, True), stream_order, cfg.batch_videos, mesh,
                feat_dim=cfg.feat_dim, zero_union=zero_union, rel_bf16=rel_bf16,
                num_workers=cfg.num_workers, device_masks=cfg.device_spatial_masks,
                yield_indices=True, device=device)
        else:
            streamed = placed_buckets(stream_order)
        for idxs, batch in streamed:
            if entry_store is not None and not entry_store.overflow:
                with timer("store_build"):
                    entry_store.add_batch(idxs, batch)
            yield len(idxs), batch
        if entry_store is not None and (n_stored or entry_store.overflow):
            logger.info(f"device entry store: {n_stored} gathered batches this epoch, "
                        f"{entry_store.bytes / 1e9:.2f} GB resident"
                        + (", over budget: the rest streams" if entry_store.overflow else ""))

    # a resume continues the step counter: metric keys stay unique and the
    # per-step generators do not replay epoch 0's
    global_step = state.step
    for epoch in range(start_epoch, cfg.nepoch):
        t0 = time.time()
        order = np.random.default_rng(cfg.seed + epoch).permutation(n_train).tolist()
        n_seen, trace_end = 0, None
        with contextlib.ExitStack() as profiling:
            for n_batch, batch in batch_iter(order):
                n_seen += n_batch
                if cfg.profile_steps and primary and epoch == start_epoch \
                        and global_step == 2:
                    profiling.enter_context(trace(os.path.join(cfg.save_path, "trace")))
                    trace_end = global_step + cfg.profile_steps
                with timer("train_step"):  # waits for the step's validity flag
                    state, m = train_step(state, batch, step_generator(
                        cfg.seed, global_step, device, step_rank))
                global_step += 1
                if global_step == trace_end:
                    profiling.close()
                    logger.info(f"wrote {cfg.profile_steps}-step trace to "
                                f"{os.path.join(cfg.save_path, 'trace')}")
                if global_step % 100 == 0:
                    metrics.write(global_step, **{k: float(v) for k, v in m.items()})
                    logger.info(f"e{epoch} step {global_step} loss {float(m['total']):.4f}")

        tv, tb, tr = trunc.take()
        if tv:
            logger.warning(
                f"epoch {epoch}: bucket truncation dropped {tb} boxes / {tr} relations "
                f"across {tv} videos; enlarge cfg.buckets (max_boxes/max_rels) to keep "
                f"those labels")
            metrics.write(global_step, truncated_videos=tv, truncated_boxes=tb,
                          truncated_rels=tr)
        logger.info(f"epoch {epoch} done in {(time.time() - t0) / 60:.1f} min "
                    f"({n_seen} videos, skipped {state.skipped})")
        logger.info("host phases:\n" + timer.summary())

        # ---- the epoch's evaluation, streamed ----
        device_recalls = [] if cfg.device_eval else None
        promotion = None
        if cfg.device_eval_promote:
            if multiproc:
                logger.warning("device_eval_promote is single-process only (its burn-in "
                               "spans one evaluator); ignoring")
            else:
                promotion = DeviceEvalPromotion(cfg.device_eval_burnin, cfg.device_eval_recheck)
        evaluator = SceneGraphEvaluator(mode=cfg.mode, taxonomy=tax)
        # under a group each data index scores its strided shard with its
        # replica (the ranks of one model group score the same videos)
        my_idx = (range(pdist.data_index(), n_test, pdist.data_size()) if multiproc
                  else range(n_test))
        # a model group's ranks gather inside every forward: one batch order
        batches = grounded_batches(lambda i: ground(ds_test, i, False), ds_test.gt_annotations,
                                   my_idx, cfg.batch_videos, cfg.num_workers,
                                   ordered=pdist.model_size() > 1)
        evaluate_epoch(model, batches, evaluator=evaluator, device_recalls=device_recalls,
                       promotion=promotion, device=device, zero_union=zero_union)
        if multiproc:  # the whole split's lists on every rank, in rank order
            pdist.merge_evaluators(evaluator)
            if device_recalls is not None:
                device_recalls = [d for shard in
                                  pdist.allgather_obj(device_recalls)[::pdist.model_size()]
                                  for d in shard]
        if device_recalls:
            log_device_recalls(logger, device_recalls)
        ev, eb, er = trunc_eval.take()
        if ev:
            logger.warning(f"epoch {epoch} eval: bucket truncation dropped {eb} boxes / {er} "
                           f"relations across {ev} test videos; enlarge cfg.buckets")
        stats_note = ""
        if promotion is not None and promotion.promoted:
            score = promotion.score(20)
            stats_note = (f"burn-in+recheck subset only ({promotion.checked} host-scored "
                          f"videos), promoted epoch")
            logger.info(
                f"device evaluator promoted after {promotion.checked} burn-in videos of exact "
                f"agreement: epoch metric (mean R@20 = {score:.4f}) is device-scored; host "
                f"stats below cover only the burn-in; run tools/test_sttran for reported "
                f"numbers")
        elif promotion is not None and promotion.late_demoted:
            score = promotion.score(20)
            stats_note = "partial host coverage, demoted mid-epoch"
            logger.warning(
                f"device evaluator DEMOTED mid-epoch by a recheck mismatch after promotion: "
                f"epoch metric (mean R@20 = {score:.4f}) mixes verified device rows and host "
                f"rows, with up to {promotion.recheck_every - 1} unverified device-scored "
                f"videos before the mismatch; treat this epoch's metric as suspect and run "
                f"tools/test_sttran")
        else:
            if promotion is not None:
                why = ("host/device mismatch during burn-in, demoted" if not promotion.ok
                       else f"only {promotion.checked}/{promotion.burnin} comparable "
                            f"burn-in videos in the split")
                logger.warning(f"device evaluator NOT promoted ({why}); host eval covered "
                               f"the full split as usual")
            score = evaluator.mean_score(20)
        evaluator.calculate_mean_recall()
        logger.info(f"------------Inference in Epoch ({epoch})------------")
        evaluator.print_stats(logger, note=stats_note)
        new_lr = scheduler.step(score)
        state = set_learning_rate(state, new_lr)
        metrics.write(global_step, epoch=epoch, mean_r20=score, lr=new_lr)
        # after the eval and the plateau step, so a resume continues with the
        # epoch's scheduler decision applied (the sidecar holds the history)
        # the one-rank layout: under a model axis the first model group gathers
        payload = state_payload(state) if pdist.data_index() == 0 else None
        if primary:
            save_checkpoint(ckpt_dir, epoch, state, config_json=cfg.to_json(),
                            extra={"scheduler": scheduler.state_dict()}, payload=payload)
        del payload
        pdist.barrier()  # no rank runs ahead of the saved epoch

    metrics.close()
    if own_group:
        pdist.shutdown()
    return state


def main(argv=None):
    args = parse_args(argv)
    return run_training(config_from_args(args), args, build_model)


if __name__ == "__main__":
    main()
