"""Online grounding engine: unlocalized pseudo-triplets -> padded Entry
(port of nl_vsgg_tpu/data/grounding.py).

The live weak-supervision path of the reference (lib/object_detector.py:35-45
`wk_forward` -> lib/assign_pseudo_label.py):

  1. `load_frame_features`: cached VinVL detections + RoI features per frame
     (dets.npy / feat.npy, or the dets_f32.npy sidecar through the native
     reader, utils/native_io).
  2. `assign_labels_video`: per frame the max-conf person and the OpenImages
     -> AG class mapping, intersected with the frame's pseudo-GT classes at
     train time, in the reference's CPython set-iteration order.
  3. `build_entry`: the `convert_data` equivalent (:1196-1384): person-first
     box tables, `create_dis` soft distributions, person -> object pairs,
     union boxes and their features (`_resolve_union_features`: a pluggable
     extractor behind an on-disk cache, zeros without one), spatial masks
     (or the width-0 sentinel the models rasterize on the device), padded to
     the bucket picked from the exact counts.

`wk_forward` is the python path; `wk_forward_native` runs steps 1-3 through
the C++ engine (native/grounding.cpp), byte-identical to it. Both return
the port's Entry of CPU tensors, made from the numpy arrays without a copy;
`entry_to_eval_pred` and `entry_to_pred` build the evaluator's input from
an Entry and model outputs on any device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import warnings
import zipfile
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..ops.union_masks import draw_union_boxes_np
from ..utils.native_io import get_lib, read_feat_batch
from . import schema
from .entry import FEAT_DIM, MASK_P, POOL, Entry, pad_entry, pick_joint_bucket, to_numpy


@dataclass
class FrameDetections:
    """One frame's cached VinVL output (dets.npy + feat.npy schema,
    NL-VSGG/data_preprocess/extract_bbox_features_ag.py:110-119)."""

    classes: np.ndarray  # (D,) int OpenImages ids (0..1594)
    confs: np.ndarray    # (D,) float
    rects: np.ndarray    # (D, 4) xyxy
    feats: np.ndarray    # (D, FEAT_DIM)


# Plain-float sidecar for dets.npy: (D, 6) float32 [class, conf, x1, y1, x2,
# y2]. dets.npy is a pickled object array (reference schema, unparseable
# natively); the sidecar carries the same information as a flat matrix the
# C++ parallel reader can stream. Written by tools/preprocess.py (features /
# dets-cache); load_frame_features prefers it when every frame has one.
DETS_F32 = "dets_f32.npy"


def dets_to_f32(dets: list[dict]) -> np.ndarray:
    """Pickle-schema det dicts -> (D, 6) float32 sidecar matrix."""
    out = np.zeros((len(dets), 6), np.float32)
    for i, d in enumerate(dets):
        out[i, 0] = float(d["class"])
        out[i, 1] = float(d["conf"])
        out[i, 2:6] = np.asarray(d["rect"], np.float32).reshape(4)
    return out


def _frames_from_f32(dets_mat: np.ndarray, feat: np.ndarray) -> FrameDetections:
    return FrameDetections(
        classes=dets_mat[:, 0].astype(np.int64),
        confs=dets_mat[:, 1].astype(np.float32),
        rects=dets_mat[:, 2:6].astype(np.float32).reshape(-1, 4),
        feats=feat,
    )


def load_frame_features(frame_paths: Sequence[str], use_native: bool = True,
                        feat_dim: int = FEAT_DIM,
                        max_dets: int = 128) -> list[FrameDetections]:
    """Read dets/feat per frame directory (assign_pseudo_label.py:27-45).

    Fast path: when every frame has a dets_f32.npy sidecar, BOTH the det
    table and the feature matrix stream through the native C++ parallel
    reader (utils/native_io) — no pickle parsing on the hot path. Otherwise
    dets.npy goes through np.load(allow_pickle=True) like the reference,
    with feat.npy still native when possible.

    `max_dets` caps detections per frame on BOTH paths (the native reader
    has a fixed row budget; the pickle path clamps to the same value so the
    two loaders can never diverge on the same frame). VinVL's postprocess
    emits <=100 detections, so the default 128 never truncates real data; a
    warning fires if it ever would.
    """
    if not frame_paths:
        return []
    lib = get_lib() if use_native else None

    sidecars = [os.path.join(p, DETS_F32) for p in frame_paths]
    if lib is not None and all(map(os.path.isfile, sidecars)):
        try:
            dpad, dcnt = read_feat_batch(sidecars, 6, max_rows_each=max_dets)
            rows = max(int(dcnt.max()), 1)
            fpad, fcnt = read_feat_batch(
                [os.path.join(p, "feat.npy") for p in frame_paths],
                feat_dim, max_rows_each=rows)
            return [_frames_from_f32(dpad[i, :int(dcnt[i])],
                                     fpad[i, :int(fcnt[i])])
                    for i in range(len(frame_paths))]
        except IOError:
            pass  # malformed sidecar: fall through to the pickle path

    dets_all = [np.load(os.path.join(p, "dets.npy"), allow_pickle=True).tolist()
                for p in frame_paths]
    if any(len(d) > max_dets for d in dets_all):
        warnings.warn(f"a frame has more than max_dets={max_dets} detections; "
                      f"truncating (raise max_dets to keep them)")
        dets_all = [d[:max_dets] for d in dets_all]
    feats_all: list[np.ndarray]
    if lib is not None:
        rows = max((len(d) for d in dets_all), default=1) or 1
        try:
            padded, counts = read_feat_batch(
                [os.path.join(p, "feat.npy") for p in frame_paths],
                feat_dim, max_rows_each=rows)
            feats_all = [padded[i, :int(counts[i])]
                         for i in range(len(frame_paths))]
        except IOError:  # odd dtype/shape: fall back to numpy
            lib = None
    if lib is None:
        feats_all = [np.asarray(np.load(os.path.join(p, "feat.npy")), np.float32)
                     for p in frame_paths]
    out = []
    for dets, feat in zip(dets_all, feats_all):
        out.append(FrameDetections(
            classes=np.asarray([d["class"] for d in dets], np.int64),
            confs=np.asarray([float(d["conf"]) for d in dets], np.float32),
            rects=np.asarray([d["rect"] for d in dets], np.float32).reshape(-1, 4),
            feats=feat,
        ))
    return out


@dataclass
class GroundedFrame:
    """Per-frame grounding result (person + AG-labeled objects)."""

    has_person: bool
    person_rect: np.ndarray | None = None
    person_conf: float = 0.0
    person_feat: np.ndarray | None = None
    obj_classes: np.ndarray | None = None  # (K,) AG ids 2..36
    obj_confs: np.ndarray | None = None
    obj_rects: np.ndarray | None = None
    obj_feats: np.ndarray | None = None


def assign_labels_frame(frame: FrameDetections, gt_frame: list[dict],
                        is_train: bool, person_ids: frozenset[int],
                        oi_to_ag: dict[int, list[int]],
                        pseudo_way: int = 0) -> GroundedFrame:
    """assign_label_to_proposals_by_dict_for_image (:49-141), vectorized.

    Person = max-conf detection among person OI classes (first on ties).
    Objects: every non-person det's OI class maps to 0+ AG classes; at train
    time only classes present in the frame's pseudo-GT survive; one object
    row is emitted per (det, mapped class), in det-then-class order like the
    reference's nested loop.
    """
    classes = frame.classes.copy()
    classes[classes == 1594] = 1593  # :114-115
    is_person = np.isin(classes, list(person_ids))
    if not is_person.any():
        if pseudo_way == 0:
            return GroundedFrame(has_person=False)
        person_idx = 0  # pseudo_way == 1 (:89-93)
    else:
        pconfs = np.where(is_person, frame.confs, -np.inf)
        person_idx = int(pconfs.argmax())  # argmax = first max, like .index(max)

    gt_classes = {int(g["class"]) for g in gt_frame if "class" in g}

    obj_cls, obj_conf, obj_rect, obj_feat = [], [], [], []
    for i in range(len(classes)):
        if i == person_idx or is_person[i]:
            continue
        ag_ids = oi_to_ag.get(int(classes[i]), [])
        if is_train:
            # same expression as the reference (:128) so multi-mapped classes
            # emit rows in the identical CPython set-iteration order
            ag_ids = list(set(ag_ids) & gt_classes)
        for c in ag_ids:
            obj_cls.append(c)
            obj_conf.append(frame.confs[i])
            obj_rect.append(frame.rects[i])
            obj_feat.append(frame.feats[i])
    k = len(obj_cls)
    return GroundedFrame(
        has_person=True,
        person_rect=frame.rects[person_idx],
        person_conf=float(frame.confs[person_idx]),
        person_feat=frame.feats[person_idx],
        obj_classes=np.asarray(obj_cls, np.int64).reshape(k),
        obj_confs=np.asarray(obj_conf, np.float32).reshape(k),
        obj_rects=np.asarray(obj_rect, np.float32).reshape(k, 4),
        obj_feats=(np.stack(obj_feat) if k else
                   np.zeros((0, frame.feats.shape[-1]), np.float32)),
    )


def assign_labels_video(frames: Sequence[FrameDetections], gt_annotation,
                        is_train: bool, assets_dir: str | None = None,
                        pseudo_way: int = 0) -> list[GroundedFrame]:
    """assign_label_to_proposals_by_dict_for_video (:894-909)."""
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps(assets_dir)
    person_ids = frozenset(ag_to_oi[1])
    return [assign_labels_frame_fast(f, gt_annotation[i], is_train, person_ids,
                                     oi_to_ag, pseudo_way)
            for i, f in enumerate(frames)]


def create_dis(conf: np.ndarray, idx: np.ndarray, num: int = 36) -> np.ndarray:
    """Soft one-hot rows: conf at idx, (1-conf)/35 elsewhere (:934-938)."""
    conf = np.asarray(conf, np.float32).reshape(-1)
    rows = np.tile(((1.0 - conf) / (num - 1))[:, None], (1, num))
    rows[np.arange(len(conf)), np.asarray(idx, np.int64)] = conf
    return rows


# Union-feature extractor signature: (frame_index, union_boxes_xyxy (K,4))
# -> (K, POOL, POOL, FEAT_DIM). None => zeros (union_box_feature: False).
UnionFeatFn = Callable[[int, np.ndarray], np.ndarray]


def _resolve_union_features(union: np.ndarray, im: np.ndarray,
                            bucket_rels: int, feat_dim: int,
                            union_feat_fn: UnionFeatFn | None,
                            union_cache_path: str | None,
                            union_cache_dtype: str,
                            union_cache_key: str,
                            extract_mask: np.ndarray | None = None) -> np.ndarray:
    """Union features for the rel rows described by (union (R,4), im (R,)).

    Shared by the python and native grounding paths. Cache-or-extract:
      * fingerprint = sha1(union boxes) + provider key — a re-extracted
        dataset / re-converted detector / pseudo-label change invalidates it;
      * a failed provider (frames missing) keeps zeros for the video and is
        never cached, so the fallback cannot poison the persistent cache;
      * `extract_mask` limits extraction to valid rows (native path: rows
        whose pair indices survived bucket truncation).
    Returns (R, POOL, POOL, feat_dim), or a bucket-shaped calloc-zeros array
    when there is no provider (pad_entry passes it through untouched).
    """
    n_rels = len(union)
    if union_feat_fn is None:
        # no provider -> union_feat is all-zeros (train loop materializes the
        # zeros on device, place_entries zero_union). Allocate straight at the
        # bucket shape: calloc pages are never written, and pad_entry's fit()
        # passes a full-size array through as a view
        return np.zeros((bucket_rels, POOL, POOL, feat_dim), np.float32)

    fingerprint = None
    if union_cache_path is not None:
        fp = hashlib.sha1(np.ascontiguousarray(union, np.float32).tobytes())
        fp.update(str(union_cache_key).encode())
        fingerprint = fp.hexdigest()
        if os.path.exists(union_cache_path):
            try:
                with np.load(union_cache_path) as z:
                    arr = z["uf"]
                    key = str(z["key"])
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                arr, key = None, ""  # truncated / corrupt / old-format file: a miss
            # validity = row count AND stored dtype AND fingerprint: an
            # exact-parity float32 run must not silently consume a stale fp16
            # cache, nor anyone a cache from different boxes/detector
            if arr is not None and arr.shape == (n_rels, POOL, POOL, feat_dim) \
                    and arr.dtype == np.dtype(union_cache_dtype) \
                    and key == fingerprint:
                return arr.astype(np.float32)
            # else: stale cache -> re-extract (and overwrite)

    uf = np.zeros((n_rels, POOL, POOL, feat_dim), np.float32)
    rows = (np.ones(n_rels, bool) if extract_mask is None
            else np.asarray(extract_mask, bool))
    ok = True
    for f in np.unique(im[rows]):
        sel = (im == f) & rows
        block = union_feat_fn(int(f), union[sel])
        if block is None:
            ok = False
            break
        uf[sel] = block
    if ok and union_cache_path is not None:
        os.makedirs(os.path.dirname(union_cache_path) or ".", exist_ok=True)
        # per-writer tmp + rename: concurrent jobs sharing the cache dir
        # (train + eval, or two model families) must never interleave
        # bytes in one tmp file
        tmp = f"{union_cache_path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, uf=uf.astype(union_cache_dtype), key=fingerprint)
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz",
                   union_cache_path)
    if not ok:
        uf = np.zeros((bucket_rels, POOL, POOL, feat_dim), np.float32)
    return uf

# Truncation report signature: (n_boxes_dropped, n_rels_dropped) called when a
# video overflows its padding bucket. None => silent (tools pass a counter).
TruncateFn = Callable[[int, int], None]


def build_entry(grounded: Sequence[GroundedFrame], gt_annotation, is_train: bool,
                bucket_boxes: int | Sequence[int],
                bucket_rels: int | Sequence[int],
                union_feat_fn: UnionFeatFn | None = None,
                feat_dim: int = FEAT_DIM,
                compute_spatial_masks: bool = True,
                on_truncate: TruncateFn | None = None,
                union_cache_path: str | None = None,
                union_cache_dtype: str = "float16",
                union_cache_key: str = "") -> Entry | None:
    """convert_data (:1196-1384) -> padded Entry; None when no relations.

    `union_cache_path`: optional .npy path for the extracted union features.
    Grounding is deterministic per video, so a hit (row count matches this
    build) replaces the union_feat_fn extraction entirely; a miss extracts
    and writes the pre-padding rows. The cache stores `union_cache_dtype`
    (float16 default: ~1e-3 relative error, below bf16 compute noise; use
    float32 for exact-parity runs)."""
    boxes, frames, labels, scores, feats = [], [], [], [], []
    pair_idx, im_idx = [], []
    a_rel, s_rel, c_rel = [], [], []

    for idx, g in enumerate(grounded):
        if not g.has_person:
            continue
        person_row = len(boxes)
        boxes.append(g.person_rect)
        frames.append(idx)
        labels.append(1)
        scores.append(g.person_conf)
        feats.append(g.person_feat)
        gt_frame = gt_annotation[idx]
        for j in range(len(g.obj_classes)):
            row = len(boxes)
            boxes.append(g.obj_rects[j])
            frames.append(idx)
            labels.append(int(g.obj_classes[j]))
            scores.append(float(g.obj_confs[j]))
            feats.append(g.obj_feats[j])
            if is_train:
                for obj_info in gt_frame:  # first GT row of this class (:1269-1291)
                    if obj_info.get("class") == int(g.obj_classes[j]):
                        pair_idx.append([person_row, row])
                        im_idx.append(idx)
                        a_rel.append(np.asarray(obj_info["attention_relationship"]).reshape(-1))
                        s_rel.append(np.asarray(obj_info["spatial_relationship"]).reshape(-1))
                        c_rel.append(np.asarray(obj_info["contacting_relationship"]).reshape(-1))
                        break
            else:
                pair_idx.append([person_row, row])
                im_idx.append(idx)

    n_rels = len(pair_idx)
    if n_rels == 0:
        return None  # :1302-1304
    n_boxes = len(boxes)

    # ladder form: pick the bucket from the EXACT post-grounding counts —
    # the pre-grounding detection-count hint overshoots by the unmatched
    # detections (~2-3x padded compute at AG-shaped distributions,
    # tools/tune_buckets.py). Joint rung index bounds compile count.
    if not isinstance(bucket_boxes, (int, np.integer)):
        bucket_boxes, bucket_rels = pick_joint_bucket(
            tuple(bucket_boxes), tuple(bucket_rels), n_boxes, n_rels)

    boxes = np.asarray(boxes, np.float32).reshape(n_boxes, 4)
    labels_np = np.asarray(labels, np.int64)
    scores_np = np.asarray(scores, np.float32)
    pair_np = np.asarray(pair_idx, np.int64)

    def multi_hot(rel_lists, num):
        m = np.zeros((n_rels, num), np.float32)
        for i, ids in enumerate(rel_lists):
            m[i, np.asarray(ids, np.int64)] = 1.0
        return m

    union = np.concatenate([
        np.minimum(boxes[pair_np[:, 0], :2], boxes[pair_np[:, 1], :2]),
        np.maximum(boxes[pair_np[:, 0], 2:], boxes[pair_np[:, 1], 2:])], axis=1)
    uf = _resolve_union_features(union, np.asarray(im_idx), bucket_rels,
                                 feat_dim, union_feat_fn, union_cache_path,
                                 union_cache_dtype, union_cache_key)

    if compute_spatial_masks:
        # numpy twin: grounding runs on the prefetch workers, on the host
        pair_rois = np.concatenate([boxes[pair_np[:, 0]], boxes[pair_np[:, 1]]], 1)
        masks = draw_union_boxes_np(pair_rois, MASK_P) - 0.5  # :1359-1363
    else:
        # width-0 sentinel: the models rasterize the exact masks on device
        # from boxes[pair_idx] (models/sttran.spatial_mask_input) — the
        # (R, 27, 27, 2) array (~560 KB/video fp32) is neither built here
        # nor uploaded. Production default (cfg.device_spatial_masks).
        masks = np.zeros((n_rels, MASK_P, MASK_P, 0), np.float32)

    e = Entry.from_numpy(dict(
        boxes=boxes,
        box_frame=np.asarray(frames, np.int32),
        box_mask=np.ones(n_boxes, bool),
        labels=labels_np.astype(np.int32),
        scores=scores_np,
        distribution=create_dis(scores_np, labels_np - 1),
        features=np.stack(feats).astype(np.float32),
        pair_idx=pair_np.astype(np.int32),
        im_idx=np.asarray(im_idx, np.int32),
        rel_mask=np.ones(n_rels, bool),
        union_feat=uf,
        spatial_masks=masks.astype(np.float32),
        attention_gt=multi_hot(a_rel, schema.NUM_ATTENTION) if is_train
        else np.zeros((n_rels, schema.NUM_ATTENTION), np.float32),
        spatial_gt=multi_hot(s_rel, schema.NUM_SPATIAL) if is_train
        else np.zeros((n_rels, schema.NUM_SPATIAL), np.float32),
        contacting_gt=multi_hot(c_rel, schema.NUM_CONTACTING) if is_train
        else np.zeros((n_rels, schema.NUM_CONTACTING), np.float32),
        num_frames=np.int32(len(grounded)),
    ))
    padded = pad_entry(e, bucket_boxes, bucket_rels)
    if on_truncate is not None:
        dropped_boxes = max(0, n_boxes - bucket_boxes)
        # exact: counts rows past the rel bucket AND rels invalidated because
        # a pair index points past the truncated box table (pad_entry clamp)
        dropped_rels = n_rels - int(np.asarray(padded.rel_mask).sum())
        if dropped_boxes or dropped_rels:
            on_truncate(dropped_boxes, dropped_rels)
    return padded


def wk_forward(frames: Sequence[FrameDetections], gt_annotation, is_train: bool,
               bucket_boxes: int | Sequence[int],
               bucket_rels: int | Sequence[int],
               union_feat_fn: UnionFeatFn | None = None,
               assets_dir: str | None = None, pseudo_way: int = 0,
               feat_dim: int = FEAT_DIM,
               on_truncate: TruncateFn | None = None,
               union_cache_path: str | None = None,
               union_cache_dtype: str = "float16",
               union_cache_key: str = "",
               compute_spatial_masks: bool = True) -> Entry | None:
    """The full grounding pass (lib/object_detector.py:35-45)."""
    grounded = assign_labels_video(frames, gt_annotation, is_train,
                                   assets_dir, pseudo_way)
    return build_entry(grounded, gt_annotation, is_train, bucket_boxes,
                       bucket_rels, union_feat_fn, feat_dim,
                       compute_spatial_masks=compute_spatial_masks,
                       on_truncate=on_truncate,
                       union_cache_path=union_cache_path,
                       union_cache_dtype=union_cache_dtype,
                       union_cache_key=union_cache_key)


@dataclass
class GTPack:
    """Per-video pseudo-GT annotation flattened for the native engine.

    Static per dataset — build once per video (pack_gt_annotation) and reuse
    across epochs; the per-step work then stays entirely in C++.
    """

    cls: np.ndarray  # (G,) int32 AG class per GT row, frames concatenated
    off: np.ndarray  # (F+1,) int64 frame offsets
    att: np.ndarray  # (G, 3) float32 multi-hot
    sp: np.ndarray   # (G, 6) float32
    con: np.ndarray  # (G, 17) float32


def pack_gt_annotation(gt_annotation) -> GTPack:
    """AGTrain-style per-frame annotation lists -> flat GT arrays."""
    cls, att, sp, con = [], [], [], []
    off = [0]
    for frame in gt_annotation:
        for m in frame:
            if "class" not in m:
                continue
            cls.append(int(m["class"]))
            a = np.zeros(schema.NUM_ATTENTION, np.float32)
            a[np.asarray(m["attention_relationship"], np.int64).reshape(-1)] = 1.0
            att.append(a)
            s = np.zeros(schema.NUM_SPATIAL, np.float32)
            s[np.asarray(m["spatial_relationship"], np.int64).reshape(-1)] = 1.0
            sp.append(s)
            c = np.zeros(schema.NUM_CONTACTING, np.float32)
            c[np.asarray(m["contacting_relationship"], np.int64).reshape(-1)] = 1.0
            con.append(c)
        off.append(len(cls))
    g = len(cls)
    return GTPack(
        cls=np.asarray(cls, np.int32).reshape(g),
        off=np.asarray(off, np.int64),
        att=np.asarray(att, np.float32).reshape(g, schema.NUM_ATTENTION),
        sp=np.asarray(sp, np.float32).reshape(g, schema.NUM_SPATIAL),
        con=np.asarray(con, np.float32).reshape(g, schema.NUM_CONTACTING),
    )


@functools.lru_cache(maxsize=4)
def _native_taxonomy(assets_dir: str | None):
    """(person_lut u8, oi2ag (n_oi, fan) i32, counts i32) for ground_pack."""
    oi_to_ag, ag_to_oi = schema.load_oi_ag_maps(assets_dir)
    lut = _person_lut(frozenset(ag_to_oi[1])).astype(np.uint8)
    n_oi = max(oi_to_ag.keys(), default=0) + 1
    fan = max((len(v) for v in oi_to_ag.values()), default=1)
    oi2ag = np.zeros((n_oi, fan), np.int32)
    cnt = np.zeros(n_oi, np.int32)
    for k, v in oi_to_ag.items():
        cnt[k] = len(v)
        oi2ag[k, :len(v)] = v
    return lut, oi2ag, cnt


_NATIVE_UNAVAILABLE = object()  # sentinel: caller must fall back to python


def wk_forward_native(frame_paths: Sequence[str], gt_annotation, is_train: bool,
                      max_boxes_buckets: Sequence[int],
                      max_rels_buckets: Sequence[int],
                      union_feat_fn: UnionFeatFn | None = None,
                      assets_dir: str | None = None, pseudo_way: int = 0,
                      feat_dim: int = FEAT_DIM,
                      on_truncate: TruncateFn | None = None,
                      union_cache_path: str | None = None,
                      union_cache_dtype: str = "float16",
                      union_cache_key: str = "",
                      compute_spatial_masks: bool = False,
                      gt_pack: GTPack | None = None,
                      max_dets: int = 128):
    """The full grounding pass through the native C++ engine.

    One `ground_pack` call replaces assign_labels_video + build_entry's
    packing (semantics pinned byte-identical to the python path by
    tests/test_torch_data_engine.py, incl. the CPython set-iteration-order
    quirk of the mapped-class emission). Detections/features stream through
    the native .npy reader; the GIL is released for the whole pack, so
    prefetch worker threads scale on multi-core hosts.

    Returns Entry, None (no relations — reference :1302-1304), or the
    module-level `_NATIVE_UNAVAILABLE` sentinel when the native library or
    the dets_f32.npy sidecars are missing (caller falls back to wk_forward).
    """
    lib = get_lib()
    if lib is None or not frame_paths:
        return _NATIVE_UNAVAILABLE
    sidecars = [os.path.join(p, DETS_F32) for p in frame_paths]
    if not all(map(os.path.isfile, sidecars)):
        return _NATIVE_UNAVAILABLE
    try:
        dpad, dcnt = read_feat_batch(sidecars, 6, max_rows_each=max_dets)
        frows = max(int(dcnt.max()), 1)
        fpad, fcnt = read_feat_batch(
            [os.path.join(p, "feat.npy") for p in frame_paths],
            feat_dim, max_rows_each=frows)
    except IOError:
        return _NATIVE_UNAVAILABLE

    F = len(frame_paths)
    # allocate at the ladder TOP (calloc — untouched pages are free): the
    # detection-count hint is NOT an upper bound (multi-map fanout can emit
    # several boxes per detection), and truncating below the top rung would
    # diverge from the python path's exact-count rung pick. The arrays are
    # sliced down to the exact rung after the pack (below).
    bb = int(max_boxes_buckets[-1])
    br = int(max_rels_buckets[-1])

    if is_train and gt_pack is None:
        gt_pack = pack_gt_annotation(gt_annotation)
    lut, oi2ag, oicnt = _native_taxonomy(assets_dir)

    z = np.zeros
    boxes = z((bb, 4), np.float32)
    box_frame = z(bb, np.int32)
    box_mask = z(bb, np.uint8)
    labels = z(bb, np.int32)
    scores = z(bb, np.float32)
    dist = z((bb, schema.NUM_OBJ_CLASSES - 1), np.float32)
    feats = z((bb, feat_dim), np.float32)
    pair_idx = z((br, 2), np.int32)
    im_idx = z(br, np.int32)
    rel_mask = z(br, np.uint8)
    att = z((br, schema.NUM_ATTENTION), np.float32)
    sp = z((br, schema.NUM_SPATIAL), np.float32)
    con = z((br, schema.NUM_CONTACTING), np.float32)
    counts = z(3, np.int64)

    F32 = ctypes.POINTER(ctypes.c_float)
    I64 = ctypes.POINTER(ctypes.c_int64)
    I32 = ctypes.POINTER(ctypes.c_int32)
    U8 = ctypes.POINTER(ctypes.c_uint8)
    p = lambda a, t: a.ctypes.data_as(t)
    gcls = gt_pack.cls if gt_pack is not None else z(0, np.int32)
    goff = (gt_pack.off if gt_pack is not None
            else z(F + 1, np.int64))
    gatt = gt_pack.att if gt_pack is not None else z((0, 3), np.float32)
    gsp = gt_pack.sp if gt_pack is not None else z((0, 6), np.float32)
    gcon = gt_pack.con if gt_pack is not None else z((0, 17), np.float32)

    rc = lib.ground_pack(
        F, dpad.shape[1], p(dpad, F32), p(dcnt, I64),
        p(fpad, F32), fpad.shape[1], p(fcnt, I64), feat_dim,
        p(gcls, I32), p(goff, I64), p(gatt, F32), p(gsp, F32), p(gcon, F32),
        p(lut, U8), len(lut),
        p(oi2ag, I32), p(oicnt, I32), oi2ag.shape[0], oi2ag.shape[1],
        int(is_train), int(pseudo_way), bb, br,
        p(boxes, F32), p(box_frame, I32), p(box_mask, U8),
        p(labels, I32), p(scores, F32), p(dist, F32), p(feats, F32),
        p(pair_idx, I32), p(im_idx, I32), p(rel_mask, U8),
        p(att, F32), p(sp, F32), p(con, F32), p(counts, I64))
    if rc < 0:
        raise RuntimeError(f"native ground_pack failed (rc={rc})")
    if rc == 1:
        return None  # no relations (:1302-1304)
    n_boxes, n_rels, n_kept = (int(c) for c in counts)
    if on_truncate is not None:
        dropped_boxes = max(0, n_boxes - bb)
        dropped_rels = n_rels - n_kept
        if dropped_boxes or dropped_rels:
            on_truncate(dropped_boxes, dropped_rels)

    # shrink to the exact-count rung (pick_joint_bucket): the hint-sized
    # allocation above is typically 2-3x the grounded size. Only when
    # nothing truncated — under truncation, invalidated rows may sit
    # anywhere below the write limit and the tail is the top rung anyway.
    if n_boxes <= bb and n_rels == n_kept:
        bb2, br2 = pick_joint_bucket(tuple(max_boxes_buckets),
                                     tuple(max_rels_buckets),
                                     n_boxes, n_rels)
        if bb2 < bb or br2 < br:
            bb, br = min(bb2, bb), min(br2, br)
            boxes = np.ascontiguousarray(boxes[:bb])
            box_frame, box_mask = box_frame[:bb].copy(), box_mask[:bb].copy()
            labels, scores = labels[:bb].copy(), scores[:bb].copy()
            dist, feats = (np.ascontiguousarray(dist[:bb]),
                           np.ascontiguousarray(feats[:bb]))
            pair_idx = np.ascontiguousarray(pair_idx[:br])
            im_idx, rel_mask = im_idx[:br].copy(), rel_mask[:br].copy()
            att = np.ascontiguousarray(att[:br])
            sp = np.ascontiguousarray(sp[:br])
            con = np.ascontiguousarray(con[:br])

    rm = rel_mask.astype(bool)
    union = np.concatenate([
        np.minimum(boxes[pair_idx[:, 0], :2], boxes[pair_idx[:, 1], :2]),
        np.maximum(boxes[pair_idx[:, 0], 2:], boxes[pair_idx[:, 1], 2:])], 1)
    uf = _resolve_union_features(union, im_idx, br, feat_dim, union_feat_fn,
                                 union_cache_path, union_cache_dtype,
                                 union_cache_key, extract_mask=rm)
    if compute_spatial_masks:
        masks = np.zeros((br, MASK_P, MASK_P, 2), np.float32)
        if rm.any():
            pair_rois = np.concatenate(
                [boxes[pair_idx[rm, 0]], boxes[pair_idx[rm, 1]]], 1)
            masks[rm] = draw_union_boxes_np(pair_rois, MASK_P) - 0.5
    else:  # device-compute sentinel (models/sttran.spatial_mask_input)
        masks = np.zeros((br, MASK_P, MASK_P, 0), np.float32)

    return Entry.from_numpy(dict(
        boxes=boxes, box_frame=box_frame, box_mask=box_mask.astype(bool),
        labels=labels, scores=scores, distribution=dist, features=feats,
        pair_idx=pair_idx, im_idx=im_idx, rel_mask=rm,
        union_feat=uf if len(uf) == br else np.zeros(
            (br, POOL, POOL, feat_dim), np.float32),
        spatial_masks=masks,
        attention_gt=att, spatial_gt=sp, contacting_gt=con,
        num_frames=np.int32(F),
    ))


def entry_to_eval_pred(entry: Entry, pred: dict) -> dict:
    """Model outputs + the Entry fields the evaluator needs, as host numpy.

    One definition for every eval path (epoch eval, sgdet and sgcls test
    flows), so the evaluator's input cannot diverge between them. Entry
    fields and outputs may be tensors on any device, floating ones in
    bfloat16 (`to_numpy` casts them to float32)."""
    out = {k: to_numpy(v) for k, v in pred.items()}
    out.update(boxes=to_numpy(entry.boxes),
               pair_idx=to_numpy(entry.pair_idx),
               im_idx=to_numpy(entry.im_idx),
               rel_mask=to_numpy(entry.rel_mask),
               box_mask=to_numpy(entry.box_mask),
               labels=to_numpy(entry.labels),
               scores=to_numpy(entry.scores))
    return out


def entry_to_pred(entry: Entry | None) -> dict:
    """Oracle-detector pred from the Entry's GT relation labels."""
    if entry is None:
        return {}
    return {
        "boxes": to_numpy(entry.boxes),
        "box_mask": to_numpy(entry.box_mask),
        "labels": to_numpy(entry.labels),
        "scores": to_numpy(entry.scores),
        "pred_labels": to_numpy(entry.labels),
        "pred_scores": to_numpy(entry.scores),
        "pair_idx": to_numpy(entry.pair_idx),
        "im_idx": to_numpy(entry.im_idx),
        "rel_mask": to_numpy(entry.rel_mask),
        # attention goes through softmax in the evaluator; huge logits on the
        # GT bits reproduce the reference's exact one-hot probabilities
        "attention_distribution": to_numpy(entry.attention_gt) * 1e4,
        "spatial_distribution": to_numpy(entry.spatial_gt),
        "contacting_distribution": to_numpy(entry.contacting_gt),
    }


@functools.lru_cache(maxsize=8192)
def _mapped_order_cached(ag_ids: tuple[int, ...],
                         gt_classes: frozenset[int]) -> tuple[int, ...]:
    return tuple(set(ag_ids) & set(gt_classes))


def _mapped_order(ag_ids: tuple[int, ...], gt_classes: frozenset[int],
                  is_train: bool) -> tuple[int, ...]:
    """Per-det mapped-class emission order. Must match the reference's
    `list(set(ag_ids) & set(gt))` CPython set-iteration order exactly
    (assign_pseudo_label.py:128); lru-cached (bounded — a plain dict would
    grow monotonically over a multi-epoch run) per (ids, gt-set) combination."""
    if not is_train:
        return ag_ids
    return _mapped_order_cached(ag_ids, gt_classes)


@functools.lru_cache(maxsize=8)
def _person_lut(person_ids: frozenset[int]) -> np.ndarray:
    """Boolean lookup table over OI class ids: `lut[cls]` replaces the
    per-frame np.isin/sort machinery. The table's last slot is a non-person sentinel so
    np.take(..., mode='clip') is safe for any id; callers must mask negative
    ids separately (clip maps them to index 0)."""
    if not person_ids:  # degenerate taxonomy: nothing is a person
        return np.zeros(1, bool)
    size = max(person_ids) + 2  # +1 sentinel row for clipped out-of-range ids
    lut = np.zeros(size, bool)
    lut[list(person_ids)] = True
    lut[size - 1] = False
    return lut


def assign_labels_frame_fast(frame: FrameDetections, gt_frame: list[dict],
                             is_train: bool, person_ids: frozenset[int],
                             oi_to_ag: dict[int, list[int]],
                             pseudo_way: int = 0) -> GroundedFrame:
    """Vectorized assign_labels_frame: one isin/argmax for person selection,
    numpy fan-out for the (overwhelmingly single-mapped) object classes,
    exact row-order parity with the loop version (fuzz-tested)."""
    classes = frame.classes.copy()
    classes[classes == 1594] = 1593
    is_person = np.take(_person_lut(person_ids), classes, mode="clip") \
        & (classes >= 0)  # clip maps negatives to index 0; np.isin said False
    if not is_person.any():
        if pseudo_way == 0:
            return GroundedFrame(has_person=False)
        person_idx = 0
    else:
        pconfs = np.where(is_person, frame.confs, -np.inf)
        person_idx = int(pconfs.argmax())

    gt_classes = frozenset(int(g["class"]) for g in gt_frame if "class" in g)
    keep = ~is_person
    keep[person_idx] = False
    rows = np.where(keep)[0]
    out_rows, out_cls = [], []
    for i in rows:  # tiny loop over kept dets; mapping itself is dict+cache
        ag = oi_to_ag.get(int(classes[i]))
        if not ag:
            continue
        for c in _mapped_order(tuple(ag), gt_classes, is_train):
            out_rows.append(i)
            out_cls.append(c)
    out_rows = np.asarray(out_rows, np.int64)
    k = len(out_rows)
    return GroundedFrame(
        has_person=True,
        person_rect=frame.rects[person_idx],
        person_conf=float(frame.confs[person_idx]),
        person_feat=frame.feats[person_idx],
        obj_classes=np.asarray(out_cls, np.int64).reshape(k),
        obj_confs=frame.confs[out_rows].astype(np.float32) if k
        else np.zeros(0, np.float32),
        obj_rects=frame.rects[out_rows].reshape(k, 4) if k
        else np.zeros((0, 4), np.float32),
        obj_feats=frame.feats[out_rows] if k
        else np.zeros((0, frame.feats.shape[-1]), np.float32),
    )
