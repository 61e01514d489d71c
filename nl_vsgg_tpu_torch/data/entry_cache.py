"""Packed-Entry disk cache: warm epochs skip host grounding (port of
nl_vsgg_tpu/data/entry_cache.py).

Grounding is deterministic per video: given the same frame features, pseudo
labels, bucket ladder and grounding flags, `wk_forward` produces the same
padded Entry every epoch. The reference re-runs the whole host pipeline
every step of every epoch (tools/train_STTran.py:121-203 calling
lib/assign_pseudo_label.py:27-45); here the first epoch writes each video's
finished Entry to disk and later epochs (and eval re-runs) read it back.

Layout: one .npz per video under <root>/<split>/, holding every Entry field
plus a fingerprint of the inputs that determine it, the same layout as the
JAX package's, so a file written by either package loads in the other. A
key mismatch is a miss (the stale file is overwritten, never trusted).
Videos that ground to None (no relations) are cached as a tombstone. The
bucket-truncation counts are stored and replayed to the per-epoch
TruncationCounter. Writes are atomic (tmp + os.replace), so concurrent
prefetch workers or processes sharing one directory cannot tear a file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading

import numpy as np

from .entry import Entry, to_numpy

# bump when the cached layout or grounding semantics change: old files
# become misses, never wrong entries
_FORMAT_VERSION = 2  # v2: all-zero union_feat stored as a shape marker

# fields stored at reduced precision when full-width (the same tradeoff and
# dtype knob as the union-feature cache, utils/config.py union_feat_cache_dtype)
_UNION_FIELD = "union_feat"


class _Miss:
    """Sentinel distinguishing 'not cached' from a cached None entry."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover
        return "MISS"


MISS = _Miss()


class EntryCache:
    """Per-video packed-Entry store.

    `key` must encode everything that determines the grounded Entry: the
    dataset identity (pseudo-label pickle path + mtime, frame-features path),
    grounding flags (pseudo_way, feat_dim, device_spatial_masks), the bucket
    ladder, and the union-feature provider identity (or 'none'). Build it
    with `entry_cache_key`.
    """

    def __init__(self, root: str, split: str, key: str,
                 union_dtype: str = "float16"):
        self.dir = os.path.join(root, split)
        self.fingerprint = hashlib.sha1(
            f"v{_FORMAT_VERSION}:{key}".encode()).hexdigest()
        if union_dtype not in ("float32", "float16"):
            raise ValueError(f"union_dtype={union_dtype!r}")
        self.union_dtype = union_dtype
        self.hits = 0
        self.misses = 0

    def path(self, video_id: str) -> str:
        return os.path.join(self.dir, str(video_id).replace("/", "_") + ".npz")

    def load(self, video_id: str):
        """-> (Entry | None, (trunc_boxes, trunc_rels)) on a hit, MISS else."""
        p = self.path(video_id)
        if not os.path.exists(p):
            self.misses += 1
            return MISS
        try:
            with np.load(p) as z:
                if str(z["__key__"]) != self.fingerprint:
                    self.misses += 1
                    return MISS
                trunc = tuple(int(v) for v in z["__trunc__"])
                if bool(z["__none__"]):
                    self.hits += 1
                    return None, trunc
                kw = {}
                zero_union = "__union_zero_shape__" in z.files
                for f in dataclasses.fields(Entry):
                    if f.name == _UNION_FIELD and zero_union:
                        # no-provider grounding: the union block is all
                        # zeros — reconstruct via calloc instead of reading
                        # ~19 MB of stored zeros back per video per epoch
                        kw[f.name] = np.zeros(
                            tuple(z["__union_zero_shape__"]), np.float32)
                        continue
                    v = z[f.name]
                    if f.name == _UNION_FIELD and v.dtype != np.float32:
                        v = v.astype(np.float32)
                    kw[f.name] = v
                self.hits += 1
                return Entry.from_numpy(kw), trunc
        except (KeyError, ValueError, OSError, EOFError):
            # torn/foreign file: treat as a miss and let store() replace it
            self.misses += 1
            return MISS

    def store(self, video_id: str, entry: Entry | None,
              trunc: tuple[int, int] = (0, 0)) -> None:
        os.makedirs(self.dir, exist_ok=True)
        p = self.path(video_id)
        payload = {"__key__": self.fingerprint,
                   "__none__": entry is None,
                   "__trunc__": np.asarray(trunc, np.int64)}
        if entry is not None:
            for f in dataclasses.fields(Entry):
                v = to_numpy(getattr(entry, f.name))
                if f.name == _UNION_FIELD and v.size and not v.any():
                    # all-zero union block (no union provider): a shape
                    # marker replaces ~19 MB of zeros — the dominant cost of
                    # both the store and every warm-epoch load
                    payload["__union_zero_shape__"] = np.asarray(
                        v.shape, np.int64)
                    continue
                if f.name == _UNION_FIELD and v.shape[-1] \
                        and self.union_dtype != "float32":
                    v = v.astype(self.union_dtype)
                payload[f.name] = v
        tmp = f"{p}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
        # uncompressed: warm-epoch load speed is the point of the cache
        np.savez(tmp, **payload)
        os.replace(tmp, p)


def entry_cache_key(cfg, is_train: bool, union_key: str) -> str:
    """Fingerprint input for EntryCache from a Config (utils/config.py).

    Includes the pseudo-label pickle's mtime (train labels change ->
    invalidate) and every grounding-relevant flag; `union_key` is the union
    provider identity string already used by the union-feature cache
    ('' when union features are off/zero).
    """
    pl = str(cfg.pseudo_localized_SG_path)
    try:
        pl_mtime = int(os.path.getmtime(pl))
    except OSError:
        pl_mtime = 0
    return ":".join([
        str(cfg.data_path), str(cfg.frame_features_path),
        f"{pl}@{pl_mtime}" if is_train else "eval",
        f"feat{cfg.feat_dim}", f"pw{cfg.pseudo_way}",
        f"boxes{cfg.buckets.max_boxes}", f"rels{cfg.buckets.max_rels}",
        f"devmasks{cfg.device_spatial_masks}",
        f"union[{union_key or 'none'}:{cfg.union_feat_cache_dtype}]",
        "pickexact",  # rungs picked from the exact post-grounding counts
    ])
