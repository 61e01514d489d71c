"""Device-resident Entry store: warm epochs gather batches on the card (port
of nl_vsgg_tpu/data/device_store.py, single device).

The packed-Entry disk cache (entry_cache.py) removes the warm epochs'
grounding; what remains is the per-batch upload, and grounding is
deterministic per video, so the uploaded rows are the same every epoch.
Here the cold epoch keeps each bucket's placed batches on the card
(`add_batch` adopts a batch that `train.step.place_entries` already put
there, at no second upload), and every later epoch sends only the shuffled
video indices: `gather` is one `torch.index_select` a field on the card,
bit-identical to `place_entries` over the same videos.

`budget_bytes` caps the store; past it `overflow` is set and callers stream
the remaining videos as usual: the store is a cache tier, not a correctness
dependency. A batch keeps the dtypes `place_entries` gave it (bf16 relation
arrays under `rel_bf16=True`). The JAX package's host fill (`add` + `seal`),
its `feats_bf16` cast and its sharded store (a mesh's data axis) are not
ported: the train loop fills the store with `add_batch` only.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .entry import Entry

_FIELDS = tuple(f.name for f in dataclasses.fields(Entry))


def _bucket_key(shapes) -> tuple:
    return tuple(tuple(s) for s in shapes)


class DeviceEntryStore:
    """Per-bucket stacked Entry batches resident on `device` (None: the card).

    Fill it with `add_batch` (batches placed by `place_entries`).
    `gather(indices)` returns a batched Entry on the device; `plan_batches`
    groups an epoch's order into same-bucket batches of stored videos and
    lists the misses."""

    def __init__(self, budget_bytes: int | None = None, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.budget = budget_bytes
        # appended batches per bucket, concatenated once at the next gather
        self._chunks: dict[tuple, list[Entry]] = {}
        self._n: dict[tuple, int] = {}              # rows per bucket
        self._row_of: dict[int, tuple[tuple, int]] = {}  # video -> (bucket, row)
        self._bytes = 0
        self.overflow = False

    def add_batch(self, video_indices, batch: Entry) -> bool:
        """Adopt a batch already on the store's device (place_entries) as
        store rows: no copy. Returns False, and stores nothing, on budget
        overflow or when the batch lies elsewhere."""
        if self.overflow or batch.box_mask.device != self.device:
            return False
        nbytes = sum(getattr(batch, n).numel() * getattr(batch, n).element_size()
                     for n in _FIELDS)
        if self.budget is not None and self._bytes + nbytes > self.budget:
            self.overflow = True
            return False
        self._bytes += nbytes
        key = _bucket_key(getattr(batch, n).shape[1:] for n in _FIELDS)
        offset = self._n.get(key, 0)
        self._chunks.setdefault(key, []).append(batch)
        self._n[key] = offset + len(video_indices)
        for r, vid in enumerate(video_indices):
            self._row_of[int(vid)] = (key, offset + r)
        return True

    def __contains__(self, video_idx: int) -> bool:
        return int(video_idx) in self._row_of

    @property
    def bytes(self) -> int:
        return self._bytes

    def rows_for(self, indices) -> tuple[tuple, list[int]] | None:
        """(bucket key, rows) of `indices`; None unless all of them are
        stored and share one bucket."""
        rows, keys = [], set()
        for i in indices:
            hit = self._row_of.get(int(i))
            if hit is None:
                return None
            keys.add(hit[0])
            rows.append(hit[1])
        if len(keys) != 1:
            return None
        return next(iter(keys)), rows

    def plan_batches(self, order, batch_size: int) -> tuple[list[list[int]], list[int]]:
        """Group `order` into same-bucket batches of stored videos (the
        bucket_events rule: a bucket's batch is emitted when full, the
        partial ones at the end). Returns (batches, misses); the caller
        streams the misses through ground -> place."""
        pending: dict[tuple, list[int]] = {}
        batches: list[list[int]] = []
        misses: list[int] = []
        for i in order:
            hit = self._row_of.get(int(i))
            if hit is None:
                misses.append(int(i))
                continue
            q = pending.setdefault(hit[0], [])
            q.append(int(i))
            if len(q) == batch_size:
                batches.append(pending.pop(hit[0]))
        batches.extend(pending.values())
        return batches, misses

    def gather(self, indices) -> Entry | None:
        """The batch of `indices` (one bucket) on the device; None when a
        video is not stored or the videos span buckets (the caller streams
        them). Only the row vector crosses to the card."""
        hit = self.rows_for(indices)
        if hit is None:
            return None
        key, rows = hit
        chunks = self._chunks[key]
        if len(chunks) > 1:  # concatenate once; kept until the next append
            chunks = self._chunks[key] = [Entry(**{
                n: torch.cat([getattr(c, n) for c in chunks]) for n in _FIELDS})]
        idx = torch.tensor(rows, dtype=torch.int64).to(self.device)
        return Entry(**{n: torch.index_select(getattr(chunks[0], n), 0, idx)
                        for n in _FIELDS})
