"""Device-resident Entry store: warm epochs gather batches on the card (port
of nl_vsgg_tpu/data/device_store.py).

The packed-Entry disk cache (entry_cache.py) removes the warm epochs'
grounding; what remains is the per-batch upload, and grounding is
deterministic per video, so the uploaded rows are the same every epoch.
Here the cold epoch keeps each bucket's placed batches on the card
(`add_batch` adopts a batch that `train.step.place_entries` already put
there, at no second upload), and every later epoch sends only the shuffled
video indices: `gather` is one `torch.index_select` a field on the card,
bit-identical to `place_entries` over the same videos.

Under a process group of more than one rank (the JAX store's mesh mode, `_seal_sharded` / `_plan_sharded` / `_gather_sharded`), each
rank keeps only its own block of each global batch: `add_batch` takes the
global composition and the rank's local block (parallel.DistributedBatcher
yields both), and every rank records the same bookkeeping, video -> (bucket,
owning rank, row). `plan_batches` plans shard-balanced batches, batch_size
/ n videos stored on each rank, in rank order, the same plan on every rank;
`gather` returns the rank's block. The over-budget decision is all-reduced:
if one rank streamed while another gathered, the ranks would deadlock.
The shards run over the data axis: under a mesh with a model axis the ranks
of one model group hold the same blocks (the JAX store replicates across
the model column), so "rank" above is the data index.

`budget_bytes` caps the store (the rank's resident bytes); past it
`overflow` is set and callers stream the remaining videos as usual: the
store is a cache tier, not a correctness dependency. A batch keeps the
dtypes `place_entries` gave it (bf16 relation arrays under
`rel_bf16=True`). The JAX package's host fill (`add` + `seal`) and its
`feats_bf16` cast are not ported: the train loop fills the store with
`add_batch` only.
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
    lists the misses. Under a process group of more than one rank it holds
    the rank's blocks only."""

    def __init__(self, budget_bytes: int | None = None, device=None):
        from ..parallel import distributed as dist_mod

        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.budget = budget_bytes
        self._dist = dist_mod
        # the data axis: the ranks of one model group hold the same block
        self.D, self.me = dist_mod.data_size(), dist_mod.data_index()
        # the rank's appended batches per bucket, concatenated at the next gather
        self._chunks: dict[tuple, list[Entry]] = {}
        self._nrows: dict[tuple, list[int]] = {}    # rows per bucket and rank
        self._row_of: dict[int, tuple[tuple, int, int]] = {}  # video -> (bucket, rank, row)
        self._bytes = 0
        self.overflow = False

    def add_batch(self, video_indices, batch: Entry) -> bool:
        """Adopt a batch already on the store's device (place_entries) as
        store rows: no copy. Sharded, `video_indices` is the global batch
        and `batch` the rank's block of it. Returns False, and stores
        nothing, on budget overflow (on any rank) or when the batch lies
        elsewhere or does not match the composition."""
        if self.overflow:
            return False
        B = len(video_indices)
        per = B // self.D
        nbytes = sum(getattr(batch, n).numel() * getattr(batch, n).element_size()
                     for n in _FIELDS)
        flags = [int(batch.box_mask.device != self.device or B % self.D != 0
                     or batch.box_mask.shape[0] != per),
                 int(self.budget is not None and self._bytes + nbytes > self.budget)]
        if self.D > 1:  # one decision on every rank
            flags = self._dist.all_reduce_host(flags, "max").tolist()
        if flags[1] and not flags[0]:
            self.overflow = True
        if any(flags):
            return False
        self._bytes += nbytes
        key = _bucket_key(getattr(batch, n).shape[1:] for n in _FIELDS)
        nrows = self._nrows.setdefault(key, [0] * self.D)
        self._chunks.setdefault(key, []).append(batch)
        for pos, vid in enumerate(video_indices):
            d = pos // per
            self._row_of[int(vid)] = (key, d, nrows[d] + pos % per)
        for d in range(self.D):
            nrows[d] += per
        return True

    def __contains__(self, video_idx: int) -> bool:
        return int(video_idx) in self._row_of

    @property
    def bytes(self) -> int:
        return self._bytes

    def rows_for(self, indices) -> tuple[tuple, list[int]] | None:
        """(bucket key, the rank's rows) of `indices`; None unless all of
        them are stored and share one bucket and, sharded, come in rank
        order, len(indices) / n a rank, as `plan_batches` emits them."""
        B = len(indices)
        if B % self.D:
            return None
        per = B // self.D
        rows, keys = [], set()
        for pos, i in enumerate(indices):
            hit = self._row_of.get(int(i))
            if hit is None or hit[1] != pos // per:
                return None
            keys.add(hit[0])
            if hit[1] == self.me:
                rows.append(hit[2])
        if len(keys) != 1:
            return None
        return next(iter(keys)), rows

    def plan_batches(self, order, batch_size: int) -> tuple[list[list[int]], list[int]]:
        """Group `order` into same-bucket batches of stored videos. One rank:
        the bucket_events rule (a bucket's batch is emitted when full, the
        partial ones at the end). Sharded: batch_size / n videos stored on
        each rank, grouped in rank order, emitted when every rank has its
        share; the stragglers are misses. Returns (batches, misses); the
        caller streams the misses through ground -> place."""
        if self.D > 1:
            return self._plan_sharded(order, batch_size)
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

    def _plan_sharded(self, order, batch_size: int) -> tuple[list[list[int]], list[int]]:
        if batch_size % self.D:
            return [], [int(i) for i in order]
        per = batch_size // self.D
        queues: dict[tuple, list[list[int]]] = {}
        batches: list[list[int]] = []
        misses: list[int] = []
        for i in order:
            hit = self._row_of.get(int(i))
            if hit is None:
                misses.append(int(i))
                continue
            key, d, _ = hit
            q = queues.setdefault(key, [[] for _ in range(self.D)])
            q[d].append(int(i))
            if all(len(s) >= per for s in q):
                batch: list[int] = []
                for s in q:
                    batch.extend(s[:per])
                    del s[:per]
                batches.append(batch)
        for q in queues.values():
            for s in q:
                misses.extend(s)
        return batches, misses

    def gather(self, indices) -> Entry | None:
        """The batch of `indices` (one bucket; sharded, the rank's block) on
        the device; None when a video is not stored, the videos span
        buckets or, sharded, do not come in rank order (the caller streams
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
