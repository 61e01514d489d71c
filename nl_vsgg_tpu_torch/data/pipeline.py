"""Host-side data pipeline: background grounding + bucket batching (port of
nl_vsgg_tpu/data/pipeline.py).

The reference's train loop grounds one video on the host, then steps the
GPU, strictly in turn (tools/train_STTran.py:121-195). Here a thread pool
grounds videos ahead of the card and a bucketer groups same-shape Entries
into batches, so host IO and grounding overlap the card's work;
`DoubleBuffer` holds one queued batch so the host post-processes the
previous one while the card computes.
"""

from __future__ import annotations

import queue
import threading
from collections import defaultdict
from typing import Callable, Iterator, Sequence

from .entry import Entry


class TruncationCounter:
    """Thread-safe tally of boxes/relations dropped by bucket truncation
    (data/entry.py pad_entry keeps only the first bucket rows for oversized
    videos). Tools pass `.add` as build_entry's on_truncate and log the tally
    per epoch — silent label loss is un-debuggable recall drift."""

    def __init__(self):
        self.videos = 0
        self.boxes = 0
        self.rels = 0
        self._lock = threading.Lock()

    def add(self, n_boxes: int, n_rels: int) -> None:
        with self._lock:
            self.videos += 1
            self.boxes += int(n_boxes)
            self.rels += int(n_rels)

    def take(self) -> tuple[int, int, int]:
        """Return (videos, boxes, rels) and reset."""
        with self._lock:
            out = (self.videos, self.boxes, self.rels)
            self.videos = self.boxes = self.rels = 0
        return out


class GroundingPrefetcher:
    """Runs `ground_fn(index) -> Entry | None` for each index on worker
    threads, yielding results in completion order with bounded lookahead,
    or, with `ordered=True`, in the order of `indices` (`indices` then
    distinct), so that what a consumer builds from them does not depend on
    the workers' timing. Ordered, results that finish early wait for the
    ones before them, and no worker starts a position `prefetch` or more
    past the next one to yield: a slow video stalls the stream, but at
    most `prefetch` results are held, grounded or grounding, meanwhile."""

    def __init__(self, ground_fn: Callable[[int], Entry | None],
                 indices: Sequence[int], num_workers: int = 4,
                 prefetch: int = 16, ordered: bool = False):
        self.ground_fn = ground_fn
        self.indices = list(indices)
        self.ordered = ordered
        self._ahead = threading.Semaphore(prefetch) if ordered else None
        self.num_workers = max(1, num_workers)
        self.out: queue.Queue = queue.Queue(maxsize=prefetch)
        self._in: queue.Queue = queue.Queue()
        for i in self.indices:
            self._in.put(i)
        self._threads = []
        self._errors: list[BaseException] = []
        self._pos = {i: p for p, i in enumerate(self.indices)}

    def _worker(self):
        while True:
            if self._ahead is not None:
                self._ahead.acquire()
            try:
                idx = self._in.get_nowait()
            except queue.Empty:
                if self._ahead is not None:
                    self._ahead.release()
                return
            try:
                self.out.put((idx, self.ground_fn(idx)))
            except Exception as e:
                self._errors.append(e)
                self.out.put((idx, None))
            except BaseException as e:  # KeyboardInterrupt/SystemExit: still
                # enqueue the sentinel (the consumer waits for exactly
                # len(indices) items — a missing slot would deadlock it),
                # then re-raise so the interrupt stays loud in this thread
                self._errors.append(e)
                self.out.put((idx, None))
                raise

    def __iter__(self) -> Iterator[tuple[int, Entry | None]]:
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()
        early: dict[int, tuple] = {}   # ordered: finished before their turn
        for pos in range(len(self.indices)):
            while self.ordered and pos not in early:
                item = self.out.get()
                early[self._pos[item[0]]] = item
                self._raise_first()
            if self.ordered:
                item = early.pop(pos)
                self._ahead.release()
            else:
                item = self.out.get()
                self._raise_first()
            yield item
        for t in self._threads:
            t.join()
        self._raise_first()

    def _raise_first(self) -> None:
        # fail loud now: deferring to the end of the epoch would score the
        # rest of the split as skips first, and a consumer that stops early
        # would never see the error at all
        if self._errors:
            raise self._errors[0]


def bucket_events(pairs: Iterator[tuple[int, Entry | None]], batch_size: int
                  ) -> Iterator[tuple[str, int | list[tuple[int, Entry]]]]:
    """Shared bucket-batching event stream for (index, Entry|None) iterators
    (one definition for the train epoch and the epoch eval): yields ("skip",
    index) for None entries and ("batch", [(index, entry), ...]) whenever a
    same-shape bucket reaches `batch_size`, flushing leftovers at the end —
    at most one pending batch per bucket, so host memory stays bounded."""
    pending: dict[tuple[int, int], list[tuple[int, Entry]]] = defaultdict(list)
    for i, e in pairs:
        if e is None:
            yield ("skip", i)
            continue
        key = (e.n_boxes, e.n_rels)
        pending[key].append((i, e))
        if len(pending[key]) == batch_size:
            yield ("batch", pending.pop(key))
    for key in list(pending):
        yield ("batch", pending.pop(key))


class DoubleBuffer:
    """Hold one in-flight batch so host post-processing overlaps device
    compute: `push(x)` returns the previously pushed value (process it after
    queueing the next batch), `flush()` returns the last pending one."""

    def __init__(self):
        self._pending = None

    def push(self, item):
        prev, self._pending = self._pending, item
        return prev

    def flush(self):
        prev, self._pending = self._pending, None
        return prev
