"""Host phase timing and device traces (port of
nl_vsgg_tpu/utils/profiling.py).

`PhaseTimer` sums wall-clock seconds by named phase (grounding, step
dispatch, store gathers, ...) and prints the JAX package's summary lines.
`trace(logdir)` runs its block under `torch.profiler` (CPU activity, and
CUDA activity when a card is present) and writes a Chrome trace into
`logdir`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Wall seconds and calls by phase name; prefetch workers time their
    grounding into the same timer, so the sums take a lock."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: total {t:.2f}s, {c} calls, "
                         f"avg {1e3 * t / max(c, 1):.1f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler scope; on exit the trace is written to
    `<logdir>/trace.json` (chrome://tracing or Perfetto opens it)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
