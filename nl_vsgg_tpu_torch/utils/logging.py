"""Console/file logging and scalar metrics (port of
nl_vsgg_tpu/utils/logging.py).

`setup_logger` is stdlib logging to stdout and, with a `save_dir`, to
`<save_dir>/log.txt`. `MetricWriter` appends one JSON record a call to
`<save_dir>/metrics.jsonl`: `step`, `time`, then the scalars as floats, the
JAX package's records key for key. `SmoothedValue` keeps a window's median
and mean (the reference's lib/logger.py:19-48).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from collections import deque


def setup_logger(name: str = "nl_vsgg_tpu_torch", save_dir: str | None = None,
                 filename: str = "log.txt", level: int = logging.INFO) -> logging.Logger:
    """The named logger with a stdout handler and, with `save_dir`, a file
    handler. Handlers are attached once a process: a second call returns
    the logger as it is."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s",
                            datefmt="%m/%d %H:%M:%S")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Append-only JSONL scalar sink."""

    def __init__(self, save_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, filename)
        self._f = open(self.path, "a")

    def write(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class SmoothedValue:
    """Windowed median / mean tracker (lib/logger.py:19-48)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.series = []
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(value)
        self.series.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        # torch.median (the reference's) returns the lower middle value of
        # an even-length window, not the mean of the two
        d = sorted(self.deque)
        return d[(len(d) - 1) // 2]

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)
