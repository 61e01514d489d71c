"""Per-call time of a function by two-point differencing, on the card or on
the CPU.

The counterpart of tools/bench_suite.py's `timed` and `timed_delta`: a
window of n calls and a window of k n calls are each timed (the median of
`reps` windows), and their difference over (k - 1) n calls cancels what a
window costs once (a synchronize, event records, the loop's set-up). PyTorch
queues calls on one stream in order, so no carry chains them as the JAX
probes' `fori_loop` did.

A clock times one window: `clock(fn, n) -> (device_seconds, host_seconds)`.
- `cuda_clock` queues a sleep kernel first, so the card is still busy while
  the host queues the n calls, then records CUDA events around them: the
  device time is the calls' own work, not the host's launch rate, and the
  host time is what issuing the calls cost (through `ctypes` for the port's
  kernels, through the dispatcher for a native op).
- `wall_clock` is the host clock alone (device time None), for the CPU.
A test passes a stub clock.

An unstable pair (a difference of at most a tenth of the long window, in
either time) is measured again, up to 3 times, then raises: it is never
clamped.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

SLEEP_CYCLES = 50_000_000              # about 25 ms at an H100's clocks
HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,    # dense tensor-core bf16
            torch.float32: 67e12}      # float32 outside the tensor cores

Clock = Callable[[Callable[[], object], int], "tuple[float | None, float]"]


@dataclass(frozen=True)
class CallTime:
    device_s: float | None   # device seconds a call; None where no device clock ran
    host_s: float            # host seconds to issue a call
    calls: int               # calls made while measuring, the warm-up included


def cuda_clock(fn, n: int) -> tuple[float, float]:
    """One window of n calls of fn on the current CUDA stream."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 1e3, t1 - t0


def wall_clock(fn, n: int, now: Callable[[], float] = time.perf_counter) -> tuple[None, float]:
    """One window of n calls of fn on the host clock (for the CPU)."""
    t0 = now()
    for _ in range(n):
        fn()
    return None, now() - t0


def timed_delta(fn, iters: int, clock: Clock, k: int = 3, reps: int = 3,
                warmup: int = 1) -> CallTime:
    """Per-call device and host time of fn: windows of `iters` and
    k * `iters` calls, `reps` of each (medians), differenced."""
    if iters < 1 or k < 2 or reps < 1:
        raise ValueError(f"need iters >= 1, k >= 2, reps >= 1; got {iters}, {k}, {reps}")
    for _ in range(warmup):
        fn()
    calls = warmup
    for _ in range(3):
        short = [clock(fn, iters) for _ in range(reps)]
        long = [clock(fn, k * iters) for _ in range(reps)]
        calls += reps * (k + 1) * iters
        d1, dk = _median([s[0] for s in short]), _median([s[0] for s in long])
        h1, hk = _median([s[1] for s in short]), _median([s[1] for s in long])
        pairs = [(h1, hk)] if d1 is None else [(d1, dk), (h1, hk)]
        if all(b - a > 0.1 * b for a, b in pairs):
            n = (k - 1) * iters
            return CallTime(None if d1 is None else (dk - d1) / n, (hk - h1) / n, calls)
    raise RuntimeError(
        f"two-point differencing unstable after 3 attempts (device {d1} / {dk} s, host "
        f"{h1:.6f} / {hk:.6f} s for {iters} / {k * iters} calls): raise iters or retry")


def bound_s(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    """Least time on an H100 SXM: bytes over the memory rate or operations
    over the dtype's peak, whichever is larger, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _median(vals):
    if vals[0] is None:
        return None
    s = sorted(vals)
    m = len(s) // 2
    return s[m] if len(s) % 2 else 0.5 * (s[m - 1] + s[m])
