"""The composed training loop, timed by the epoch (port of
tools/bench_suite.py::run_train_e2e_loop):

    from nl_vsgg_tpu_torch.tools.train_e2e import run_train_e2e_loop
    results = run_train_e2e_loop(cfg, ds, ground, n_videos, epochs, batch_videos)

ground -> prefetch -> place -> step over whole epochs, dataset-agnostic:
any `AGTrain`-like dataset and a `ground(i) -> Entry | None` callable
(tools/acceptance.py points it at an Action Genome split). The model comes
from `tools.train_sttran.build_model` (bf16 compute when cfg.dtype says
so), the state and step from `train.state.create_train_state` and
`train.step.make_train_step`. One step on the first groundable video runs
before the timed epochs. Epoch e's videos are
`np.random.default_rng(cfg.seed + e).permutation(len(ds))[:n_videos]`.
With `device_store` the cold epoch keeps each placed batch on the card
(`DeviceEntryStore.add_batch`, no second upload) and later epochs gather
the stored videos from their indices (`plan_batches` / `gather`); the
misses stream through `GroundingPrefetcher` -> `bucket_events` ->
`place_entries`. The prefetcher yields in the epoch's order, so the
batches do not depend on the workers' timing. Step i's generator is
`train_sttran.step_generator(cfg.seed, i)`, the warm-up step's that of
step 2^31. Each epoch's wall is read after a synchronize, and its frames
are each grounded video's own frame count.

Returns [(epoch, wall_s, frames_per_s, host_s), ...], host_s the seconds
spent grounding (summed over the workers), placing and adding to the
store. Each epoch logs one line (`epoch N (cold|warm)`: its wall,
frames/s, videos, host seconds, stored and streamed batches, skipped
steps and whether every loss was finite), then a `summary` line. A list
given as `counts` receives the same numbers, one dict an epoch: videos,
frames, stored, streamed, skipped, finite.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..data import schema
from ..data.device_store import DeviceEntryStore
from ..data.pipeline import GroundingPrefetcher, bucket_events
from ..device import resolve_device
from ..train.state import create_train_state
from ..train.step import make_train_step, place_entries
from . import train_sttran

WARMUP_STEP = 2 ** 31   # the warm-up step's generator key, outside the epochs' steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_train_e2e_loop(cfg, ds, ground, n_videos: int, epochs: int, batch_videos: int,
                       device_store: bool = True, store_budget_gb: float = 10.0, log=print,
                       device=None, counts: list | None = None):
    """`epochs` timed epochs of `n_videos` videos each on `device` (None:
    the card); see the module docstring."""
    device = resolve_device(device)
    model = train_sttran.build_model(cfg, schema.load_taxonomy(), device)
    rel_bf16 = cfg.dtype == "bfloat16"

    sample = None
    for i in range(min(len(ds), 32)):
        sample = ground(i)
        if sample is not None:
            break
    assert sample is not None, "no groundable video in the first 32"
    state = create_train_state(model, cfg.lr, cfg.weight_decay, cfg.grad_clip_norm)
    train_step = make_train_step(model, state.optimizer, bce=True)

    # one step outside the timed epochs (the kernels' first launches, the
    # allocator's first blocks)
    batch0 = place_entries([sample] * batch_videos, zero_union=True, rel_bf16=rel_bf16,
                           device=device)
    state, _ = train_step(state, batch0, train_sttran.step_generator(cfg.seed, WARMUP_STEP,
                                                                     device))
    _sync(device)

    store = (DeviceEntryStore(budget_bytes=int(store_budget_gb * 1e9), device=device)
             if device_store else None)
    results = []
    step_i = 0
    frames_of: dict[int, int] = {}  # each grounded video's own frame count
    for epoch in range(epochs):
        host_s = {"ground": 0.0, "place": 0.0, "store": 0.0}
        lock = threading.Lock()
        totals: list[torch.Tensor] = []
        batches_of = {"stored": 0, "streamed": 0}

        def timed_ground(i):
            g0 = time.perf_counter()
            e = ground(i)
            with lock:
                host_s["ground"] += time.perf_counter() - g0
            return e

        def step(batch):
            nonlocal state, step_i
            state, met = train_step(state, batch, train_sttran.step_generator(
                cfg.seed, step_i, device))
            totals.append(met["total"])
            step_i += 1

        def stream(indices):
            """ground -> prefetch -> place -> step for `indices`."""
            seen = frames = 0
            pre = GroundingPrefetcher(timed_ground, list(indices), num_workers=cfg.num_workers,
                                      ordered=True)
            for kind, payload in bucket_events(iter(pre), batch_videos):
                if kind == "skip":
                    continue
                p0 = time.perf_counter()
                batch = place_entries([e for _, e in payload], zero_union=True,
                                      rel_bf16=rel_bf16, device=device)
                host_s["place"] += time.perf_counter() - p0
                step(batch)
                batches_of["streamed"] += 1
                seen += len(payload)
                for i, e in payload:
                    frames_of[int(i)] = int(e.num_frames)
                    frames += int(e.num_frames)
                if store is not None and not store.overflow:
                    # the batch already on the card becomes store rows
                    s0 = time.perf_counter()
                    store.add_batch([int(i) for i, _ in payload], batch)
                    host_s["store"] += time.perf_counter() - s0
            return seen, frames

        order = np.random.default_rng(cfg.seed + epoch).permutation(len(ds))[:n_videos]
        if store is not None:
            pre, _ = store.plan_batches(order.tolist(), batch_videos)
            if pre:  # the first gather concatenates the cold epoch's batches: untimed
                store.gather(pre[0])
                _sync(device)
        skipped0 = state.skipped
        e0 = time.perf_counter()
        n_seen = n_frames = 0
        if store is not None:
            batches, misses = store.plan_batches(order.tolist(), batch_videos)
            for idxs in batches:  # the card-resident tier: indices only
                step(store.gather(idxs))
                n_seen += len(idxs)
                n_frames += sum(frames_of[int(i)] for i in idxs)
                batches_of["stored"] += 1
            s, f = stream(misses)
            n_seen, n_frames = n_seen + s, n_frames + f
        else:
            n_seen, n_frames = stream(order.tolist())
        _sync(device)   # every queued step
        wall = time.perf_counter() - e0
        finite = bool(torch.isfinite(torch.stack(totals)).all()) if totals else True
        results.append((epoch, wall, n_frames / wall, dict(host_s)))
        skipped = state.skipped - skipped0
        if counts is not None:
            counts.append(dict(videos=n_seen, frames=n_frames, **batches_of, skipped=skipped,
                               finite=finite))
        tag = "cold" if epoch == 0 else "warm"
        tier = (f", {batches_of['stored']} device-store batches" if batches_of["stored"]
                else "")
        log(f"train_e2e   epoch {epoch} ({tag}): {wall:7.2f}s wall, "
            f"{n_frames / wall:8,.0f} frames/s sustained "
            f"({n_seen} videos; host ground {host_s['ground']:.2f}s, "
            f"place+upload {host_s['place']:.2f}s, store build "
            f"{host_s['store']:.2f}s{tier}); {n_frames} frames, {batches_of['stored']} stored "
            f"and {batches_of['streamed']} streamed batches, {skipped} skipped steps, losses "
            f"{'finite' if finite else 'NOT finite'}")
        if store is not None and store.overflow and epoch == 0:
            log(f"train_e2e   device store over budget ({store.bytes / 1e9:.2f} GB used): "
                f"warm epochs stream the remainder")
    if len(results) > 1:
        warm = results[1:]
        wfs = sum(r[2] for r in warm) / len(warm)
        card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        log(f"train_e2e   summary: cold {results[0][2]:,.0f} f/s | warm "
            f"{wfs:,.0f} f/s (mean of {len(warm)}) on {card}")
    return results
