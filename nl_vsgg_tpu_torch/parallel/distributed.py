"""Multi-process data-parallel training support (port of
nl_vsgg_tpu/parallel/distributed.py).

One process per rank over `torch.distributed`:

  * `init_distributed` starts the process group from the same contract as
    the JAX tool: cfg.coordinator_address / num_processes / process_id, or
    the environment variables NL_VSGG_COORDINATOR / NL_VSGG_NUM_PROCESSES
    / NL_VSGG_PROCESS_ID. The coordinator's host:port becomes a tcp://
    rendezvous (a file:// or tcp:// URL is taken as it is). Rank r runs on
    cuda:(r % device_count), or on the CPU when the caller asks for it.
    Before the group starts, every rank publishes its host name and card
    count through the rendezvous store; the backend is NCCL when every
    rank has a card of its own, and gloo when ranks share a card (NCCL
    refuses two ranks on one card) or run on the CPU. A second, gloo group
    carries host objects whatever the backend.
  * `DistributedBatcher`: each global batch is a fixed block of the shared
    epoch order; rank p grounds and owns the contiguous block [p B/n,
    (p+1) B/n) and yields it as its local padded batch on its device. One
    all-gather of the (n_boxes, n_rels) hints agrees the padded bucket.
  * `merge_evaluators` all-gathers the host evaluator's per-video recall
    lists after each rank scored its shard of the test split, so R@K
    equals one evaluation of the whole split.

Under a mesh with a model axis (parallel/mesh.make_mesh, `model` > 1) rank
r is data index r // model and model index r % model, as JAX lays out
`devices.reshape(data, model)`. The ranks of one model group hold one
replica between them, so every data-parallel rule keys on the data index
and the data-axis size (`data_index`, `data_size`): the batcher's blocks,
the store's shards, the eval split; `merge_evaluators` keeps the lists of
the model-index-0 ranks only, or each video would count `model` times.

Every collective runs under the group's explicit timeout (`timeout_s`, by
default NL_VSGG_DIST_TIMEOUT_S or 600 s): a rank that dies leaves the
others raising, not hanging. With no group every helper degrades to its
one-process form, so the training tool calls them unconditionally.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.entry import Entry, empty_entry, pad_entry
from ..device import resolve_device

ENV_COORD, ENV_NPROC, ENV_PID = ("NL_VSGG_COORDINATOR", "NL_VSGG_NUM_PROCESSES",
                                 "NL_VSGG_PROCESS_ID")


def default_timeout_s() -> float:
    return float(os.environ.get("NL_VSGG_DIST_TIMEOUT_S", "600"))


@dataclasses.dataclass
class _Group:
    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: object          # gloo group for host objects
    timeout: datetime.timedelta
    local_ranks: int            # ranks on this rank's host


_GROUP: _Group | None = None
_MODEL_AXIS = {"size": 1}   # the mesh's model axis (make_mesh), 1 without one


def rendezvous_url(coord: str) -> str:
    """host:port -> tcp://host:port; URLs pass through."""
    return coord if "://" in coord else f"tcp://{coord}"


def _store(url: str, rank: int, world: int, timeout: datetime.timedelta):
    if url.startswith("file://"):
        return dist.FileStore(url[len("file://"):], world)
    if url.startswith("tcp://"):
        host, port = url[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout,
                             wait_for_workers=False)
    raise ValueError(f"rendezvous {url!r}: expected host:port, tcp:// or file://")


def choose_backend(hosts: Sequence[str], cards: Sequence[int], device_type: str) -> str:
    """NCCL when every rank has a card of its own, else gloo: `hosts[r]`
    and `cards[r]` are rank r's host name and card count."""
    if device_type != "cuda":
        return "gloo"
    per_host: dict[str, int] = {}
    for h in hosts:
        per_host[h] = per_host.get(h, 0) + 1
    own = all(per_host[h] <= c for h, c in zip(hosts, cards))
    return "nccl" if own else "gloo"


def init_distributed(cfg=None, logger=None, device=None, timeout_s: float | None = None
                     ) -> bool:
    """Start the process group if configured; True when more than one rank
    runs. Sources, in priority order: cfg.coordinator_address /
    num_processes / process_id; the NL_VSGG_* environment variables;
    cfg.distributed with no coordinator: torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). `device` None is the
    card (cuda:(rank % device_count)); "cpu" runs the rank on the CPU.
    Safe to call twice: the second call returns the group's state."""
    global _GROUP
    if _GROUP is not None:
        return _GROUP.world > 1
    coord = (getattr(cfg, "coordinator_address", "") or os.environ.get(ENV_COORD, ""))
    nproc = int(getattr(cfg, "num_processes", -1) if cfg is not None else -1)
    if nproc < 0:
        nproc = int(os.environ.get(ENV_NPROC, "-1"))
    pid = int(getattr(cfg, "process_id", -1) if cfg is not None else -1)
    if pid < 0:
        pid = int(os.environ.get(ENV_PID, "-1"))
    if not (bool(getattr(cfg, "distributed", False)) or coord):
        return False
    if not coord:
        coord = f"{os.environ.get('MASTER_ADDR', 'localhost')}:" \
                f"{os.environ.get('MASTER_PORT', '29500')}"
        nproc = nproc if nproc >= 0 else int(os.environ.get("WORLD_SIZE", "-1"))
        pid = pid if pid >= 0 else int(os.environ.get("RANK", "-1"))
    if nproc < 1 or not 0 <= pid < nproc:
        raise ValueError(f"distributed: process {pid} of {nproc}: set num_processes and "
                         f"process_id (or {ENV_NPROC} / {ENV_PID})")
    timeout = datetime.timedelta(seconds=timeout_s or default_timeout_s())
    requested = resolve_device(device)
    n_cards = torch.cuda.device_count() if requested.type == "cuda" else 0
    dev = torch.device("cuda", pid % n_cards) if requested.type == "cuda" else requested
    store = _store(rendezvous_url(coord), pid, nproc, timeout)
    # one exchange before the group starts: who runs where, on how many cards
    host = socket.gethostname()
    meta = dist.PrefixStore("nl_vsgg/ranks", store)
    meta.set(str(pid), f"{n_cards} {host}")
    seen = [meta.get(str(r)).decode().split(" ", 1) for r in range(nproc)]
    hosts, cards = [s[1] for s in seen], [int(s[0]) for s in seen]
    backend = choose_backend(hosts, cards, dev.type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.PrefixStore("nl_vsgg/pg", store),
                            rank=pid, world_size=nproc, timeout=timeout)
    host_group = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=timeout))
    _GROUP = _Group(pid, nproc, dev, backend, host_group, timeout, hosts.count(host))
    if logger is not None:
        logger.info(describe())
    return nproc > 1


def describe() -> str:
    """The `distributed:` log line: rank, backend, device, ranks a host."""
    g = _GROUP
    if g is None:
        return "distributed: not initialized (one process)"
    return (f"distributed: process {g.rank}/{g.world}, backend {g.backend}, device "
            f"{g.device}, {g.local_ranks} ranks on this host")


def join_processes(ctx, timeout_s: float | None = None) -> None:
    """Wait for a `torch.multiprocessing` context's ranks; a rank's failure
    raises here (the others are terminated). `timeout_s` (None:
    NL_VSGG_JOIN_TIMEOUT_S, or no limit when it is unset) bounds the wait:
    past it the ranks are killed and TimeoutError is raised."""
    import time

    if timeout_s is None and os.environ.get("NL_VSGG_JOIN_TIMEOUT_S"):
        timeout_s = float(os.environ["NL_VSGG_JOIN_TIMEOUT_S"])
    end = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=5.0):
        if end is not None and time.monotonic() > end:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"ranks still running after {timeout_s} s: killed")


def shutdown() -> None:
    """Tear the group down (a no-op without one)."""
    global _GROUP
    if _GROUP is not None:
        dist.destroy_process_group()
        _GROUP = None
    _MODEL_AXIS["size"] = 1


def initialized() -> bool:
    return _GROUP is not None


def rank() -> int:
    return _GROUP.rank if _GROUP is not None else 0


def world_size() -> int:
    return _GROUP.world if _GROUP is not None else 1


def set_model_axis(model: int) -> None:
    """Record the mesh's model-axis size (parallel/mesh.make_mesh)."""
    if world_size() % model:
        raise ValueError(f"model axis {model} does not divide {world_size()} ranks")
    _MODEL_AXIS["size"] = model


def model_size() -> int:
    return _MODEL_AXIS["size"]


def data_size() -> int:
    """The data axis: the replicas that split each global batch."""
    return world_size() // model_size()


def data_index() -> int:
    return rank() // model_size()


def model_index() -> int:
    return rank() % model_size()


def rank_device() -> torch.device | None:
    """The rank's device, or None without a group."""
    return _GROUP.device if _GROUP is not None else None


def backend() -> str | None:
    return _GROUP.backend if _GROUP is not None else None


def is_primary() -> bool:
    """True on the rank that writes logs, metrics and checkpoints."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank, on the host group (a no-op without a group)."""
    if _GROUP is not None and _GROUP.world > 1:
        dist.barrier(group=_GROUP.host_group)


def allgather_obj(obj) -> list:
    """Every rank's picklable `obj`, in rank order. One rank: [obj]."""
    if _GROUP is None or _GROUP.world == 1:
        return [obj]
    out: list = [None] * _GROUP.world
    dist.all_gather_object(out, obj, group=_GROUP.host_group)
    return out


def all_reduce_host(values: np.ndarray, op: str = "sum") -> np.ndarray:
    """A small host array reduced over the ranks on the host group."""
    t = torch.as_tensor(np.asarray(values))
    if _GROUP is not None and _GROUP.world > 1:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=_GROUP.host_group)
    return t.numpy()


def merge_evaluators(evaluator) -> None:
    """Merge per-rank SceneGraphEvaluator shards in place: every rank ends
    with the whole split's per-video lists, in data-index order. Under a
    model axis the ranks of one model group scored the same videos: only
    the model-index-0 rank's lists count."""
    state = (evaluator.recall, evaluator.recall_nogc, evaluator.semi_recall,
             evaluator.mean_recall.collect, evaluator.ng_mean_recall.collect)
    all_states = allgather_obj(state)[::model_size()]
    if len(all_states) == 1:
        return
    for tgt_i, tgt in enumerate((evaluator.recall, evaluator.recall_nogc,
                                 evaluator.semi_recall)):
        for k in tgt:
            tgt[k] = [v for st in all_states for v in st[tgt_i][k]]
    for tgt_i, coll in ((3, evaluator.mean_recall), (4, evaluator.ng_mean_recall)):
        for k in coll.collect:
            coll.collect[k] = [[v for st in all_states for v in st[tgt_i][k][n]]
                               for n in range(coll.num_rel)]


class DistributedBatcher:
    """Fixed-composition global video batches for multi-process training.

    Batch t is order[t B : (t+1) B]; rank p grounds and owns the contiguous
    block of B / n videos from p B / n. One all-gather of the members'
    (n_boxes, n_rels) agrees the padded bucket (the max over the batch); a
    batch with no groundable video on any rank is skipped on every rank; a
    failed grounding becomes a zero-weight fill slot; the ragged tail (<
    B videos) is dropped. `ground_fn(video_index) -> Entry | None` runs on
    `num_workers` threads, block t+1 grounding while block t is stepped.
    Yields the rank's local padded batch on `device` (None: the rank's
    device, else the card), placed as `train.step.place_entries` places it
    (a width-0 union under `zero_union`, bf16 relation arrays under
    `rel_bf16`), or (global_index_block, batch) with `yield_indices`."""

    def __init__(self, ground_fn: Callable[[int], Entry | None], order: Sequence[int],
                 batch_videos: int, mesh=None, feat_dim: int = 2048, zero_union: bool = False,
                 rel_bf16: bool = False, num_workers: int = 4, device_masks: bool = False,
                 yield_indices: bool = False, device=None):
        self.yield_indices = yield_indices
        self.ground_fn = ground_fn
        self.order = list(order)
        self.B = batch_videos
        self.feat_dim = feat_dim
        self.zero_union = zero_union
        self.device_masks = device_masks
        self.rel_bf16 = rel_bf16
        self.num_workers = max(1, num_workers)
        self.nproc, self.pid = data_size(), data_index()   # a model group shares a block
        self.device = resolve_device(device if device is not None else rank_device())
        if self.B % self.nproc:
            raise ValueError(
                f"batch_videos={self.B} must be a multiple of the process "
                f"count ({self.nproc} on the data axis) so every process contributes "
                f"the same number of videos per global batch")
        data_axis = mesh.data if mesh is not None else self.nproc
        if self.B % data_axis:
            raise ValueError(
                f"batch_videos={self.B} must be a multiple of the mesh data "
                f"axis ({data_axis})")
        self.per_proc = self.B // self.nproc

    def __iter__(self) -> Iterator[Entry]:
        from concurrent.futures import ThreadPoolExecutor

        from ..train.step import place_entries

        chunks = [self.order[t0:t0 + self.B] for t0 in range(0, len(self.order), self.B)]
        chunks = [c for c in chunks if len(c) == self.B]
        blocks = [c[self.pid * self.per_proc:(self.pid + 1) * self.per_proc] for c in chunks]
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = None
            for t, mine in enumerate(blocks):
                futs = pending or [ex.submit(self.ground_fn, i) for i in mine]
                pending = ([ex.submit(self.ground_fn, i) for i in blocks[t + 1]]
                           if t + 1 < len(blocks) else None)
                entries = []
                for i, f in zip(mine, futs):
                    try:
                        entries.append(f.result())
                    except Exception as e:
                        # a rank raising here would leave the others waiting
                        # in the all-gather below: a fill slot instead
                        logging.getLogger("nl_vsgg_tpu_torch").warning(
                            f"grounding video {i} failed ({e!r}): skipped")
                        entries.append(None)
                hints = np.zeros((self.per_proc, 2), np.int64)
                for j, e in enumerate(entries):
                    if e is not None:
                        hints[j] = (e.n_boxes, e.n_rels)
                all_hints = np.concatenate(allgather_obj(hints))
                if not all_hints.any():
                    continue  # nothing groundable anywhere in this batch
                bb, br = int(all_hints[:, 0].max()), int(all_hints[:, 1].max())
                if self.zero_union:
                    # the width-0 union before padding: pad_entry never copies
                    # the zeros to the agreed bucket
                    entries = [dataclasses.replace(e, union_feat=e.union_feat.new_zeros(
                        tuple(e.union_feat.shape[:-1]) + (0,))) if e is not None else None
                        for e in entries]
                local = [pad_entry(e, bb, br) if e is not None
                         else empty_entry(bb, br, self.feat_dim,
                                          with_union_feat=not self.zero_union,
                                          with_spatial_masks=not self.device_masks)
                         for e in entries]
                out = place_entries(local, zero_union=self.zero_union, rel_bf16=self.rel_bf16,
                                    device=self.device)
                yield (chunks[t], out) if self.yield_indices else out
