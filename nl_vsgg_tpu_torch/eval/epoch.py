"""Per-epoch evaluation: the streaming eval loop and the burn-in promotion
of the on-device R@K scorer (port of tools/train_STTran.py:304-497).

`evaluate_epoch` scores same-bucket batches of (GT annotation, Entry): each
batch is placed on the card (`train.step.place_entries`), run through the
eval step, and scored by the host evaluator and/or `eval/recall_device`.
The loop is double-buffered: batch i's forward is queued before batch i-1
is scored on the host, so the card computes while the host scores.
`grounded_batches` makes such batches the way the training tool does: the
test videos grounded on prefetch workers and grouped by bucket.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from ..data.entry import Entry, to_numpy
from ..data.grounding import entry_to_eval_pred
from ..data.pipeline import GroundingPrefetcher, bucket_events
from ..device import resolve_device
from ..train.step import eval_step, place_entries
from .recall import SceneGraphEvaluator
from .recall_device import device_eval_batch

# the model outputs the evaluators read (the rest stay on the card)
EVAL_KEYS = ("attention_distribution", "spatial_distribution", "contacting_distribution",
             "pred_labels", "pred_scores")
# the device scorers' frame bucket: a video's GT past it is host-scored
F_BUCKET = 32


class DeviceEvalPromotion:
    """Burn-in equivalence check that promotes the on-device R@K scorer
    (tools/train_STTran.py::DeviceEvalPromotion of the JAX package, the same
    rules).

    For the first `burnin` comparable videos of an epoch eval both
    evaluators run and their with/no-constraint/semi R@K rows are compared
    (atol 1e-6 covers float32-vs-float64 division only; hit counts must
    agree). On full agreement the host evaluator is skipped for the
    remaining videos and `score(20)`, the plateau metric, comes from the
    device rows. After promotion every `recheck_every`-th device-scored
    video is still host-compared, so a divergence that shows only on later
    videos cannot bias the metric for the whole epoch. Any value mismatch
    demotes: the eval loop reverts to host scoring for the rest of the
    epoch; a post-promotion (late) demotion keeps recording host rows into
    `rows`, so `score()` still covers the full split, with at most
    `recheck_every - 1` unverified device rows before the mismatch. Videos
    whose GT exceeds the device frame bucket (gt_dropped > 0) are never
    compared nor device-scored into the metric: the loop host-scores them
    and records the host rows, so bucket truncation can neither demote the
    epoch nor bias the promoted mean. Reported numbers come from the host
    evaluator; this only speeds up the per-epoch metric.
    """

    def __init__(self, burnin: int = 16, recheck_every: int = 64):
        self.burnin = burnin
        self.recheck_every = recheck_every
        self.checked = 0
        self.ok = True
        self.late_demoted = False
        self._since_check = 0  # device-only videos since the last host compare
        self.rows: list[dict] = []

    @property
    def promoted(self) -> bool:
        return self.ok and self.checked >= self.burnin

    def host_needed(self) -> bool:
        """True during burn-in AND on periodic post-promotion recheck ticks."""
        if not self.promoted:
            return True
        return (self.recheck_every > 0
                and self._since_check + 1 >= self.recheck_every)

    def add_skip(self, gt_annotation) -> None:
        # grounding produced nothing: the host evaluator appends one 0.0 row
        # per frame (eval/recall.py, the empty-pred path); mirror that frame count
        z = np.zeros((len(gt_annotation), 3), np.float32)
        self.rows.append({"recall": z, "recall_nogc": z, "semi": z,
                          "gt_dropped": 0})

    @staticmethod
    def _host_rows(evaluator, host_marks) -> dict:
        row = {"gt_dropped": 0}
        for name, sink in (("recall", evaluator.recall),
                           ("recall_nogc", evaluator.recall_nogc),
                           ("semi", evaluator.semi_recall)):
            row[name] = np.stack(
                [np.asarray(sink[k][host_marks[name]:], np.float64)
                 for k in (10, 20, 50)], axis=-1)
        return row

    def add_host_rows(self, evaluator, host_marks) -> None:
        """Record a host-scored video (bucket-truncation fallback)."""
        self.rows.append(self._host_rows(evaluator, host_marks))

    def add(self, dev_row: dict, evaluator, host_marks=None) -> None:
        """dev_row: device_eval_video output. host_marks: per-sink list
        lengths captured BEFORE the host scored this video (burn-in and
        periodic recheck videos)."""
        self.rows.append(dev_row)
        if host_marks is None:
            self._since_check += 1
            return
        was_promoted = self.promoted
        self._since_check = 0
        self.checked += 1
        ok = dev_row.get("gt_dropped", 0) == 0  # safety; loop diverts these
        host = self._host_rows(evaluator, host_marks)
        for name in ("recall", "recall_nogc", "semi"):
            dev = np.asarray(dev_row[name], np.float64)
            ok &= host[name].shape == dev.shape and \
                np.allclose(host[name], dev, atol=1e-6)
        self.ok &= ok
        if not ok and was_promoted:
            self.late_demoted = True

    def score(self, k: int = 20) -> float:
        col = {10: 0, 20: 1, 50: 2}[k]
        r = np.concatenate([d["recall"] for d in self.rows]) if self.rows \
            else np.zeros((0, 3))
        return float(r[:, col].mean()) if len(r) else 0.0


def start_fetch(out: dict, device: torch.device, keys: Sequence[str] = EVAL_KEYS
                ) -> Callable[[], dict]:
    """Start copying a batch's `keys` outputs to the host; the returned
    function waits for them and gives host numpy. On the card the copies go
    into pinned memory with non_blocking=True and an event is recorded
    behind them: started before the next batch's forward is queued, the
    wait does not wait for that forward (a plain `.cpu()` issued after it
    would, on the one stream)."""
    if device.type != "cuda":
        return lambda: {k: to_numpy(out[k]) for k in keys}
    host = {k: torch.empty(out[k].shape, dtype=out[k].dtype, pin_memory=True)
            .copy_(out[k], non_blocking=True) for k in keys}
    done = torch.cuda.Event()
    done.record()

    def wait() -> dict:
        done.synchronize()
        return {k: to_numpy(v) for k, v in host.items()}

    return wait


def grounded_batches(get_entry: Callable[[int], Entry | None], gt_annotations: Sequence,
                     indices: Iterable[int], batch_videos: int, num_workers: int = 4
                     ) -> Iterator[list[tuple[list, Entry | None]]]:
    """`evaluate_epoch`'s input as the training tool builds it
    (tools/train_STTran.py:400-509): `get_entry(i)` grounds test video i on
    `num_workers` prefetch threads; Entries are grouped into same-bucket
    batches of `batch_videos` (`bucket_events`); a video that grounds to
    None comes as a batch of its own, as it arrives."""
    prefetcher = GroundingPrefetcher(get_entry, list(indices), num_workers=num_workers)
    for kind, payload in bucket_events(iter(prefetcher), batch_videos):
        if kind == "skip":
            yield [(gt_annotations[payload], None)]
        else:
            yield [(gt_annotations[i], e) for i, e in payload]


def evaluate_epoch(model: torch.nn.Module,
                   batches: Iterable[Sequence[tuple[list, Entry | None]]],
                   evaluator: SceneGraphEvaluator | None = None,
                   device_recalls: list | None = None,
                   promotion: DeviceEvalPromotion | None = None,
                   device=None, zero_union: bool = False) -> SceneGraphEvaluator:
    """Streaming evaluation (the reference's tools/train_STTran.py:210-232).

    `batches` yields lists of (gt_annotation, Entry) whose Entries share one
    bucket shape; an Entry of None is a video that grounding produced
    nothing for, scored as an empty prediction. Batches are scored and
    dropped, so host memory does not grow with the split. Pass a list as
    `device_recalls` to also score every video with the on-device scorers;
    pass a `DeviceEvalPromotion` to let them replace the host evaluator
    after its burn-in. The host evaluator stays the reported source of
    truth. `device=None` is the card; the model must live there.
    `zero_union` places the batches with a width-0 union_feat, as the
    training tool does when there is no union-feature provider."""
    device = resolve_device(device)
    if evaluator is None:
        evaluator = SceneGraphEvaluator(mode=getattr(model, "mode", "sgdet"))
    dtype = getattr(model, "dtype", None)

    def _marks():
        return {"recall": len(evaluator.recall[10]),
                "recall_nogc": len(evaluator.recall_nogc[10]),
                "semi": len(evaluator.semi_recall[10])}

    def score(items, pred):
        ps = [entry_to_eval_pred(e, {k: v[bi] for k, v in pred.items()})
              for bi, (_, e) in enumerate(items)]
        # one device call and one packed fetch for the whole batch, computed
        # up front when any video will need a device row
        dev_rows = [None] * len(items)
        if device_recalls is not None or (promotion is not None and promotion.ok):
            dev_rows = device_eval_batch([e for _, e in items], ps, [g for g, _ in items],
                                         evaluator, f_bucket=F_BUCKET, device=device)
        for bi, (gt, _) in enumerate(items):
            p = ps[bi]
            # a demoted promotion reverts to plain host scoring: no further
            # device comparisons for the rest of the epoch
            active = promotion is not None and promotion.ok
            dev_row = dev_rows[bi]
            if device_recalls is not None:
                device_recalls.append(dev_row)
            if not active:
                marks = _marks()
                evaluator.evaluate_scene_graph(gt, p)
                if promotion is not None and promotion.late_demoted:
                    # post-promotion demotion: keep recording host rows so
                    # promotion.score() still covers the full split
                    promotion.add_host_rows(evaluator, marks)
                continue
            if dev_row.get("gt_dropped", 0):
                # GT past the device frame bucket: host-score this video and
                # record the host rows (no burn-in credit, cannot demote)
                marks = _marks()
                evaluator.evaluate_scene_graph(gt, p)
                promotion.add_host_rows(evaluator, marks)
            elif promotion.host_needed():  # burn-in or periodic recheck
                marks = _marks()
                evaluator.evaluate_scene_graph(gt, p)
                promotion.add(dev_row, evaluator, host_marks=marks)
            else:  # promoted: device rows only, host evaluator skipped
                promotion.add(dev_row, evaluator)

    pending = None   # (items, outputs) of the batch dispatched last
    for batch in batches:
        items = []
        for gt, e in batch:
            if e is None:
                # empty-pred host scoring is one zeros-append per frame: run it
                # even under promotion (its rows are unused when promoted)
                evaluator.evaluate_scene_graph(gt, {})
                if promotion is not None and (promotion.ok or promotion.late_demoted):
                    promotion.add_skip(gt)
            else:
                items.append((gt, e))
        if not items:
            continue
        fetch = start_fetch(pending[1], device) if pending else None
        out = eval_step(model, place_entries([e for _, e in items], zero_union=zero_union,
                                             rel_bf16=dtype == torch.bfloat16, device=device))
        if pending:
            score(pending[0], fetch())
        pending = (items, out)
    if pending:
        score(pending[0], start_fetch(pending[1], device)())
    return evaluator
