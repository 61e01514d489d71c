"""Batch serving: Entries in, one JSON scene graph per video out.

Port of tools/predict.py's serving core (`scene_graph_json` and the batch
dispatch around the eval step). Real videos become Entries through the
host data engine (cached detector features -> grounding,
`tools.train_sttran.ground_video`); tests and smoke runs build them with
`data.synthetic.make_synthetic_entry`.

Scene graph layout:
    {"video", "num_frames", "objects": [{"frame", "box", "label", "score"}],
     "triplets": [{"frame", "subject", "object", "predicate", "score",
                   "ranking_score"}]}
`subject`/`object` index into `objects`; triplets carry all three
predicate heads (attention argmax + sigmoided spatial/contacting), ranked
by score * subj_score * obj_score (the no-graph-constraint ordering), at
most `topk` per video.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .data import schema
from .data.entry import Entry, to_numpy as _np
from .device import resolve_device
from .train.step import eval_step, place_entries

NEEDED = ("attention_distribution", "spatial_distribution", "contacting_distribution")


def scene_graph_json(video_id: str, entry: Entry, pred: dict, tax, topk: int) -> dict:
    """One padded Entry + its model outputs -> JSON-serializable scene graph."""
    box_mask = _np(entry.box_mask)
    rel_mask = _np(entry.rel_mask)
    boxes = _np(entry.boxes)
    labels = _np(entry.labels)
    scores = _np(entry.scores)
    box_frame = _np(entry.box_frame)
    pair = _np(entry.pair_idx)
    im_idx = _np(entry.im_idx)

    n_boxes = int(box_mask.sum())
    objects = [{
        "frame": int(box_frame[i]),
        "box": [round(float(x), 2) for x in boxes[i]],
        "label": tax.object_classes[int(labels[i])],
        "score": round(float(scores[i]), 4),
    } for i in range(n_boxes)]

    a = _np(pred["attention_distribution"]).astype(np.float64)
    a = np.exp(a - a.max(axis=-1, keepdims=True))
    att = a / a.sum(axis=-1, keepdims=True)
    sp = _np(pred["spatial_distribution"])
    con = _np(pred["contacting_distribution"])

    triplets = []
    for r in range(len(pair)):
        if not rel_mask[r]:
            continue
        s, o = int(pair[r, 0]), int(pair[r, 1])
        pair_score = float(scores[s]) * float(scores[o])
        j = int(att[r].argmax())
        triplets.append((float(att[r, j]) * pair_score, r, s, o,
                         tax.attention_relationships[j], float(att[r, j])))
        for j, name in enumerate(tax.spatial_relationships):
            triplets.append((float(sp[r, j]) * pair_score, r, s, o, name, float(sp[r, j])))
        for j, name in enumerate(tax.contacting_relationships):
            triplets.append((float(con[r, j]) * pair_score, r, s, o, name, float(con[r, j])))
    triplets.sort(key=lambda t: -t[0])
    out_trip = [{
        "frame": int(im_idx[r]), "subject": s, "object": o,
        "predicate": name, "score": round(rel_score, 4),
        "ranking_score": round(rank, 6),
    } for rank, r, s, o, name, rel_score in triplets[:topk]]

    return {"video": video_id, "num_frames": int(entry.num_frames),
            "objects": objects, "triplets": out_trip}


def place_batch(entries: Sequence[Entry], device: torch.device, dtype=None) -> Entry:
    """Stack same-bucket Entries and move them to `device` for a model of
    compute dtype `dtype` (None: float32; bfloat16): `place_entries` with
    `union_feat` and `spatial_masks` cast to bfloat16 on the device. Only
    compute-dtype layers read them, so the cast is the model's own and later
    reads move half the bytes. `features` stays float32 (the object
    classifier reads it in float32)."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype}: expected None, float32 or bfloat16")
    return place_entries(list(entries), rel_bf16=dtype == torch.bfloat16, device=device)


def predict(model: torch.nn.Module, entries: Sequence[Entry], batch: int,
            device=None, video_ids: Sequence[str] | None = None,
            topk: int = 100, tax=None) -> list[dict]:
    """Serve `entries` (same bucket shape) in batches of `batch` videos.

    A leftover batch is padded to `batch` by repeating its first entry (the
    copies' outputs are dropped), so every call has one shape. Returns one
    scene graph per entry, in input order."""
    device = resolve_device(device)
    tax = tax or schema.load_taxonomy()
    ids = list(video_ids) if video_ids is not None else [str(i) for i in range(len(entries))]
    graphs = []
    for start in range(0, len(entries), batch):
        chunk = list(entries[start:start + batch])
        n = len(chunk)
        chunk += [chunk[0]] * (batch - n)
        pred = eval_step(model, place_batch(chunk, device, getattr(model, "dtype", None)))
        host = {k: pred[k][:n].float().cpu().numpy() for k in NEEDED}
        for i in range(n):
            graphs.append(scene_graph_json(ids[start + i], chunk[i],
                                           {k: v[i] for k, v in host.items()}, tax, topk))
    return graphs
