"""Negative pseudo-labels from motion cues (NL-VSGG/Assign_negative_classes.py);
the port's own copy of nl_vsgg_tpu/pipelines/negatives.py over the port's
taxonomy.

For frames NOT matched to any caption sentence, the person-object gIoU trend
over each unmatched interval decides negatives: a drop below the alpha=15%
threshold (-0.21572745591402054, :48) labels the interval's boundary frames
`not looking at` (attention id 1, :124-143) and its last frame
`not contacting` (:145-160). gIoU here is the 0-area-convention form over the
*first* person / first matching-object detection per frame (:51-90).

The per-frame gIoU extraction is vectorized over each video's cached
detections; label insertion mutates final_ag_data in place like the
reference (including its quirk of reusing the loop variable `f` from the
'not looking at' pass in the 'not contacting' pass — equivalent to the last
boundary frame, preserved by construction here).
"""

from __future__ import annotations

import itertools

import numpy as np

from ..data import schema

THRESHOLD = -0.21572745591402054  # alpha = 15% (:48)


def pair_giou(b1: np.ndarray, b2: np.ndarray) -> float:
    """Single-pair generalized IoU, 0-area convention (:51-90)."""
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    lt = np.maximum(b1[:2], b2[:2])
    rb = np.minimum(b1[2:], b2[2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[0] * wh[1]
    union = a1 + a2 - inter
    iou = inter / union
    lt = np.minimum(b1[:2], b2[:2])
    rb = np.maximum(b1[2:], b2[2:])
    wh = np.clip(rb - lt, 0, None)
    area = wh[0] * wh[1]
    return float(iou - (area - union) / area)


def frame_person_object_giou(det_classes: np.ndarray, det_rects: np.ndarray,
                             object_name: str, taxonomy=None,
                             assets_dir: str | None = None) -> float | None:
    """gIoU between the frame's person det and the named object's det.

    Mirrors extract_gIou (:51-90): OI classes map through the FIRST AG id of
    oi_to_ag; the *last* matching detection of each role wins (the reference
    overwrites person_bbox/object_bbox in its scan loop); substring matching
    (`in`) is used for both roles, as in the original.
    """
    tax = taxonomy or schema.load_taxonomy(assets_dir)
    oi_to_ag, _ = schema.load_oi_ag_maps(assets_dir)
    obj_names = list(tax.object_classes_pipeline)
    person_bbox = object_bbox = None
    for cls, rect in zip(det_classes, det_rects):
        ag = oi_to_ag.get(int(cls), [])
        if not ag:
            continue
        name = obj_names[ag[0]]
        if name in "person":
            person_bbox = rect
        if name in object_name:
            object_bbox = rect
    if person_bbox is None or object_bbox is None:
        return None
    return pair_giou(np.asarray(person_bbox, np.float64),
                     np.asarray(object_bbox, np.float64))


def unmatched_intervals(num_frames: int, mapped_frame: list[list[int]]) -> list[np.ndarray]:
    """Frames matched to no sentence, split into consecutive runs (:107-108)."""
    mapped = np.unique(list(itertools.chain(*mapped_frame))) \
        if mapped_frame else np.asarray([], np.int64)
    un = np.setdiff1d(np.arange(num_frames), mapped)
    return np.split(un, np.where(np.diff(un) != 1)[0] + 1)


def _insert_label(frames: list, f: int, obj_index: int, rel_type: str,
                  rel_idx: int) -> None:
    for d in frames[f]:
        if d.get("class") == obj_index:
            d[rel_type] = np.unique(np.concatenate(
                [np.asarray(d[rel_type], np.int64), [rel_idx]]))
            return
    if len(frames[f]) == 0:
        frames[f].append({"person_bbox": np.zeros(4)})
    entry = {"class": obj_index, "bbox": np.zeros(4),
             "attention_relationship": np.asarray([], np.int64),
             "spatial_relationship": np.asarray([], np.int64),
             "contacting_relationship": np.asarray([], np.int64)}
    entry[rel_type] = np.asarray([rel_idx], np.int64)
    frames[f].append(entry)


def assign_negative_classes_video(final_frames: list, triplets_per_frame,
                                  mapped_frame: list[list[int]],
                                  giou_fn, taxonomy=None,
                                  threshold: float = THRESHOLD) -> None:
    """Mutates `final_frames` adding negative labels (:105-160).

    giou_fn(frame_index, object_name) -> float | None supplies per-frame
    person-object gIoU (from cached dets via frame_person_object_giou, or a
    test stub).
    """
    tax = taxonomy or schema.load_taxonomy()
    obj_names = list(tax.object_classes_pipeline)
    contacting_idx = list(tax.contacting_relationships_gt).index("not contacting")
    intervals = unmatched_intervals(len(final_frames), mapped_frame)
    obj_set = set(t[2] for t in itertools.chain(*triplets_per_frame))
    for obj in obj_set:
        obj_index = obj_names.index("cup" if obj == "glass" else obj)
        for i_f in intervals:
            if len(i_f) == 0:
                continue
            start = end = None
            for f in i_f:
                g = giou_fn(int(f), obj)
                if g is not None:
                    end = g
                    if start is None:
                        start = g
            if start is None or end - start == 0:
                continue
            if end - start > threshold:
                continue
            boundary = np.unique(i_f[[0, -1]])
            for f in boundary:
                _insert_label(final_frames, int(f), obj_index,
                              "attention_relationship", 1)  # 'not looking at'
            # 'not contacting' on the last boundary frame (:145-160)
            _insert_label(final_frames, int(boundary[-1]), obj_index,
                          "contacting_relationship", contacting_idx)
