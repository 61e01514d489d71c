"""Object sequencing and tracking for DSG-DETR (port of
nl_vsgg_tpu/models/track.py; reference lib/track.py). Host numpy and scipy:
the tracker is sequential and runs once a video on the host, feeding
per-box group ids to the model on the card.

`get_sequence_groups` is the fast sequencing of predcls and sgdet (:127-152):
a group id a box, boxes sharing an id form one tracklet; a singleton group
attends to itself with rank 0, as the reference's length-1 sequences do.
`track_video` is the full Hungarian tracker of sgcls (:154-262): per-class
NMS clustering (`clean_bbox`, with the reference's `range(int(boxes[-1,
0]))` quirk that skips the last frame), tracks that expire after 50 frames
without a match, and the cosine / L1 / gIoU matcher (models/matcher.py) with
a cost threshold of 0.5. `clusters_to_groups` turns its clusters into group
ids, and `sgcls_group_ids` does the whole for one Entry.
"""

from __future__ import annotations

import numpy as np

from .matcher import HungarianMatcher


def get_sequence_groups(labels: np.ndarray, distribution: np.ndarray | None,
                        mode: str) -> np.ndarray:
    """Fast sequencing (lib/track.py:128-152): per-box tracklet group ids.

    predcls: group by GT label; sgdet: group by argmax predicted class.
    """
    if mode == "predcls":
        return np.asarray(labels, np.int32)
    if mode == "sgdet":
        assert distribution is not None
        return np.asarray(np.argmax(distribution, axis=-1), np.int32)
    raise ValueError(f"use track_video for mode={mode}")


def _xyxy_to_xywh(b):
    out = np.array(b, np.float64, copy=True)
    out[..., 2] -= out[..., 0]
    out[..., 3] -= out[..., 1]
    return out


def _giou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # DETR-style 0-area convention, matching the reference's
    # models/box_ops.py::generalized_box_iou used by clean_bbox's alignment
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0])).clip(min=0)
    ih = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1])).clip(min=0)
    inter = iw * ih
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / np.maximum(union, 1e-9)
    ew = np.maximum(a[:, None, 2], b[None, :, 2]) - np.minimum(a[:, None, 0], b[None, :, 0])
    eh = np.maximum(a[:, None, 3], b[None, :, 3]) - np.minimum(a[:, None, 1], b[None, :, 1])
    enclose = ew * eh
    return iou - (enclose - union) / np.maximum(enclose, 1e-9)


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Classic greedy NMS with the LEGACY +1-pixel convention: the tracker's
    reference NMS is fasterRCNN's `_C.nms` (lib/track.py:2,95 -> csrc
    nms.cu:16-19, `right - left + 1`), not torchvision's 0-area form —
    near-threshold overlaps keep/suppress differently between the two."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        iw = (np.minimum(boxes[i, 2], boxes[:, 2])
              - np.maximum(boxes[i, 0], boxes[:, 0]) + 1).clip(min=0)
        ih = (np.minimum(boxes[i, 3], boxes[:, 3])
              - np.maximum(boxes[i, 1], boxes[:, 1]) + 1).clip(min=0)
        iou = iw * ih / np.maximum(areas[i] + areas - iw * ih, 1e-9)
        suppressed |= iou > thresh
    return np.asarray(keep, np.int64)


class _Tracker:
    """lib/track.py:43-62."""

    def __init__(self, box, index, cluster):
        self.box = box
        self.index = index
        self.cluster = cluster
        self.updated = False

    def update(self, box, index):
        if self.updated:
            return True
        self.updated = True
        if box is None:
            return index - self.index < 50
        self.box = box
        self.index = index
        return True


def clean_bbox(box_frame, boxes, features, distribution, labels):
    """Per-class NMS clustering (lib/track.py:64-124). Returns kept arrays and
    keep->original mapping {kept_row: [original rows...]}."""
    final_boxes, final_feats, final_dists, final_labels = [], [], [], []
    final_frames = []
    mapping: dict[int, list[int]] = {}
    counts = 0
    last_frame = int(box_frame[-1])  # range(int(boxes[-1,0])): last frame skipped
    for i in range(last_frame):
        sel = np.where(box_frame == i)[0]
        if len(sel) == 0:
            continue
        scores = distribution[sel]
        pred_boxes = boxes[sel]
        argmaxes = scores.argmax(1)
        for j in np.unique(argmaxes):
            inds = np.where(argmaxes == j)[0]
            cls_scores = scores[inds][:, j]
            order = np.argsort(-cls_scores)
            cls_boxes = pred_boxes[inds]
            keep = _nms(cls_boxes[order], cls_scores[order], 0.4)
            not_keep = np.asarray([k for k in range(len(inds)) if k not in keep],
                                  np.int64)
            if len(not_keep) > 0:
                align = np.argmax(_giou(cls_boxes[keep], cls_boxes[not_keep]), 0)
            else:
                align = []
            final_dists.append(scores[inds][order][keep])
            final_boxes.append(cls_boxes[order][keep])
            final_feats.append(features[sel][inds][order][keep])
            final_labels.append(labels[sel][inds][order][keep])
            final_frames.append(np.full(len(keep), i, np.int32))
            for k, ind in enumerate(keep):
                mapping[counts + k] = [int(sel[inds[order[ind]]])]
            for ind, al in zip(not_keep, align):
                mapping[counts + int(al)].append(int(sel[inds[order[ind]]]))
            counts += len(keep)
    if not final_boxes:  # e.g. every box sits in the (skipped) last frame:
        # rank-correct empties keep downstream argmax(1)/indexing working
        return (np.zeros(0, np.int32), np.zeros((0, 4), boxes.dtype),
                np.zeros((0, features.shape[-1]), features.dtype),
                np.zeros((0, distribution.shape[-1]), distribution.dtype),
                np.zeros(0, labels.dtype), mapping)
    cat = lambda xs: np.concatenate(xs, 0)
    return (cat(final_frames), cat(final_boxes), cat(final_feats),
            cat(final_dists), cat(final_labels), mapping)


def track_video(mode: str, box_frame, boxes, features, distribution, labels,
                frame_keys: list[int], im_size: tuple[float, float],
                matcher: HungarianMatcher | None = None) -> list[list[int]]:
    """Full tracker (lib/track.py:154-262). Returns clusters of original box
    rows (sgdet) or kept rows (sgcls), in reference order — convert to group
    ids with `clusters_to_groups`."""
    matcher = matcher or HungarianMatcher(0.5, 1, 1, 0.5)
    w, h = im_size
    if mode == "sgdet":
        frames_k, boxes_k, feats_k, dists_k, labels_k, mapping = clean_bbox(
            box_frame, boxes, features, distribution, labels)
        pred = dists_k.argmax(1)
        dists_k = np.eye(distribution.shape[1], dtype=np.float32)[pred]
    elif mode == "sgcls":
        frames_k, boxes_k, feats_k, labels_k = box_frame, boxes, features, labels
        pred = distribution.argmax(1)
        dists_k = np.eye(distribution.shape[1], dtype=np.float32)[pred]
        mapping = {i: [i] for i in range(len(boxes))}
    else:
        raise ValueError(mode)

    cluster: list[list[int]] = []
    cluster_feature: list = []
    cluster_dist: list = []
    tracks: list[_Tracker] = []
    Z = np.array([[w, h, w, h]])
    uniq, cnt = np.unique(frames_k, return_counts=True)
    counts_by_frame = {int(u): int(c) for u, c in zip(uniq, cnt)}
    counts = np.cumsum([0] + [counts_by_frame.get(int(u), 0) for u in uniq])
    frame_rank = {int(u): r for r, u in enumerate(uniq)}

    def oob(p):  # sgcls out-of-figure guard (:201-203)
        return (p[0] + p[2] > h) or (p[1] + p[3] > w) or (p[0] < 0) or (p[1] < 0)

    for index, current_key in enumerate(frame_keys):
        if index not in frame_rank:
            # frame contributed no kept boxes; still age the tracks.
            # ORDER MATTERS: `t.update(None, ...) or t.updated` is a
            # tautology (update sets t.updated=True before answering), which
            # made the 50-frame timeout dead on empty frames
            for t in tracks:
                t.updated = False
            tracks = [t for t in tracks if t.updated or t.update(None, current_key)]
            continue
        r0 = counts[frame_rank[index]]
        sel = np.where(frames_k == index)[0]
        pred_xywh = _xyxy_to_xywh(boxes_k[sel])
        for t in tracks:
            t.updated = False
        row_ind = []
        if tracks:
            tb = np.stack([t.box for t in tracks])
            cf = [np.mean(cluster_feature[t.cluster], axis=0) for t in tracks]
            cd = [np.mean(cluster_dist[t.cluster], axis=0) for t in tracks]
            row_ind, col_ind, c1, c2 = matcher(
                {"boxes": pred_xywh / Z, "features": feats_k[sel], "dists": dists_k[sel]},
                {"boxes": tb / Z, "features": np.stack(cf), "dists": np.stack(cd)})
            for t, (r, c) in enumerate(zip(row_ind, col_ind)):
                if (c1[t] < 0.5) or (c2[t] < 0.5):
                    cluster[tracks[c].cluster].append(int(r0 + r))
                    if mode == "sgcls" and oob(pred_xywh[r]):
                        continue
                    cluster_feature[tracks[c].cluster] = np.concatenate(
                        [cluster_feature[tracks[c].cluster], feats_k[sel][r:r + 1]])
                    cluster_dist[tracks[c].cluster] = np.concatenate(
                        [cluster_dist[tracks[c].cluster], dists_k[sel][r:r + 1]])
                    tracks[c].update(pred_xywh[r], current_key)
                else:
                    cluster.append([int(r0 + r)])
                    if mode == "sgcls" and oob(pred_xywh[r]):
                        cluster_feature.append([])
                        cluster_dist.append([])
                        continue
                    cluster_feature.append(feats_k[sel][r:r + 1])
                    cluster_dist.append(dists_k[sel][r:r + 1])
                    tracks.append(_Tracker(pred_xywh[r], current_key, len(cluster) - 1))
        if len(row_ind) < len(sel):
            for j in range(len(sel)):
                if j not in list(row_ind):
                    cluster.append([int(r0 + j)])
                    if mode == "sgcls" and oob(pred_xywh[j]):
                        cluster_feature.append([])
                        cluster_dist.append([])
                        continue
                    cluster_feature.append(feats_k[sel][j:j + 1])
                    cluster_dist.append(dists_k[sel][j:j + 1])
                    tracks.append(_Tracker(pred_xywh[j], current_key, len(cluster) - 1))
        tracks = [t for t in tracks if t.updated or t.update(None, current_key)]

    if mode == "sgcls":
        return [c for c in cluster if len(c) > 0]
    # sgdet: expand kept rows back through the NMS mapping (:252-262)
    expanded = []
    for c in cluster:
        rows = []
        for i in c:
            rows.extend(mapping[i])
        expanded.append(rows)
    return expanded


def clusters_to_groups(clusters: list[list[int]], n_boxes: int) -> np.ndarray:
    """Cluster lists -> per-box group ids (unclustered boxes get unique ids)."""
    g = np.full(n_boxes, -1, np.int32)
    for gid, rows in enumerate(clusters):
        for r in rows:
            g[r] = gid
    nxt = len(clusters)
    for i in range(n_boxes):
        if g[i] < 0:
            g[i] = nxt
            nxt += 1
    return g


def sgcls_group_ids(entry, im_size: tuple[float, float]) -> np.ndarray:
    """Per-box tracklet ids (n_boxes,) int32 for one unbatched Entry from
    the sgcls tracker over its valid boxes (JAX tools/test_DSG_DETR.py
    `sgcls_group_ids`, with the image size given in place of the dataset).

    `im_size` is what the reference passes: the frame's (height, width)
    over its scale, img_info[:2] / scale (or the video size reversed,
    (height, width)); `track_video` unpacks it as (w, h), and that order
    quirk is kept. Padded rows get unique ids past every real tracklet, so
    the tracklet attention can never join them to a real box."""
    def host(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    nb = int(host(entry.box_mask).sum())
    clusters = track_video(
        "sgcls", host(entry.box_frame)[:nb], host(entry.boxes)[:nb],
        host(entry.features)[:nb], host(entry.distribution)[:nb], host(entry.labels)[:nb],
        frame_keys=list(range(int(entry.num_frames))),
        im_size=(float(im_size[0]), float(im_size[1])))
    gid = np.full(entry.n_boxes, -1, np.int32)
    gid[:nb] = clusters_to_groups(clusters, nb)
    pad_rows = np.where(gid < 0)[0]
    gid[pad_rows] = gid[:nb].max(initial=-1) + 1 + np.arange(len(pad_rows))
    return gid
