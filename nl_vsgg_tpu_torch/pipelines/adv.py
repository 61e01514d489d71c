"""ADV — Action-Duration-Variability-aware caption-frame alignment; the
port's own copy of nl_vsgg_tpu/pipelines/adv.py.

Rebuilds NL-VSGG/ADV.py as batched array math over *embeddings*:

  * `align_video` — the core alignment (:104-190): KMeans over frame
    embeddings with k = max(2, floor(T / beta)), cluster-vs-sentence scores
    softmax(100 * C @ T^T) over clusters, per-sentence cluster selection via
    the largest score-gap heuristic, <= 2 clusters per sentence, chronological
    monotonicity (a sentence may not map before its predecessor's first
    frame), and the longest-consecutive-run reduction.
  * short videos (<= 5 frames) use per-frame scores instead of clusters
    (:161-190) — same selection math with singleton "clusters".
  * `filter_triplets` / `broadcast_triplets` / `build_final_video` — triplet
    filtering (subject must be 'person', predicate not 'unsure', :201-207),
    broadcast to matched frames + dedup (:219-230), and conversion to
    per-frame annotation dicts (`add_info_vanilla`, :258-283) producing the
    final_ag_data.pkl schema.

Embeddings come from any CLIP-style encoder: the reference uses DAC
(CLIP ViT-B/32 + LoRA-4, :30-52; the port's is pipelines/clip.py). This
module takes (sentences x D) and (frames x D) unit-normalized numpy arrays;
the alignment is host numpy on tens of frames.

KMeans: the JAX package calls sklearn's `KMeans(n_clusters=k,
random_state=seed, n_init="auto")`. The port needs no sklearn: `kmeans` is
that estimator's algorithm in numpy (k-means++ seeding with the same
`RandomState` draws, one Lloyd run, sklearn's tolerance, empty-cluster
relocation and final E-step), so labels and centers are sklearn's.

Reference quirks preserved: `c_s[:2]` truncation happens *before* the
`len > 2` uniqueness repair, making that branch dead (:141-147); a matched
run's last frame expands to the video end when it is the final frame
(:156-158).
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

BETA = 4


def find_consecutive_numbers(lst) -> list[int]:
    """Longest run of consecutive ints (NL-VSGG/ADV.py:71-88)."""
    groups, cur = [], []
    for num in sorted(lst):
        if not cur or num == cur[-1] + 1:
            cur.append(int(num))
        else:
            groups.append(cur)
            cur = [int(num)]
    groups.append(cur)
    return max(groups, key=len, default=[])


def _select_clusters(cluster_scores: np.ndarray) -> list[list[int]]:
    """Largest-gap heuristic (:127-137): for each sentence (column), keep
    clusters whose score is >= the value just above the largest gap."""
    sort_scores = np.sort(cluster_scores, axis=0)
    diff = np.diff(sort_scores, axis=0)
    sort_idx = diff.argmax(axis=0) + 1
    thresh = sort_scores[sort_idx, np.arange(sort_scores.shape[1])]
    cand_cluster, cand_sentence = (thresh[None, :] <= cluster_scores).nonzero()
    picked: list[list[int]] = [[] for _ in range(cluster_scores.shape[1])]
    for c, s in zip(cand_cluster, cand_sentence):
        picked[s].append(int(c))
    return picked


def _softmax0(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=0, keepdims=True))
    return e / e.sum(axis=0, keepdims=True)


# ---------- KMeans (sklearn.cluster.KMeans's algorithm, numpy) ----------

def _sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances (len(a), len(b)) as sklearn's k-means++ takes them:
    ||a||^2 - 2 a.b + ||b||^2 in float64, clipped at 0, in a's dtype."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    return np.maximum(d.astype(a.dtype, copy=False), 0)


def _kmeans_plusplus(x: np.ndarray, k: int, w: np.ndarray,
                     rs: np.random.RandomState) -> np.ndarray:
    """k-means++ seeding: the first center drawn by weight, each next one
    the best of 2 + log(k) candidates drawn by squared distance."""
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    first = rs.choice(n, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_dists(centers[0, None], x)
    pot = closest @ w
    for c in range(1, k):
        r = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(w * closest), r)
        np.clip(ids, None, closest.size - 1, out=ids)
        d = np.minimum(closest, _sq_dists(x[ids], x))
        pots = d @ w.reshape(-1, 1)
        best = np.argmin(pots)
        pot, closest = pots[best], d[best]
        centers[c] = x[ids[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """E step: each row's nearest center (the first on a tie), int32."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2 * (x @ centers.T)
    return d.argmin(axis=1).astype(np.int32)


def _lloyd_step(x, w, centers):
    """One Lloyd iteration from `centers`: (labels, new centers, shift)."""
    k = len(centers)
    labels = _assign(x, centers)
    new = np.zeros_like(centers)
    weight = np.zeros(k, x.dtype)
    np.add.at(weight, labels, w)                 # in sample order, as sklearn sums
    np.add.at(new, labels, x * w[:, None])
    empty = np.flatnonzero(weight == 0)
    if len(empty):                               # relocate to the farthest points
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if dist.max() != 0:
            for new_id, f in zip(empty, far):
                old_id = labels[f]
                new[old_id] -= x[f] * w[f]
                new[new_id] = x[f] * w[f]
                weight[new_id] = w[f]
                weight[old_id] -= w[f]
    biggest = int(np.argmax(weight))
    for j in range(k):                           # in place, in order, as sklearn
        if weight[j] > 0:
            new[j] *= x.dtype.type(1.0 / float(weight[j]))
        else:
            new[j] = new[biggest]
    shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
    return labels, new, shift


def kmeans(x: np.ndarray, k: int, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> tuple[np.ndarray, np.ndarray]:
    """(labels (n,) int32, centers (k, d)) of sklearn.cluster.KMeans(
    n_clusters=k, random_state=seed, n_init="auto").fit(x): the data
    centred, k-means++ seeding from RandomState(seed), one Lloyd run to
    `max_iter` iterations that stops when no label changes or the centers
    move by at most tol times the data's mean variance, and a last E step
    when it stopped on the tolerance. float32 data stays float32, other
    data is float64."""
    x = np.array(x, dtype=np.float32 if np.asarray(x).dtype == np.float32 else np.float64,
                 order="C", copy=True)
    if len(x) < k:
        raise ValueError(f"n_samples={len(x)} should be >= n_clusters={k}")
    tol = float(np.mean(np.var(x, axis=0))) * tol
    rs = np.random.RandomState(seed)
    w = np.ones(len(x), x.dtype)
    mean = x.mean(axis=0)
    x -= mean
    centers = _kmeans_plusplus(x, k, w, rs)
    labels_old = np.full(len(x), -1, np.int32)
    strict = False
    for _ in range(max_iter):
        labels, centers_new, shift = _lloyd_step(x, w, centers)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    return labels, centers + mean


def align_sentences_to_frames(text_features: np.ndarray,
                              visual_features: np.ndarray,
                              beta: int = BETA, seed: int = 0) -> list[list[int]]:
    """(S, D) x (T, D) unit-norm embeddings -> per-sentence frame index lists.

    One caption group at a time (the reference loops caption groups per video
    with a shared monotonicity state across ALL groups of the video — use
    `align_video` for that)."""
    return _align(text_features, visual_features, beta, seed, start_cond=0)[0]


def _align(text_features, visual_features, beta, seed, start_cond):
    T = len(visual_features)
    if T > 5:
        k = max(2, int(T / beta))
        labels, centers = kmeans(np.asarray(visual_features), k, seed)
        scores = _softmax0(100.0 * centers @ np.asarray(text_features).T)
        picked = _select_clusters(scores)
        out: list[list[int]] = []
        cond = start_cond
        for c_s in picked:
            c_s = np.array(c_s)[:2]
            matched = (labels[None, :] == c_s[:, None]).any(0).nonzero()[0] \
                if len(c_s) else np.array([], np.int64)
            matched = matched[matched >= cond]
            run = find_consecutive_numbers(matched)
            if len(run) == 0:
                out.append([])
                continue
            cond = run[0]
            frames: list[int] = []
            for m in run:
                if T > m + 1:
                    frames.extend(range(m, m + 1))
                else:
                    frames.extend(range(m, T))
            out.append(frames)
        return out, cond
    # short video: per-frame scores, candidates are frame indices (:161-190)
    scores = _softmax0(100.0 * np.asarray(visual_features) @ np.asarray(text_features).T)
    picked = _select_clusters(scores)
    out = []
    cond = start_cond
    for c_s in picked:
        matched = np.array(c_s)[:2]
        matched = matched[matched >= cond]
        run = find_consecutive_numbers(matched)
        if len(run) == 0:
            out.append([])
            continue
        cond = run[0]
        frames = []
        for m in run:
            if T > m + 1:
                frames.extend(range(m, m + 1))
            else:
                frames.extend(range(m, T))
        out.append(frames)
    return out, cond


def align_video(caption_groups_text: Sequence[np.ndarray],
                visual_features: np.ndarray, beta: int = BETA,
                seed: int = 0) -> list[list[int]]:
    """Align every caption group of a video; mapped_frame entry per sentence
    (flattened over groups, like ADV.py's `ith` counter). The monotonicity
    state resets per caption group in the reference (`unrealistic_condition =
    0` inside the group loop, :139/:175) — reproduced here."""
    mapped: list[list[int]] = []
    for text_features in caption_groups_text:
        if len(text_features) == 0:
            continue
        out, _ = _align(text_features, visual_features, beta, seed, start_cond=0)
        mapped.extend(out)
    return mapped


# ---------- triplet bookkeeping (ADV.py:192-306) ----------

def filter_triplets(triplet_groups) -> list[list[tuple]]:
    """Keep person-subject, non-'unsure'-predicate triplets (:199-207)."""
    flat = list(itertools.chain.from_iterable(triplet_groups))
    out = []
    for tris in flat:
        out.append([tuple(t) for t in tris
                    if t[0] == "person" and t[1] != "unsure"])
    return out


def broadcast_triplets(triplets_per_sentence: list[list[tuple]],
                       mapped_frame: list[list[int]],
                       num_frames: int) -> list[list[tuple]] | None:
    """Sentence triplets -> per-frame deduped triplet lists (:219-230).

    Returns None for an error-case video: a sentence/mapping length mismatch
    (zip would silently misalign every subsequent sentence's triplets) or an
    out-of-range mapped frame id. The reference collects both into
    `error_case` intending to delete those videos (:216,:224); its deletion
    loop is itself buggy (`del ...[k]` iterates error_case but deletes a
    leaked loop variable, :231-232 — KeyError with two error cases) so we
    implement the intent, not the crash."""
    if len(triplets_per_sentence) != len(mapped_frame):
        return None
    per_frame: list[list[tuple]] = [[] for _ in range(num_frames)]
    for triplets, frames in zip(triplets_per_sentence, mapped_frame):
        for tri in triplets:
            for f in frames:
                if f >= num_frames:
                    return None
                per_frame[f].append((tri[0], tri[1], tri[2]))
    return [list(set(t)) for t in per_frame]


def add_info_vanilla(rel_class: str, nth_frame: int, obj_index: int,
                     frames: list, taxonomy) -> None:
    """Insert one (predicate, object) into a frame's annotation list
    (ADV.py:258-283); groups multi-hot relationship ids per object."""
    att = list(taxonomy.attention_relationships_gt)
    sp = list(taxonomy.spatial_relationships_gt)
    con = list(taxonomy.contacting_relationships_gt)
    if rel_class in att:
        rel_type, rel_idx = "attention_relationship", att.index(rel_class)
    elif rel_class in sp:
        rel_type, rel_idx = "spatial_relationship", sp.index(rel_class)
    else:
        rel_type, rel_idx = "contacting_relationship", con.index(rel_class)

    frame = frames[nth_frame]
    if len(frame) == 0:
        frame.append({"person_bbox": np.zeros(4)})
    for d in frame:
        if d.get("class") == obj_index:
            d[rel_type] = np.unique(np.concatenate(
                [np.asarray(d[rel_type], np.int64), [rel_idx]]))
            return
    entry = {"class": obj_index, "bbox": np.zeros(4),
             "attention_relationship": np.asarray([], np.int64),
             "spatial_relationship": np.asarray([], np.int64),
             "contacting_relationship": np.asarray([], np.int64)}
    entry[rel_type] = np.asarray([rel_idx], np.int64)
    frame.append(entry)


def build_final_video(per_frame_triplets: list[list[tuple]], taxonomy) -> list | None:
    """Per-frame triplets -> final_ag_data annotation lists (:288-301).
    Returns None when the video has no triplets (removed, :298-300)."""
    obj_classes = list(taxonomy.object_classes_pipeline)
    frames: list = [[] for _ in range(len(per_frame_triplets))]
    count = 0
    for nth, triplets in enumerate(per_frame_triplets):
        for tri in triplets:
            obj = "cup" if tri[2] == "glass" else tri[2]  # :293-295
            count += 1
            add_info_vanilla(tri[1], nth, obj_classes.index(obj), frames, taxonomy)
    return frames if count else None
