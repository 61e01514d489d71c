"""Recommend padding buckets (cfg.buckets) from a dataset scan (port of
tools/tune_buckets.py).

Every video pads to the smallest bucket that fits it (data/entry.py
pick_bucket); the last bucket truncates oversized videos (label loss,
counted by the train loop) and oversized buckets waste padded compute.
The reference has no equivalent (its batch is one ragged video); for a
batched build the bucket ladder is a first-order cost knob.

The scan reads per-video box counts cheaply: `feat.npy` holds (N, 2048)
RoI features, so N comes from the .npy header without reading data. It
joins the frame lists the dataset layer uses (triplets_LLM4SGG.pkl) and
solves the K-bucket 1-D partition that minimizes the total padded cost by
dynamic programming. Cost per video = b + b^2/alpha, the step's shape:
projections and FFN are linear in the padded relation count b, attention
quadratic (alpha ~ model width / attention share; default 256).

Prints a YAML `buckets:` block (the port's load_config reads it) plus
per-bucket occupancy, padded-waste % and truncation counts against the
current config.

Usage:
  python -m nl_vsgg_tpu_torch.tools.tune_buckets --cfg configs/nl_vsgg_config.yml
  python -m nl_vsgg_tpu_torch.tools.tune_buckets --features_dir d --frame_lists t.pkl -k 4
  python -m nl_vsgg_tpu_torch.tools.tune_buckets --synthetic 9800
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def npy_rows(path: str) -> int:
    """Row count from a .npy header (no data read)."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        reader = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                  else np.lib.format.read_array_header_2_0)
        shape, _, _ = reader(f)
    return int(shape[0])


def scan_video_counts(features_dir: str, frame_lists: dict) -> dict[str, tuple[int, int]]:
    """{video: (n_boxes_hint, n_frames)} — the same hint ground_video uses
    (total detections across the video's frames)."""
    out = {}
    for vid, meta in frame_lists.items():
        frames = meta["frame_list"] if isinstance(meta, dict) else meta
        total, got = 0, 0
        for fr in frames:
            p = os.path.join(features_dir, vid, fr, "feat.npy")
            if os.path.isfile(p):
                total += npy_rows(p)
                got += 1
        if got:
            out[vid] = (total, got)
    return out


def optimal_buckets(counts: np.ndarray, k: int, alpha: float = 256.0,
                    align: int = 8) -> list[int]:
    """K bucket edges minimizing sum over videos of cost(bucket(video)),
    cost(b) = b + b*b/alpha. Edges are the aligned-up data values (classic
    1-D partition DP over unique counts, O(K * U^2))."""
    counts = np.asarray(sorted(counts))
    up = lambda v: int(-(-int(v) // align) * align)
    uniq = sorted({up(v) for v in counts})
    U = len(uniq)
    # videos covered by edge u_j but not u_{j-1}: weight per segment
    n_le = np.searchsorted(counts, uniq, side="right")  # videos <= uniq[j]
    cost = lambda b: b + b * b / alpha
    INF = float("inf")
    dp = [[INF] * U for _ in range(k + 1)]
    arg = [[-1] * U for _ in range(k + 1)]
    for j in range(U):
        dp[1][j] = n_le[j] * cost(uniq[j])
    for kk in range(2, k + 1):
        for j in range(kk - 1, U):
            best, bi = INF, -1
            for i in range(kk - 2, j):
                c = dp[kk - 1][i] + (n_le[j] - n_le[i]) * cost(uniq[j])
                if c < best:
                    best, bi = c, i
            dp[kk][j], arg[kk][j] = best, bi
    # the last edge must cover the max; fewer buckets may already be optimal
    best_k = min(range(1, k + 1), key=lambda kk: dp[kk][U - 1])
    edges, j = [], U - 1
    for kk in range(best_k, 0, -1):
        edges.append(uniq[j])
        j = arg[kk][j]
    return sorted(edges)


def waste(counts: np.ndarray, buckets: list[int], alpha: float) -> tuple[float, int]:
    """(padded-cost overhead vs exact shapes, #videos truncated)."""
    cost = lambda b: b + b * b / alpha
    exact = sum(cost(c) for c in counts)
    padded, trunc = 0.0, 0
    for c in counts:
        fit = [b for b in buckets if c <= b]
        if fit:
            padded += cost(fit[0])
        else:
            padded += cost(buckets[-1])
            trunc += 1
    return padded / max(exact, 1e-9) - 1.0, trunc


def synthetic_ag_counts(n_videos: int, seed: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """AG-shaped (grounded_boxes, frames) samples for ladder evidence when
    the real dataset is absent. The rung is picked from the exact
    post-grounding counts (data/entry.py pick_joint_bucket): grounding
    keeps the person and the GT-matched objects a frame, not every raw
    detection. Assumptions, replaceable by a real scan:

      * labeled frames/video: Action Genome annotates ~234k frames over
        ~9.8k train videos (~23.8/video, long-tailed; the dataset layer
        keeps videos with >2 person frames,
        dataloader/wk_action_genome.py:268-302 of the reference) —
        modeled lognormal(median 20, sigma 0.55) clipped [3, 100];
      * grounded boxes/frame: 1 person + the frame's matched GT objects
        (AG annotates a handful of objects in view) — modeled
        1 + clip(1 + Poisson(1.5), 1, 5).
    """
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.lognormal(np.log(20), 0.55, n_videos), 3, 100
                     ).astype(int)
    boxes = np.array([
        int((1 + np.clip(1 + rng.poisson(1.5, f), 1, 5)).sum())
        for f in frames])
    return boxes, frames


def occupancy(counts: np.ndarray, buckets: list[int]) -> list[tuple]:
    """Per-bucket (edge, #videos, mean fill %) under first-fit-up."""
    rows = []
    prev = 0
    for b in buckets:
        sel = counts[(counts > prev) & (counts <= b)]
        rows.append((b, len(sel), float(sel.mean() / b) if len(sel) else 0.0))
        prev = b
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", dest="cfg_file", default=None)
    p.add_argument("--features_dir", default=None,
                   help="frame_features root (default: cfg.frame_features_path)")
    p.add_argument("--frame_lists", default=None,
                   help="triplets_LLM4SGG.pkl (default: <data_path>/triplets_LLM4SGG.pkl)")
    p.add_argument("-k", "--max_buckets", type=int, default=5)
    p.add_argument("--alpha", type=float, default=256.0,
                   help="quadratic-cost scale: cost(b) = b + b^2/alpha")
    p.add_argument("--align", type=int, default=8,
                   help="round bucket edges up to this multiple")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="skip the disk scan: tune against N videos sampled "
                        "from the documented AG-shaped distribution "
                        "(synthetic_ag_counts) — ladder evidence when the "
                        "real dataset is absent")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..utils.config import load_config
    cfg = load_config(args.cfg_file)
    if args.synthetic:
        boxes, frames = synthetic_ag_counts(args.synthetic, args.seed)
        print(f"# synthetic AG-shaped sample: {args.synthetic} videos "
              f"(assumptions in synthetic_ag_counts docstring)")
    else:
        features_dir = args.features_dir or cfg.frame_features_path
        frame_lists_path = args.frame_lists or os.path.join(
            cfg.data_path, "triplets_LLM4SGG.pkl")
        with open(frame_lists_path, "rb") as f:
            frame_lists = pickle.load(f)

        stats = scan_video_counts(features_dir, frame_lists)
        if not stats:
            raise SystemExit(f"no videos found under {features_dir}")
        boxes = np.asarray([b for b, _ in stats.values()])
        frames = np.asarray([f for _, f in stats.values()])

    print(f"# {len(boxes)} videos: boxes p50/p90/p99/max = "
          f"{np.percentile(boxes, 50):.0f}/{np.percentile(boxes, 90):.0f}/"
          f"{np.percentile(boxes, 99):.0f}/{boxes.max()}; frames max {frames.max()}")

    bb = optimal_buckets(boxes, args.max_buckets, args.alpha, args.align)
    # the runtime picks the rung from exact post-grounding counts with a
    # joint rung index (data/entry.py pick_joint_bucket), so the rel ladder
    # can be tuned against the rel distribution (rels = boxes - frames: one
    # relation row per grounded person-object pair) as long as it has the
    # same rung count — pad with the box ladder's tail if the DP returns
    # fewer rungs
    rels = np.maximum(boxes - frames, 1)
    br = optimal_buckets(rels, args.max_buckets, args.alpha, args.align)
    while len(br) < len(bb):
        br.append(bb[len(br)])
    br = br[:len(bb)]
    w_new, t_new = waste(boxes, bb, args.alpha)
    w_old, t_old = waste(boxes, list(cfg.buckets.max_boxes), args.alpha)
    print(f"# padded-cost overhead (boxes): current buckets "
          f"{list(cfg.buckets.max_boxes)} = +{w_old:.1%} "
          f"({t_old} videos truncated); tuned = +{w_new:.1%} ({t_new} truncated)")
    print(f"# {len(bb)} bucket shapes (one padded step shape each)")
    for b, n, fill in occupancy(boxes, bb):
        print(f"#   bucket {b:4d}: {n:5d} videos, mean fill {fill:.0%}")
    print("# paste into your config yaml:")
    print("buckets:")
    print(f"  max_boxes: {bb}")
    print(f"  max_rels: {br}")
    edges = {int(-(-int(f) // args.align) * args.align)
             for f in (np.percentile(frames, 50), frames.max())}
    print(f"  max_frames: {sorted(edges)}")
    return bb, br


if __name__ == "__main__":
    main()
