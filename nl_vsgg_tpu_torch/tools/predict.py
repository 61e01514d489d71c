"""Export scene graphs for unannotated videos (port of tools/predict.py):

    python -m nl_vsgg_tpu_torch.tools.predict --model_path out/ckpt \
        --features_dir data/frame_features [--cfg cfg.yml] \
        [--videos vid1.mp4 vid2.mp4] [--out scene_graphs.jsonl] [--topk 100] \
        [--dsg_detr] [--batch 16] [--workers N] [--device cpu]

The weak-supervision sgdet pipeline (cached VinVL detections -> OI->AG class
mapping -> Entry -> STTran or DSG-DETR -> relation distributions) over videos
without annotations: in test mode grounding keeps every mapped class and
pairs the person with every object, so an empty per-frame GT list gives the
full detector-driven graph. `--model_path` is a port checkpoint directory;
without `--cfg` its configs.json configures the run.

Input: features_dir/{video}/{frame}/dets.npy + feat.npy (the cache that
`tools/preprocess.py features` writes). Videos are grounded on worker
threads, grouped by bucket, and served in batches of `--batch` (a short
batch padded by repeating its first video), each placed with the bf16
model's casts (`place_entries(cast_bf16=...)`); only the three relation
heads are copied back, and batch i-1 is written while batch i runs on the
card. The JSONL lines therefore follow batch completion, not input order;
each names its video. A video whose grounding fails is skipped with a
warning. Output: one `serve.scene_graph_json` object a line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from ..data import schema
from ..data.pipeline import DoubleBuffer, GroundingPrefetcher, bucket_events
from ..device import resolve_device
from ..eval.epoch import start_fetch
from ..serve import NEEDED, scene_graph_json
from ..train.step import eval_step, place_entries
from ..utils.logging import setup_logger
from .test_sttran import config_for, load_weights
from .train_sttran import ground_video, make_union_provider


class UnlabeledVideos:
    """A stand-in for AGTest over bare feature directories: the
    `video_ids` / `video_list` / `gt_annotations` that ground_video and the
    union provider read, with empty per-frame GT. Directories with no frame
    directory are listed in `skipped`."""

    def __init__(self, features_root: str, videos: list[str] | None = None):
        vids = videos or sorted(d for d in os.listdir(features_root)
                                if os.path.isdir(os.path.join(features_root, d)))
        if not vids:
            raise SystemExit(f"no video directories under {features_root}")
        self.video_ids, self.video_list, self.skipped = [], [], []
        for vid in vids:
            vdir = os.path.join(features_root, vid)
            frames = sorted(d for d in os.listdir(vdir) if os.path.isdir(os.path.join(vdir, d)))
            if not frames:
                self.skipped.append(vid)
                continue
            self.video_ids.append(vid)
            self.video_list.append([os.path.join(vid, f) for f in frames])
        if not self.video_ids:
            raise SystemExit(f"no video with frame directories under {features_root}")
        self.gt_annotations = [[[] for _ in fl] for fl in self.video_list]

    def __len__(self):
        return len(self.video_list)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="scene-graph export (sgdet)")
    p.add_argument("--cfg", dest="cfg_file", default=None,
                   help="config yaml or json (default: <model_path>/configs.json)")
    p.add_argument("--model_path", required=True, help="port checkpoint directory")
    p.add_argument("--features_dir", required=True,
                   help="root of cached VinVL features ({video}/{frame}/dets.npy)")
    p.add_argument("--videos", nargs="*", default=None,
                   help="video ids (default: every subdirectory)")
    p.add_argument("--out", default="-", help="output JSONL path ('-' = stdout)")
    p.add_argument("--topk", type=int, default=100, help="triplets kept per video")
    p.add_argument("--dsg_detr", action="store_true",
                   help="serve a DSG-DETR checkpoint instead of STTran")
    p.add_argument("--batch", type=int, default=16, help="videos per model call")
    p.add_argument("--workers", type=int, default=0,
                   help="grounding worker threads (0 = cfg.num_workers)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Returns the number of scene graphs written."""
    args = parse_args(argv)
    cfg = dataclasses.replace(config_for(args), mode="sgdet",
                              frame_features_path=args.features_dir)
    device = resolve_device(args.device)
    logger = setup_logger()
    tax = schema.load_taxonomy()
    ds = UnlabeledVideos(args.features_dir, args.videos)
    for vid in ds.skipped:
        logger.warning(f"{vid}: no frame directories (skipped)")
    logger.info(f"videos to export: {len(ds)}")

    if args.dsg_detr:
        from .train_dsg_detr import build_model
    else:
        from .train_sttran import build_model
    model = load_weights(build_model(cfg, tax, device), args.model_path)
    union_provider = make_union_provider(cfg, logger, device=device)

    def get_entry(i):
        """Per-video fault isolation: a corrupt feature directory skips that
        video with a warning instead of ending the job."""
        try:
            return ground_video(ds, i, cfg, False, cfg.buckets, union_provider=union_provider)
        except Exception as e:
            logger.warning(f"{ds.video_ids[i]}: grounding failed ({e!r}), skipped")
            return None

    # the leading videos grounded while looking for one with relations are
    # kept, not grounded twice
    grounded: dict[int, object] = {}
    for i in range(len(ds)):
        grounded[i] = get_entry(i)
        if grounded[i] is not None:
            break
    else:
        raise SystemExit("no video produced any relations")

    zero_union = union_provider is None
    cast16 = cfg.dtype == "bfloat16"
    sink = sys.stdout if args.out == "-" else open(args.out, "w")
    n_exported = 0

    def dispatch(items):
        entries = [e for _, e in items]
        entries += [entries[0]] * (args.batch - len(entries))
        pred = eval_step(model, place_entries(entries, zero_union=zero_union,
                                              cast_bf16=cast16, device=device))
        return items, start_fetch(pred, device, NEEDED)

    def drain(items, fetch):
        nonlocal n_exported
        pred = fetch()
        for bi, (i, e) in enumerate(items):
            sg = scene_graph_json(ds.video_ids[i], e, {k: v[bi] for k, v in pred.items()},
                                  tax, args.topk)
            sink.write(json.dumps(sg) + "\n")
            n_exported += 1

    prefetcher = GroundingPrefetcher(lambda i: grounded.pop(i) if i in grounded else get_entry(i),
                                     list(range(len(ds))),
                                     num_workers=args.workers or cfg.num_workers)
    try:
        buf = DoubleBuffer()
        for kind, payload in bucket_events(iter(prefetcher), args.batch):
            if kind == "skip":
                logger.warning(f"{ds.video_ids[payload]}: no relations (skipped)")
                continue
            prev = buf.push(dispatch(payload))
            if prev is not None:
                drain(*prev)
        prev = buf.flush()
        if prev is not None:
            drain(*prev)
    finally:
        if sink is not sys.stdout:
            sink.close()
    logger.info(f"exported {n_exported}/{len(ds)} scene graphs")
    return n_exported


if __name__ == "__main__":
    main()
