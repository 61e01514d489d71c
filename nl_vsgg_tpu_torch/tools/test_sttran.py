"""Evaluate a trained STTran checkpoint on the Action Genome test split
(port of tools/test_STTran.py):

    python -m nl_vsgg_tpu_torch.tools.test_sttran --model_path out/ckpt \
        [--cfg cfg.yml] [--max_videos N] [--device_eval] [--device cpu]

`--model_path` is a port checkpoint directory (utils/checkpoint.py: the
newest step is read). Without `--cfg` the run's own snapshot,
<model_path>/configs.json, configures it (the defaults when there is none).
sgdet grounds the test videos as training does and streams them through
`evaluate_epoch`; predcls builds GT-box Entries (`make_gt_entry_builder`:
VinVL features at the GT boxes from cfg.ckpt); sgcls runs the reference's
two-stage reassignment flow (`evaluate_sgcls`). R@K / mR@K are printed by
the host evaluator; `--device_eval` also scores R@K on the device.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data import schema
from ..data.entry import pick_bucket, to_numpy
from ..data.gt_entry import build_gt_entry
from ..data.grounding import entry_to_eval_pred
from ..data.infer_entry import build_infer_entry
from ..device import resolve_device
from ..eval.epoch import EVAL_KEYS, evaluate_epoch, grounded_batches
from ..eval.recall import SceneGraphEvaluator
from ..models.sgcls_infer import sgcls_assign
from ..train.step import place_entries
from ..utils.checkpoint import load_model_state, load_state
from ..utils.config import load_config
from ..utils.logging import setup_logger
from .train_sttran import (ag_test_split, build_model, cv2_frame_reader, ground_video,
                           load_vinvl_state_dict, log_device_recalls, make_union_provider,
                           on_card_runner)


def load_weights(model: torch.nn.Module, model_path: str) -> torch.nn.Module:
    """The newest checkpoint's weights under `model_path` into `model`, over
    the model's own keys (`load_model_state`: an sgdet checkpoint serves a
    predcls model, which has no object classifier)."""
    load_model_state(model, load_state(model_path)["model"])
    return model


def make_gt_entry_builder(cfg, read_frames=None, device=None):
    """build(ds, idx, buckets, return_union_fn=False) -> the video's GT-box
    Entry (and, with return_union_fn, its union_feat_fn) for predcls /
    sgcls: RoI features of the VinVL detector from cfg.ckpt (a .pth,
    computed in cfg.vinvl_dtype on `device`) at the GT boxes, union
    features (predcls) and the detector's classifier (sgcls).
    `read_frames(ds, idx)` gives the video's BGR frames; by default
    `cv2_frame_reader` over <data_path>/frames (cv2 is imported here, when
    the builder is built). Detector work runs through `on_card_runner`, so
    prefetch workers can share it."""
    if read_frames is None:
        read_frames = cv2_frame_reader(os.path.join(cfg.data_path, "frames"))
    if not cfg.ckpt or not os.path.isfile(str(cfg.ckpt)):
        raise ValueError(f"mode={cfg.mode} needs a VinVL checkpoint (cfg.ckpt = {cfg.ckpt!r})")
    from ..detector.attr_rcnn import AttrRCNNTorch

    det = AttrRCNNTorch(load_vinvl_state_dict(str(cfg.ckpt)),
                        compute_dtype=None if cfg.vinvl_dtype == "float32" else cfg.vinvl_dtype,
                        device=device)
    on_card = on_card_runner(lambda: det)
    cls = det.module.box_head.predictor.cls_score
    w = cls.weight.detach().float().cpu().numpy().T
    b = cls.bias.detach().float().cpu().numpy()

    def classify(feats):
        return feats @ w + b

    def build(ds, idx, buckets, return_union_fn=False):
        frames = read_frames(ds, idx)
        if frames is None:
            raise FileNotFoundError(f"frame images of {ds.video_ids[idx]} are missing")
        feat_fn = on_card(lambda d: d.make_union_feature_fn(frames))

        def union_fn(f, boxes):
            return on_card(lambda d: feat_fn(f, boxes))

        def feature_fn(i, boxes):
            return on_card(lambda d: d.extract_box_features(frames[i], boxes)).mean((-3, -2))

        gt = ds.gt_annotations[idx]
        n_boxes = sum(len(f) for f in gt)
        e = build_gt_entry(gt, cfg.mode, pick_bucket(buckets.max_boxes, n_boxes),
                           pick_bucket(buckets.max_rels, n_boxes), feature_fn,
                           union_feature_fn=union_fn if cfg.mode == "predcls" else None,
                           classify_fn=classify if cfg.mode == "sgcls" else None,
                           feat_dim=cfg.feat_dim,
                           compute_spatial_masks=not cfg.device_spatial_masks)
        # sgcls rebuilds the pairs after the label reassignment and extracts
        # union features at the new union boxes (lib/sttran.py:142-170)
        return (e, union_fn) if return_union_fn else e

    return build


def evaluate_sgcls(cfg, args, logger, build_model_fn=build_model, group_id_fn=None,
                   read_frames=None) -> SceneGraphEvaluator:
    """SGCLS evaluation with the reference's eval-time reassignment
    (lib/sttran.py:93-170, lib/dsg_detr.py:185-275), as two model passes:

      stage 1: the model on the GT-box Entry -> 37-way object logits;
      host:    models/sgcls_infer.sgcls_assign -> new labels, scores and
               person -> object pairs; data/infer_entry.build_infer_entry
               packs them with union features at the new union boxes;
      stage 2: the model on the rebuilt Entry -> relation distributions.

    The evaluator reads the rebuilt Entry's labels and scores.
    `group_id_fn(entry, ds, idx) -> (n_boxes,) int32` gives DSG-DETR's
    tracklet ids (tools/test_dsg_detr); the box table is the same in both
    stages, so one tracker pass serves both. The model runs on
    `args.device` (None: the card)."""
    device = resolve_device(args.device)
    tax = schema.load_taxonomy()
    ds_test = ag_test_split(cfg)
    logger.info(f"test videos: {len(ds_test)}")
    model = build_model_fn(cfg, tax, device)
    if args.model_path:
        load_weights(model, args.model_path)
    builder = make_gt_entry_builder(cfg, read_frames=read_frames, device=device)
    rel_bf16 = cfg.dtype == "bfloat16"

    def run(e, gid):
        batch = place_entries([e], rel_bf16=rel_bf16, device=device)
        kw = {} if gid is None else {"group_id": torch.as_tensor(gid, device=device)[None]}
        with torch.inference_mode():
            out = model(batch, train=False, **kw)
        return {k: to_numpy(v[0]) for k, v in out.items() if k in EVAL_KEYS + ("distribution",)}

    evaluator = SceneGraphEvaluator(mode="sgcls", taxonomy=tax)
    n = min(args.max_videos, len(ds_test)) if args.max_videos else len(ds_test)
    for i in range(n):
        gt = ds_test.gt_annotations[i]
        e, uf = builder(ds_test, i, cfg.buckets, return_union_fn=True)
        if e is None:
            evaluator.evaluate_scene_graph(gt, {})
            continue
        gid = group_id_fn(e, ds_test, i) if group_id_fn is not None else None
        stage1 = run(e, gid)
        nb = int(e.box_mask.sum())
        assign = sgcls_assign(stage1["distribution"][:nb], to_numpy(e.box_frame)[:nb])
        assign.update(boxes=to_numpy(e.boxes)[:nb], box_frame=to_numpy(e.box_frame)[:nb],
                      features=to_numpy(e.features)[:nb])
        e2 = build_infer_entry(assign, int(e.num_frames), e.n_boxes, e.n_rels,
                               union_feat_fn=uf, feat_dim=cfg.feat_dim,
                               compute_spatial_masks=not cfg.device_spatial_masks)
        if e2 is None:  # every box classified person: no pairs
            evaluator.evaluate_scene_graph(gt, {})
            continue
        evaluator.evaluate_scene_graph(gt, entry_to_eval_pred(e2, run(e2, gid)))
    evaluator.calculate_mean_recall()
    evaluator.print_stats(logger)
    return evaluator


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="relation-model evaluation")
    p.add_argument("--cfg", dest="cfg_file", default=None,
                   help="config yaml or json (default: <model_path>/configs.json)")
    p.add_argument("--model_path", default=None, help="port checkpoint directory")
    p.add_argument("--max_videos", type=int, default=0)
    p.add_argument("--device_eval", action="store_true",
                   help="also score R@K on the device (the host evaluator stays the "
                        "reported source of truth)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def config_for(args):
    path = args.cfg_file
    if path is None and args.model_path:
        snap = os.path.join(args.model_path, "configs.json")
        path = snap if os.path.isfile(snap) else None
    return load_config(path)


def main(argv=None, build_model_fn=build_model, read_frames=None) -> SceneGraphEvaluator:
    """`build_model_fn(cfg, tax, device)` lets tools/test_dsg_detr run the
    same loop with its builder; `read_frames` replaces the cv2 frame
    reader of the predcls / sgcls builder and of sgdet's union features."""
    args = parse_args(argv)
    cfg = config_for(args)
    device = resolve_device(args.device)
    logger = setup_logger()
    if cfg.mode == "sgcls":
        return evaluate_sgcls(cfg, args, logger, build_model_fn=build_model_fn,
                              read_frames=read_frames)
    if not args.model_path:
        raise ValueError("--model_path is required for sgdet / predcls evaluation")
    tax = schema.load_taxonomy()
    ds_test = ag_test_split(cfg)
    logger.info(f"test videos: {len(ds_test)}")
    model = load_weights(build_model_fn(cfg, tax, device), args.model_path)
    zero_union = False
    if cfg.mode == "predcls":
        builder = make_gt_entry_builder(cfg, read_frames=read_frames, device=device)
        get_entry = lambda i: builder(ds_test, i, cfg.buckets)  # noqa: E731
    else:
        # the union-feature wiring of training: zeroed union features against
        # a checkpoint trained on real ones would skew R@K
        union_provider = make_union_provider(cfg, logger, read_frames=read_frames,
                                             device=device)
        zero_union = union_provider is None
        get_entry = lambda i: ground_video(ds_test, i, cfg, False, cfg.buckets,  # noqa: E731
                                           union_provider=union_provider)
    evaluator = SceneGraphEvaluator(mode=cfg.mode, taxonomy=tax)
    device_recalls: list | None = [] if args.device_eval else None
    n = min(args.max_videos, len(ds_test)) if args.max_videos else len(ds_test)
    evaluate_epoch(model, grounded_batches(get_entry, ds_test.gt_annotations, range(n),
                                           cfg.batch_videos, cfg.num_workers),
                   evaluator=evaluator, device_recalls=device_recalls, device=device,
                   zero_union=zero_union)
    evaluator.calculate_mean_recall()
    evaluator.print_stats(logger)
    if device_recalls:
        log_device_recalls(logger, device_recalls)
    return evaluator


if __name__ == "__main__":
    main()
