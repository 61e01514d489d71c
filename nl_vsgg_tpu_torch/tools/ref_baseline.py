"""The live PyTorch reference's eval, as the acceptance runbook's
ref_baseline stage runs it, in a process of its own:

    python -m nl_vsgg_tpu_torch.tools.ref_baseline --cfg eval_config.json \
        --relation_ckpt model_best.tar --ref_root REFERENCE --family sttran \
        --out_dir out/acceptance [--max_videos N]

writes <out_dir>/expected.json and prints `ref_baseline videos N` as its
last line. Importing the reference installs stubs for its native and
GPU-only dependencies (`tools.ref_stubs`) and patches `torch.device` to
the CPU; both last only as long as this process, so the runbook that
starts it keeps its own torch untouched.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np

from ..data import schema
from ..utils.config import load_config


def run_ref_baseline(cfg, relation_ckpt: str, ref_root: str, out_dir: str, family: str,
                     max_videos: int = 0) -> tuple[dict, int]:
    """The reference's per-video protocol (tools/test_STTran.py:75-92 of
    the reference: detector entry -> model -> evaluate_scene_graph;
    DSG-DETR also runs lib/track.py's get_sequence) on the test videos;
    returns (expected dict, n_videos). Needs the reference checkout at
    `ref_root`, the torch .tar and the cached VinVL frame features the
    reference's load_feature reads. The reference reads datasets/ paths
    relative to its working directory: a scratch directory of symlinks
    under out_dir stands in. Its class-name files come from the
    repository's assets/ when the data root lacks them; GloVe is stubbed
    (`tools.ref_stubs`), harmless for eval since the checkpoint's
    obj_embed weights overwrite it. The reference runs on the CPU. Call it
    only in a process of its own (`main`): the stubs and the patched
    `torch.device` stay for the rest of the process."""
    import torch

    from .ref_stubs import install

    install(ref_root)
    import lib.assign_pseudo_label as apl

    real_device = torch.device
    apl.torch.device = lambda spec: real_device("cpu")

    ann = (cfg.data_path if cfg.data_path.endswith("annotations")
           else os.path.join(cfg.data_path, "annotations"))
    assets = schema.ASSETS_DIR
    scratch = os.path.join(out_dir, "ref_cwd")
    agd = os.path.join(scratch, "datasets", "AG")
    os.makedirs(agd, exist_ok=True)

    def _link(src, dst):
        if os.path.lexists(dst):
            os.remove(dst)
        os.symlink(os.path.abspath(src), dst)

    for name in ("ag_to_oi_word_map_synset.npy", "oi_to_ag_word_map_synset.npy"):
        _link(os.path.join(assets, name), os.path.join(scratch, "datasets", name))
    _link(cfg.frame_features_path, os.path.join(agd, "frame_features"))
    for cand in (os.path.join(ann, os.pardir, "ag_img_info_test.pkl"),
                 os.path.join(ann, "ag_img_info_test.pkl")):
        if os.path.isfile(cand):
            _link(cand, os.path.join(agd, "ag_img_info_test.pkl"))
            break
    sann = os.path.join(scratch, "annotations")
    os.makedirs(sann, exist_ok=True)
    for entry in os.listdir(ann):
        _link(os.path.join(ann, entry), os.path.join(sann, entry))
    for t in ("object_classes.txt", "relationship_classes.txt"):
        if not os.path.exists(os.path.join(sann, t)):
            _link(os.path.join(assets, t), os.path.join(sann, t))

    os.chdir(scratch)
    from dataloader.wk_action_genome import AG_Test
    from lib.evaluation_recall import SceneGraphEvaluator as RefEval
    from lib.object_detector import detector as RefDetector

    class _Log:
        def info(self, *a, **k):
            pass

    ds = AG_Test("test", _Log(), data_path=os.path.abspath(sann))
    # AG_Test has no object_classes4gt (only the train dataset does, the
    # reference's dataloader/wk_action_genome.py:31-42): the train list is
    # the raw names with the five singleton renames, exactly the five
    # indices AG_Test gives slashed names
    classes4gt = list(ds.object_classes)
    for i, name in ((9, "cabinet"), (11, "glass"), (23, "paper"), (24, "phone"), (31, "sofa")):
        classes4gt[i] = name
    RefModel = importlib.import_module(
        "lib.dsg_detr" if family == "dsg_detr" else "lib.sttran").STTran
    model = RefModel(
        mode=cfg.mode, attention_class_num=len(ds.attention_relationships),
        spatial_class_num=len(ds.spatial_relationships),
        contact_class_num=len(ds.contacting_relationships), obj_classes=classes4gt,
        enc_layer_num=cfg.enc_layer, dec_layer_num=cfg.dec_layer,
        transformer_mode=cfg.transformer_mode, is_wks=cfg.is_wks,
        feat_dim=cfg.feat_dim).eval()
    ckpt = torch.load(relation_ckpt, map_location="cpu", weights_only=False)
    model.load_state_dict(ckpt.get("state_dict", ckpt), strict=False)
    ref_ev = RefEval(
        mode=cfg.mode, AG_object_classes=ds.object_classes,
        AG_all_predicates=ds.relationship_classes,
        AG_attention_predicates=ds.attention_relationships,
        AG_spatial_predicates=ds.spatial_relationships,
        AG_contacting_predicates=ds.contacting_relationships,
        iou_threshold=0.5, constraint="with")
    ref_ev.register_container()
    # the reference's union extraction needs the maskrcnn /
    # scene-graph-benchmark packages (stubbed): it runs without union
    # features, which a zero-union eval of ours pairs exactly
    if cfg.union_box_feature:
        print("[acceptance] ref_baseline: reference runs with union_box_feature=false "
              "(maskrcnn stack unavailable); pair it with a zero-union eval for an exact gate")
    conf_ns = SimpleNamespace(is_wks=cfg.is_wks, mode=cfg.mode, pseudo_way=cfg.pseudo_way,
                              union_box_feature=False)
    det = RefDetector(train=True, object_classes=classes4gt, use_SUPPLY=True,
                      conf=conf_ns).eval()
    det.is_train = False
    if family == "dsg_detr":
        from lib.matcher import HungarianMatcher
        from lib.track import get_sequence
        matcher = HungarianMatcher(0.5, 1, 1, 0.5)
    n = len(ds) if not max_videos else min(max_videos, len(ds))
    with torch.no_grad():
        for i in range(n):
            gt = ds.gt_annotations[i]
            entry = det(gt, ds.video_list[i], None, None)
            if family == "dsg_detr" and entry is not None:
                im_info = torch.as_tensor(np.asarray(ds.img_info[i], dtype=np.float32))
                get_sequence(entry, gt, matcher, im_info[0][:2] / im_info[0, 2], cfg.mode)
            pred = model(entry) if entry is not None else {}
            ref_ev.evaluate_scene_graph(gt, pred)
    ref_ev.calculate_mean_recall()
    rd, m = ref_ev.result_dict, cfg.mode

    def _means(key):
        return {str(k): float(np.mean(v)) if len(v) else 0.0 for k, v in rd[f"{m}_{key}"].items()}

    expected = {"recall": _means("recall"), "recall_nogc": _means("recall_nogc"),
                "mean_recall": {str(k): float(v) for k, v in rd[f"{m}_mean_recall"].items()}}
    return expected, n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the live PyTorch reference's eval -> expected.json")
    p.add_argument("--cfg", required=True, help="the runbook's config snapshot (.json)")
    p.add_argument("--relation_ckpt", required=True, help="the reference's torch .tar")
    p.add_argument("--ref_root", required=True, help="the reference checkout")
    p.add_argument("--family", choices=["sttran", "dsg_detr"], required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_videos", type=int, default=0)
    args = p.parse_args(argv)
    out_dir = os.path.abspath(args.out_dir)
    expected, n = run_ref_baseline(load_config(args.cfg), os.path.abspath(args.relation_ckpt),
                                   os.path.abspath(args.ref_root), out_dir, args.family,
                                   args.max_videos)
    with open(os.path.join(out_dir, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1)
    print(f"ref_baseline videos {n}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
