"""Stubs for importing the PyTorch reference checkout (the original
NL-VSGG code) beside the port: its native and GPU-only dependencies
(Cython IoU and union-box rasterizer, CUDA RoI layers, the maskrcnn /
scene-graph-benchmark towers, GloVe, torchvision) replaced by one
consistent set of modules, installed once a process (port of
tests/ref_stubs.py). `tools/ref_baseline.run_ref_baseline` uses it, in a
process of its own: the stubs replace modules and torch attributes for
the rest of the process. The IoU and the rasterizer are the port's own
(`eval.recall.np_iou`, `ops.union_masks.draw_union_boxes_np`).
"""

from __future__ import annotations

import sys
import types


def _callable_stub(*a, **k):
    return _callable_stub


def install(root: str) -> None:
    """Put the reference checkout at `root` on sys.path and install the
    stubs (once a process)."""
    import torch

    if root not in sys.path:
        sys.path.insert(0, root)

    if getattr(install, "_done", False):
        return
    install._done = True

    # GloVe loader: deterministic random embeddings (no download)
    wv = types.ModuleType("lib.word_vectors")
    wv.obj_edge_vectors = lambda names, wv_type=None, wv_dir=None, wv_dim=200: \
        torch.randn(len(names), wv_dim)
    sys.modules["lib.word_vectors"] = wv

    # Cython IoU: numpy equivalent (+1 convention)
    from ..eval.recall import np_iou
    bbox = types.ModuleType("lib.fpn.box_intersections_cpu.bbox")
    bbox.bbox_overlaps = lambda a, b: np_iou(a, b)
    bbox.bbox_intersections = _callable_stub
    sys.modules["lib.fpn.box_intersections_cpu.bbox"] = bbox

    # Cython union-box rasterizer: the port's numpy twin, torch layout
    from ..ops.union_masks import draw_union_boxes_np
    dr = types.ModuleType("lib.draw_rectangles.draw_rectangles")
    dr.draw_union_boxes = lambda pair_rois, size: draw_union_boxes_np(pair_rois, size,
                                                                      as_nchw=True)
    sys.modules["lib.draw_rectangles.draw_rectangles"] = dr

    # easydict: trivial attr-dict (lib/funcs.py -> fasterRCNN config needs it)
    if "easydict" not in sys.modules:
        ed = types.ModuleType("easydict")

        class EasyDict(dict):
            def __getattr__(self, k):
                try:
                    return self[k]
                except KeyError as e:
                    raise AttributeError(k) from e

            def __setattr__(self, k, v):
                self[k] = v

        ed.EasyDict = EasyDict
        sys.modules["easydict"] = ed

    # CUDA roi layers: callable factories (never exercised on tested paths)
    roi = types.ModuleType("fasterRCNN.lib.model.roi_layers")
    roi.ROIAlign = _callable_stub
    roi.ROIPool = _callable_stub
    roi.nms = _callable_stub
    sys.modules["fasterRCNN.lib.model.roi_layers"] = roi

    ebf = types.ModuleType("lib.extract_bbox_features")
    for a in ("extract_base_feature_one_img", "extract_feature_given_bbox",
              "extract_feature_given_bbox_video",
              "extract_feature_given_bbox_base_feat",
              "extract_feature_given_bbox_base_feat_torch", "prepare_func"):
        setattr(ebf, a, _callable_stub)
    sys.modules["lib.extract_bbox_features"] = ebf

    # torchvision: real box_area math (lib/matcher.py needs it)
    tv = types.ModuleType("torchvision")
    ops = types.ModuleType("torchvision.ops")
    boxes = types.ModuleType("torchvision.ops.boxes")
    boxes.box_area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    ops.boxes = boxes
    tv.ops = ops
    models = types.ModuleType("torchvision.models")  # fasterRCNN import chain
    tv.models = models
    sys.modules.update({"torchvision": tv, "torchvision.ops": ops,
                        "torchvision.ops.boxes": boxes,
                        "torchvision.models": models})

    # maskrcnn/scene_graph_benchmark towers (import-time only)
    for name in ("scene_graph_benchmark", "scene_graph_benchmark.AttrRCNN",
                 "scene_graph_benchmark.config",
                 "maskrcnn_benchmark", "maskrcnn_benchmark.data",
                 "maskrcnn_benchmark.data.transforms",
                 "maskrcnn_benchmark.data.datasets",
                 "maskrcnn_benchmark.data.datasets.utils",
                 "maskrcnn_benchmark.data.datasets.utils.load_files",
                 "maskrcnn_benchmark.structures",
                 "maskrcnn_benchmark.structures.image_list",
                 "maskrcnn_benchmark.structures.bounding_box",
                 "maskrcnn_benchmark.utils",
                 "maskrcnn_benchmark.utils.checkpoint",
                 "maskrcnn_benchmark.utils.miscellaneous",
                 "maskrcnn_benchmark.config"):
        mod = types.ModuleType(name)
        for attr in ("AttrRCNN", "build_transforms", "to_image_list", "BoxList",
                     "DetectronCheckpointer", "cfg", "sg_cfg",
                     "config_dataset_file", "mkdir"):
            setattr(mod, attr, _callable_stub)
        sys.modules[name] = mod

    # torch quirk patches: int key_padding_mask (lib/transformer_wk.py:154)
    # and inline .cuda() calls (lib/dsg_detr.py:542,560) on a CPU-only host
    orig = torch.nn.MultiheadAttention.forward

    def fwd(self, *a, **kw):
        kpm = kw.get("key_padding_mask")
        if kpm is not None and kpm.dtype not in (torch.bool, torch.float32):
            kw["key_padding_mask"] = kpm.bool()
        return orig(self, *a, **kw)
    torch.nn.MultiheadAttention.forward = fwd
    if not torch.cuda.is_available():
        torch.Tensor.cuda = lambda self, *a, **k: self
