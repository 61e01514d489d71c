"""VinVL AttrRCNN detector facade, port of nl_vsgg_tpu/detector/attr_rcnn.py.

  * `preprocess`: a BGR uint8 image -> resized (min side 600, max 1000, the
    non-min side truncated as maskrcnn's Resize does), BGR pixel means
    subtracted, padded to a bucket that is a multiple of 32. The resize is
    `F.interpolate(bilinear, align_corners=False)` on the device, rounded to
    the uint8 grid as cv2.resize(INTER_LINEAR) returns it (no cv2 here:
    the values differ from cv2's fixed-point weights by at most one unit).
  * `AttrRCNNTorch.detect` / `detect_video`: backbone -> RPN -> box head ->
    padded detections with mean-pooled 2048-d features per box (the
    dets.npy / feat.npy schema); a video is one backbone pass over all
    frames, and the RPN, box head (one RoIAlign launch) and postprocess run
    batched over frames.
  * `extract_box_features[_frames]`, `make_union_feature_fn`: (N, 7, 7,
    2048) RoI features for given boxes (the union features of training).

Layouts at the public functions are the JAX package's: images and feature
maps NHWC, boxes xyxy. `compute_dtype="bfloat16"` runs the backbone, the
RPN and the C5 stage in bf16 (weights cast once at load); RoIAlign
arithmetic, the predictor and the box geometry stay fp32, and every output
is fp32, as in the JAX facade's bf16 mode.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .anchors import grid_anchors
from .resnet import ResNeXt152C4
from .roi_box import RoIBoxHead, postprocess_detections
from .rpn import RPNHead, select_proposals, take_rows

PIXEL_MEAN_BGR = (103.530, 116.280, 123.675)
MIN_SIZE, MAX_SIZE = 600, 1000


def compute_scale(h: int, w: int, min_size: int = MIN_SIZE, max_size: int = MAX_SIZE) -> float:
    """maskrcnn Resize.get_size's min-side scale for an (h, w) image. The
    resized non-min dimension truncates, so pixel-exact sizes come from
    resize_hw."""
    size = min_size
    mn, mx = min(h, w), max(h, w)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if mn == size:
        return 1.0
    return size / mn


def resize_hw(h: int, w: int, min_size: int = MIN_SIZE,
              max_size: int = MAX_SIZE) -> tuple[int, int]:
    """maskrcnn Resize.get_size_with_aspect_ratio, exact: the min side ->
    `size` (int(round(...)) under the max_size cap), the other dimension
    truncates (a 500x333 image resizes to 900x600)."""
    size = min_size
    mn, mx = min(h, w), max(h, w)
    if mx / mn * size > max_size:
        size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        return int(size * h / w), size
    return size, int(size * w / h)


def video_bucket_hw(frame_images_bgr) -> tuple[int, int]:
    """The shared padded bucket of a video: the 32-ceil of the frames'
    exact resized sizes."""
    sizes = [resize_hw(i.shape[0], i.shape[1]) for i in frame_images_bgr]
    return (-(-max(s[0] for s in sizes) // 32) * 32, -(-max(s[1] for s in sizes) // 32) * 32)


def preprocess(image_bgr: np.ndarray, bucket_hw: tuple[int, int] | None = None,
               device: str | torch.device | None = None):
    """BGR uint8 (H, W, 3) -> (padded float32 (Hb, Wb, 3) on `device`,
    box_scale (4,) numpy [sx, sy, sx, sy], (new_h, new_w)). `device=None`
    is the GPU (`resolve_device`); pass "cpu" for the CPU."""
    device = resolve_device(device)
    h, w = image_bgr.shape[:2]
    nh, nw = resize_hw(h, w)
    img = torch.as_tensor(np.ascontiguousarray(image_bgr), device=device)
    img = img.permute(2, 0, 1)[None].float()
    if (nh, nw) != (h, w):
        img = F.interpolate(img, size=(nh, nw), mode="bilinear", align_corners=False,
                            antialias=False).round_().clamp_(0.0, 255.0)
    img = img[0].permute(1, 2, 0) - torch.tensor(PIXEL_MEAN_BGR, device=img.device)
    if bucket_hw is None:
        bucket_hw = (-(-nh // 32) * 32, -(-nw // 32) * 32)
    out = torch.zeros((bucket_hw[0], bucket_hw[1], 3), dtype=torch.float32, device=img.device)
    out[:nh, :nw] = img
    box_scale = np.asarray([nw / w, nh / h, nw / w, nh / h], np.float32)
    return out, box_scale, (nh, nw)


class AttrRCNNModule(nn.Module):
    """backbone + RPN head + box head (the JAX module's parameter tree)."""

    def __init__(self, groups: int = 32, fused: bool = True):
        super().__init__()
        self.backbone = ResNeXt152C4(groups, fused=fused)
        self.rpn_head = RPNHead()
        self.box_head = RoIBoxHead(groups, fused=fused)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images (F, H, W, 3) -> C4 (F, H/16, W/16, 1024), both NHWC, in
        the backbone's dtype."""
        x = images.to(self.backbone.stem_conv1.weight.dtype).permute(0, 3, 1, 2)
        return self.backbone(x.contiguous(memory_format=torch.channels_last)).permute(0, 2, 3, 1)

    def rpn(self, c4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """C4 (F, H, W, C) -> fp32 objectness (F, H*W*15) and deltas (F, H*W*15, 4)."""
        return self.rpn_head(c4.permute(0, 3, 1, 2))

    def box(self, c4: torch.Tensor, boxes: torch.Tensor, frame_idx: torch.Tensor | None = None):
        return self.box_head(c4, boxes, frame_idx)


def _unpack(packed: np.ndarray, scale: np.ndarray) -> dict:
    return {"boxes": packed[:, :4] / scale, "scores": packed[:, 4],
            "labels": packed[:, 5].astype(np.int64),
            "box_index": packed[:, 6].astype(np.int64),
            "valid": packed[:, 7] > 0.5, "features": packed[:, 8:]}


class AttrRCNNTorch:
    """Inference facade over AttrRCNNModule with the JAX facade's methods.

    `state_dict` is the port's (detector/convert.py makes one from a VinVL
    checkpoint or from JAX variables). `device=None` means the GPU (raises
    without one); pass device="cpu" to run on the CPU, where the kernels'
    plain versions stand in. `fused=False` takes the plain versions on the
    GPU too (a comparison path)."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], max_proposals: int = 300,
                 max_dets: int = 100, compute_dtype=None, device=None, fused: bool = True):
        self.device = resolve_device(device)
        self.max_proposals, self.max_dets = max_proposals, max_dets
        with torch.device("meta"):  # no host-side init of 146 M parameters
            module = AttrRCNNModule(fused=fused)
        module.to_empty(device=self.device).load_state_dict(dict(state_dict))
        module.requires_grad_(False).eval()
        module.to(memory_format=torch.channels_last)
        if compute_dtype in ("bfloat16", torch.bfloat16):
            for part in (module.backbone, module.rpn_head, module.box_head.head):
                part.to(torch.bfloat16)
        elif compute_dtype is not None:
            raise ValueError(f"compute_dtype must be None or 'bfloat16', got {compute_dtype!r}")
        self.module = module

    # ------------------------------------------------------------ helpers
    def _prep(self, frames, bucket_hw=None):
        """-> (images (F, Hb, Wb, 3) on the device, scales (F, 4), sizes (F, 2))."""
        hw = bucket_hw or video_bucket_hw(frames)
        outs = [preprocess(f, hw, self.device) for f in frames]
        return (torch.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]),
                np.asarray([o[2] for o in outs], np.float32))

    @torch.inference_mode()
    def detect_packed(self, images: torch.Tensor, im_hw: torch.Tensor) -> torch.Tensor:
        """Preprocessed images (F, Hb, Wb, 3) and valid extents (F, 2) ->
        (F, max_dets, 8 + 2048) float32: boxes, score, label, box_index,
        valid, features (the JAX facade's packed layout)."""
        m = self.module
        c4 = m.features(images)
        logits, deltas = m.rpn(c4)
        anchors = torch.as_tensor(grid_anchors(c4.shape[1], c4.shape[2]), device=c4.device)
        proposals, pvalid = select_proposals(anchors, logits, deltas, im_hw,
                                             post_nms_top_n=self.max_proposals)
        nf, p = proposals.shape[:2]
        frame_idx = torch.arange(nf, device=c4.device, dtype=torch.int32).repeat_interleave(p)
        cls, bd, feats77 = m.box(c4, proposals.reshape(-1, 4), frame_idx)
        dets = postprocess_detections(cls.view(nf, p, -1), bd.view(nf, p, -1), proposals,
                                      pvalid, im_hw, max_dets=self.max_dets)
        feats = feats77.mean(dim=(1, 2)).view(nf, p, -1)
        return torch.cat([dets["boxes"], dets["scores"][..., None],
                          dets["labels"][..., None].float(),
                          dets["box_index"][..., None].float(),
                          dets["valid"][..., None].float(),
                          take_rows(feats, dets["box_index"])], dim=-1)

    @torch.inference_mode()
    def box_features(self, images: torch.Tensor, boxes: torch.Tensor,
                     frame_idx: torch.Tensor) -> torch.Tensor:
        """Preprocessed images (F, Hb, Wb, 3), boxes (R, 4) in their
        coordinates, frame_idx (R,) -> (R, 7, 7, 2048) float32: one backbone
        pass, one RoIAlign launch, one C5 pass."""
        m = self.module
        c4 = m.features(images)
        return m.box_head.c5(m.box_head.crops(c4, boxes, frame_idx))

    # ------------------------------------------------------ entry points
    def detect(self, image_bgr: np.ndarray) -> dict:
        """-> dict(boxes [original coords], scores, labels, box_index, valid,
        features) of max_dets rows."""
        return self.detect_video([image_bgr])[0]

    def detect_video(self, frame_images_bgr) -> list[dict]:
        """Detect over a whole video: one backbone pass over all frames (a
        shared padded bucket, per-frame clip extents), one host transfer."""
        images, scales, sizes = self._prep(frame_images_bgr)
        packed = self.detect_packed(images, torch.as_tensor(sizes, device=self.device))
        packed = packed.cpu().numpy()
        return [_unpack(packed[f], scales[f]) for f in range(len(frame_images_bgr))]

    def extract_box_features(self, image: np.ndarray, boxes_xyxy: np.ndarray,
                             preprocessed: bool = False) -> np.ndarray:
        """-> (N, 7, 7, 2048) RoI features, boxes in original image coords
        (or in the preprocessed image's, with preprocessed=True)."""
        if preprocessed:
            img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)[None]
            scale = np.ones(4, np.float32)
        else:
            img, scale, _ = self._prep([image])
            scale = scale[0]
        boxes = torch.as_tensor(np.asarray(boxes_xyxy, np.float32) * scale, device=self.device)
        frame_idx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=self.device)
        return self.box_features(img, boxes, frame_idx).cpu().numpy()

    def extract_box_features_frames(self, frame_images_bgr, boxes_xyxy: np.ndarray,
                                    frame_idx: np.ndarray) -> np.ndarray:
        """(R, 7, 7, 2048) RoI features for boxes spread across frames: one
        backbone pass, one frame-indexed RoIAlign, one C5 pass."""
        images, scales, _ = self._prep(frame_images_bgr)
        frame_idx = np.asarray(frame_idx)
        boxes = np.asarray(boxes_xyxy, np.float32) * scales[frame_idx]
        return self.box_features(images, torch.as_tensor(boxes, device=self.device),
                                 torch.as_tensor(frame_idx, dtype=torch.int32,
                                                 device=self.device)).cpu().numpy()

    def make_union_feature_fn(self, frame_images_bgr, bucket_hw=None):
        """-> union_feat_fn(frame_idx, boxes) -> (N, 7, 7, 2048): every
        frame's C4 map is computed once, in one backbone pass."""
        images, scales, _ = self._prep(frame_images_bgr, bucket_hw)
        with torch.inference_mode():
            c4 = self.module.features(images)
        head = self.module.box_head

        def union_feat_fn(frame_idx: int, boxes_xyxy: np.ndarray) -> np.ndarray:
            boxes = torch.as_tensor(np.asarray(boxes_xyxy, np.float32) * scales[frame_idx],
                                    device=self.device)
            with torch.inference_mode():
                return head.c5(head.crops(c4[frame_idx], boxes)).cpu().numpy()

        return union_feat_fn
