"""RoI box head: RoIAlign pooler + C5 feature extractor + 1595-class
predictor + postprocess, port of nl_vsgg_tpu/detector/roi_box.py, batched
over frames.

  * pooler: RoIAlign 14x14 at 1/16 over the C4 map (`ops.roi_align`, the
    hand kernel; one launch for the rois of every frame);
  * feature extractor: ResNeXt stage 5 -> (7, 7, 2048); the mean-pooled
    2048-d features are what the reference caches as feat.npy;
  * predictor: cls_score (1595) + bbox_pred (1595 * 4), float32;
  * postprocess: softmax, per-class decode with weights (10, 10, 5, 5),
    clip, score threshold 0.2, per-class NMS 0.5, 100 detections with the
    10-detection fallback, in fixed shapes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nms import nms_topk
from ..ops.roi_align import roi_align, roi_align_reference
from .resnet import ResNeXtC5Head
from .rpn import clip_to_image, decode_boxes, take_rows, top_k_stable

NUM_CLASSES = 1595


class BoxPredictor(nn.Module):
    def __init__(self, in_channels: int = 2048, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.cls_score = nn.Linear(in_channels, num_classes)
        self.bbox_pred = nn.Linear(in_channels, num_classes * 4)

    def forward(self, feats77: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """feats77 (N, 7, 7, 2048) float32 -> (logits (N, 1595), deltas (N, 6380))."""
        x = feats77.mean(dim=(1, 2))
        return self.cls_score(x), self.bbox_pred(x)


class RoIBoxHead(nn.Module):
    """pooler + C5 + predictor. `fused=False` takes the plain RoIAlign (and
    the C5's plain grouped conv)."""

    def __init__(self, groups: int = 32, fused: bool = True):
        super().__init__()
        self.fused = fused
        self.head = ResNeXtC5Head(groups, fused=fused)
        self.predictor = BoxPredictor()

    def crops(self, c4: torch.Tensor, boxes: torch.Tensor,
              frame_idx: torch.Tensor | None = None) -> torch.Tensor:
        """(R, 14, 14, C) crops of the (F, H, W, C) C4 map in the C5's dtype:
        fp32 sampling arithmetic, one rounding at the end."""
        align = roi_align if self.fused else roi_align_reference
        return align(c4, boxes.float(), frame_idx, output_size=(14, 14),
                     spatial_scale=1.0 / 16, out_dtype=self.head.layer4.block0.conv1.weight.dtype)

    def c5(self, crops: torch.Tensor) -> torch.Tensor:
        """(N, 14, 14, 1024) crops -> (N, 7, 7, 2048) float32 features."""
        return self.head(crops.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()

    def forward(self, c4: torch.Tensor, boxes: torch.Tensor,
                frame_idx: torch.Tensor | None = None):
        """-> (cls logits (R, 1595), box deltas (R, 6380), features (R, 7, 7, 2048))."""
        feats77 = self.c5(self.crops(c4, boxes, frame_idx))
        logits, deltas = self.predictor(feats77)
        return logits, deltas, feats77


def postprocess_detections(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                           proposals: torch.Tensor, proposal_valid: torch.Tensor,
                           im_hw: torch.Tensor, score_thresh: float = 0.2,
                           nms_thresh: float = 0.5, max_dets: int = 100,
                           min_dets: int = 10) -> dict[str, torch.Tensor]:
    """Per frame: cls_logits (F, n, c), box_deltas (F, n, 4c), proposals
    (F, n, 4), proposal_valid (F, n), im_hw (F, 2) -> dict of (F, max_dets)
    boxes (…, 4), scores, labels (1..c-1), box_index (the source proposal
    row) and valid. maskrcnn's PostProcessor with the MIN_DETECTIONS_PER_IMG
    fallback: if fewer than min_dets pass the threshold, the best
    candidates below it fill the quota."""
    F_, n, c = cls_logits.shape
    dev = cls_logits.device
    probs = torch.softmax(cls_logits.float(), dim=-1)
    deltas = box_deltas.float().view(F_, n, c, 4)
    boxes = decode_boxes(proposals[:, :, None, :], deltas, weights=(10.0, 10.0, 5.0, 5.0))
    boxes = clip_to_image(boxes, im_hw[:, 0, None, None], im_hw[:, 1, None, None])

    # flatten (proposal, class > 0) candidates in (proposal, class) order
    cand_scores = probs[:, :, 1:].reshape(F_, -1)
    cand_boxes = boxes[:, :, 1:, :].reshape(F_, -1, 4)
    cand_labels = torch.arange(1, c, device=dev).repeat(n)
    cand_rows = torch.arange(n, device=dev).repeat_interleave(c - 1)
    cand_valid = proposal_valid.repeat_interleave(c - 1, dim=1)

    # cap the NMS working set: the top 4 * max_dets candidates by score
    k = min(4 * max_dets, cand_scores.shape[1])
    top_scores, top_idx = top_k_stable(torch.where(cand_valid, cand_scores, -1.0), k)
    tboxes = take_rows(cand_boxes, top_idx)
    tlabels = cand_labels[top_idx]
    trows = cand_rows[top_idx]

    # per-class greedy NMS, first max_dets survivors (already in score order)
    kept_idx, kept_ok = nms_topk(tboxes, top_scores, nms_thresh, max_dets,
                                 valid=top_scores > 0, class_ids=tlabels, plus_one=True)
    kept_scores = torch.where(kept_ok, top_scores.gather(1, kept_idx), -1.0)
    n_above = (kept_ok & (kept_scores > score_thresh)).sum(1)
    quota = torch.maximum(kept_ok.sum(1).clamp(max=min_dets), n_above)
    return {
        "boxes": take_rows(tboxes, kept_idx),
        "scores": top_scores.gather(1, kept_idx),
        "labels": tlabels.gather(1, kept_idx),
        "box_index": trows.gather(1, kept_idx),
        "valid": torch.arange(max_dets, device=dev)[None] < quota[:, None],
    }
