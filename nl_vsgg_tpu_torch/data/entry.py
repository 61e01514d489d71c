"""The Entry: the grounding -> model contract, as a dataclass of tensors.

Same 16 fields, dtypes, padding and masking as nl_vsgg_tpu/data/entry.py:
ragged box/relation lists become (N, ...) / (R, ...) tensors plus boolean
masks; padded rows are all-zero with mask False and every consumer masks.
Feature-map fields stay channel-last, (R, 7, 7, C) and (R, 27, 27, 2), so
both packages take the same arrays; the models permute to NCHW where a
convolution needs it.

A batch is the same dataclass with a leading video axis on every field
(`stack_entries`); the models take batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import schema

FEAT_DIM = 2048
POOL = 7
MASK_P = 27

# fields indexed by relation slot (everything else but num_frames is per box)
_REL_FIELDS = ("pair_idx", "im_idx", "rel_mask", "union_feat", "spatial_masks",
               "attention_gt", "spatial_gt", "contacting_gt")


@dataclasses.dataclass
class Entry:
    """One (optionally batched) video's grounded detections + relation slots."""

    # boxes -------------------------------------------------------- (N, ...)
    boxes: torch.Tensor         # (N, 4) float32 xyxy in image coords
    box_frame: torch.Tensor     # (N,) int32 frame index of each box
    box_mask: torch.Tensor      # (N,) bool
    labels: torch.Tensor        # (N,) int32, 1..36 (0 = padding)
    scores: torch.Tensor        # (N,) float32 detector confidence
    distribution: torch.Tensor  # (N, 36) float32 class distribution (no bg)
    features: torch.Tensor      # (N, FEAT_DIM) float32 RoI features
    # relations ---------------------------------------------------- (R, ...)
    pair_idx: torch.Tensor      # (R, 2) int32 indices into boxes (person, obj)
    im_idx: torch.Tensor        # (R,) int32 frame index of each relation
    rel_mask: torch.Tensor      # (R,) bool
    union_feat: torch.Tensor    # (R, POOL, POOL, FEAT_DIM) float32; channel
    # width 0 = "logically all-zeros": the models reduce the union projection
    # to its exact bias broadcast (models/sttran.union_projection)
    spatial_masks: torch.Tensor  # (R, MASK_P, MASK_P, 2) float32; channel
    # width 0 = "compute on device": the models rasterize the masks from
    # boxes[pair_idx] (ops/union_masks, models/sttran.spatial_mask_input)
    attention_gt: torch.Tensor   # (R, 3) float32 multi-hot
    spatial_gt: torch.Tensor     # (R, 6) float32 multi-hot
    contacting_gt: torch.Tensor  # (R, 17) float32 multi-hot
    # video-level scalar
    num_frames: torch.Tensor     # () int32

    @property
    def n_boxes(self) -> int:
        return self.boxes.shape[-2]

    @property
    def n_rels(self) -> int:
        return self.pair_idx.shape[-2]

    def replace(self, **kw) -> "Entry":
        return dataclasses.replace(self, **kw)

    def to(self, device, non_blocking: bool = False) -> "Entry":
        return Entry(**{f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
                        for f in dataclasses.fields(self)})

    @classmethod
    def from_numpy(cls, arrays: dict) -> "Entry":
        return cls(**{k: torch.as_tensor(np.asarray(v)) for k, v in arrays.items()})


def to_numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor on any device (floating tensors as
    float32: bfloat16 has no numpy dtype), or np.asarray of anything else."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


def stack_entries(entries: list[Entry]) -> Entry:
    """Stack same-bucket Entries into a leading batch axis."""
    return Entry(**{f.name: torch.stack([getattr(e, f.name) for e in entries])
                    for f in dataclasses.fields(Entry)})


def empty_entry(n_boxes: int, n_rels: int, feat_dim: int = FEAT_DIM,
                with_union_feat: bool = True,
                with_spatial_masks: bool = True) -> Entry:
    """All-padding Entry of the given bucket shape (a fill video).

    `with_union_feat=False` / `with_spatial_masks=False` emit the width-0
    sentinel forms so a fill video matches the real entries it is batched
    with."""
    z = torch.zeros
    f32 = torch.float32
    return Entry(
        boxes=z((n_boxes, 4), dtype=f32),
        box_frame=z((n_boxes,), dtype=torch.int32),
        box_mask=z((n_boxes,), dtype=torch.bool),
        labels=z((n_boxes,), dtype=torch.int32),
        scores=z((n_boxes,), dtype=f32),
        distribution=z((n_boxes, schema.NUM_OBJ_CLASSES - 1), dtype=f32),
        features=z((n_boxes, feat_dim), dtype=f32),
        pair_idx=z((n_rels, 2), dtype=torch.int32),
        im_idx=z((n_rels,), dtype=torch.int32),
        rel_mask=z((n_rels,), dtype=torch.bool),
        union_feat=z((n_rels, POOL, POOL, feat_dim if with_union_feat else 0), dtype=f32),
        spatial_masks=z((n_rels, MASK_P, MASK_P, 2 if with_spatial_masks else 0), dtype=f32),
        attention_gt=z((n_rels, schema.NUM_ATTENTION), dtype=f32),
        spatial_gt=z((n_rels, schema.NUM_SPATIAL), dtype=f32),
        contacting_gt=z((n_rels, schema.NUM_CONTACTING), dtype=f32),
        num_frames=torch.tensor(0, dtype=torch.int32),
    )


def pick_bucket(sizes: tuple[int, ...], n: int) -> int:
    """Smallest bucket >= n (last bucket truncates, reported by the caller)."""
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


def pick_joint_bucket(box_sizes, rel_sizes, n_boxes: int, n_rels: int
                      ) -> tuple[int, int]:
    """Smallest shared ladder rung fitting both exact counts: the two
    ladders pair by rung index, so a run sees |ladder| shapes, not
    |boxes| x |rels| combinations."""

    def idx(sizes, n):
        for i, s in enumerate(sizes):
            if n <= s:
                return i
        return len(sizes) - 1

    i = max(idx(box_sizes, n_boxes), idx(rel_sizes, n_rels))
    return (box_sizes[min(i, len(box_sizes) - 1)],
            rel_sizes[min(i, len(rel_sizes) - 1)])


def pad_entry(e: Entry, n_boxes: int, n_rels: int) -> Entry:
    """Pad (or truncate, keeping the first rows) every field to bucket shape."""

    def fit(a: torch.Tensor, n: int) -> torch.Tensor:
        if a.shape[0] >= n:
            return a[:n]
        out = a.new_zeros((n,) + tuple(a.shape[1:]))
        out[: a.shape[0]] = a
        return out

    kw = {}
    for f in dataclasses.fields(Entry):
        v = torch.as_tensor(getattr(e, f.name))
        if f.name == "num_frames":
            kw[f.name] = v
        else:
            kw[f.name] = fit(v, n_rels if f.name in _REL_FIELDS else n_boxes)
    # clamp pair indices that point past a truncated box table
    pi = kw["pair_idx"]
    rm = kw["rel_mask"] & (pi < n_boxes).all(dim=-1)
    kw["pair_idx"] = torch.where(rm[:, None], pi, 0).to(torch.int32)
    kw["rel_mask"] = rm
    return Entry(**kw)
