"""DSG-DETR relation model (port of nl_vsgg_tpu/models/dsg_detr.py), eval and
train mode, over a batch of padded Entries with a leading video axis.

DSG-DETR shares STTran's front end: the weak-supervision object classifier
(sgdet), the visual and semantic relation features (`models/sttran.py`'s
`relation_features`) and the three predicate heads. Its transformer is two
stacks of post-norm encoder layers (8 heads, FFN 2048, d_model 1936):

  * local: every relation attends to the relations of its frame (the
    frame of its object box);
  * global: every relation attends to the relations whose object has its
    class, across the whole video, after a sinusoidal position is added.
    The position is the relation's tracklet rank in sgdet (`tracklet_rank`:
    how many distinct subject rows of its class sequence come before its
    own) and its ordinal in the class sequence in sgcls and predcls
    (`sequence_ordinal`), as the JAX model computes them.

In sgcls mode the object classifier is `ObjectClassifierTracklet`: 3
encoder layers (FFN 1024, d_model feat + 200 + 128 = 2376, head dim 297)
over the boxes of each tracklet, the tracklets given as per-box group ids
(`group_id`, from `models/track.py`; by default the box labels). It runs
in float32, as the JAX module does, through the port's attention kernels
(the tiled route: float32, D = 297).

Every grouping is an allow mask over the flat relation (or box) array, as
in STTran. Train mode draws every dropout from the `generator` passed to
`forward`, and BatchNorm normalizes each video with its own statistics
(models/layers.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..data.entry import Entry
from ..device import resolve_device
from ..ops.boxes import center_size
from .layers import MaskedBatchNorm, TorchEncoderLayer, dropout, sinusoidal_position_table
from .sttran import (REL_DIM, ObjectClassifierWK, _Stack, _take, add_fusion_layers,
                     add_relation_heads, init_weights, relation_features, relation_heads)

HEADS = 8


def _pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] & b[..., None, :]


def _same_group(group_id: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., L, L) bool: both rows valid and in one group."""
    return (group_id[..., :, None] == group_id[..., None, :]) & _pairs(valid, valid)


def sequence_ordinal(group_id: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ordinal[i] = the valid rows of row i's group before it in flat order
    (the reference's pad_sequence layout with no explicit positions, used by
    sgcls and predcls); int32, 0 on padded rows."""
    L = group_id.shape[-1]
    earlier = torch.ones(L, L, dtype=torch.bool, device=group_id.device).tril(-1)
    return (_same_group(group_id, valid) & earlier).sum(-1).to(torch.int32)


def tracklet_rank(group_id: torch.Tensor, anchor: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """rank[i] = the distinct `anchor` values below anchor[i] among the
    valid rows of row i's group (the reference's unique/counts loop over
    subject rows); int32, 0 on padded rows. Counted exactly: each distinct
    value is counted at its first row."""
    L = group_id.shape[-1]
    same = _same_group(group_id, valid)
    same_anchor = same & (anchor[..., :, None] == anchor[..., None, :])
    earlier = torch.ones(L, L, dtype=torch.bool, device=group_id.device).tril(-1)
    first = ~(same_anchor & earlier).any(-1)          # row j holds its value's first row
    less = anchor[..., None, :] < anchor[..., :, None]  # [i, j]: anchor[j] < anchor[i]
    return (same & less & first[..., None, :]).sum(-1).to(torch.int32)


class SinusoidalPE(nn.Module):
    """Adds the sinusoidal table's rows at `positions` (clipped to max_len
    - 1), then dropout (train mode). The table is a non-persistent buffer:
    it is no weight, and the state_dict does not carry it."""

    def __init__(self, d_model: int, max_len: int = 400, dropout: float = 0.1):
        super().__init__()
        self.max_len, self.dropout = max_len, dropout
        self.register_buffer("table", sinusoidal_position_table(max_len, d_model),
                             persistent=False)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.table[positions.long().clamp(0, self.max_len - 1)]
        return dropout(x, self.dropout, generator)


class ObjectClassifierTracklet(nn.Module):
    """The tracklet object head (JAX ObjectClassifierTracklet, reference
    lib/dsg_detr.py:296-344): the class distribution's soft embedding
    (`obj_embed`, 36 x 200), the BatchNorm'd box position through `pos_fc`,
    the RoI features; 3 encoder layers over each tracklet's boxes with the
    box's rank among its tracklet's frames as its position; then
    1024 -> classes. Float32 throughout; `fused` picks the attention
    kernels (on a GPU) or the plain attention."""

    def __init__(self, num_classes: int = 37, feat_dim: int = 2048, mode: str = "sgcls",
                 fused: bool = True, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        d_model = feat_dim + 200 + 128
        self.obj_embed = nn.Parameter(torch.empty(num_classes - 1, 200))
        self.pos_bn = MaskedBatchNorm(4, momentum=0.001)
        self.pos_fc = nn.Linear(4, 128)
        self.positional_encoder = SinusoidalPE(d_model, 600 if mode == "sgdet" else 400, dropout)
        self.layers = [TorchEncoderLayer(d_model, HEADS, 1024, None, fused, dropout)
                       for _ in range(3)]
        for i, layer in enumerate(self.layers):
            self.add_module(f"enc_{i}", layer)
        self.decoder_fc1 = nn.Linear(d_model, 1024)
        self.decoder_bn = MaskedBatchNorm(1024, momentum=0.1)
        self.decoder_fc2 = nn.Linear(1024, num_classes)

    def forward(self, entry: Entry, group_id: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        g = generator if train else None
        bm = entry.box_mask
        obj_embed = entry.distribution @ self.obj_embed
        pos = self.pos_bn(center_size(entry.boxes), bm, train)
        pos = dropout(torch.relu(self.pos_fc(pos)), self.dropout, g)
        h = torch.cat([entry.features.float(), obj_embed, pos], dim=-1)
        allow = _same_group(group_id, bm)
        h = self.positional_encoder(h, tracklet_rank(group_id, entry.box_frame, bm), g)
        for layer in self.layers:
            h = layer(h, allow, generator=g)
        h = torch.where(bm[..., None], h, 0.0)
        z = torch.relu(self.decoder_bn(self.decoder_fc1(h), bm, train))
        return torch.where(bm[..., None], self.decoder_fc2(z), 0.0)


class DSGDETR(nn.Module):
    """DSG-DETR (reference lib/dsg_detr.py:464-571) over a batch of Entries.

    `forward(entry, train=False, group_id=None, generator=None)` returns
    STTran's output dict, so the train step, the losses, serving and
    evaluation take it unchanged. `group_id` (B, N) assigns each box to a
    tracklet for the sgcls object head (default: the box labels); the other
    modes ignore it. `dtype` is the compute dtype of the projections, the
    mask convolutions and the relation transformer (None = float32); the
    object classifiers and the heads stay float32. Weights are drawn from
    `generator` (default: a generator seeded 0); `glove_obj36` (36 x 200)
    and `glove_obj37` (37 x 200) replace the drawn class embeddings, as the
    JAX module's initializers take them. `dropout` is the rate of every
    dropout (0.1 in the JAX model)."""

    def __init__(self, mode: str = "sgdet", attention_class_num: int = 3,
                 spatial_class_num: int = 6, contact_class_num: int = 17,
                 obj_classes=(), feat_dim: int = 2048, enc_layer_num: int = 1,
                 dec_layer_num: int = 3, dtype=None, fused: bool = True,
                 glove_obj36=None, glove_obj37=None, dropout: float = 0.1, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if mode not in ("sgdet", "sgcls", "predcls"):
            raise ValueError(f"mode {mode!r}")
        device = resolve_device(device)
        self.mode, self.dtype = mode, dtype
        num_classes = max(len(obj_classes), 37)
        if mode == "sgdet":
            self.object_classifier = ObjectClassifierWK(num_classes, feat_dim, dropout)
        elif mode == "sgcls":
            self.object_classifier = ObjectClassifierTracklet(num_classes, feat_dim, mode,
                                                              fused, dropout)
        add_fusion_layers(self, feat_dim, num_classes)
        self.local_transformer = _Stack(
            TorchEncoderLayer(REL_DIM, HEADS, 2048, dtype, fused, dropout)
            for _ in range(enc_layer_num))
        self.positional_encoder = SinusoidalPE(REL_DIM, 400, dropout)
        self.global_transformer = _Stack(
            TorchEncoderLayer(REL_DIM, HEADS, 2048, dtype, fused, dropout)
            for _ in range(dec_layer_num))
        add_relation_heads(self, attention_class_num, spatial_class_num, contact_class_num)
        generator = generator or torch.Generator().manual_seed(0)
        init_weights(self, generator)
        with torch.no_grad():
            if mode == "sgcls":
                self.object_classifier.obj_embed.copy_(
                    torch.randn(self.object_classifier.obj_embed.shape, generator=generator))
            if glove_obj36 is not None and mode != "predcls":
                oc = self.object_classifier
                emb = oc.obj_embed if mode == "sgcls" else oc.obj_embed.weight
                emb.copy_(torch.as_tensor(glove_obj36, dtype=torch.float32))
            if glove_obj37 is not None:
                for emb in (self.obj_embed, self.obj_embed2):
                    emb.weight.copy_(torch.as_tensor(glove_obj37, dtype=torch.float32))
        self.to(device)
        self.eval()

    def segment_inputs(self, entry: Entry, train: bool = False) -> tuple[torch.Tensor, ...]:
        """The relation transformer's inputs: relation features (B, R,
        1936), each relation's frame and object class (its local and global
        groups) and its position in the class sequence (the sinusoidal
        encoding's index). parallel/dsg_detr_sp runs the transformer on
        them token-sharded."""
        rm = entry.rel_mask
        h = relation_features(self, entry, entry.labels, train)
        subj, obj = entry.pair_idx[..., 0], entry.pair_idx[..., 1]
        frame_of = _take(entry.box_frame, obj)
        obj_cls = _take(entry.labels, obj)
        if self.mode == "sgdet":
            ranks = tracklet_rank(obj_cls, subj, rm)
        else:  # no explicit positions: the ordinal in the class sequence
            ranks = sequence_ordinal(obj_cls, rm)
        return h, frame_of, obj_cls, ranks

    def forward(self, entry: Entry, train: bool = False, group_id: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """`train=True` needs `generator` (on the model's device)."""
        if train and generator is None:
            raise ValueError("train mode draws its dropout from a generator: pass one")
        g = generator if train else None
        out: dict[str, torch.Tensor] = {}
        if self.mode == "sgcls":
            gid = group_id if group_id is not None else entry.labels
            out["distribution"] = self.object_classifier(entry, gid, train, g)
        elif self.mode == "sgdet":
            out["distribution"] = self.object_classifier(entry, train, g)
        pred_labels = entry.labels
        out["pred_labels"] = pred_labels
        out["pred_scores"] = entry.scores

        h, frame_of, obj_cls, ranks = self.segment_inputs(entry, train)
        rm = entry.rel_mask
        # ---- local: the relations of one frame (lib/dsg_detr.py:536-543) ----
        allow_s = _same_group(frame_of, rm)
        for layer in self.local_transformer.layers:
            h = layer(h, allow_s, generator=g)
        h = torch.where(rm[..., None], h, 0.0)

        # ---- global: the relations of one object class (:545-564) ----
        allow_t = _same_group(obj_cls, rm)
        h = self.positional_encoder(h, ranks, g)
        for layer in self.global_transformer.layers:
            h = layer(h, allow_t, generator=g)
        glob = torch.where(rm[..., None], h, 0.0).float()
        return relation_heads(self, glob, out)
