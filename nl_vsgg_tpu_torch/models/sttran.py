"""STTran relation model (port of nl_vsgg_tpu/models/sttran.py), eval and
train mode.

Object classifier + visual/semantic relation features + the shipped `wk`
spatio-temporal transformer (reference lib/sttran.py, lib/transformer_wk.py)
over a batch of padded Entries with a leading video axis.

The temporal decoder runs the duplicated former/latter token streams in
one masked pass (allow = same window), exactly as the JAX package does;
see its module docstring for why that equals the reference's per-window
loops. The JAX model is vmapped per video; this one is batched, so every
per-video reduction (the last relation-bearing frame `f_last`, the window
validity, the `f_last > 0` fallback) is taken per video and broadcast back.

Layouts: Entry feature maps are channel-last; the mask conv tower runs
NCHW on a permuted view, and `vr_fc` reads its input in the reference's
(C, 7, 7) flatten order, so the reference state_dict loads unchanged.

Train mode (`forward(entry, train=True, generator=g)`): dropout at every
place the JAX model applies it, drawn from `g`, and BatchNorm statistics per
video (the JAX step vmaps the model per video, so each video normalizes with
its own statistics; the mask tower's BatchNorms reduce over each video's
(R, H, W), never over the pooled B*R rows). The running updates stay
pending in each MaskedBatchNorm until the train step commits them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..data.entry import MASK_P, Entry
from ..device import resolve_device
from ..ops.boxes import center_size
from ..ops.union_masks import draw_union_boxes
from .layers import (MaskedBatchNorm, MaskedDecoderLayer, MaskedEncoderLayer,
                     MaskedMHA, _cast, dropout, linear, remat)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-video gather: x (B, N, ...), idx (B, R) -> (B, R, ...)."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bidx, idx.long()]


def union_projection(union_feat: torch.Tensor, union_func1: nn.Conv2d,
                     dtype=None) -> torch.Tensor:
    """The reference's 1x1 `union_func1` conv over (B, R, 7, 7, C) union
    features as a channel-axis matmul -> (B*R, 256, 7, 7), NCHW-shaped.

    A width-0 `union_feat` is the zero-union sentinel (no union-feature
    provider): x W + b == b, so the result is the bias broadcast and no
    zeros are made."""
    B, R, P = union_feat.shape[:3]
    w, b = union_func1.weight, union_func1.bias
    if union_feat.shape[-1] == 0:
        return _cast(b, dtype).view(1, -1, 1, 1).expand(B * R, -1, P, P)
    out = F.linear(_cast(union_feat, dtype), _cast(w[:, :, 0, 0], dtype), _cast(b, dtype))
    return out.reshape(B * R, P, P, -1).permute(0, 3, 1, 2)


def spatial_mask_input(entry: Entry) -> torch.Tensor:
    """The (B, R, 27, 27, 2) mask-conv input. A width-0 `spatial_masks` is
    the compute-on-device sentinel: the masks are rasterized here from
    boxes[pair_idx]. Padded relations index box 0 and give junk rows that
    every consumer masks by rel_mask."""
    if entry.spatial_masks.shape[-1]:
        return entry.spatial_masks
    sub = _take(entry.boxes, entry.pair_idx[..., 0])
    obj = _take(entry.boxes, entry.pair_idx[..., 1])
    return draw_union_boxes(torch.cat([sub, obj], dim=-1), MASK_P) - 0.5


class ObjectClassifierWK(nn.Module):
    """Weak-supervision object head (reference lib/sttran.py:20-51, 173-184):
    GloVe soft-embedding of the detector distribution, BatchNorm'd box
    position embedding, (feat + 200 + 128) -> 1024 -> classes. float32.
    BatchNorm momenta are the JAX module's: 0.001 for the position
    embedding's, 0.1 for the decoder's. `generator` (train mode) drops the
    position embedding out at `dropout` after its ReLU."""

    def __init__(self, num_classes: int = 37, feat_dim: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.obj_embed = nn.Embedding(num_classes - 1, 200)
        self.pos_embed = nn.Sequential(MaskedBatchNorm(4, momentum=0.001),
                                       nn.Linear(4, 128), nn.ReLU(), nn.Dropout(dropout))
        self.decoder_lin = nn.Sequential(nn.Linear(feat_dim + 200 + 128, 1024),
                                         MaskedBatchNorm(1024, momentum=0.1), nn.ReLU(),
                                         nn.Linear(1024, num_classes))

    def forward(self, entry: Entry, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        obj_embed = entry.distribution @ self.obj_embed.weight
        pos = self.pos_embed[0](center_size(entry.boxes), entry.box_mask, train)
        pos = dropout(torch.relu(self.pos_embed[1](pos)), self.dropout,
                      generator if train else None)
        h = self.decoder_lin[0](torch.cat([entry.features.float(), obj_embed, pos], dim=-1))
        h = torch.relu(self.decoder_lin[1](h, entry.box_mask, train))
        logits = self.decoder_lin[3](h)
        return torch.where(entry.box_mask[..., None], logits, 0.0)


class SpatialMaskConv(nn.Sequential):
    """2 -> 256 conv tower over 27x27 masks (reference lib/sttran.py:337-345),
    NCHW, convolutions in the compute dtype, BatchNorm in float32 (momentum
    0.01, as the JAX module's). x is (B*R, 2, 27, 27), mask (B, R)."""

    def __init__(self, dtype=None):
        super().__init__(nn.Conv2d(2, 128, 7, 2, 3), nn.ReLU(),
                         MaskedBatchNorm(128, channel_dim=1, momentum=0.01),
                         nn.MaxPool2d(3, 2, 1), nn.Conv2d(128, 256, 3, 1, 1), nn.ReLU(),
                         MaskedBatchNorm(256, channel_dim=1, momentum=0.01))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        def conv(c: nn.Conv2d, x):
            return F.conv2d(_cast(x, self.dtype), _cast(c.weight, self.dtype),
                            _cast(c.bias, self.dtype), c.stride, c.padding)

        x = self[2](torch.relu(conv(self[0], x)), mask, train)
        x = F.max_pool2d(x, 3, 2, 1)
        return self[6](torch.relu(conv(self[4], x)), mask, train)


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class STTranTransformer(nn.Module):
    """Spatial encoder + windowed temporal decoder (lib/transformer_wk.py).

    mode 'latter' (shipped) or 'both'; variant 'wk' (shipped) or 'org',
    which differ only on window-less videos (all relations in frame 0):
    wk passes the spatial encoder output through, org returns zeros.
    `remat` recomputes the encoder and decoder layers in the backward
    (layers.remat), as the JAX module's `nn.remat` does, with its
    exception: the 'latter' mode's last decoder layer, which takes `kv=` /
    `pos_kv=`, stays as it is (nl_vsgg_tpu/models/sttran.py:203-214)."""

    def __init__(self, embed_dim: int = 1936, num_heads: int = 8,
                 dim_feedforward: int = 2048, enc_layers: int = 1, dec_layers: int = 3,
                 mode: str = "latter", variant: str = "wk", dtype=None, fused: bool = True,
                 dropout: float = 0.1, remat: bool = False):
        super().__init__()
        if mode not in ("latter", "both") or variant not in ("wk", "org"):
            raise ValueError(f"mode {mode!r} / variant {variant!r}")
        self.mode, self.variant, self.remat = mode, variant, remat
        self.position_embedding = nn.Embedding(2, embed_dim)
        self.local_attention = _Stack(
            MaskedEncoderLayer(embed_dim, num_heads, dim_feedforward, dtype, fused, dropout)
            for _ in range(enc_layers))
        self.global_attention = _Stack(
            MaskedDecoderLayer(embed_dim, num_heads, dim_feedforward, dtype, fused, dropout)
            for _ in range(dec_layers))

    def forward(self, rel_features: torch.Tensor, im_idx: torch.Tensor,
                rel_mask: torch.Tensor, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        """`generator` switches dropout on (train mode)."""
        g = generator
        R = rel_features.shape[-2]
        im_idx = im_idx.long()
        rm = rel_mask

        def pairs(a, b):  # (B, Q), (B, K) -> (B, Q, K)
            return a[:, :, None] & b[:, None, :]

        def run(layer, *args, **kw):  # the encoder and square decoder layers
            return (remat(layer, *args, generator=g, **kw) if self.remat
                    else layer(*args, generator=g, **kw))

        # ---- spatial encoder: attention within the same frame ----
        allow_s = (im_idx[:, :, None] == im_idx[:, None, :]) & pairs(rm, rm)
        local = rel_features
        for layer in self.local_attention.layers:
            local = run(layer, local, allow_s)
        local = torch.where(rm[..., None], local, 0.0)

        # ---- temporal decoder over duplicated former/latter streams ----
        window = torch.cat([im_idx, im_idx - 1], dim=-1)            # (B, 2R)
        # per video, windows 0 .. f_last - 1 with f_last the last frame that
        # has a relation (the reference sizes its window grid by it), so a
        # video whose relations all sit in frame 0 has no window
        f_last = torch.where(rm, im_idx, 0).amax(-1, keepdim=True)  # (B, 1)
        last_window = f_last - 1
        valid = torch.cat([rm & (im_idx <= last_window), rm & (im_idx >= 1)], dim=-1)
        allow_t = (window[:, :, None] == window[:, None, :]) & pairs(valid, valid)

        pe = self.position_embedding.weight                           # (2, E)
        pos = pe.repeat_interleave(R, dim=0)                          # (2R, E)
        dec = list(self.global_attention.layers)

        def run_square(layers):
            toks = torch.cat([local, local], dim=-2)
            for i, layer in enumerate(layers):
                toks = (run(layer, local, pe, allow_t, dup2=True) if i == 0
                        else run(layer, toks, pos, allow_t))
            return toks

        if self.mode == "both":
            tokens = run_square(dec)
            former, latter = tokens[:, :R], tokens[:, R:]
            mid = 0.5 * (former + latter)
            out = torch.where((im_idx == 0)[..., None], former,
                              torch.where((im_idx == f_last)[..., None], latter, mid))
        else:  # 'latter': the last layer queries only the R output rows
            tokens = run_square(dec[:-1])
            is0 = im_idx == 0
            q_tokens = torch.where(is0[..., None], tokens[:, :R], tokens[:, R:])
            q_window = torch.where(is0, im_idx, im_idx - 1)
            q_valid = torch.where(is0, rm & (im_idx <= last_window), rm & (im_idx >= 1))
            allow_q = (q_window[:, :, None] == window[:, None, :]) & pairs(q_valid, valid)
            # each row's slot embedding by `where`, not an index: the index's
            # backward accumulates into pe's 2 rows in no fixed order
            q_pos = torch.where(is0[..., None], pe[0], pe[1])
            out = dec[-1](q_tokens, q_pos, allow_q, kv=tokens, pos_kv=pos, generator=g)
        # no windows (all relations in frame 0): wk passes the spatial output
        # through, org returns its zeros-initialized buffer
        fallback = local if self.variant == "wk" else torch.zeros_like(local)
        out = torch.where((f_last > 0)[..., None], out, fallback)
        return torch.where(rm[..., None], out, 0.0)


class STTran(nn.Module):
    """Full STTran (reference lib/sttran.py:314-411) over a batch of Entries.

    `forward(batch)` returns a dict: object `distribution` logits,
    `attention_distribution` logits, sigmoided `spatial_distribution` /
    `contacting_distribution` with their raw logits, and `global_output`.
    `dtype` is the compute dtype of projections, convolutions and attention
    (None = float32); the object classifier and the heads stay float32.
    Weights are drawn from `generator` (default: a generator seeded 0).
    `dropout` is the rate of every dropout (the JAX model's 0.1; 0 turns
    dropout off in train mode). `remat` (cfg.remat) recomputes the temporal
    stack's layers in the backward (STTranTransformer)."""

    def __init__(self, mode: str = "sgdet", attention_class_num: int = 3,
                 spatial_class_num: int = 6, contact_class_num: int = 17,
                 obj_classes=(), enc_layer_num: int = 1, dec_layer_num: int = 3,
                 feat_dim: int = 2048, transformer_fusion: str = "latter",
                 transformer_variant: str = "wk", dtype=None, fused: bool = True,
                 dropout: float = 0.1, remat: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        self.mode, self.dtype = mode, dtype
        num_classes = max(len(obj_classes), 37)
        if mode != "predcls":
            self.object_classifier = ObjectClassifierWK(num_classes, feat_dim, dropout)
        add_fusion_layers(self, feat_dim, num_classes)
        self.glocal_transformer = STTranTransformer(
            embed_dim=REL_DIM, enc_layers=enc_layer_num, dec_layers=dec_layer_num,
            mode=transformer_fusion, variant=transformer_variant, dtype=dtype, fused=fused,
            dropout=dropout, remat=remat)
        add_relation_heads(self, attention_class_num, spatial_class_num, contact_class_num)
        init_weights(self, generator or torch.Generator().manual_seed(0))
        self.to(device)
        self.eval()

    def forward(self, entry: Entry, train: bool = False,
                generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """`train=True` needs `generator` (on the model's device): dropout
        masks and attention seeds are drawn from it, and BatchNorm uses each
        video's own statistics (their running updates stay pending)."""
        if train and generator is None:
            raise ValueError("train mode draws its dropout from a generator: pass one")
        g = generator if train else None
        out: dict[str, torch.Tensor] = {}
        if self.mode != "predcls":
            out["distribution"] = self.object_classifier(entry, train, g)
        out["pred_labels"] = entry.labels
        out["pred_scores"] = entry.scores
        rel_features = relation_features(self, entry, entry.labels, train)
        glob = self.glocal_transformer(rel_features, entry.im_idx, entry.rel_mask,
                                       generator=g).float()
        return relation_heads(self, glob, out)


REL_DIM = 3 * 512 + 2 * 200  # relation features: subject, object, union; two class embeddings


def add_fusion_layers(model: nn.Module, feat_dim: int, num_classes: int) -> None:
    """Register the relation models' shared front end on `model`, under the
    reference's names (lib/sttran.py:335-355): the union projection
    `union_func1`, the mask conv tower `conv`, `subj_fc`, `obj_fc`, `vr_fc`
    and the two class embeddings."""
    model.union_func1 = nn.Conv2d(feat_dim, 256, 1, 1)
    model.conv = SpatialMaskConv(model.dtype)
    model.subj_fc = nn.Linear(feat_dim, 512)
    model.obj_fc = nn.Linear(feat_dim, 512)
    model.vr_fc = nn.Linear(256 * 7 * 7, 512)
    model.obj_embed = nn.Embedding(num_classes, 200)
    model.obj_embed2 = nn.Embedding(num_classes, 200)


def add_relation_heads(model: nn.Module, attention: int, spatial: int, contact: int) -> None:
    model.a_rel_compress = nn.Linear(REL_DIM, attention)
    model.s_rel_compress = nn.Linear(REL_DIM, spatial)
    model.c_rel_compress = nn.Linear(REL_DIM, contact)


def relation_features(model: nn.Module, entry: Entry, pred_labels: torch.Tensor,
                      train: bool) -> torch.Tensor:
    """(B, R, REL_DIM) relation features from the layers `add_fusion_layers`
    put on `model`: the subject's and object's projected RoI features, the
    union projection plus the mask conv tower through `vr_fc` (the visual
    part, lib/sttran.py:380-388, in the model's compute dtype), and the
    subject's and object's class embeddings (the semantic part, :391-396)."""
    dt = model.dtype
    B, R = entry.pair_idx.shape[:2]
    subj, obj = entry.pair_idx[..., 0], entry.pair_idx[..., 1]
    subj_rep = linear(_take(entry.features, subj), model.subj_fc, dt)
    obj_rep = linear(_take(entry.features, obj), model.obj_fc, dt)
    masks = spatial_mask_input(entry)                   # (B, R, 27, 27, 2)
    masks = masks.reshape(B * R, *masks.shape[2:]).permute(0, 3, 1, 2)
    vr = (union_projection(entry.union_feat, model.union_func1, dt)
          + model.conv(masks, entry.rel_mask, train))   # (B*R, 256, 7, 7)
    vr = linear(vr.reshape(B, R, -1), model.vr_fc, dt)  # (C, 7, 7) order
    x_visual = torch.cat([subj_rep, obj_rep, vr], dim=-1)
    x_semantic = torch.cat([model.obj_embed.weight[_take(pred_labels, subj).long()],
                            model.obj_embed2.weight[_take(pred_labels, obj).long()]], dim=-1)
    return torch.cat([x_visual, x_semantic], dim=-1)


def relation_heads(model: nn.Module, glob: torch.Tensor,
                   out: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The three predicate heads over the float32 transformer output, into
    `out`: attention logits, spatial and contacting logits and their
    sigmoids, and `global_output` itself."""
    out["global_output"] = glob
    out["attention_distribution"] = model.a_rel_compress(glob)
    s_logits = model.s_rel_compress(glob)
    c_logits = model.c_rel_compress(glob)
    out["spatial_logits"] = s_logits
    out["contacting_logits"] = c_logits
    out["spatial_distribution"] = torch.sigmoid(s_logits)
    out["contacting_distribution"] = torch.sigmoid(c_logits)
    return out


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter and BatchNorm buffer from `generator`, in module
    order: torch's default bounds for linear and conv layers, xavier for the
    packed attention projection, N(0, 1) embeddings, and norms near the
    identity (not exactly, so a weight-conversion test sees every tensor)."""

    def uniform(t, lo, hi):
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=generator))

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform(m.weight, -bound, bound)
            uniform(m.bias, -bound, bound)
        elif isinstance(m, MaskedMHA):
            E = m.embed_dim
            uniform(m.in_proj_weight, -math.sqrt(1.5 / E), math.sqrt(1.5 / E))
            uniform(m.in_proj_bias, -1.0 / math.sqrt(E), 1.0 / math.sqrt(E))
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.LayerNorm, MaskedBatchNorm)):
            uniform(m.weight, 0.9, 1.1)
            uniform(m.bias, -0.1, 0.1)
            if isinstance(m, MaskedBatchNorm):
                uniform(m.running_mean, -0.1, 0.1)
                uniform(m.running_var, 0.5, 1.5)
