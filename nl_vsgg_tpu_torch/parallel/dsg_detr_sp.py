"""Token-axis sequence parallelism for DSG-DETR's relation transformer
(port of nl_vsgg_tpu/parallel/dsg_detr_sp.py).

DSG-DETR's temporal attention groups relation tokens by object class
across the whole video (lib/dsg_detr.py:545-564), so a frame partition
would cut every tracklet. Instead the flat relation axis R is sharded over
the ranks: each layer's input is all-gathered once and projected to the
keys and values, so each rank attends its local queries against every
token; the frame, class and validity of every token are all-gathered once
and reused by every layer's allow mask. LayerNorms and FFNs are
token-local. The layers are the port's own (`DSGDETR.local_transformer`,
`global_transformer`, `positional_encoder`), attention on the port's
kernel. A forward (inference) path, as in the JAX package.
"""

from __future__ import annotations

import torch

from . import comm
from . import distributed as D


def dsg_detr_transformer_sharded(model, rel_features, frame_of, obj_cls, ranks,
                                 rel_mask) -> torch.Tensor:
    """The relation transformer of `model` (a DSGDETR) on one video's
    segment inputs (`model.segment_inputs`: (R, E) features, (R,) frame,
    class and rank, (R,) validity), R a multiple of the rank count; this
    rank runs tokens [r R / n, (r + 1) R / n). Every rank returns the (R,
    E) float32 output, equal to the dense model's `global_output`."""
    n, r = D.world_size(), D.rank()
    R = rel_features.shape[0]
    if R % n:
        raise ValueError(f"R={R} relation slots is not a multiple of {n} ranks")
    sl = slice(r * R // n, (r + 1) * R // n)
    x, rk, m = rel_features[sl], ranks[sl], rel_mask[sl]
    # one metadata gather, reused by every layer's allow mask
    meta = comm.all_gather(torch.stack([frame_of[sl].long(), obj_cls[sl].long(),
                                        m.long()], -1))
    fo_g, oc_g, m_g = meta[:, 0], meta[:, 1], meta[:, 2] > 0
    pair = m[:, None] & m_g[None, :]
    allow_s = ((frame_of[sl].long()[:, None] == fo_g[None, :]) & pair)[None]
    allow_t = ((obj_cls[sl].long()[:, None] == oc_g[None, :]) & pair)[None]

    def run(layers, x, allow):
        for layer in layers:  # the layer input gathered once: the keys and values
            x = layer(x[None], allow, kv=comm.all_gather(x)[None])[0]
        return x

    with torch.no_grad():
        x = run(model.local_transformer.layers, x, allow_s)
        x = model.positional_encoder(torch.where(m[:, None], x, 0.0), rk)
        x = run(model.global_transformer.layers, x, allow_t)
        return comm.all_gather(torch.where(m[:, None], x, 0.0).float())
