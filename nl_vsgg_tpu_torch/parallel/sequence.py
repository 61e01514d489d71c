"""Frame-axis sequence parallelism for the windowed temporal attention
(port of nl_vsgg_tpu/parallel/sequence.py).

STTran's temporal stage attends within windows of 2 consecutive frames
(lib/transformer_wk.py:158-171), so sharding a long video's frame axis over
the ranks needs exactly a 1-frame halo: each rank receives its left
neighbour's last frame by a point-to-point exchange (`comm.shift`), then
computes its frames' windowed attention locally. No all-gather, no ring.

Layout: tokens are frame-major (F, L, E) with per-slot validity (F, L). The
attention is the temporal decoder's cross-frame op ('latter' fusion: frame
f attends over frames f-1 and f; frame 0 over frames 0 and 1 as the
'former' slot). `params` holds "q", "k", "v", "o" each as {"kernel": (E,
E), "bias": (E,)} (the JAX layout, x @ kernel + bias). The attention core
is the port's kernel (`ops/masked_attention.masked_mha`; its plain version
on the CPU). `windowed_attention_reference` is the dense demo op;
`windowed_attention_sharded` runs on each rank over its block of frames.
"""

from __future__ import annotations

import math

import torch

from ..ops.masked_attention import masked_mha
from . import comm
from . import distributed as D


def _attn(q, k, v, allow, params, num_heads: int):
    """Masked MHA over (B, L, E) inputs and a (B, Lq, Lk) allow mask."""
    E = q.shape[-1]
    Dh = E // num_heads

    def proj(x, w):
        return (x @ w["kernel"] + w["bias"]).unflatten(-1, (num_heads, Dh))

    out = masked_mha(proj(q, params["q"]), proj(k, params["k"]), proj(v, params["v"]),
                     allow, 1.0 / math.sqrt(Dh))
    return out.flatten(-2) @ params["o"]["kernel"] + params["o"]["bias"]


def _frame_windows(tokens, valid, pos, params, num_heads):
    """Windowed attention of (F + 1, L, E) tokens whose row 0 is the left
    halo: returns the outputs of rows 1.. (the local frames)."""
    cur = tokens[1:] + pos[1]                               # each frame, 'latter' slot
    kv = torch.cat([tokens[:-1] + pos[0], cur], 1)          # (F, 2L, E)
    allow = valid[1:, :, None] & torch.cat([valid[:-1], valid[1:]], 1)[:, None, :]
    kv_raw = torch.cat([tokens[:-1], tokens[1:]], 1)
    return _attn(cur, kv, kv_raw, allow, params, num_heads)


def _frame0(t, v, pos, params, num_heads):
    """Global frame 0 as the 'former' slot over frames 0 and 1."""
    q0 = (t[0] + pos[0])[None]
    kv0 = torch.cat([t[0] + pos[0], t[1] + pos[1]], 0)[None]
    allow0 = (v[0][:, None] & torch.cat([v[0], v[1]], 0)[None, :])[None]
    return _attn(q0, kv0, torch.cat([t[0], t[1]], 0)[None], allow0, params, num_heads)[0]


def windowed_attention_reference(tokens, valid, params, pos, num_heads: int = 8):
    """Dense windowed temporal attention, frame-major (F, L, E), F >= 2:
    out[f] = frame f (latter slot) over frames f-1, f; out[0] = frame 0 as
    the former slot over frames 0, 1."""
    F, L, E = tokens.shape
    if F < 2:
        raise ValueError(f"windowed attention needs >= 2 frames, got {F}")
    t = torch.cat([tokens.new_zeros(1, L, E), tokens], 0)
    v = torch.cat([valid.new_zeros(1, L), valid], 0)
    out = _frame_windows(t, v, pos, params, num_heads)
    out = torch.cat([_frame0(tokens, valid, pos, params, num_heads)[None], out[1:]], 0)
    return torch.where(valid[..., None], out, 0.0)


def windowed_attention_sharded(tokens, valid, params, pos, num_heads: int = 8):
    """This rank's block of frames (Fl >= 2 a rank, blocks in rank order)
    -> its block of the dense op's output; the left halo comes from the
    previous rank (none on rank 0)."""
    if tokens.shape[0] < 2:
        raise ValueError(f"need >= 2 frames a rank, got {tokens.shape[0]}")
    halo_t = comm.shift(tokens[-1:], 1)
    halo_v = comm.shift(valid[-1:], 1)           # all False on rank 0
    out = _frame_windows(torch.cat([halo_t, tokens], 0), torch.cat([halo_v, valid], 0), pos,
                         params, num_heads)
    if D.rank() == 0:
        out = torch.cat([_frame0(tokens, valid, pos, params, num_heads)[None], out[1:]], 0)
    return torch.where(valid[..., None], out, 0.0)
