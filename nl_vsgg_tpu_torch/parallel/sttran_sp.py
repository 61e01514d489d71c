"""Frame-axis sequence parallelism for STTranTransformer (port of
nl_vsgg_tpu/parallel/sttran_sp.py).

Runs the port's own module (`models/sttran.STTranTransformer`: its
MaskedEncoderLayer and MaskedDecoderLayer objects and weights, attention on
the port's kernel) with one video's frame axis sharded over the ranks. A
forward (inference) path, as in the JAX package; training parallelism is
data parallel over videos (parallel/mesh.py).

Layout. Tokens are relation-major (R, E) with a frame id each; they are
scattered into a frame-major grid (F, L, E) (L slots a frame) plus a
validity grid (`rel_to_grid`), and gathered back (`grid_to_rel`).

Communication. The spatial encoder attends within one frame: local. The
temporal decoder runs the former (A, owned by frame w) and latter (B,
owned by frame w + 1) streams as separate grids; window w needs A[w]
(local) and B[w + 1]: one halo row from the next rank a decoder layer, and
the updated row sent back (`comm.shift`, point-to-point). The output grids
are all-gathered once at the end so every rank returns the (R, E) result.
"""

from __future__ import annotations

import torch

from . import comm
from . import distributed as D


def rel_to_grid(rel_features, im_idx, rel_mask, n_frames: int, slots: int):
    """(R, E) relation-major -> (F, L, E) frame-major, the (F, L) validity
    and the gather map. Invalid relations go to a scratch frame (row F);
    `slots` must be >= the most valid relations in one frame."""
    R = rel_features.shape[0]
    r = torch.arange(R, device=rel_features.device)
    im_idx = im_idx.long()
    same = (im_idx[None, :] == im_idx[:, None]) & rel_mask[None, :]
    pos_in_frame = (same & (r[None, :] < r[:, None])).sum(1)
    f_idx = torch.where(rel_mask, im_idx, n_frames)
    s_idx = torch.where(rel_mask, pos_in_frame, 0)
    if bool((s_idx >= slots).any()):
        raise ValueError(f"a frame holds more than slots={slots} relations")
    grid = rel_features.new_zeros((n_frames + 1, slots, rel_features.shape[-1]))
    grid[f_idx[rel_mask], s_idx[rel_mask]] = rel_features[rel_mask]
    valid = torch.zeros((n_frames + 1, slots), dtype=torch.bool, device=rel_features.device)
    valid[f_idx[rel_mask], s_idx[rel_mask]] = True
    return grid[:n_frames], valid[:n_frames], (f_idx, s_idx)


def grid_to_rel(grid, gather, rel_mask):
    """Inverse of rel_to_grid for an (F, L, E) output grid."""
    f_idx, s_idx = gather
    out = torch.cat([grid, grid.new_zeros((1,) + tuple(grid.shape[1:]))], 0)[f_idx, s_idx]
    return torch.where(rel_mask[:, None], out, 0.0)


def sttran_transformer_sharded(module, rel_features, im_idx, rel_mask, n_frames_max: int,
                               slots: int) -> torch.Tensor:
    """Frame-sharded forward of `module` (an STTranTransformer, 'latter'
    fusion) on one video's (R, E) relation features. n_frames_max must be a
    multiple of the rank count; this rank runs frames [r Fl, (r + 1) Fl).
    Every rank returns the (R, E) output, equal to module(rel_features)."""
    if module.mode != "latter":
        raise ValueError(f"fusion {module.mode!r}: the frame-sharded forward runs 'latter'")
    n, r = D.world_size(), D.rank()
    if n_frames_max % n:
        raise ValueError(f"n_frames_max={n_frames_max} is not a multiple of {n} ranks")
    Fl = n_frames_max // n
    im_idx = im_idx.long()
    grid, gvalid, gather = rel_to_grid(rel_features, im_idx, rel_mask, n_frames_max, slots)
    fno = torch.arange(r * Fl, (r + 1) * Fl, device=grid.device)
    g, gv = grid[r * Fl:(r + 1) * Fl], gvalid[r * Fl:(r + 1) * Fl]
    # the last relation-bearing frame: windows exist over 0 .. f_last - 1
    f_last = int(torch.where(rel_mask, im_idx, 0).max())

    with torch.no_grad():
        # ---- spatial encoder: same-frame attention, local ----
        allow_s = gv[:, :, None] & gv[:, None, :]
        local = g
        for layer in module.local_attention.layers:
            local = layer(local, allow_s)
        local = torch.where(gv[..., None], local, 0.0)

        # ---- temporal decoder: the two streams, one halo row a layer ----
        def pull_next_first(rows):  # the next rank's first row after my last
            return torch.cat([rows[1:], comm.shift(rows[:1], -1)], 0)

        vA = gv & (fno[:, None] <= f_last - 1)
        vB_s = pull_next_first(gv & (fno[:, None] >= 1))  # the last rank's row: False
        allow_row = torch.cat([vA, vB_s], 1)
        allow_t = allow_row[:, :, None] & allow_row[:, None, :]
        pe = module.position_embedding.weight
        L = g.shape[1]
        pos = pe.repeat_interleave(L, dim=0)                 # (2L, E)
        A, B = local, local
        for layer in module.global_attention.layers:
            x = layer(torch.cat([A, pull_next_first(B)], 1), pos, allow_t)
            A, B_s = x[:, :L], x[:, L:]
            # the updated halo row back to its owner (the next rank's frame 0)
            B = torch.cat([comm.shift(B_s[-1:], 1), B_s[:-1]], 0)

        # 'latter' fusion: frame 0 from the former stream, the rest latter
        out = torch.where((fno == 0)[:, None, None], A, B)
        if f_last == 0:  # no window: wk passes the spatial output through
            out = local if module.variant == "wk" else torch.zeros_like(local)
        out = torch.where(gv[..., None], out, 0.0)
        return grid_to_rel(comm.all_gather(out), gather, rel_mask)
