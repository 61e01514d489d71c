"""Masked transformer blocks and mask-aware BatchNorm (port of
nl_vsgg_tpu/models/layers.py), eval mode.

Every structural grouping (same frame, same sliding window) is a boolean
(Q, K) allow matrix over flat token arrays, batched over a leading video
axis. Parameter names and layouts are the torch reference's
(nn.MultiheadAttention's packed `in_proj_weight`/`in_proj_bias` +
`out_proj`, nn.Linear, nn.LayerNorm, BatchNorm's running buffers), so a
reference state_dict loads as it is.

`dtype` is the compute dtype (None = the parameters' float32): linear
layers and attention cast their inputs and weights to it, LayerNorm and
BatchNorm normalize in float32 and return the compute dtype, as the JAX
package does. LayerNorm keeps torch's eps (1e-5, the reference's) where
flax uses 1e-6: a relative difference of about 5e-6 on unit-variance rows.

Train mode (dropout, masked-BN batch statistics and its hand backward)
comes with the training slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masked_attention

TRAIN_TODO = ("train mode is not ported yet: dropout, masked-BatchNorm batch "
              "statistics and the training step come with ROADMAP Queue 1 "
              "item 5")


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def linear(x: torch.Tensor, layer: nn.Linear, dtype=None) -> torch.Tensor:
    """nn.Linear in the compute dtype (weights cast per call; params stay fp32)."""
    return F.linear(_cast(x, dtype), _cast(layer.weight, dtype), _cast(layer.bias, dtype))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype=None) -> torch.Tensor:
    out = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return out.to(dtype or x.dtype)


class MaskedMHA(nn.Module):
    """Torch-parity multi-head attention with an explicit (B, Q, K) allow mask.

    Projections sharing an input run as one wide matmul: q=k=v (encoder),
    q=k (decoder), or separate (the rectangular last decoder layer). The
    `dup2_pos` path is the first temporal-decoder layer's: q_in is k_in is
    v_in is the undup (B, R, E) token array x and the logical inputs are
    q = k = [x + P[0]; x + P[1]], v = [x; x] with P the (2, E) slot
    embedding; projection is affine, so the x-projection runs once and the
    2-row position projection is broadcast-added.

    `fused=True` runs the attention core through `masked_mha` (the CUDA
    kernel on a GPU, its plain version on the CPU); `fused=False` always
    runs the plain version."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=None, fused: bool = True):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dtype, self.fused = dtype, fused
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _proj(self, x, lo: int, hi: int):
        E, dt = self.embed_dim, self.dtype
        w = self.in_proj_weight[lo * E:hi * E]
        b = self.in_proj_bias[lo * E:hi * E]
        return F.linear(_cast(x, dt), _cast(w, dt), _cast(b, dt)).split(E, dim=-1)

    def heads(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
              dup2_pos: torch.Tensor | None = None):
        """The projected q, k, v as (B, L, H, D) views: the attention core's
        inputs."""
        E, H, dt = self.embed_dim, self.num_heads, self.dtype
        if dup2_pos is not None:
            if not (q_in is k_in and k_in is v_in):
                raise ValueError("dup2_pos needs q_in is k_in is v_in")
            xq, xk, xv = self._proj(q_in, 0, 3)
            pos = _cast(dup2_pos, dt)
            pq = F.linear(pos, _cast(self.in_proj_weight[:E], dt))
            pk = F.linear(pos, _cast(self.in_proj_weight[E:2 * E], dt))
            q = torch.cat([xq + pq[0], xq + pq[1]], dim=-2)
            k = torch.cat([xk + pk[0], xk + pk[1]], dim=-2)
            v = torch.cat([xv, xv], dim=-2)
        elif q_in is k_in and k_in is v_in:
            q, k, v = self._proj(q_in, 0, 3)
        elif q_in is k_in:
            q, k = self._proj(q_in, 0, 2)
            (v,) = self._proj(v_in, 2, 3)
        else:
            (q,) = self._proj(q_in, 0, 1)
            (k,) = self._proj(k_in, 1, 2)
            (v,) = self._proj(v_in, 2, 3)
        split = (H, E // H)  # (B, L, E) -> (B, L, H, D): a view, no copy
        return q.unflatten(-1, split), k.unflatten(-1, split), v.unflatten(-1, split)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor,
                allow: torch.Tensor, dup2_pos: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self.heads(q_in, k_in, v_in, dup2_pos)
        attend = (masked_attention.masked_mha if self.fused
                  else masked_attention.masked_mha_reference)
        out = attend(q, k, v, allow, 1.0 / math.sqrt(q.shape[-1]))
        return linear(out.flatten(-2), self.out_proj, self.dtype)


class MaskedEncoderLayer(nn.Module):
    """Post-norm encoder layer: attn -> add -> LN -> FFN -> add -> LN
    (reference lib/transformer_wk.py:5-30)."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 dtype=None, fused: bool = True):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MaskedMHA(embed_dim, num_heads, dtype, fused)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = layer_norm(x + self.self_attn(x, x, x, allow), self.norm1, dt)
        h = linear(torch.relu(linear(x, self.linear1, dt)), self.linear2, dt)
        return layer_norm(x + h, self.norm2, dt)


class MaskedDecoderLayer(nn.Module):
    """Windowed temporal layer: q/k carry position embeds, LN after attention
    only (reference lib/transformer_wk.py:33-58).

    `kv`/`pos_kv` let the key/value tokens differ from the query rows
    (rectangular allow): the last 'latter' layer queries only its R output
    rows against all 2R stream tokens. `dup2=True` is the first layer's fast
    path: `x` is the undup (B, R, E) encoder output, `pos` the raw (2, E)
    slot-embedding pair, and the result the (B, 2R, E) duplicated stream."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 dtype=None, fused: bool = True):
        super().__init__()
        self.dtype = dtype
        self.multihead2 = MaskedMHA(embed_dim, num_heads, dtype, fused)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, allow: torch.Tensor,
                kv: torch.Tensor | None = None, pos_kv: torch.Tensor | None = None,
                dup2: bool = False) -> torch.Tensor:
        dt = self.dtype
        if dup2:
            attn = self.multihead2(x, x, x, allow, dup2_pos=pos)
            x = torch.cat([x, x], dim=-2)  # residual stream, duplicated
        else:
            q_in = x + pos  # one object when kv is None -> fused q/k projection
            k_in = q_in if kv is None else kv + pos_kv
            v_in = x if kv is None else kv
            attn = self.multihead2(q_in, k_in, v_in, allow)
        x = layer_norm(x + attn, self.norm3, dt)
        return x + linear(torch.relu(linear(x, self.linear1, dt)), self.linear2, dt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows only, torch-compatible buffers; eval mode.

    Normalizes with the running statistics along `channel_dim` in float32
    and returns the input's dtype. Train mode (statistics over the rows
    `mask` marks valid) comes with the training slice."""

    def __init__(self, num_features: int, eps: float = 1e-5, channel_dim: int = -1):
        super().__init__()
        self.eps, self.channel_dim = eps, channel_dim
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(TRAIN_TODO)
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1

        def c(t):
            return t.view(shape)

        rstd = 1.0 / torch.sqrt(self.running_var + self.eps)
        out = c(self.weight) * (x.float() - c(self.running_mean)) * c(rstd) + c(self.bias)
        return out.to(x.dtype)
