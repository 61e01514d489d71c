"""Masked transformer blocks and mask-aware BatchNorm (port of
nl_vsgg_tpu/models/layers.py), eval and train mode.

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

Train mode. Dropout runs where the JAX layers apply it (the attention
probabilities, after attention, after the FFN ReLU and after the FFN), and
every mask is drawn from the `torch.Generator` passed down the call, never
from torch's global generator: the transformer layers take `generator=None`
for eval (no dropout) and a generator for training. The attention
probabilities' dropout is one seed per (video, MaskedMHA call) drawn from
it, hashed per (head, query, key) inside the attention op
(ops/masked_attention.py). MaskedBatchNorm(train=True) normalizes each
video with its own statistics (the JAX step vmaps per video) and keeps the
per-video running updates pending until the train step commits their
validity-weighted mean (`commit`) or drops them (`discard`).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masked_attention


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout at `rate` with a mask drawn from `generator` (flax's
    Dropout: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate)). No generator or rate 0: the identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


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
    kernels on a GPU, their plain version on the CPU); `fused=False` always
    runs the plain version. Both drop the probabilities out with the same
    hashed mask, so they agree with dropout on."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=None, fused: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dtype, self.fused, self.dropout = dtype, fused, dropout
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
                allow: torch.Tensor, dup2_pos: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q, k, v = self.heads(q_in, k_in, v_in, dup2_pos)
        attend = (masked_attention.masked_mha if self.fused
                  else masked_attention.masked_mha_reference)
        rate, seeds = 0.0, None
        if generator is not None and self.dropout > 0.0:
            rate = self.dropout
            seeds = torch.randint(-2 ** 31, 2 ** 31, (q.shape[0],), generator=generator,
                                  device=q.device, dtype=torch.int32)
        out = attend(q, k, v, allow, 1.0 / math.sqrt(q.shape[-1]), rate, seeds)
        return linear(out.flatten(-2), self.out_proj, self.dtype)


class MaskedEncoderLayer(nn.Module):
    """Post-norm encoder layer: attn -> add -> LN -> FFN -> add -> LN
    (reference lib/transformer_wk.py:5-30). `generator` switches dropout
    on (train mode) at `dropout`, in the attention and on the three
    residual branches, as the JAX layer does."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 dtype=None, fused: bool = True, dropout: float = 0.1):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.self_attn = MaskedMHA(embed_dim, num_heads, dtype, fused, dropout)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm1 = nn.LayerNorm(embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, allow: torch.Tensor,
                generator: torch.Generator | None = None,
                kv: torch.Tensor | None = None) -> torch.Tensor:
        """`kv` (B, K, E) gives the attention other key/value tokens than
        the query rows `x` (the token-sharded forward's gathered tokens)."""
        dt, rate, g = self.dtype, self.dropout, generator
        attn = (self.self_attn(x, x, x, allow, generator=g) if kv is None
                else self.self_attn(x, kv, kv, allow, generator=g))
        x = layer_norm(x + dropout(attn, rate, g), self.norm1, dt)
        h = dropout(torch.relu(linear(x, self.linear1, dt)), rate, g)
        h = linear(h, self.linear2, dt)
        return layer_norm(x + dropout(h, rate, g), self.norm2, dt)


# torch.nn.TransformerEncoderLayer (post-norm, ReLU) with an allow mask, the
# building block of DSG-DETR (nl_vsgg_tpu/models/layers.py::TorchEncoderLayer):
# the JAX package's two classes are the same computation with the same
# submodule names, so the port keeps one.
TorchEncoderLayer = MaskedEncoderLayer


class MaskedDecoderLayer(nn.Module):
    """Windowed temporal layer: q/k carry position embeds, LN after attention
    only (reference lib/transformer_wk.py:33-58).

    `kv`/`pos_kv` let the key/value tokens differ from the query rows
    (rectangular allow): the last 'latter' layer queries only its R output
    rows against all 2R stream tokens. `dup2=True` is the first layer's fast
    path: `x` is the undup (B, R, E) encoder output, `pos` the raw (2, E)
    slot-embedding pair, and the result the (B, 2R, E) duplicated stream.
    `generator` switches dropout on, as in MaskedEncoderLayer."""

    def __init__(self, embed_dim: int, num_heads: int, dim_feedforward: int = 2048,
                 dtype=None, fused: bool = True, dropout: float = 0.1):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.multihead2 = MaskedMHA(embed_dim, num_heads, dtype, fused, dropout)
        self.linear1 = nn.Linear(embed_dim, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, pos: torch.Tensor, allow: torch.Tensor,
                kv: torch.Tensor | None = None, pos_kv: torch.Tensor | None = None,
                dup2: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        dt, rate, g = self.dtype, self.dropout, generator
        if dup2:
            attn = self.multihead2(x, x, x, allow, dup2_pos=pos, generator=g)
            x = torch.cat([x, x], dim=-2)  # residual stream, duplicated
        else:
            q_in = x + pos  # one object when kv is None -> fused q/k projection
            k_in = q_in if kv is None else kv + pos_kv
            v_in = x if kv is None else kv
            attn = self.multihead2(q_in, k_in, v_in, allow, generator=g)
        x = layer_norm(x + dropout(attn, rate, g), self.norm3, dt)
        h = dropout(torch.relu(linear(x, self.linear1, dt)), rate, g)
        return x + dropout(linear(h, self.linear2, dt), rate, g)


class _MaskedBNTrain(torch.autograd.Function):
    """Train-mode masked BatchNorm with the JAX package's hand backward
    (nl_vsgg_tpu/models/layers.py::_masked_bn_core).

    x has the video axis first; `red` are the axes reduced per video (all
    but the video and channel axes), `m` the float validity mask
    broadcastable to x and `count` the valid positions per video (spatial
    dims included, at least 1). Forward: fp32 two-pass mean and biased
    variance per video, out = w (x - mean) rstd + b in x's dtype; mean and
    var come out too, not differentiable. Backward: the two reductions
    sum(dy) and sum(dy (x - mean)) per video over one read of (dy, x), then
    one elementwise pass; out is produced at every position, so only the
    mean and var paths carry the mask."""

    @staticmethod
    def forward(ctx, x, m, count, weight, bias, eps, red, cshape):
        xf = x.float()
        mean = (xf * m).sum(red, keepdim=True) / count
        xc = xf - mean
        var = (xc.square() * m).sum(red, keepdim=True) / count  # biased
        rstd = 1.0 / torch.sqrt(var + eps)
        out = (weight.view(cshape) * xc * rstd + bias.view(cshape)).to(x.dtype)
        ctx.save_for_backward(x, m, count, weight, mean, rstd)
        ctx.red, ctx.cshape = red, cshape
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, m, count, weight, mean, rstd = ctx.saved_tensors
        red, cshape = ctx.red, ctx.cshape
        xc = x.float() - mean
        dyf = dy.float()
        sum_dy = dyf.sum(red, keepdim=True)                  # per video, per channel
        sum_dyx = (dyf * xc).sum(red, keepdim=True)
        w = weight.view(cshape)
        dvar = -0.5 * (sum_dyx * w) * rstd ** 3
        dmean = -(sum_dy * w) * rstd
        dx = dyf * (w * rstd) + m * (2.0 * dvar * xc + dmean) / count
        chan = [d for d in range(x.dim()) if cshape[d] == 1]  # every axis but the channel
        dweight = (sum_dyx * rstd).sum(chan).view(-1)
        dbias = sum_dy.sum(chan).view(-1)
        return dx.to(x.dtype), None, None, dweight, dbias, None, None, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows only, torch-compatible buffers.

    Eval mode normalizes with the running statistics along `channel_dim` in
    float32 and returns the input's dtype.

    Train mode (`train=True`, `mask` required) normalizes each video with
    the statistics of its own valid positions, as the JAX step's per-video
    vmap does; the batched layouts are
      * rows, `channel_dim=-1`: x (B, N, ..., C), mask (B, N);
      * NCHW, `channel_dim=1`: x (B*R, C, H, W), mask (B, R), reduced per
        video over (R, H, W), never over the pooled B*R rows.
    The per-video running updates, (1 - momentum) * running + momentum *
    (mean, unbiased var), stay pending until `commit(video_weight)` writes
    their validity-weighted mean into the buffers (the JAX step's `wmean`)
    or `discard()` drops them (a skipped step)."""

    def __init__(self, num_features: int, eps: float = 1e-5, channel_dim: int = -1,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.channel_dim, self.momentum = eps, channel_dim, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.pending: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                train: bool = False) -> torch.Tensor:
        if train:
            return self._train(x, mask)
        shape = [1] * x.dim()
        shape[self.channel_dim] = -1

        def c(t):
            return t.view(shape)

        rstd = 1.0 / torch.sqrt(self.running_var + self.eps)
        out = c(self.weight) * (x.float() - c(self.running_mean)) * c(rstd) + c(self.bias)
        return out.to(x.dtype)

    def _train(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if mask is None:
            raise ValueError("train-mode MaskedBatchNorm needs the validity mask")
        nchw = self.channel_dim % x.dim() == 1 and x.dim() == 4
        if nchw:                       # (B*R, C, H, W) -> (B, R, C, H, W)
            if x.shape[0] != mask.numel():
                raise ValueError(f"mask {tuple(mask.shape)} does not cover the "
                                 f"{x.shape[0]} rows of x")
            xv = x.unflatten(0, tuple(mask.shape))
            m = mask.reshape(*mask.shape, 1, 1, 1)
            red, cdim = (1, 3, 4), 2
        elif self.channel_dim % x.dim() == x.dim() - 1:
            if tuple(x.shape[:mask.dim()]) != tuple(mask.shape):
                raise ValueError(f"mask {tuple(mask.shape)} does not lead x {tuple(x.shape)}")
            xv = x
            m = mask.reshape(*mask.shape, *([1] * (x.dim() - mask.dim())))
            red, cdim = tuple(range(1, x.dim() - 1)), x.dim() - 1
        else:
            raise ValueError("train mode takes rows (channel_dim=-1) or NCHW "
                             "(channel_dim=1) input")
        m = m.float()
        cshape = [1] * xv.dim()
        cshape[cdim] = -1
        per_row = 1
        for d in red:
            per_row *= xv.shape[d] // m.shape[d]
        count = (m.sum(red, keepdim=True) * per_row).clamp(min=1.0)
        out, mean, var = _MaskedBNTrain.apply(xv, m, count, self.weight, self.bias,
                                              self.eps, red, tuple(cshape))
        B = xv.shape[0]
        unbiased = var * count / (count - 1.0).clamp(min=1.0)
        self.pending = (mean.reshape(B, -1), unbiased.reshape(B, -1))
        return out.flatten(0, 1) if nchw else out

    @torch.no_grad()
    def commit(self, video_weight: torch.Tensor) -> None:
        """Write the pending per-video updates' weighted mean into the
        running buffers. `where`, not multiply: a NaN statistic of a
        weight-0 video stays out of the sum."""
        if self.pending is None:
            return
        self.commit_apply(*self.commit_sums(video_weight))

    @torch.no_grad()
    def commit_sums(self, video_weight: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The pending updates' weighted sums over the videos (mean, var)
        and the weights' sum, consuming them. Under data parallelism the
        train step all-reduces these over the ranks before `commit_apply`,
        so every rank's buffers take the global batch's weighted mean."""
        mean, var = self.pending
        self.pending = None
        w = video_weight.float().view(-1, 1)
        mom = self.momentum
        sums = [torch.where(w > 0, ((1.0 - mom) * buf + mom * stat) * w, 0.0).sum(0)
                for buf, stat in ((self.running_mean, mean), (self.running_var, var))]
        return sums[0], sums[1], w.sum()

    @torch.no_grad()
    def commit_apply(self, mean_sum: torch.Tensor, var_sum: torch.Tensor,
                     weight_sum: torch.Tensor) -> None:
        denom = weight_sum.clamp(min=1.0)
        self.running_mean.copy_(mean_sum / denom)
        self.running_var.copy_(var_sum / denom)
        self.num_batches_tracked += 1

    def discard(self) -> None:
        self.pending = None


def sinusoidal_position_table(max_len: int, d_model: int) -> torch.Tensor:
    """DETR-style (max_len, d_model) float32 table: sin on even dims, cos on
    odd ones, frequencies 10000^(-2i / d_model) (reference lib/dsg_detr.py)."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                    * (-torch.log(torch.tensor(10000.0)) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def mlp(in_features: int, features: Sequence[int],
        activation: Callable[[], nn.Module] = nn.ReLU) -> nn.Sequential:
    """Linear layers of widths `features` from `in_features`, `activation`
    between them (not after the last): the reference's DSG-DETR MLP."""
    layers: list[nn.Module] = []
    for i, f in enumerate(features):
        layers.append(nn.Linear(in_features, f))
        if i < len(features) - 1:
            layers.append(activation())
        in_features = f
    return nn.Sequential(*layers)
