"""Train state, optimizer and learning-rate schedule (port of
nl_vsgg_tpu/train/state.py).

Optimizer: global-norm gradient clipping at 5 in optax's form, g * min(1,
5 / ||g||) (no `clip_grad_norm_` epsilon), then AdamW with betas (0.9,
0.999), eps 1e-8 and decoupled weight decay 1e-2 times the learning rate.
torch.optim.AdamW's update, p - lr wd p - lr m_hat / (sqrt(v_hat) + eps),
is optax.adamw's. A parameter that got no gradient (the union projection
with the width-0 union sentinel) takes a zero gradient, as it does under
JAX, so weight decay and the moments still step it.

Under tensor parallel (parallel/tensor.py) a sharded parameter's gradient
is the rank's slice: the clip's global norm sums those slices' squared
norms over the model group and counts each replicated gradient once, so
it is the norm over whole arrays, as optax takes it. AdamW is elementwise
and steps each slice on its own rank.

Schedule: torch's ReduceLROnPlateau, mode 'max', threshold_mode 'abs',
stepped on the epoch score on the host (`PlateauScheduler`);
`set_learning_rate` writes its lr into the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch


class ClippedAdamW:
    """clip_by_global_norm(grad_clip_norm) -> AdamW, over `params`."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-5,
                 weight_decay: float = 1e-2, grad_clip_norm: float = 5.0,
                 model_group=None, sharded: Iterable[torch.nn.Parameter] = ()):
        """`sharded` are the parameters that hold a slice on each rank of
        `model_group` (parallel/tensor.sharded_parameters)."""
        self.params = [p for p in params if p.requires_grad]
        self.grad_clip_norm = grad_clip_norm
        ids = {id(p) for p in sharded}
        self.model_group = model_group if ids else None
        self.sharded = [id(p) in ids for p in self.params]
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    @property
    def param_groups(self):
        return self.adamw.param_groups

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def grads(self) -> list[torch.Tensor]:
        """Every parameter's gradient, zeros where none was produced."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    @torch.no_grad()
    def clip_(self) -> torch.Tensor:
        """Scale the gradients in place by min(1, grad_clip_norm / ||g||)
        (optax's clip_by_global_norm; no epsilon). Returns ||g|| before."""
        grads = self.grads()
        norms = torch.stack(torch._foreach_norm(grads, 2.0))
        if self.model_group is None:
            norm = torch.linalg.vector_norm(norms)
        else:  # the slices' squares summed over the model group, the rest once
            import torch.distributed as dist

            sq = norms.float().square()
            part = torch.tensor(self.sharded, device=sq.device)
            split = torch.stack([sq[~part].sum(), sq[part].sum()])
            dist.all_reduce(split[1:], group=self.model_group)
            norm = split.sum().sqrt()
        torch._foreach_mul_(grads, (self.grad_clip_norm / norm).clamp(max=1.0))
        return norm

    @torch.no_grad()
    def step(self) -> None:
        self.clip_()
        self.adamw.step()


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-5,
                   weight_decay: float = 1e-2, grad_clip_norm: float = 5.0,
                   model_group=None, sharded: Iterable[torch.nn.Parameter] = ()) -> ClippedAdamW:
    return ClippedAdamW(params, lr, weight_decay, grad_clip_norm, model_group, sharded)


@dataclasses.dataclass
class TrainState:
    """The model and its optimizer (both updated in place by the step), the
    step count and the cumulative NaN/empty skips (lib/utils.py:3-12)."""

    model: torch.nn.Module
    optimizer: ClippedAdamW
    step: int = 0
    skipped: int = 0


def create_train_state(model: torch.nn.Module, lr: float = 1e-5, weight_decay: float = 1e-2,
                       grad_clip_norm: float = 5.0,
                       optimizer: ClippedAdamW | None = None) -> TrainState:
    """A fresh state over an already built (and placed, and under tensor
    parallel sharded) model."""
    if optimizer is None:
        from ..parallel.tensor import sharded_parameters

        group, sharded = sharded_parameters(model)
        optimizer = make_optimizer(model.parameters(), lr, weight_decay, grad_clip_norm,
                                   group, sharded)
    return TrainState(model, optimizer)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Write a new lr into the optimizer (the host-side scheduler's)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau, mode='max',
    threshold_mode='abs' (tools/train_STTran.py:117)."""

    def __init__(self, lr: float, patience: int = 1, factor: float = 0.5,
                 threshold: float = 1e-4, min_lr: float = 1e-7):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("-inf")
        self.num_bad = 0

    def step(self, score: float) -> float:
        """Feed the epoch score; returns the (possibly reduced) lr."""
        if score > self.best + self.threshold:
            self.best = score
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])
