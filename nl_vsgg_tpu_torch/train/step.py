"""Eval step over batched Entries (port of nl_vsgg_tpu/train/step.py's eval
step). The JAX step vmaps the per-video model over the leading batch axis;
the port's models are natively batched over it, so the step is one call.
The train step comes with the training slice (ROADMAP Queue 1 item 5)."""

from __future__ import annotations

import torch

from ..data.entry import Entry, stack_entries

__all__ = ["eval_step", "stack_entries"]


def eval_step(model: torch.nn.Module, batch: Entry) -> dict[str, torch.Tensor]:
    """batch: Entry[B, ...] on the model's device -> pred dict[B, ...]."""
    with torch.inference_mode():
        return model(batch, train=False)
