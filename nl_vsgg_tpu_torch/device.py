"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the GPU. A CUDA device with no GPU present raises: the
    port never drops to the CPU on its own; callers ask for it with
    `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nl_vsgg_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return dev
