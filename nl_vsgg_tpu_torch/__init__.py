"""nl_vsgg_tpu_torch — the PyTorch / NVIDIA H100 port of nl_vsgg_tpu.

Same data contract (padded Entry batches, channel-last feature maps), same
weights (the torch reference's state_dict names and layouts), same
functions; the Pallas kernels of the JAX package become hand-written CUDA
kernels under `csrc/`, built with nvcc at first use (`ops/_build.py`).

Importing this package imports torch and numpy only: no JAX, no
nl_vsgg_tpu module, no kernel build.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
