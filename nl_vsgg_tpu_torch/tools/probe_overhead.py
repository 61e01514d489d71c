"""Launch-overhead probe: what one call of a hand-written kernel costs through
the port's binding (a `ctypes` call into an nvcc-built library), beside the
same work done by native PyTorch ops.

    python -m nl_vsgg_tpu_torch.tools.probe_overhead [--iters N] [--device cpu]

Port of tools/probe_pallas_overhead.py, with its rows and inputs (drawn from
np.random.default_rng(0) in the same order):

  tiny-copy      y = 2x of (256, 128) fp32 by the copy kernel, one unit
  slab-copy      y = 2x of (8, 40, 64, 128) bf16, one unit
  slab-copy-g8   the same as 8 units, one per image (the probe's 8 grid
                 steps); the kernel spreads each unit over enough blocks
                 to fill the card (ops/probe_copy.copy_plan)
  mm-kernel      (20480, 128) @ (128, 128) bf16 by the mma.sync kernel
  mm-torch       the same product by torch.matmul (cuBLAS; mm-xla's counterpart)
  conv-cudnn(g8) the stage-4 grouped conv, (8, 38, 64, 1024) bf16 by
                 (3, 3, 128, 1024) at groups 8, by cuDNN (conv-xla(g8)'s)

Each row prints the device time per call (CUDA events, two-point
differenced, the card kept busy while the host queues the calls), the
host's time to issue one call, and the least time the card could take. The
host time of the kernel rows is the fixed cost of a launch through `ctypes`;
the torch rows give a native op's beside it. Each copy row also prints the
kernel's route and grid. Without `--device cpu` it runs
on the GPU or raises; on the CPU it runs the kernels' plain versions and
prints host times only. No row's failure is caught.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import _build, probe_copy as pc, probe_matmul as pm
from . import timing

def run(iters: int = 50, device=None, tiny=(256, 128), slab=(8, 40, 64, 128),
        mm_rows: int = 20480, conv=(8, 38, 64, 1024), log=print) -> list[dict]:
    """Time the probe's six rows; print one line each and return them. The
    shapes default to the JAX probe's."""
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    clock = timing.cuda_clock if on_gpu else timing.wall_clock
    rng = np.random.default_rng(0)

    def put(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    xt = put(rng.standard_normal(tiny), torch.float32)
    xs = put(rng.standard_normal(slab), torch.bfloat16)
    xm = put(rng.standard_normal((mm_rows, pm.K)), torch.bfloat16)
    wm = put(rng.standard_normal((pm.K, pm.K)) * 0.05, torch.bfloat16)
    xc = put(rng.standard_normal(conv), torch.bfloat16)
    cg = conv[3] // 128
    wc = put(rng.standard_normal((3, 3, 128, conv[3])) * 0.05, torch.bfloat16)
    xc_nchw = xc.permute(0, 3, 1, 2)                       # channels-last storage
    wc_oihw = wc.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    mm_ops = 2.0 * mm_rows * pm.K * pm.K
    mm_bytes = (2 * mm_rows * pm.K + pm.K * pm.K) * 2
    conv_ops = 2.0 * xc.numel() * 9 * 128
    # (label, kernel, call, bytes, operations, dtype, the copy's (x, units))
    rows = [(label, "probe_copy", lambda x=x, u=u: pc.probe_copy(x, u),
             2 * x.numel() * x.element_size(), 0.0, x.dtype, (x, u))
            for label, x, u in (("tiny-copy", xt, 1), ("slab-copy", xs, 1),
                                ("slab-copy-g8", xs, 8))]
    rows += [
        ("mm-kernel", "probe_matmul", lambda: pm.probe_matmul(xm, wm), mm_bytes, mm_ops,
         torch.bfloat16, None),
        ("mm-torch", None, lambda: torch.matmul(xm, wm), mm_bytes, mm_ops, torch.bfloat16, None),
        (f"conv-cudnn(g{cg})", None,
         lambda: F.conv2d(xc_nchw, wc_oihw, padding=1, groups=cg),
         (2 * xc.numel() + wc.numel()) * 2, conv_ops, torch.bfloat16, None),
    ]
    name = torch.cuda.get_device_name(dev) if on_gpu else "cpu (plain versions)"
    log(f"# probe_overhead on {name}, iters={iters}; device and host us per call, "
        f"two-point differenced")
    out = []
    for label, kernel, fn, nbytes, ops, dtype, copy in rows:
        t = timing.timed_delta(fn, iters, clock)
        b, by = timing.bound_s(nbytes, ops, dtype)
        dev_us = None if t.device_s is None else t.device_s * 1e6
        route, shown_route = None, ""
        if copy is not None and on_gpu:
            x, units = copy
            plan = pc.copy_plan(x.numel(), x.dtype, units, _build.sm_count(dev))
            route = plan["route"]
            shown_route = f"  route {route}, {units} unit(s) x {plan['blocks_per_unit']} blocks"
        out.append(dict(name=label, kernel=kernel if on_gpu else None, device_us=dev_us,
                        host_us=t.host_s * 1e6, bound_us=b * 1e6, bound_by=by, calls=t.calls,
                        route=route))
        shown = "not measured (cpu)" if dev_us is None else f"{dev_us:10.3f} us"
        log(f"  {label:15s} device {shown}  host {t.host_s * 1e6:9.3f} us/call  "
            f"bound {b * 1e6:8.3f} us ({by}){shown_route}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default=None, help="cpu to run the plain versions on the CPU")
    args = p.parse_args(argv)
    run(args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
