"""Ablation probe of the packed grouped 3x3 conv on the tensor cores: which
part bounds it, the products, the shifted taps or the memory traffic.

    python -m nl_vsgg_tpu_torch.tools.probe_ablate [--iters N] [--device cpu]

Port of tools/probe_pallas_ablate.py at its stage-4 geometry: x (8, 40, 64,
1024) bf16 (the (8, 38, 64, 1024) C4 map with 2 halo rows), packed weights
(3, 3, 128, 1024), 128-channel super-groups, fp32 sums, inputs drawn from
np.random.default_rng(0) as the probe draws them. The variants (`full`,
`mm-only`, `mm1-only`, `add-only`, and `bt-full`, `bt-mm1` in the
block-major layout) are defined in `nl_vsgg_tpu_torch.ops.grouped_conv_ablate`.
The probe's sweep over images a grid step becomes a sweep over the
kernel's tile of output rows (each kernel row prints the route it took,
`grouped_conv_ablate.kernel_plan`); the block-major rows time the kernel
on inputs laid out once beforehand. Beside them, at the same geometry:

  row5-conv(g32)  the detector's grouped conv kernel (csrc/grouped_conv.cu)
                  on the (8, 38, 64, 1024) map with unpacked c = 32 weights;
  cudnn(g32)      cuDNN's F.conv2d at groups 32 on the same input;
  cudnn(g8)       cuDNN's F.conv2d at groups 8 with the probe's weights on x:
                  the same function as `full`, its library row.

Each row prints the device ms per call (CUDA events, two-point
differenced), the stored-tap rate of the probe (`useful_mxu`: 9 x 2 x N x
(H + 2) x W x 128 x C operations over the time) and its share of the bf16
peak, and the least time the card could take for the row's own work. The
geometry is an argument of `run` (the CLI keeps the probe's). Without
`--device cpu` it runs on the GPU or raises; on the CPU it runs the plain
versions and prints host times. No row's failure is caught.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import grouped_conv as gc, grouped_conv_ablate as ga
from . import timing

TILE_ROWS = (2, 3, 4)   # output rows a tile: 128, 192 and 256 pixels at W = 64


def run(iters: int = 20, device=None, N: int = 8, H: int = 38, W: int = 64, C: int = 1024,
        tile_rows=TILE_ROWS, log=print) -> list[dict]:
    """Time every variant at every tile size, then the rows beside them;
    print one line each and return them."""
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    clock = timing.cuda_clock if on_gpu else timing.wall_clock
    cb, nb = ga.CB, C // ga.CB
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=torch.bfloat16)

    x = put(rng.standard_normal((N, H + 2, W, C)))
    w = put(rng.standard_normal((3, 3, cb, C)) * 0.05)
    w5 = put(rng.standard_normal((3, 3, 32, C)) * (9 * 32) ** -0.5)
    xt, wt = ga.to_block_major(x, w)
    c4 = x[:, 1:H + 1].contiguous()
    x_nchw, c4_nchw = x.permute(0, 3, 1, 2), c4.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    w5_oihw = w5.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    useful_mxu = 9 * 2.0 * N * (H + 2) * W * cb * C   # the probe's stored-tap operations
    el, out_b = 2, N * H * W * C * 2
    x_rows = N * W * C * el                            # bytes of one row of every image
    tap_b = cb * C * el                                # bytes of one tap's weights
    prod = 2.0 * N * H * W * C * cb                    # operations of one tap product

    def work(variant):
        """(bytes, operations) the variant's function needs."""
        v = variant.removeprefix("bt-")
        if v == "full":
            return (H + 2) * x_rows + 9 * tap_b + out_b, 9 * prod
        if v == "mm-only":
            return H * x_rows + 9 * tap_b + out_b, 9 * prod
        if v in ("mm1-only", "mm1"):
            return H * x_rows + tap_b + out_b, prod
        return out_b, 0.0                              # add-only: the output alone

    # (label, kernel, call, (bytes, operations), route on the card)
    rows = []
    for th in tile_rows:
        route = ga.route(x, th) if on_gpu else None
        for v in ga.VARIANTS:
            rows.append((f"{v} rows{th}", "grouped_conv_ablate",
                         lambda v=v, th=th: ga.grouped_conv_ablate(x, w, v, th), work(v), route))
        route = ga.route(xt, th, block_major=True) if on_gpu else None
        for v in ga.BT_VARIANTS:
            rows.append((f"{v} rows{th}", "grouped_conv_ablate_bt",
                         lambda v=v, th=th: ga.grouped_conv_ablate_bt(xt, wt, v, th), work(v),
                         route))
    g5 = C // 32
    row5_work = (2 * c4.numel() * el + w5.numel() * el, 2.0 * c4.numel() * 9 * 32)
    rows += [
        (f"row5-conv(g{g5})", "grouped_conv3x3", lambda: gc.grouped_conv3x3(c4, w5, g5),
         row5_work, None),
        (f"cudnn(g{g5})", None, lambda: F.conv2d(c4_nchw, w5_oihw, padding=1, groups=g5),
         row5_work, None),
        (f"cudnn(g{nb})", None, lambda: F.conv2d(x_nchw, w_oihw, padding=(0, 1), groups=nb),
         work("full"), None),
    ]
    name = torch.cuda.get_device_name(dev) if on_gpu else "cpu (plain versions)"
    log(f"# probe_ablate on {name}: x {tuple(x.shape)} bf16, w {tuple(w.shape)}, out "
        f"({N}, {H}, {W}, {C}), iters={iters}")
    out = []
    for label, kernel, fn, (nbytes, ops), route in rows:
        t = timing.timed_delta(fn, iters, clock)
        b, by = timing.bound_s(nbytes, ops, torch.bfloat16)
        row = dict(name=label, kernel=kernel if on_gpu else None, calls=t.calls,
                   host_ms=t.host_s * 1e3, bound_ms=b * 1e3, bound_by=by, device_ms=None,
                   rate=None, route=route)
        shown_route = f"  route {route}" if route else ""
        if t.device_s is None:
            log(f"  {label:20s} host {t.host_s * 1e3:9.4f} ms/call (cpu; device not measured)"
                f"  bound {b * 1e3:7.4f} ms ({by}){shown_route}")
        else:
            row.update(device_ms=t.device_s * 1e3, rate=useful_mxu / t.device_s / 1e12)
            log(f"  {label:20s} {row['device_ms']:9.4f} ms  ({row['rate']:7.1f} T/s stored-tap"
                f" rate, {row['rate'] * 1e12 / timing.PEAK_OPS[torch.bfloat16] * 100:5.1f}% of "
                f"bf16 peak)  host {row['host_ms'] * 1e3:8.2f} us/call  bound "
                f"{b * 1e3:7.4f} ms ({by}){shown_route}")
        out.append(row)
    if on_gpu:
        full = min((r for r in out if r["name"].startswith("full ")),
                   key=lambda r: r["device_ms"])
        by_name = {r["name"]: r["device_ms"] for r in out}
        log(f"# full at its best tile ({full['name']}): {full['device_ms']:.4f} ms; "
            f"row 5 {by_name[f'row5-conv(g{g5})']:.4f} ms, cuDNN g{g5} "
            f"{by_name[f'cudnn(g{g5})']:.4f} ms, cuDNN g{nb} {by_name[f'cudnn(g{nb})']:.4f} ms")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default=None, help="cpu to run the plain versions on the CPU")
    args = p.parse_args(argv)
    run(args.iters, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
