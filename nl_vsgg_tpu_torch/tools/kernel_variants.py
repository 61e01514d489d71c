"""Ablations of the port's staged tensor-core kernels on the card: each
kernel beside copies of its source with one thing changed, built with nvcc
and timed on the same inputs in one process, so that the differences say
where a kernel's time goes.

    python -m nl_vsgg_tpu_torch.tools.kernel_variants [--iters N]

Variants are text edits of the committed sources (`VARIANTS`); a variant
that leaves out work computes a wrong result and is timed only:

  probe_matmul (M, 128) @ (128, 128) bf16, M = 1, 1000, 5000, 20480:
    kernel        the committed kernel
    stages-8      an 8-stage cp.async ring in place of 4
    no-w-load     w is not read: the block's time without w's L2 reads
    no-mma        the products left out
    no-store      the results not stored
  grouped_conv3x3 bf16 at the detector's four classes (the path's N):
    kernel        the committed kernel
    stages-3      a 3-stage input ring in place of 2 (c = 64 does not fit)

Each row prints device us (or ms) a call, two-point differenced with the
card kept busy while the host queues the calls (`tools.timing`), beside
`torch.matmul` or cuDNN's grouped conv on the same inputs. It needs a GPU
and nvcc, and raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import _build, grouped_conv as gc
from . import timing

MM_ROWS = (1, 1000, 5000, 20480)
CONV_SHAPES = ((32, 152, 256, 256), (32, 76, 128, 512), (32, 38, 64, 1024), (9600, 7, 7, 2048))


def _stages(n):
    return lambda s: re.sub(r"constexpr int STAGES = \d+;", f"constexpr int STAGES = {n};", s)


VARIANTS = {
    "probe_matmul": {
        "kernel": lambda s: s,
        "stages-8": _stages(8),
        "no-w-load": lambda s: s.replace(
            "cp_async16(w_s + k * PS + v * 8, w + k * KN + v * 8, true);", ""),
        "no-mma": lambda s: re.sub(r"mma_bf16_16816\(acc\[ni\], a,[^;]*;",
                                   'asm volatile("" :: "r"(a[0]));', s),
        "no-store": lambda s: s.replace("if (row < M)", "if (row < M && acc[0][0] == 1234.5f)"),
    },
    "grouped_conv": {
        "kernel": lambda s: s,
        "stages-3": _stages(3),
    },
}


def variant_sources(name: str) -> dict[str, str]:
    """The edited source text of each variant of `csrc/<name>.cu`; raises
    when an edit no longer applies to the committed source."""
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        src = f.read()
    out = {}
    for key, edit in VARIANTS[name].items():
        text = edit(src)
        if key != "kernel" and text == src:
            raise RuntimeError(f"variant {key} of {name}.cu no longer applies to the source")
        out[key] = text
    return out


def build(name: str) -> dict[str, ctypes.CDLL]:
    """Every variant of `csrc/<name>.cu`, one nvcc each, all at once, into
    `build/torch_kernels/variants/`."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for key, text in variant_sources(name).items():
        digest = hashlib.sha256(text.encode()).hexdigest()[:12]
        base = os.path.join(out_dir, f"{name}-{key}-{digest}")
        with open(base + ".cu", "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", base + ".so",
               base + ".cu"]
        jobs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), base + ".so")
    libs = {}
    for key, (proc, so) in jobs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} variant {key} failed to build:\n{report}")
        libs[key] = ctypes.CDLL(so)
    return libs


def run(iters: int = 20, device=None, log=print) -> list[dict]:
    """Build and time every variant; print one line a row and variant and
    return them (device seconds a call)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_variants times kernels on the GPU")
    torch.manual_seed(0)
    clock = timing.cuda_clock
    stream = torch.cuda.current_stream().cuda_stream
    sms = _build.sm_count(dev)
    rng = np.random.default_rng(0)
    P, I = ctypes.c_void_p, ctypes.c_int
    rows = []

    def put(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    def add(what, key, t, unit):
        rows.append({"row": what, "variant": key, "device_s": t})
        scale = 1e6 if unit == "us" else 1e3
        log(f"  {what:34s} {key:10s} {t * scale:10.3f} {unit}")

    mm = build("probe_matmul")
    w = put(rng.standard_normal((128, 128)) * 0.05)
    for M in MM_ROWS:
        x = put(rng.standard_normal((M, 128)))
        y = torch.empty_like(x)
        blocks = min(-(-M // 32), sms)
        add(f"mm ({M}, 128)", "torch", timing.timed_delta(lambda: torch.matmul(x, w), iters,
                                                          clock).device_s, "us")
        for key, lib in mm.items():
            fn = lib.probe_matmul
            fn.argtypes, fn.restype = [P, P, P, I, I, P], ctypes.c_int

            def call(fn=fn, key=key):
                if fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, blocks, stream):
                    raise RuntimeError(f"probe_matmul variant {key} failed to launch")
            add(f"mm ({M}, 128)", key, timing.timed_delta(call, iters, clock).device_s, "us")

    conv = build("grouped_conv")
    for N, H, W, C in CONV_SHAPES:
        c = C // 32
        x = torch.randn(N, H, W, C, device=dev, dtype=torch.bfloat16)
        wc = (torch.randn(3, 3, c, C, device=dev) * (9 * c) ** -0.5).bfloat16()
        b = torch.randn(C, device=dev)
        y = torch.empty_like(x)
        plan = gc.tile_plan(N, H, W, C, c, sms)
        what = f"grouped conv {(N, H, W, C)} c={c}"
        xl = x.permute(0, 3, 1, 2)
        wl = wc.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bl = b.bfloat16()
        add(what, "cuDNN", timing.timed_delta(
            lambda: F.conv2d(xl, wl, bl, padding=1, groups=32), max(1, iters // 4),
            clock).device_s, "ms")
        for key, lib in conv.items():
            fn = lib.grouped_conv3x3
            fn.argtypes, fn.restype = [I, I, P, P, P, P] + [I] * 10 + [P], ctypes.c_int
            args = (1, 1, x.data_ptr(), wc.data_ptr(), b.data_ptr(), y.data_ptr(), N, H, W, C,
                    c, 1, plan["TH"], plan["TW"], plan["NB"], plan["per_slab"], stream)
            if fn(*args):
                log(f"  {what:34s} {key:10s}  does not fit a block's shared memory")
                continue

            def call(fn=fn, args=args, key=key):
                if fn(*args):
                    raise RuntimeError(f"grouped_conv3x3 variant {key} failed to launch")
            add(what, key, timing.timed_delta(call, max(1, iters // 4), clock).device_s, "ms")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card or 'not read'}")
    run(args.iters)


if __name__ == "__main__":
    main()
