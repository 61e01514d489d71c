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
  roi_align at the detector path's inputs: a (32, 38, 64, 1024) bf16 C4
  map, 300 random rois a frame in frame order, 14x14, S = 2, bf16 out:
    kernel        the committed kernel
    no-load       the map's taps not read (a value made from the address)
    no-store      the crops not stored
    threads-128   128 threads a block in place of 256
    taps-8        8 taps a column bin in registers at S = 2 (as at S = 4)
    min-blocks-2  2 blocks an SM asked of the compiler in place of 3
    min-blocks-4  4 (64 registers a thread)
  masked_mha_bwd_dq at the train step's four shapes (B = 64, H = 8, D =
  242, bf16, q/k/v column blocks of a fused projection, 3% of pairs
  allowed at random, dropout 0.1), summed over the four, on the staged
  route the wrapper picks (and the per-element route where named):
    kernel          the committed kernel, both routes
    no-kv-load      the staged route's k and v copies zero-filled, not read
    stages-1        a ring of one chunk: no chunk in flight during a walk
    min-blocks-2    2 blocks an SM asked of the compiler in place of 3
    no-walk         the walk over the listed keys left out (copies kept)
    no-mask         no key allowed (the mask read, no key copied)
    no-second-walk  the per-element route without its second walk (the dQ
                    sum; r only): what the two-walk design paid

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

P, I = ctypes.c_void_p, ctypes.c_int
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
    "roi_align": {
        "kernel": lambda s: s,
        "no-load": lambda s: s.replace(
            "const uint4 u = *reinterpret_cast<const uint4*>(p);",
            "const uint4 u = make_uint4((unsigned)(size_t)p, 0u, 0u, 0u);"),
        "no-store": lambda s: s.replace(
            "*reinterpret_cast<uint4*>(p) = u;",
            "if (u.x == 0x7fc17fc1u) *reinterpret_cast<uint4*>(p) = u;"),
        "threads-128": lambda s: s.replace("constexpr int THREADS = 256;",
                                           "constexpr int THREADS = 128;"),
        "taps-8": lambda s: s.replace("if (vec && S <= 2)", "if (vec && S <= 0)"),
        "min-blocks-2": lambda s: s.replace("MIN_BLOCKS = 3;", "MIN_BLOCKS = 2;"),
        "min-blocks-4": lambda s: s.replace("MIN_BLOCKS = 3;", "MIN_BLOCKS = 4;"),
    },
    "masked_attention": {
        "kernel": lambda s: s,
        "no-kv-load": lambda s: s.replace(
            "kb + key * a.k_sl + 8 * piece, true);", "kb + key * a.k_sl + 8 * piece, false);"
        ).replace("vb + key * a.v_sl + 8 * piece, true);", "vb + key * a.v_sl + 8 * piece, false);"),
        "stages-1": _stages(1),
        "min-blocks-2": lambda s: s.replace("DQ_MIN_BLOCKS = 3;", "DQ_MIN_BLOCKS = 2;"),
        "no-walk": lambda s: s.replace("if (h < a.H) {\n      const __nv_bfloat16* st = ring",
                                       "if (h < 0) {\n      const __nv_bfloat16* st = ring"),
        "no-mask": lambda s: s.replace("const bool on = kj < a.Lk && arow[kj];",
                                       "const bool on = kj < a.Lk && arow[kj] == 7;"),
        "no-second-walk": lambda s: s.replace("for (int pass = 0; pass < 2; ++pass)",
                                              "for (int pass = 0; pass < 1; ++pass)"),
    },
}
# the dQ routes each masked_attention variant is timed on
DQ_ROUTES = {"kernel": ("staged", "per-element"), "no-second-walk": ("per-element",)}
ROI_MAP, ROIS_PER_FRAME, ROI_OUT = (32, 38, 64, 1024), 300, (14, 14)
DQ_SHAPES = ((96, 96), (192, 192), (192, 192), (96, 192))   # (Lq, Lk), one train step
DQ_B, DQ_H, DQ_D, DQ_DENSITY, DQ_RATE = 64, 8, 242, 0.03, 0.1


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


def run(iters: int = 20, device=None, log=print, kernels=tuple(VARIANTS)) -> list[dict]:
    """Build and time every variant of the named sources; print one line a
    row and variant and return them (device seconds a call)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("kernel_variants times kernels on the GPU")
    torch.manual_seed(0)
    clock = timing.cuda_clock
    stream = torch.cuda.current_stream().cuda_stream
    sms = _build.sm_count(dev)
    rng = np.random.default_rng(0)
    rows = []

    def put(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(device=dev, dtype=dtype)

    def add(what, key, t, unit):
        rows.append({"row": what, "variant": key, "device_s": t})
        scale = 1e6 if unit == "us" else 1e3
        log(f"  {what:34s} {key:26s} {t * scale:10.3f} {unit}")

    if "probe_matmul" in kernels:
        _run_mm(put, add, rng, iters, clock, stream, sms)
    if "grouped_conv" in kernels:
        _run_conv(add, dev, iters, clock, stream, sms)
    if "roi_align" in kernels:
        _run_roi_align(add, dev, iters, clock, stream)
    if "masked_attention" in kernels:
        _run_dq(add, dev, iters, clock, stream)
    return rows


def _run_mm(put, add, rng, iters, clock, stream, sms):
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



def _run_conv(add, dev, iters, clock, stream, sms):
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


def path_like_rois(n_frames, per_frame, H, W, dev, seed=0):
    """(rois (R, 4), frame_idx (R,)) in frame order: random boxes 8-408 px
    wide and tall on an (H, W) map at stride 16, as chip_smoke.py draws."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xy = torch.rand(n_frames * per_frame, 2, generator=g, device=dev) * torch.tensor(
        [W * 16.0, H * 16.0], device=dev)
    wh = 8 + torch.rand(n_frames * per_frame, 2, generator=g, device=dev) * 400
    fidx = torch.arange(n_frames, device=dev, dtype=torch.int32).repeat_interleave(per_frame)
    return torch.cat([xy - 20, xy + wh], 1), fidx


def _run_roi_align(add, dev, iters, clock, stream):
    libs = build("roi_align")
    F_, H, W, C = ROI_MAP
    fmap = torch.randn(F_, H, W, C, device=dev).bfloat16()
    rois, fidx = path_like_rois(F_, ROIS_PER_FRAME, H, W, dev)
    R, (ph, pw) = rois.shape[0], ROI_OUT
    out = torch.empty(R, ph, pw, C, device=dev, dtype=torch.bfloat16)
    nbytes = fmap.numel() * 2 + R * 5 * 4 + out.numel() * 2
    bound, by = timing.bound_s(nbytes, 8.0 * 4 * out.numel(), torch.float32)
    what = f"roi_align {ROI_MAP} x {R} rois"
    add(what, f"bound ({by})", bound, "ms")
    for key, lib in libs.items():
        fn = lib.roi_align
        fn.argtypes, fn.restype = [I, I, P, P, P, P] + [I] * 7 + [ctypes.c_float, I, P], I
        args = (1, 1, fmap.data_ptr(), rois.data_ptr(), fidx.data_ptr(), out.data_ptr(), R, F_,
                H, W, C, ph, pw, 1.0 / 16, 2, stream)

        def call(fn=fn, args=args, key=key):
            if fn(*args):
                raise RuntimeError(f"roi_align variant {key} failed to launch")
        add(what, key, timing.timed_delta(call, max(1, iters // 4), clock).device_s, "ms")


def dq_inputs(lq, lk, dev, seed=0):
    """One train-step attention call's backward inputs: q, k, v column blocks
    of fused (B, L, 3 H D) projections, g, a random mask, seeds, the
    forward's lse."""
    from ..ops import masked_attention as ma
    g = torch.Generator(device=dev).manual_seed(seed)
    E = DQ_H * DQ_D
    qp = torch.randn(DQ_B, lq, 3 * E, device=dev, generator=g).bfloat16()
    kp = qp if lk == lq else torch.randn(DQ_B, lk, 3 * E, device=dev, generator=g).bfloat16()
    q = qp[..., :E].unflatten(-1, (DQ_H, DQ_D))
    k = kp[..., E:2 * E].unflatten(-1, (DQ_H, DQ_D))
    v = kp[..., 2 * E:].unflatten(-1, (DQ_H, DQ_D))
    gout = torch.randn(DQ_B, lq, DQ_H, DQ_D, device=dev, generator=g).bfloat16()
    allow = torch.rand(DQ_B, lq, lk, device=dev, generator=g) < DQ_DENSITY
    seeds = torch.randint(-2 ** 31, 2 ** 31, (DQ_B,), generator=g, device=dev,
                          dtype=torch.int32)
    scale = DQ_D ** -0.5
    _, lse = ma.masked_mha_forward(q, k, v, allow, scale, DQ_RATE, seeds)
    return q, k, v, gout, allow, seeds, lse, scale


def _run_dq(add, dev, iters, clock, stream):
    from ..ops import masked_attention as ma
    libs = build("masked_attention")
    totals = {}
    for lq, lk in DQ_SHAPES:
        q, k, v, gout, allow, seeds, lse, scale = dq_inputs(lq, lk, dev)
        B, _, H, D = q.shape
        dq = torch.empty(B, lq, H, D, device=dev, dtype=q.dtype)
        r = torch.empty(B, H, lq, device=dev)
        rows_q, rows_k = B * lq * H * D, B * lk * H * D
        nbytes = (3 * rows_q + 2 * rows_k) * 2 + allow.numel() + 2 * B * H * lq * 4
        bound, _ = timing.bound_s(nbytes, 6.0 * H * D * float(allow.sum()), q.dtype)
        totals["bound (bytes)"] = totals.get("bound (bytes)", 0.0) + bound
        if ma.dq_route(q, k, v, gout) != "staged":
            raise RuntimeError("the train shapes no longer take the staged dQ route")
        runs = [(f"{key} {route}", getattr(lib, ma._DQ_ENTRY[route]))
                for key, lib in libs.items() for route in DQ_ROUTES.get(key, ("staged",))]
        for key, fn in runs:
            fn.argtypes = ([I] + [P] * 9 + [I] * 5 + [ctypes.c_longlong] * 8
                           + [ctypes.c_float, ctypes.c_uint32, ctypes.c_float, P])
            fn.restype = I
            args = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(),
                    allow.contiguous().data_ptr(), lse.data_ptr(), seeds.data_ptr(),
                    dq.data_ptr(), r.data_ptr(), B, lq, lk, H, D, q.stride(0), q.stride(1),
                    k.stride(0), k.stride(1), v.stride(0), v.stride(1), gout.stride(0),
                    gout.stride(1), scale, ma.drop_threshold(DQ_RATE), 1.0 / (1.0 - DQ_RATE),
                    stream)

            def call(fn=fn, args=args, key=key):
                if fn(*args):
                    raise RuntimeError(f"masked_mha_bwd_dq variant {key} failed to launch")
            t = timing.timed_delta(call, iters, clock).device_s
            add(f"bwd dQ {lq}x{lk}", key, t, "ms")
            totals[key] = totals.get(key, 0.0) + t
    for key, t in totals.items():
        add("bwd dQ, the 4 calls of a step", key, t, "ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS), default=sorted(VARIANTS),
                    help="the sources whose variants to time (default: all)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card or 'not read'}")
    run(args.iters, kernels=args.only)


if __name__ == "__main__":
    main()
