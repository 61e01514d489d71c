"""Ablations of the port's staged kernels on the card: each
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
  grouped_conv3x3 at the detector's four classes (the path's N), bf16
  beside cuDNN, and float32 beside cuDNN with TF32 off (the same function
  at the same accuracy) and on (PyTorch's default for convolutions, about
  3 digits) and beside the first kernel (route "fma", its own C entry):
    kernel        the committed kernel ("tc" for bf16, "3xtf32" for float32)
    stages-3      a 3-stage input ring in place of 2 (c = 64 does not fit)
    tf32-no-mma   float32: the products left out (fragments loaded and split)
    tf32-1x       float32: one TF32 mma a product in place of three (its
                  numbers keep about 3 digits: timed only; an edit of
                  csrc/mma_tf32.cuh, inlined in the variant)
    tf32-1x-call  the same product left, by an edit of the kernel's call
                  in place of the header
    tf32-taps-unrolled  float32: the 9 taps unrolled at c = 64 too (the
                  kernel loops over them there)
    tf32-taps-loop      float32: a loop over the taps at every c (the
                  kernel unrolls them at c <= 32)
  probe_copy at the launch-overhead probe's rows (tiny-copy (256, 128)
  fp32 as 1 unit, slab-copy (8, 40, 64, 128) bf16 as 1 unit, slab-copy-g8
  the same as 8 units), beside `x * 2`:
    kernel        the committed kernel at its plan's blocks a unit; also
                  at 1 block a unit (the TPU's grid, one block a grid
                  step) and at twice the plan's (the blocks-per-unit rows
                  are launch arguments, not text edits)
    depth-1       one 16-byte load in flight a thread in place of 2
    depth-4       four
    depth-8       eight
    bulk          1-D bulk async copies (cp.async.bulk, an mbarrier ring)
                  in place of the loads
    threads-128   128 threads a block in place of 256
    empty         the kernel returns at once: the launch alone
    idx64         64-bit indices where 32 bits would do
  grouped_conv_ablate bf16 at the ablation probe's geometry ((8, 40, 64,
  1024) x, 128-channel super-groups), `full` on the ring route at 2, 3 and
  4 rows a tile and `bt-full` at 4, beside cuDNN's groups-8 conv:
    kernel        the committed kernel
    stages-2      2 tap weight slots where 3 fit (4 rows: 2 either way)
    w-resident    each weight slot copied once and kept: what streaming the
                  taps' weights costs
    no-w-load     no weight copies at all
    no-x-load     no input row copies
    no-mma        the products left out (the A fragments still loaded)
    no-a-load     the A fragments made from their address, not loaded
    no-store      the tile's output not stored (staged in shared memory)
    tile-body     the ring's launches run the first design's body (one
                  tile a block, rows staged twice, taps into one buffer,
                  mma.sync)
  A variant without its copies computes on stale shared memory and is
  timed only; the products' power, and so the clocks, may differ on such
  data, so a difference is an estimate of the left-out part's share.
  roi_align at the detector path's inputs: a (32, 38, 64, 1024) bf16 C4
  map, 300 random rois a frame in frame order, 14x14, S = 2, bf16 out:
    kernel        the committed kernel
    no-load       the map's taps not read (a value made from the address)
    no-store      the crops not stored
    threads-128   128 threads a block in place of 256
    taps-8        8 taps a column bin in registers at S = 2 (as at S = 4)
    min-blocks-2  2 blocks an SM asked of the compiler in place of 3
    min-blocks-4  4 (64 registers a thread)
  masked_attention at the train step's four shapes (B = 64, H = 8, D =
  242, bf16, q/k/v column blocks of a fused projection, dropout 0.1), each
  kernel summed over the four calls. dQ on random 3% masks; the forward
  (train: lse and dropout; eval beside it) and dK/dV on two mask sets,
  path-like (`path_masks`: a synthetic batch's frames and windows, as
  models/sttran.py builds them) and random 3%. Each variant is timed on
  the staged route of the kernels it edits; the committed kernel also on
  the per-element route (the first kernels):
    kernel          the committed kernels
    no-kv-load      dQ: the keys' k and v copies zero-filled, not read
    no-chunk-load   forward and dK/dV: the listed rows' copies zero-filled
    stages-1        every ring one chunk deep: no chunk in flight during a walk
    stages-3        forward and dK/dV: rings 3 chunks deep
    stages-4        forward and dK/dV: rings 4 chunks deep
    min-blocks-2    dQ: 2 blocks an SM asked of the compiler in place of 3
    fewer-blocks    forward and dK/dV: 2 blocks an SM in place of 3
    more-blocks     forward and dK/dV: 4 blocks an SM
    heads-4         forward and dK/dV: 4 heads a block in place of 2
    parts-swap      the forward 2 warps a head in place of 4 (4 blocks an SM),
                    dK/dV 4 in place of 2 (2 blocks an SM)
    no-walk         the walk over the listed rows left out (copies kept)
    no-list         forward and dK/dV: nothing listed (mask read, tile
                    copied, zeros stored)
    no-mask         dQ: no key allowed (the mask read, no key copied)
    no-second-walk  the per-element dQ route without its second walk (the
                    dQ sum; r only): what the two-walk design paid
  and the tiled route at the sgcls tracklet encoder's shapes (64 x 128
  boxes, 8 float32 heads of 297, 4 tracklets a video; `tracklet_inputs`):
  the forward (train and eval), dQ and dK/dV, each variant's C entry on a
  row order made once, the committed kernel also on the per-element
  entries, then the wrappers (their row order included) and `row_order`
  alone:
    tiled-stages-2       the ring two chunks deep (a chunk's copy in flight
                         during a walk, fewer blocks an SM)
    tiled-no-load        every window copy zero-filled, not read (the
                         tile's rows and the staged columns)
    tiled-no-walk        the products over the staged columns left out
    tiled-no-list        nothing listed (the mask read, rows loaded, zeros
                         stored)
    tiled-fewer-blocks   3 forward and 2 backward blocks an SM asked of the
                         compiler in place of 5 and 3
    tiled-1xtf32         one TF32 mma a product in place of three (its
                         numbers keep about 3 digits: timed only; an edit
                         of csrc/mma_tf32.cuh, inlined in the variant)
  and the resident forward at CLIP's towers' shapes (`clip_inputs`: the
  image tower's (32, 50, 12, 64) with every pair allowed, the text
  tower's (3, 77, 8, 64) causal; float32 column blocks of a fused
  projection), the eval forward's C entry, the committed kernel also on
  the per-element entry and (8 heads) the tiled one on a row order made
  once, then the wrapper and SDPA on the same inputs:
    resident-no-load     every k, v and q copy zero-filled, not read
    resident-no-walk     the products (S = Q K^T, P V) left out
    resident-no-mask     the allow bytes not read (every key allowed)
    tiled-1xtf32         as above: what 3xTF32 costs the resident route

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


def _edits(*pairs):
    """A variant made of literal text edits (old, new), every one of which
    must apply to the source (`pairs` keeps them for the tests)."""
    def edit(src):
        for old, new in pairs:
            if old not in src:
                raise RuntimeError(f"the edit of {old!r} no longer applies to the source")
            src = src.replace(old, new)
        return src
    edit.pairs = pairs
    return edit


def _header_edits(header, *pairs):
    """A variant made of literal text edits of a `csrc/` header the source
    includes, inlined in place of its #include (`header` and `pairs` kept
    for the tests)."""
    def edit(src):
        include = f'#include "{header}"'
        if include not in src:
            raise RuntimeError(f"the source no longer includes {header}")
        with open(os.path.join(_build.CSRC, header)) as f:
            return src.replace(include, _edits(*pairs)(f.read()))
    edit.header, edit.pairs = header, pairs
    return edit


ONE_TF32 = _header_edits(   # one TF32 mma a product (about 3 digits): what 3x costs
    "mma_tf32.cuh", ("  mma_tf32(d, al, bh0, bh1);\n  mma_tf32(d, ah, bl0, bl1);\n", ""))

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
        "tf32-no-mma": _edits(
            ("mma_3xtf32_parts(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);",
             'asm volatile("" :: "r"(ah[mi][0]), "r"(al[mi][3]), "r"(bh0), "r"(bl1));')),
        "tf32-1x": ONE_TF32,
        "tf32-1x-call": _edits(
            ("mma_3xtf32_parts(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);",
             "mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);")),
        "tf32-taps-unrolled": _edits(("constexpr int TAP_UNROLL = CG == 64 ? 1 : 9;",
                                      "constexpr int TAP_UNROLL = 9;")),
        "tf32-taps-loop": _edits(("constexpr int TAP_UNROLL = CG == 64 ? 1 : 9;",
                                  "constexpr int TAP_UNROLL = 1;")),
    },
    "probe_copy": {
        "kernel": lambda s: s,
        "depth-1": _edits(("constexpr int DEPTH = 2;", "constexpr int DEPTH = 1;")),
        "depth-4": _edits(("constexpr int DEPTH = 2;", "constexpr int DEPTH = 4;")),
        "depth-8": _edits(("constexpr int DEPTH = 2;", "constexpr int DEPTH = 8;")),
        "bulk": _edits(("constexpr bool BULK = false;", "constexpr bool BULK = true;")),
        "threads-128": _edits(("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")),
        "empty": _edits(("  const Idx v0 = per * (Idx)blockIdx.y, v1 = min(nvec, v0 + per);\n",
                         "  const Idx v0 = per * (Idx)blockIdx.y, v1 = min(nvec, v0 + per);\n"
                         "  if (v0 >= 0) return;\n")),
        "idx64": _edits(("if (n + (long long)(DEPTH + 1)", "if (false && n + (long long)(DEPTH + 1)")),
    },
    "grouped_conv_ablate": {
        "kernel": lambda s: s,
        "stages-2": _edits(("constexpr int MAX_W_STAGES = 3;", "constexpr int MAX_W_STAGES = 2;")),
        "w-resident": _edits(("constexpr int W_LOADS = 2;", "constexpr int W_LOADS = 1;")),
        "no-w-load": _edits(("constexpr int W_LOADS = 2;", "constexpr int W_LOADS = 0;")),
        "no-x-load": _edits(("constexpr bool X_LOADS = true;", "constexpr bool X_LOADS = false;")),
        "no-mma": _edits(("wgmma_64x128x16(acc, a[ks], b_desc(wslot + ks * 2048));",
                          'asm volatile("" :: "r"(a[ks][0]), "r"(a[ks][3]));')),
        "no-a-load": _edits((
            "ldsm_x4(a[ks], pix + kh * half_stride + swz(key, (2 * ks + a_hi) & 7));",
            "a[ks][0] = a[ks][1] = a[ks][2] = a[ks][3] = pix + ks;")),
        "no-store": _edits(("        *reinterpret_cast<uint4*>(out + base + v * 8) = ",
                            "        if (v == 99) *reinterpret_cast<uint4*>(out + base + v * 8) = ")),
        "tile-body": _edits(("constexpr bool RING_BODY = true;",
                             "constexpr bool RING_BODY = false;")),
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
        "no-kv-load": _edits(   # dQ and forward: the keys' k and v copies
            ("kb + key * a.k_sl + 8 * piece, true);", "kb + key * a.k_sl + 8 * piece, false);"),
            ("vb + key * a.v_sl + 8 * piece, true);", "vb + key * a.v_sl + 8 * piece, false);")),
        "no-chunk-load": _edits(   # forward and dK/dV: the listed rows' copies
            ("cp_async16(dst + j * ld + e, xs + e, in);",
             "cp_async16(dst + j * ld + e, xs + e, false);"),
            ("cp_async16(dst + (CK + j) * ld + e, ys + e, in);",
             "cp_async16(dst + (CK + j) * ld + e, ys + e, false);")),
        "stages-1": _edits(("constexpr int STAGES = 2;", "constexpr int STAGES = 1;"),
                           ("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 1;"),
                           ("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 1;")),
        "min-blocks-2": _edits(("DQ_MIN_BLOCKS = 3;", "DQ_MIN_BLOCKS = 2;")),
        "stages-3": _edits(("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 3;"),
                           ("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 3;")),
        "stages-4": _edits(("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 4;"),
                           ("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 4;")),
        "fewer-blocks": _edits(("FWD_MIN_BLOCKS = 3;", "FWD_MIN_BLOCKS = 2;"),
                               ("DKV_STAGED_MIN_BLOCKS = 3;", "DKV_STAGED_MIN_BLOCKS = 2;")),
        "more-blocks": _edits(("FWD_MIN_BLOCKS = 3;", "FWD_MIN_BLOCKS = 4;"),
                              ("DKV_STAGED_MIN_BLOCKS = 3;", "DKV_STAGED_MIN_BLOCKS = 4;")),
        "heads-4": _edits(("constexpr int HG = 2;", "constexpr int HG = 4;")),
        "parts-swap": _edits(("constexpr int FWD_PARTS = 4;", "constexpr int FWD_PARTS = 2;"),
                             ("constexpr int DKV_PARTS = 2;", "constexpr int DKV_PARTS = 4;"),
                             ("FWD_MIN_BLOCKS = 3;", "FWD_MIN_BLOCKS = 4;"),
                             ("DKV_STAGED_MIN_BLOCKS = 3;", "DKV_STAGED_MIN_BLOCKS = 2;")),
        "no-walk": _edits(
            ("if (h < a.H) {\n      const __nv_bfloat16* st = ring",
             "if (h < 0) {\n      const __nv_bfloat16* st = ring"),
            ("if (live) {\n      // this warp's k-steps of S:", "if (false) {\n      // this warp's k-steps of S:"),
            ("if (live) {\n      float s[4] = {0.f, 0.f, 0.f, 0.f};  // the head's S",
             "if (false) {\n      float s[4] = {0.f, 0.f, 0.f, 0.f};  // the head's S"),
            ("if (live) {\n      // this warp's k-steps of S^T", "if (false) {\n      // this warp's k-steps of S^T"),
            ("if (live) {\n      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4]",
             "if (false) {\n      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4]")),
        "no-list": _edits(   # forward and dK/dV: no row allowed (the mask read, nothing listed)
            ("          if (r < nrows) bits |= (arow", "          if (r < 0) bits |= (arow"),
            ("          if (r < nrows) bits |= (acol", "          if (r < 0) bits |= (acol")),
        "no-mask": _edits(("[&](int kj) { return (unsigned)arow[kj]; }",
                           "[&](int kj) { return (unsigned)(arow[kj] == 7); }")),
        "no-second-walk": _edits(("for (int pass = 0; pass < 2; ++pass)",
                                  "for (int pass = 0; pass < 1; ++pass)")),
        "tiled-stages-2": _edits(("constexpr int TSTAGES = 1;", "constexpr int TSTAGES = 2;")),
        "tiled-no-load": _edits(   # every window copy zero-filled, not read
            ("cp_async16(dst + j * ld + e, src + e, in);",
             "cp_async16(dst + j * ld + e, src + e, false);")),
        "tiled-no-walk": _edits(   # the products over the staged columns left out
            ("for (int ks = part; ks < KS; ks += TPARTS)",
             "for (int ks = part; ks < 0; ks += TPARTS)"),
            ("      if (nt >= KS) break;\n      const float2 bv",
             "      if (nt >= 0) break;\n      const float2 bv"),
            ("      if (nt >= KS) break;\n      const float2 b1",
             "      if (nt >= 0) break;\n      const float2 b1")),
        "tiled-no-list": _edits(   # nothing listed: the mask read, the rows loaded and stored
            ("    if (rows[t] >= 0) bits |= (mb", "    if (rows[t] < -1) bits |= (mb")),
        "tiled-fewer-blocks": _edits(("FWD_TILED_BLOCKS = 5;", "FWD_TILED_BLOCKS = 3;"),
                                     ("BWD_TILED_BLOCKS = 3;", "BWD_TILED_BLOCKS = 2;")),
        "tiled-1xtf32": ONE_TF32,
        "resident-no-load": _edits(   # every copy zero-filled, not read
            ("cp_async16(vs + j * RS + e, src + e, in);",
             "cp_async16(vs + j * RS + e, src + e, false);")),
        "resident-no-walk": _edits(   # the products left out
            ("for (int kk = 0; kk < KS; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {"),
            ("      if (nd >= KS) break;\n      const float2 bv = chunk_b(vw",
             "      if (nd >= 0) break;\n      const float2 bv = chunk_b(vw")),
        "resident-no-mask": _edits(   # the allow bytes not read: every key allowed
            ("if (key < a.Lk && arow[key]) bits[r]", "if (key < a.Lk) bits[r]")),
    },
}
# the attention kernels each masked_attention variant is timed on, and the
# dQ routes
ATTENTION_KINDS = {"kernel": ("dq", "fwd", "dkv", "resident"), "no-kv-load": ("dq",),
                   "no-chunk-load": ("fwd", "dkv"), "stages-1": ("dq", "fwd", "dkv"),
                   "min-blocks-2": ("dq",), "fewer-blocks": ("fwd", "dkv"),
                   "more-blocks": ("fwd", "dkv"),
                   "stages-3": ("fwd", "dkv"), "stages-4": ("fwd", "dkv"),
                   "heads-4": ("fwd", "dkv"), "parts-swap": ("fwd", "dkv"),
                   "no-walk": ("dq", "fwd", "dkv"), "no-mask": ("dq",), "no-list": ("fwd", "dkv"),
                   "no-second-walk": ("dq",), "tiled-stages-2": ("tiled",),
                   "tiled-no-load": ("tiled",), "tiled-no-walk": ("tiled",),
                   "tiled-no-list": ("tiled",), "tiled-fewer-blocks": ("tiled",),
                   "tiled-1xtf32": ("tiled", "resident"), "resident-no-load": ("resident",),
                   "resident-no-walk": ("resident",), "resident-no-mask": ("resident",)}
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


def spills(report: str) -> list[str]:
    """The kernels of an `nvcc -Xptxas=-v` report that spill to local
    memory, each with its spill line."""
    out, fn = [], None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (int(m.group(1)) or int(m.group(2))):
            out.append(f"{fn}: {line.strip()}")
    return out


def build(name: str, log=print) -> dict[str, ctypes.CDLL]:
    """Every variant of `csrc/<name>.cu`, one nvcc each, all at once, into
    `build/torch_kernels/variants/`; logs each variant's spilling kernels
    from ptxas's report (a variant that spills is timed on local memory)."""
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
        spilled = spills(report)
        log(f"  build {name} {key}: " + ("; ".join(spilled) if spilled else "no spills"))
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
        _run_conv(add, log, dev, iters, clock, stream, sms)
    if "probe_copy" in kernels:
        _run_copy(put, add, rng, iters, clock, stream, sms)
    if "grouped_conv_ablate" in kernels:
        _run_ablate(put, add, rng, iters, clock, stream, sms)
    if "roi_align" in kernels:
        _run_roi_align(add, dev, iters, clock, stream)
    if "masked_attention" in kernels:
        libs = build("masked_attention", log)
        _run_dq(libs, add, dev, iters, clock, stream)
        _run_fwd_dkv(libs, add, log, dev, iters, clock, stream)
        _run_tiled(libs, add, dev, iters, clock, stream)
        _run_resident(libs, add, dev, iters, clock, stream)
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



# the dtypes each grouped_conv variant is timed at (tf32-* edit the 3xtf32 route only)
CONV_DTYPES = {"kernel": ("bf16", "fp32"), "stages-3": ("bf16", "fp32"),
               "tf32-no-mma": ("fp32",), "tf32-1x": ("fp32",), "tf32-1x-call": ("fp32",),
               "tf32-taps-unrolled": ("fp32",),
               "tf32-taps-loop": ("fp32",)}


def _run_conv(add, log, dev, iters, clock, stream, sms):
    conv = build("grouped_conv", log)
    for N, H, W, C in CONV_SHAPES:
        c = C // 32
        x32 = torch.randn(N, H, W, C, device=dev)
        w32 = torch.randn(3, 3, c, C, device=dev) * (9 * c) ** -0.5
        b = torch.randn(C, device=dev)
        for name, dtype, route, plan_fn, n in (
                ("bf16", torch.bfloat16, "tc", gc.tile_plan, max(1, iters // 4)),
                ("fp32", torch.float32, "3xtf32", gc.tf32_plan, max(1, iters // 10))):
            x, wc = x32.to(dtype), w32.to(dtype)
            y = torch.empty_like(x)
            plan = plan_fn(N, H, W, C, c, sms)
            what = f"grouped conv {name} {(N, H, W, C)} c={c}"
            xl = x.permute(0, 3, 1, 2)
            wl = wc.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bl = b.to(dtype)
            for tf32 in ((False, True) if name == "fp32" else (False,)):
                torch.backends.cudnn.allow_tf32 = tf32
                add(what, "cuDNN TF32" if tf32 else "cuDNN", timing.timed_delta(
                    lambda: F.conv2d(xl, wl, bl, padding=1, groups=32), n, clock).device_s,
                    "ms")
            torch.backends.cudnn.allow_tf32 = False
            args = (gc._DTYPES[dtype], x.data_ptr(), wc.data_ptr(), b.data_ptr(), y.data_ptr(),
                    N, H, W, C, c, 1,
                    plan["TH"], plan["TW"], plan["NB"], plan["per_slab"], stream)
            entries = [(key, getattr(lib, f"grouped_conv3x3_{route}"))
                       for key, lib in conv.items() if name in CONV_DTYPES[key]]
            if name == "fp32":
                entries.append(("fma", conv["kernel"].grouped_conv3x3_fma))
            for key, fn in entries:
                fn.argtypes, fn.restype = [I, P, P, P, P] + [I] * 10 + [P], ctypes.c_int
                if fn(*args):
                    log(f"  {what:34s} {key:10s}  does not fit a block's shared memory")
                    continue

                def call(fn=fn, key=key):
                    if fn(*args):
                        raise RuntimeError(f"grouped_conv3x3 variant {key} failed to launch")
                add(what, key, timing.timed_delta(call, n, clock).device_s, "ms")
            del x, wc, y, xl, wl


COPY_ROWS = (("tiny-copy", (256, 128), torch.float32, 1),
             ("slab-copy", (8, 40, 64, 128), torch.bfloat16, 1),
             ("slab-copy-g8", (8, 40, 64, 128), torch.bfloat16, 8))


def _run_copy(put, add, rng, iters, clock, stream, sms):
    from ..ops import probe_copy as pc
    libs = build("probe_copy")
    for what, shape, dtype, units in COPY_ROWS:
        x = put(rng.standard_normal(shape), dtype)
        y = torch.empty_like(x)
        add(what, "x * 2", timing.timed_delta(lambda: x * 2, iters, clock).device_s, "us")
        for key, lib in libs.items():
            fn = lib.probe_copy
            fn.argtypes, fn.restype = [I, P, P, ctypes.c_longlong, ctypes.c_longlong, I, I, P], I
            plan = pc.copy_plan(x.numel(), dtype, units, sms,
                                {"depth-1": 1, "depth-4": 4, "depth-8": 8}.get(key, pc.DEPTH),
                                128 if key == "threads-128" else pc.THREADS)
            per, plan = plan["per_unit"], plan["blocks_per_unit"]
            grids = {key: plan}
            if key == "kernel":
                grids.update({"kernel 1 block a unit": 1, "kernel 2x blocks": 2 * plan})
            for label, bpu in grids.items():
                args = (pc._DTYPES[dtype], x.data_ptr(), y.data_ptr(), x.numel(), per, units,
                        bpu, stream)

                def call(fn=fn, args=args, label=label):
                    if fn(*args):
                        raise RuntimeError(f"probe_copy variant {label} failed to launch")
                add(what, f"{label} ({bpu} a unit)",
                    timing.timed_delta(call, iters, clock).device_s, "us")


ABLATE_GEOMETRY = (8, 38, 64, 1024)   # (N, H, W, C) of the output
ABLATE_ROWS = (("full", 0, 2), ("full", 0, 3), ("full", 0, 4), ("bt-full", 1, 4))


def _run_ablate(put, add, rng, iters, clock, stream, sms):
    from ..ops import grouped_conv_ablate as ga
    libs = build("grouped_conv_ablate")
    N, H, W, C = ABLATE_GEOMETRY
    x = put(rng.standard_normal((N, H + 2, W, C)))
    w = put(rng.standard_normal((3, 3, ga.CB, C)) * 0.05)
    xt, wt = ga.to_block_major(x, w)
    out = torch.empty(N, H, W, C, device=x.device, dtype=x.dtype)
    xl, wl = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    what = f"packed conv {ABLATE_GEOMETRY}"
    add(what, f"cuDNN groups {C // ga.CB}", timing.timed_delta(
        lambda: F.conv2d(xl, wl, padding=(0, 1), groups=C // ga.CB), iters, clock).device_s,
        "ms")
    for key, lib in libs.items():
        fn = lib.grouped_conv_ablate
        fn.argtypes, fn.restype = [I, I, I, I, P, P, P] + [I] * 6 + [P], I
        for variant, bm, th in ABLATE_ROWS:
            plan = ga.kernel_plan(torch.bfloat16, N, H, W, C, th, sms)
            xa, wa = (xt, wt) if bm else (x, w)
            args = (1, ga._CODES[variant], bm, ga._ROUTES[plan["route"]], xa.data_ptr(),
                    wa.data_ptr(), out.data_ptr(), N, H, W, C, th, plan["parts"], stream)
            label = f"{variant} rows{th} {plan['route']}"
            if fn(*args):
                add(what, f"{label} {key}: does not launch (shared memory)", float("nan"), "ms")
                continue

            def call(fn=fn, args=args, key=key):
                if fn(*args):
                    raise RuntimeError(f"grouped_conv_ablate variant {key} failed to launch")
            add(what, f"{label} {key}", timing.timed_delta(call, iters, clock).device_s, "ms")


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


def _run_dq(libs, add, dev, iters, clock, stream):
    from ..ops import masked_attention as ma
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
                for key, lib in libs.items() if "dq" in ATTENTION_KINDS[key]
                for route in DQ_ROUTES.get(key, ("staged",))]
        for key, fn in runs:
            fn.argtypes, fn.restype = ma.entry_argtypes(fn.__name__), I
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


def path_masks(dev, B: int = DQ_B) -> dict:
    """The train step's masks on a synthetic batch (32 frames, 3 relations
    a frame, 96 relation slots), built from its im_idx and rel_mask as
    models/sttran.py builds them: {(96, 96): same frame, (192, 192): same
    window of the duplicated streams, (96, 192): the last decoder layer's
    queries against the windows}."""
    from ..data.entry import stack_entries
    from ..data.synthetic import make_synthetic_entry
    rng = np.random.default_rng(0)
    batch = stack_entries([make_synthetic_entry(rng, n_frames=32, objs_per_frame=3,
                                                bucket_boxes=128, bucket_rels=96, feat_dim=8)
                           for _ in range(B)])
    im, rm = batch.im_idx.to(dev).long(), batch.rel_mask.to(dev)

    def pairs(a, b):
        return a[:, :, None] & b[:, None, :]

    window = torch.cat([im, im - 1], -1)
    last = torch.where(rm, im, 0).amax(-1, keepdim=True) - 1
    valid = torch.cat([rm & (im <= last), rm & (im >= 1)], -1)
    is0 = im == 0
    q_window = torch.where(is0, im, im - 1)
    q_valid = torch.where(is0, rm & (im <= last), rm & (im >= 1))
    return {(96, 96): (im[:, :, None] == im[:, None, :]) & pairs(rm, rm),
            (192, 192): (window[:, :, None] == window[:, None, :]) & pairs(valid, valid),
            (96, 192): (q_window[:, :, None] == window[:, None, :]) & pairs(q_valid, valid)}


def _run_fwd_dkv(libs, add, log, dev, iters, clock, stream):
    """The train forward (dropout 0.1 and lse) and dK/dV at the train step's
    four shapes on two mask sets, path-like (`path_masks`) and random 3%,
    summed over the four calls: each variant on the staged route, the
    committed kernel also on the per-element route (the first kernels),
    and the eval forward (no lse, no dropout) beside them."""
    from ..ops import masked_attention as ma
    paths = path_masks(dev)
    thr, keep = ma.drop_threshold(DQ_RATE), 1.0 / (1.0 - DQ_RATE)
    for masks in ("path-like", "random 3%"):
        totals = {}
        for lq, lk in DQ_SHAPES:
            q, k, v, gout, allow, seeds, _, scale = dq_inputs(lq, lk, dev)
            if masks == "path-like":
                allow = paths[lq, lk]
            _, lse = ma.masked_mha_forward(q, k, v, allow, scale, DQ_RATE, seeds)
            _, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, DQ_RATE, seeds)
            allow_t = allow.transpose(1, 2).contiguous()
            B, _, H, D = q.shape
            if ma.fwd_route(q, k, v) != "staged" or ma.dkv_route(q, k, v, gout) != "staged":
                raise RuntimeError("the train shapes no longer take the staged routes")
            out = torch.empty(B, lq, H, D, device=dev, dtype=q.dtype)
            lse_o = torch.empty(B, H, lq, device=dev)
            dk = torch.empty(B, lk, H, D, device=dev, dtype=q.dtype)
            dv = torch.empty_like(dk)
            sizes = (B, lq, lk, H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                     v.stride(0), v.stride(1))
            fwd = lambda sd, ls: (1, q.data_ptr(), k.data_ptr(), v.data_ptr(),  # noqa: E731
                                  allow.data_ptr(), sd, out.data_ptr(), ls, *sizes, scale,
                                  thr, keep)
            dkv = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(),
                   allow_t.data_ptr(), lse.data_ptr(), r.data_ptr(), seeds.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), *sizes, gout.stride(0), gout.stride(1), scale,
                   thr, keep)
            el = B * H * D * 2
            nbytes = (2 * lq + 2 * lk) * el + allow.numel()
            pairs_ops = H * D * float(allow.sum())
            for kind, nb, ops in (("fwd", nbytes + B * H * lq * 4, 4 * pairs_ops),
                                  ("dkv", nbytes + 2 * lk * el + 2 * B * H * lq * 4,
                                   8 * pairs_ops)):
                bound, by = timing.bound_s(nb, ops, q.dtype)
                totals[kind, f"bound ({by})"] = totals.get((kind, f"bound ({by})"), 0.0) + bound
            runs = []
            for key, lib in libs.items():
                kinds = ATTENTION_KINDS[key]
                if "fwd" in kinds:
                    runs.append(("fwd", f"{key} staged", lib.masked_mha_fwd_staged,
                                 fwd(seeds.data_ptr(), lse_o.data_ptr())))
                if "dkv" in kinds:
                    runs.append(("dkv", f"{key} staged", lib.masked_mha_bwd_dkv_staged, dkv))
                if key == "kernel":
                    runs += [("fwd", "kernel per-element", lib.masked_mha_fwd,
                              fwd(seeds.data_ptr(), lse_o.data_ptr())),
                             ("fwd eval", "kernel staged", lib.masked_mha_fwd_staged,
                              fwd(None, None)),
                             ("fwd eval", "kernel per-element", lib.masked_mha_fwd,
                              fwd(None, None)),
                             ("dkv", "kernel per-element", lib.masked_mha_bwd_dkv, dkv)]
            for kind, key, fn, args in runs:
                fn.argtypes, fn.restype = ma.entry_argtypes(fn.__name__), I
                if fn(*args, stream):
                    log(f"  {kind} {lq}x{lk} {masks}: {key} does not launch (shared memory)")
                    continue

                def call(fn=fn, args=(*args, stream), key=key):
                    if fn(*args):
                        raise RuntimeError(f"{fn.__name__} variant {key} failed to launch")
                t = timing.timed_delta(call, iters, clock).device_s
                add(f"{kind} {lq}x{lk} {masks}", key, t, "ms")
                totals[kind, key] = totals.get((kind, key), 0.0) + t
        for (kind, key), t in totals.items():
            add(f"{kind}, the 4 calls of a step, {masks}", key, t, "ms")


TRACKLET_B, TRACKLET_L, TRACKLET_H, TRACKLET_D, TRACKLET_GROUPS = 64, 128, 8, 297, 4


def tracklet_inputs(dev, seed=0):
    """The sgcls tracklet encoder's attention at full size: 64 videos of 128
    boxes, 8 float32 heads of 297, q, k, v column blocks of a fused (B, L,
    3 x 2376) projection, box i of tracklet i mod 4 (a person and 3 objects
    in each of 32 frames, slots frame-major, as `chip_smoke.py` phase 12's
    boxes), g, seeds, and the forward's lse and dQ's r (dropout 0.1)."""
    from ..ops import masked_attention as ma
    g = torch.Generator(device=dev).manual_seed(seed)
    B, L, H, D = TRACKLET_B, TRACKLET_L, TRACKLET_H, TRACKLET_D
    E = H * D
    x = torch.randn(B, L, 3 * E, device=dev, generator=g)
    q, k, v = (x[..., i * E:(i + 1) * E].unflatten(-1, (H, D)) for i in range(3))
    gout = torch.randn(B, L, H, D, device=dev, generator=g)
    grp = torch.arange(L, device=dev) % TRACKLET_GROUPS
    allow = (grp[:, None] == grp[None, :]).expand(B, L, L).contiguous()
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g, device=dev, dtype=torch.int32)
    scale = D ** -0.5
    _, lse = ma.masked_mha_forward(q, k, v, allow, scale, DQ_RATE, seeds)
    _, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, DQ_RATE, seeds)
    return q, k, v, gout, allow, seeds, lse, r, scale


def _run_tiled(libs, add, dev, iters, clock, stream):
    """The tiled forward (train: dropout 0.1 and lse; eval), dQ and dK/dV at
    the tracklet encoder's shapes (`tracklet_inputs`), each variant's C
    entry on orders made once; the committed kernel also on the per-element
    entries, and the wrappers (row order included) and `row_order` alone."""
    from ..ops import masked_attention as ma
    q, k, v, gout, allow, seeds, lse, r, scale = tracklet_inputs(dev)
    B, L, H, D = q.shape
    if {ma.fwd_route(q, k, v), ma.dq_route(q, k, v, gout), ma.dkv_route(q, k, v, gout)} != {
            "tiled"}:
        raise RuntimeError("the tracklet shapes no longer take the tiled routes")
    allow_t = allow.transpose(1, 2).contiguous()
    order, order_t = ma.row_order(allow), ma.row_order(allow_t)
    out, lse_o = torch.empty_like(q, memory_format=torch.contiguous_format), torch.empty_like(lse)
    dq, r_o, dk = torch.empty_like(out), torch.empty_like(r), torch.empty_like(out)
    dv = torch.empty_like(out)
    thr, keep = ma.drop_threshold(DQ_RATE), 1.0 / (1.0 - DQ_RATE)
    dims = (B, L, L, H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1))
    bdims = (*dims, gout.stride(0), gout.stride(1), scale, thr, keep)
    base = (0, q.data_ptr(), k.data_ptr(), v.data_ptr())
    args = {  # kernel: (its arguments after the order, with the order)
        "fwd": lambda o: (*base, allow.data_ptr(), *o, seeds.data_ptr(), out.data_ptr(),
                          lse_o.data_ptr(), *dims, scale, thr, keep),
        "fwd eval": lambda o: (*base, allow.data_ptr(), *o, None, out.data_ptr(), None, *dims,
                               scale, 0, 1.0),
        "dq": lambda o: (*base, gout.data_ptr(), allow.data_ptr(), *o, lse.data_ptr(),
                         seeds.data_ptr(), dq.data_ptr(), r_o.data_ptr(), *bdims),
        "dkv": lambda o: (*base, gout.data_ptr(), allow_t.data_ptr(), *o, lse.data_ptr(),
                          r.data_ptr(), seeds.data_ptr(), dk.data_ptr(), dv.data_ptr(), *bdims)}
    entries = {"fwd": "masked_mha_fwd", "fwd eval": "masked_mha_fwd", "dq": "masked_mha_bwd_dq",
               "dkv": "masked_mha_bwd_dkv"}
    orders = {"fwd": order, "fwd eval": order, "dq": order, "dkv": order_t}
    runs = []
    for key, lib in libs.items():
        if key != "kernel" and "tiled" not in ATTENTION_KINDS[key]:
            continue
        for kind, entry in entries.items():
            runs.append((kind, f"{key} tiled", getattr(lib, entry + "_tiled"),
                         args[kind]((orders[kind].data_ptr(),))))
            if key == "kernel":
                runs.append((kind, "kernel per-element", getattr(lib, entry), args[kind](())))
    for kind, key, fn, a in runs:
        fn.argtypes, fn.restype = ma.entry_argtypes(fn.__name__), I

        def call(fn=fn, a=(*a, stream), key=key):
            if fn(*a):
                raise RuntimeError(f"{fn.__name__} variant {key} failed to launch")
        add(f"tracklet {kind}", key, timing.timed_delta(call, iters, clock).device_s, "ms")
    wrappers = {
        "fwd": lambda: ma.masked_mha_forward(q, k, v, allow, scale, DQ_RATE, seeds),
        "fwd eval": lambda: ma.masked_mha_forward(q, k, v, allow, scale, with_lse=False),
        "dq": lambda: ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, DQ_RATE, seeds),
        "dkv": lambda: ma.masked_mha_bwd_dkv(q, k, v, allow_t, scale, gout, lse, r, DQ_RATE,
                                             seeds),
        "row_order": lambda: ma.row_order(allow)}
    for kind, fn in wrappers.items():
        add(f"tracklet {kind}", "wrapper (order included)" if kind != "row_order" else "alone",
            timing.timed_delta(fn, iters, clock).device_s, "ms")


CLIP_SHAPES = {"image": (32, 50, 12, False), "text": (3, 77, 8, True)}  # B, L, H, causal


def clip_inputs(tower: str, dev, seed=0):
    """One attention call of a CLIP tower at full width: q, k, v float32
    column blocks of a fused (B, L, 3 H 64) projection, the tower's allow
    mask (every pair, or causal) and the softmax scale."""
    B, L, H, causal = CLIP_SHAPES[tower]
    g = torch.Generator(device=dev).manual_seed(seed)
    E = H * 64
    x = torch.randn(B, L, 3 * E, device=dev, generator=g)
    q, k, v = (x[..., i * E:(i + 1) * E].unflatten(-1, (H, 64)) for i in range(3))
    allow = torch.ones(L, L, dtype=torch.bool, device=dev)
    allow = (allow.tril() if causal else allow).expand(B, L, L).contiguous()
    return q, k, v, allow, 64 ** -0.5


def _run_resident(libs, add, dev, iters, clock, stream):
    """The resident eval forward at CLIP's two towers' shapes
    (`clip_inputs`): each variant's C entry; the committed kernel also on
    the per-element entry and, where the tiled rule takes the inputs, the
    tiled entry on a row order made once; then the wrapper and SDPA."""
    from ..ops import masked_attention as ma
    for tower in CLIP_SHAPES:
        q, k, v, allow, scale = clip_inputs(tower, dev)
        B, L, H, D = q.shape
        if ma.fwd_route(q, k, v) != "resident":
            raise RuntimeError(f"the CLIP {tower} shapes no longer take the resident route")
        out = torch.empty(B, L, H, D, device=dev)
        order = ma.row_order(allow)
        dims = (B, L, L, H, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), scale, 0, 1.0)
        base = (0, q.data_ptr(), k.data_ptr(), v.data_ptr(), allow.data_ptr())
        tail = (None, out.data_ptr(), None, *dims)
        runs = []
        for key, lib in libs.items():
            if "resident" not in ATTENTION_KINDS[key]:
                continue
            runs.append((f"{key} resident", lib.masked_mha_fwd_resident, (*base, *tail)))
            if key == "kernel":
                runs.append(("kernel per-element", lib.masked_mha_fwd, (*base, *tail)))
                if ma._tiled("fwd", (q, k, v)):
                    runs.append(("kernel tiled (order made once)", lib.masked_mha_fwd_tiled,
                                 (*base, order.data_ptr(), *tail)))
        for key, fn, a in runs:
            fn.argtypes, fn.restype = ma.entry_argtypes(fn.__name__), I

            def call(fn=fn, a=(*a, stream), key=key):
                if fn(*a):
                    raise RuntimeError(f"{fn.__name__} variant {key} failed to launch")
            add(f"clip {tower} fwd eval", key, timing.timed_delta(call, iters, clock).device_s,
                "us")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        for key, fn in (("wrapper", lambda: ma.masked_mha(q, k, v, allow, scale)),
                        ("sdpa", lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=allow[:, None], scale=scale))):
            add(f"clip {tower} fwd eval", key, timing.timed_delta(fn, iters, clock).device_s,
                "us")


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
