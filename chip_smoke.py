#!/usr/bin/env python3
"""Drive the PyTorch port (nl_vsgg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; any failure exits non-zero before the result line:
  1. build every CUDA kernel from csrc/ with nvcc (timed), print the card's
     name and power limit;
  2. every kernel against its plain PyTorch version at the main path's
     shapes (B=64 videos, H=8 heads, head dim 242; 96x96, 192x192, 96x192;
     float32 and bfloat16; with fully masked rows);
  3. the main path: STTran sgdet at full width (feat 2048, 1 encoder + 3
     decoder layers, 8 heads, random weights from a seeded torch.Generator)
     serving 64 synthetic videos at bench.py's shapes (32 frames, 128 box and
     96 relation slots) through `serve.predict`, with the kernels' launch
     counts set to 0 just before and read just after; then the kernel path
     against the plain-attention path on the same weights, float32 and
     bfloat16, and the bfloat16 eval step's frames/s;
  4. each kernel timed on the inputs the main path gave it, beside its
     plain version, one PyTorch library call and the card's bound; a
     torch.profiler table of the eval step's device time;
  5. the `kernels` JSON line, then the device JSON line, last.

float32 checks run with TF32 off (torch.backends.cudnn.allow_tf32 and
torch.backends.cuda.matmul.allow_tf32 set False at start): cuDNN would
otherwise run float32 convolutions in TF32. The bfloat16 path is the
serving configuration of bench.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B, N_FRAMES, OBJS, N_BOXES, N_RELS, FEAT = 64, 32, 3, 128, 96, 2048
H, HEAD_DIM = 8, 242
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"torch.bfloat16": 989e12,           # dense tensor-core bf16
            "torch.float32": 67e12}             # float32 outside the tensor cores
# kernel vs plain version on the same inputs:
#   float32: sums in another order + __expf -> |err| <= 1e-4
#   bfloat16: both round an fp32 result to bf16, so they may differ by one
#   bf16 ulp: |err| <= 2^-7 |ref| + 1e-3
KERNEL_TOL = {"torch.float32": (1e-4, 0.0), "torch.bfloat16": (1e-3, 2.0 ** -7)}
# whole model, kernel path vs plain-attention path on the same weights:
#   float32: the same math in another order through 4 layers -> 1e-3
#   bfloat16: one-ulp attention differences carried through bf16
#   projections, LayerNorms and FFNs -> 5e-2 on logits and probabilities
MODEL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
HEADS = ("attention_distribution", "spatial_distribution", "contacting_distribution",
         "distribution")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def attention_bound_ms(q, k, v, allow) -> tuple[float, str]:
    """Least time for masked attention on these inputs: read q, k, v and
    the mask once, write out once; 4 * H * D operations per allowed
    (query, key) pair (two multiply-adds per dim)."""
    Bq, Lq, Hh, D = q.shape
    el = q.element_size()
    nbytes = (2 * Bq * Lq * Hh * D + 2 * k.shape[0] * k.shape[1] * Hh * D) * el + allow.numel()
    ops = 4.0 * Hh * D * float(allow.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_err(out, ref) -> tuple[float, bool]:
    atol, rtol = KERNEL_TOL[str(ref.dtype)]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    return float(err.max()), bool((err <= atol + rtol * r.abs()).all()) and bool(o.isfinite().all())


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on the GPU")
    sys.path.insert(0, HERE)
    try:
        import nl_vsgg_tpu_torch  # noqa: F401
    except ImportError:
        fail(f"package nl_vsgg_tpu_torch not found beside {__file__}")
    import torch.nn.functional as F

    from nl_vsgg_tpu_torch.data.synthetic import make_synthetic_entry
    from nl_vsgg_tpu_torch.models.layers import MaskedMHA
    from nl_vsgg_tpu_torch.models.sttran import STTran
    from nl_vsgg_tpu_torch.ops import _build, masked_attention as ma
    from nl_vsgg_tpu_torch.serve import place_batch, predict
    from nl_vsgg_tpu_torch.train.step import eval_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. build ----
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {json.dumps(built)} total {time.perf_counter() - t0:.3f} s")
    for name in built:
        report = open(_build.library_path(name) + ".log").read()
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not read"
    log(f"card: {card}")

    # ---- 2. kernel vs plain version at the path's shapes ----
    g = torch.Generator(device=dev).manual_seed(0)
    scale = HEAD_DIM ** -0.5
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in ((96, 96), (192, 192), (96, 192)):
            q = torch.randn(B, lq, H, HEAD_DIM, device=dev, generator=g).to(dtype)
            kv = torch.randn(B, lk, 2 * H * HEAD_DIM, device=dev, generator=g).to(dtype)
            k = kv[..., :H * HEAD_DIM].unflatten(-1, (H, HEAD_DIM))  # strided, as on the path
            v = kv[..., H * HEAD_DIM:].unflatten(-1, (H, HEAD_DIM))
            allow = torch.rand(B, lq, lk, device=dev, generator=g) < 0.3
            allow[:, ::7] = False                    # fully masked rows
            out = ma.masked_mha(q, k, v, allow, scale)
            torch.cuda.synchronize()
            err, ok = kernel_err(out, ma.masked_mha_reference(q, k, v, allow, scale))
            zero_rows = float(out[:, ::7].float().abs().max())
            kms = cuda_ms(lambda: ma.masked_mha(q, k, v, allow, scale))
            log(f"masked_mha {str(dtype)[6:]} {lq}x{lk}: max_abs_err {err:.3e} "
                f"(tol {KERNEL_TOL[str(dtype)]}), masked rows max |out| {zero_rows}, "
                f"{kms:.4f} ms on dense random masks (every key tile live)")
            if not ok or zero_rows != 0.0:
                fail(f"masked_mha disagrees with its plain version at {dtype} {lq}x{lk}")

    # ---- 3. the main path at full width ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(1000)
    entries = [make_synthetic_entry(rng, n_frames=N_FRAMES, objs_per_frame=OBJS,
                                    bucket_boxes=N_BOXES, bucket_rels=N_RELS,
                                    feat_dim=FEAT) for _ in range(B)]
    log(f"requests: {B} synthetic videos in {time.perf_counter() - t0:.3f} s (host)")
    t0 = time.perf_counter()
    kw = dict(mode="sgdet", feat_dim=FEAT, enc_layer_num=1, dec_layer_num=3, device=dev)
    models = {}
    for dname, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        for fused in (True, False):
            models[dname, fused] = STTran(dtype=dtype, fused=fused,
                                          generator=torch.Generator().manual_seed(0), **kw)
    log(f"models: 4 x STTran in {time.perf_counter() - t0:.3f} s")

    ma.masked_mha.launches = 0
    t0 = time.perf_counter()
    graphs = predict(models["bfloat16", True], entries, batch=B, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"masked_mha": ma.masked_mha.launches}
    log(f"serve.predict: {len(graphs)} scene graphs in {serve_s:.3f} s wall "
        f"(host stacking, upload, one bf16 forward, JSON); launches {launches}")
    if launches["masked_mha"] != 4:
        fail(f"masked_mha launched {launches['masked_mha']} times in one forward, expected 4")
    if len(graphs) != B or any(not gr["triplets"] for gr in graphs):
        fail("serve.predict did not return one non-empty scene graph per video")
    if not all(np.isfinite(t["score"]) for gr in graphs for t in gr["triplets"]):
        fail("non-finite triplet scores")

    batches = {"float32": place_batch(entries, dev),
               "bfloat16": place_batch(entries, dev, torch.bfloat16)}
    for dname, batch in batches.items():
        ker = eval_step(models[dname, True], batch)
        pln = eval_step(models[dname, False], batch)
        for key in HEADS + ("global_output",):
            a, b = ker[key], pln[key]
            if a.shape[0] != B or not bool(a.isfinite().all()):
                fail(f"{dname} {key}: shape {tuple(a.shape)} or non-finite values")
            d = float((a.float() - b.float()).abs().max())
            log(f"model {dname} kernel vs plain {key}: max_abs_diff {d:.3e}")
            if key in HEADS and d > MODEL_TOL[dname]:
                fail(f"{dname} {key}: kernel path differs from plain by {d} "
                     f"> {MODEL_TOL[dname]}")
    del ker, pln

    frames = B * N_FRAMES
    step_ms = {}
    for dname in ("bfloat16", "float32"):
        for fused in (True, False):
            m, batch = models[dname, fused], batches[dname]
            step_ms[dname, fused] = cuda_ms(lambda: eval_step(m, batch), iters=10)
            log(f"eval_step {dname} {'kernel' if fused else 'plain'} attention: "
                f"{step_ms[dname, fused]:.3f} ms/step, "
                f"{frames / step_ms[dname, fused] * 1e3:.1f} frames/s "
                f"(B={B} x {N_FRAMES} frames)")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---- 4. kernel timings on the main path's own inputs ----
    # the attention core's inputs of one bf16 forward, rebuilt from each
    # MaskedMHA call's own arguments (forward pre-hooks record them)
    calls = []
    mhas = [m for m in models["bfloat16", True].modules() if isinstance(m, MaskedMHA)]
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append((mod, args, kwargs)), with_kwargs=True)
        for m in mhas]
    try:
        eval_step(models["bfloat16", True], batches["bfloat16"])
    finally:
        for hk in hooks:
            hk.remove()
    with torch.inference_mode():
        captured = [(*mod.heads(*args[:3], dup2_pos=kwargs.get("dup2_pos")), args[3],
                     HEAD_DIM ** -0.5) for mod, args, kwargs in calls]
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    bound_terms = {"bytes": 0.0, "operations": 0.0}
    max_err = 0.0
    for q, k, v, allow, s in captured:
        err, ok = kernel_err(ma.masked_mha(q, k, v, allow, s),
                             ma.masked_mha_reference(q, k, v, allow, s))
        if not ok:
            fail(f"masked_mha disagrees with its plain version on main-path inputs {tuple(q.shape)}")
        max_err = max(max_err, err)
        kms = cuda_ms(lambda: ma.masked_mha(q, k, v, allow, s))
        pms = cuda_ms(lambda: ma.masked_mha_reference(q, k, v, allow, s))
        qt, kt, vt, mask = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), allow[:, None]
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=s))
        bms, by = attention_bound_ms(q, k, v, allow)
        bound_terms[by] += bms
        density = float(allow.float().mean())
        log(f"masked_mha main path {tuple(q.shape)} x Lk={k.shape[1]} {str(q.dtype)[6:]}: "
            f"kernel {kms:.4f} ms, plain {pms:.4f} ms, sdpa {lms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), allowed pairs {density:.4f}, max_abs_err {err:.3e}")
        for key, val in (("ms", kms), ("plain_ms", pms), ("bound_ms", bms), ("library_ms", lms)):
            totals[key] += val
    log(f"masked_mha per forward (4 launches): kernel {totals['ms']:.4f} ms = "
        f"{totals['ms'] / step_ms['bfloat16', True] * 100:.1f}% of the bf16 eval step")

    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                eval_step(models["bfloat16", True], batches["bfloat16"])
            torch.cuda.synchronize()
        # kernel rows only: operator rows repeat their kernels' device time
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        dev_total = sum(e.self_device_time_total for e in rows)
        if dev_total <= 0:
            log("profile: the profiler recorded no device time (not measured)")
        else:
            log(f"profile: bf16 eval step, kernel time {dev_total / 3e3:.3f} ms/step "
                f"(busy {dev_total / 3e3 / step_ms['bfloat16', True] * 100:.1f}% of the "
                f"event-timed step); top kernels by self device time:")
            for e in rows[:12]:
                t = e.self_device_time_total
                log(f"  {t / dev_total * 100:5.1f}%  {t / 3e3:8.3f} ms/step  {e.key[:100]}")
    except Exception as ex:  # the profiler is a diagnostic: report, never fail
        log(f"profile: unavailable ({ex!r})")

    # ---- 5. result lines ----
    by = max(bound_terms, key=bound_terms.get)
    kernels = [{
        "name": "masked_mha", "route": "cuda",
        "source": "nl_vsgg_tpu_torch/csrc/masked_attention.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_attention.py:143",
        "launches": launches["masked_mha"], "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": by,
        "library_ms": totals["library_ms"],
    }]
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
