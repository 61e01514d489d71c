#!/usr/bin/env python3
"""Drive the PyTorch port (nl_vsgg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; any failure exits non-zero before the result line:
  1. build every CUDA kernel from csrc/ with nvcc (timed), print the card's
     name and power limit;
  2. every kernel against its plain PyTorch version at the main paths'
     shapes (B=64 videos, H=8 heads, head dim 242; 96x96, 192x192, 96x192;
     float32 and bfloat16; with fully masked rows): the eval forward, and
     the train forward (dropout rate 0 and 0.1, with the log-sum-exp) with
     both backward kernels, rows and key columns with no allowed pair
     exactly 0;
  3. the serving path: STTran sgdet at full width (feat 2048, 1 encoder + 3
     decoder layers, 8 heads, random weights from a seeded torch.Generator)
     serving 64 synthetic videos at bench.py's shapes (32 frames, 128 box and
     96 relation slots) through `serve.predict`, with the kernels' launch
     counts set to 0 just before and read just after; then the kernel path
     against the plain-attention path on the same weights, float32 and
     bfloat16, and the bfloat16 eval step's frames/s;
  4. the eval forward timed on the inputs the serving path gave it, beside
     its plain version, one PyTorch library call and the card's bound; a
     torch.profiler table of the eval step's device time;
  5. the training path: one train-mode forward and backward at full width
     (dropout 0.1), kernel path against plain-attention path on the same
     weights and generator seed, parameter gradients compared in float32
     and bfloat16; then bfloat16 `train_step`s at B=64 (clipped AdamW, the
     NaN/empty guard) with the launch counts set to 0 just before and read
     just after (4 forward and 4 + 4 backward launches a step), finite
     losses and no skip, ms/step and frames/s, peak memory;
  6. the train forward and both backward kernels timed on the inputs one
     train step gave them, beside their plain versions, the library call
     and the bound; a torch.profiler table of the train step;
  7. the `kernels` JSON line, then the device JSON line, last.

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
# gradients, kernel vs plain on the same inputs: float32 sums in another
# order over up to 192 keys of products of O(10) -> |err| <= 2e-4 + 1e-5 |ref|;
# bfloat16 as above (one rounding of an fp32 result on each side)
GRAD_TOL = {"torch.float32": (2e-4, 1e-5), "torch.bfloat16": (1e-3, 2.0 ** -7)}
# whole model, kernel path vs plain-attention path on the same weights:
#   float32: the same math in another order through 4 layers -> 1e-3
#   bfloat16: one-ulp attention differences carried through bf16
#   projections, LayerNorms and FFNs -> 5e-2 on logits and probabilities
MODEL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# parameter gradients of one train-mode forward and backward, kernel path vs
# plain-attention path, as ||g_kernel - g_plain|| / ||g_plain|| per tensor:
#   float32: reduction-order noise through 4 layers and their backward -> 1e-3
#   bfloat16: one-ulp attention differences in the forward and in dq/dk/dv,
#   carried through bf16 layers both ways -> 5e-2
TRAIN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
RATE = 0.1                                      # STTran's dropout
SLEEP_CYCLES = 50_000_000                       # about 25 ms at the H100's clocks
TRAIN_STEPS = 5
HEADS = ("attention_distribution", "spatial_distribution", "contacting_distribution",
         "distribution")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Device time per call: CUDA events around `iters` calls. A sleep
    kernel queued first keeps the card busy while the host queues the
    calls, so a call shorter than its Python wrapper is timed by its device
    work, not by the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def attention_bound_ms(q, k, v, allow, with_lse: bool = False) -> tuple[float, str]:
    """Least time for masked attention on these inputs: read q, k, v and
    the mask once, write out (and the fp32 lse) once; 4 * H * D operations
    per allowed (query, key) pair (two multiply-adds per dim)."""
    Bq, Lq, Hh, D = q.shape
    el = q.element_size()
    nbytes = (2 * Bq * Lq * Hh * D + 2 * k.shape[0] * k.shape[1] * Hh * D) * el + allow.numel()
    nbytes += Bq * Hh * Lq * 4 if with_lse else 0
    ops = 4.0 * Hh * D * float(allow.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bwd_bound_ms(q, k, allow, kind: str) -> tuple[float, str]:
    """Least time for one backward kernel on these inputs. dQ reads q, k, v,
    g, the mask and lse and writes dq and r, with 6 * H * D operations per
    allowed pair (q.k, g.v, dS k); dK/dV reads q, k, v, g, the transposed
    mask, lse and r and writes dk and dv, with 8 * H * D (q.k, g.v, P~ g,
    dS q)."""
    Bq, Lq, Hh, D = q.shape
    el, Lk = q.element_size(), k.shape[1]
    rows_q, rows_k = Bq * Lq * Hh * D, Bq * Lk * Hh * D
    stats = Bq * Hh * Lq * 4
    if kind == "dq":
        nbytes = (2 * rows_q + 2 * rows_k + rows_q) * el + allow.numel() + 2 * stats
        ops = 6.0 * Hh * D * float(allow.sum())
    else:
        nbytes = (2 * rows_q + 2 * rows_k + 2 * rows_k) * el + allow.numel() + 2 * stats
        ops = 8.0 * Hh * D * float(allow.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[str(q.dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_err(out, ref, tol=None) -> tuple[float, bool]:
    atol, rtol = (tol or KERNEL_TOL)[str(ref.dtype)]
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    return float(err.max()), bool((err <= atol + rtol * r.abs()).all()) and bool(o.isfinite().all())


def profile_table(fn, step_ms: float, label: str, n: int = 3) -> None:
    """Device time by kernel over `n` calls of `fn` (torch.profiler); a
    diagnostic: reports, never fails."""
    import torch
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # kernel rows only: operator rows and user annotations on the device
        # (the optimizer's step) repeat their kernels' device time
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.key.startswith("Optimizer.")),
                      key=lambda e: -e.self_device_time_total)
        dev_total = sum(e.self_device_time_total for e in rows)
        if dev_total <= 0:
            log(f"profile {label}: the profiler recorded no device time (not measured)")
            return
        per = dev_total / n / 1e3
        log(f"profile: {label}, kernel time {per:.3f} ms/step (busy "
            f"{per / step_ms * 100:.1f}% of the timed step); top kernels by self device time:")
        for e in rows[:14]:
            t = e.self_device_time_total
            log(f"  {t / dev_total * 100:5.1f}%  {t / n / 1e3:8.3f} ms/step  "
                f"{e.count // n:4d}/step  {e.key[:90]}")
    except Exception as ex:  # the profiler is a diagnostic: report, never fail
        log(f"profile {label}: unavailable ({ex!r})")


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

    # the train forward (dropout, lse) and both backward kernels; with
    # dropout on, one pair whose keep bit differed from the plain version's
    # would move the output by about p |v|, far above the tolerance
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g, device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lk in ((96, 96), (192, 192), (96, 192)):
            q = torch.randn(B, lq, H, HEAD_DIM, device=dev, generator=g).to(dtype)
            kv = torch.randn(B, lk, 2 * H * HEAD_DIM, device=dev, generator=g).to(dtype)
            k = kv[..., :H * HEAD_DIM].unflatten(-1, (H, HEAD_DIM))
            v = kv[..., H * HEAD_DIM:].unflatten(-1, (H, HEAD_DIM))
            gout = torch.randn(B, lq, H, HEAD_DIM, device=dev, generator=g).to(dtype)
            allow = torch.rand(B, lq, lk, device=dev, generator=g) < 0.3
            allow[:, ::7] = False                    # rows with no allowed key
            allow[:, :, 5::11] = False               # keys no query may see
            allow_t = allow.transpose(1, 2).contiguous()
            for rate in (0.0, RATE):
                sd = seeds if rate else None
                out, lse = ma.masked_mha_forward(q, k, v, allow, scale, rate, sd)
                dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, scale, gout, lse, rate, sd)
                dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow_t, scale, gout, lse, r, rate, sd)
                torch.cuda.synchronize()
                what = f"{str(dtype)[6:]} {lq}x{lk} rate {rate}"
                errs = {}
                for name, got, ref, tol in (
                        ("out", out, ma.masked_mha_reference(q, k, v, allow, scale, rate, sd),
                         KERNEL_TOL),
                        ("lse", lse, ma.masked_mha_lse_reference(q, k, allow, scale), GRAD_TOL),
                        *zip(("dq", "r"), (dq, r),
                             ma.masked_mha_bwd_dq_reference(q, k, v, allow, scale, gout, rate,
                                                            sd), (GRAD_TOL, GRAD_TOL)),
                        *zip(("dk", "dv"), (dk, dv),
                             ma.masked_mha_bwd_dkv_reference(q, k, v, allow, scale, gout, r,
                                                             rate, sd), (GRAD_TOL, GRAD_TOL))):
                    errs[name], ok = kernel_err(got, ref, tol)
                    if not ok:
                        fail(f"train kernels: {name} disagrees with its plain version at "
                             f"{what} (max_abs_err {errs[name]:.3e})")
                empty = [float(t.float().abs().max()) for t in
                         (out[:, ::7], dq[:, ::7], dk[:, 5::11], dv[:, 5::11])]
                if any(empty) or not bool((lse.transpose(1, 2)[:, ::7] == ma.LSE_EMPTY).all()):
                    fail(f"train kernels: rows or keys with no allowed pair are not 0 at {what}")
                # the autograd path launches the same kernels on the same inputs
                q2, kv2 = q.detach().requires_grad_(), kv.detach().requires_grad_()
                k2 = kv2[..., :H * HEAD_DIM].unflatten(-1, (H, HEAD_DIM))
                v2 = kv2[..., H * HEAD_DIM:].unflatten(-1, (H, HEAD_DIM))
                ma.masked_mha(q2, k2, v2, allow, scale, rate, sd).backward(gout)
                same = (torch.equal(q2.grad, dq)
                        and torch.equal(kv2.grad, torch.cat([dk, dv], -2).flatten(-2)))
                if not same:
                    fail(f"train kernels: the autograd path differs from the wrappers at {what}")
                log(f"train kernels {what}: max_abs_err " + ", ".join(
                    f"{n} {e:.3e}" for n, e in errs.items()) + "; empty rows/keys exactly 0")

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

    ma.reset_launches()
    t0 = time.perf_counter()
    graphs = predict(models["bfloat16", True], entries, batch=B, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(ma.LAUNCHES)
    log(f"serve.predict: {len(graphs)} scene graphs in {serve_s:.3f} s wall "
        f"(host stacking, upload, one bf16 forward, JSON); launches {launches}")
    if launches != {"fwd": 4, "bwd_dq": 0, "bwd_dkv": 0}:
        fail(f"serving launched {launches} in one forward, expected 4 forward launches")
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

    profile_table(lambda: eval_step(models["bfloat16", True], batches["bfloat16"]),
                  step_ms["bfloat16", True], "bf16 eval step")

    # ---- 5. the training path at full width ----
    from nl_vsgg_tpu_torch.models.layers import MaskedBatchNorm
    from nl_vsgg_tpu_torch.models.losses import sttran_losses
    from nl_vsgg_tpu_torch.train.state import create_train_state
    from nl_vsgg_tpu_torch.train.step import make_train_step

    def train_grads(model, batch, seed):
        """Parameter gradients of one train-mode forward and backward (the
        train step's loss), BatchNorm updates dropped."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        model.zero_grad(set_to_none=True)
        per_video = sttran_losses(model(batch, train=True, generator=gen), batch, gen)
        w = batch.box_mask.any(-1).float()
        (torch.where(w > 0, per_video["total"] * w, 0.0).sum() / w.sum().clamp(min=1.0)).backward()
        for mod in model.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.discard()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return grads

    for dname in ("float32", "bfloat16"):
        ma.reset_launches()
        ker = train_grads(models[dname, True], batches[dname], 7)
        torch.cuda.synchronize()
        got = dict(ma.LAUNCHES)
        ma.reset_launches()
        pln = train_grads(models[dname, False], batches[dname], 7)
        if got != {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4} or any(ma.LAUNCHES.values()):
            fail(f"{dname} train forward/backward launched {got} (kernel path) and "
                 f"{dict(ma.LAUNCHES)} (plain path)")
        if ker.keys() != pln.keys():
            fail(f"{dname}: the two paths gave gradients to different parameters")
        worst, worst_name = 0.0, ""
        for name, gp in pln.items():
            gk = ker[name]
            if not bool(gk.isfinite().all()):
                fail(f"{dname} train gradient {name} is not finite")
            rel = float((gk - gp).norm() / gp.norm().clamp(min=1e-30))
            if rel > worst:
                worst, worst_name = rel, name
        log(f"train grads {dname} kernel vs plain attention (dropout {RATE}, same generator "
            f"seed): {len(pln)} tensors, worst ||dg||/||g|| {worst:.3e} at {worst_name} "
            f"(tol {TRAIN_GRAD_TOL[dname]})")
        if worst > TRAIN_GRAD_TOL[dname]:
            fail(f"{dname} train gradients: kernel path differs from plain by {worst} "
                 f"at {worst_name}")
    del ker, pln

    batch = batches["bfloat16"]
    train_ms, train_launches, steps = {}, {}, {}
    for fused in (True, False):
        m = models["bfloat16", fused]
        st = create_train_state(m, lr=1e-5)
        step = make_train_step(m, st.optimizer)
        gen = torch.Generator(device=dev).manual_seed(11)
        for _ in range(2):                        # warm-up
            st, met = step(st, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ma.reset_launches()
        t0 = time.perf_counter()
        totals_t = []
        for _ in range(TRAIN_STEPS):
            st, met = step(st, batch, gen)
            totals_t.append(met["total"])
        torch.cuda.synchronize()
        train_ms[fused] = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        train_launches[fused] = dict(ma.LAUNCHES)
        losses = [float(t) for t in totals_t]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        label = "kernel" if fused else "plain"
        log(f"train_step bf16 {label} attention: {train_ms[fused]:.3f} ms/step, "
            f"{frames / train_ms[fused] * 1e3:.1f} frames/s (B={B} x {N_FRAMES} frames, "
            f"{TRAIN_STEPS} steps after 2 warm-up), losses {[round(x, 4) for x in losses]}, "
            f"skipped {st.skipped}, launches {train_launches[fused]}, "
            f"peak device memory {peak:.2f} GiB")
        if not all(np.isfinite(losses)) or st.skipped != 0:
            fail(f"bf16 train steps ({label}): losses {losses}, skipped {st.skipped}")
        want = ({"fwd": 4 * TRAIN_STEPS, "bwd_dq": 4 * TRAIN_STEPS, "bwd_dkv": 4 * TRAIN_STEPS}
                if fused else {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0})
        if train_launches[fused] != want:
            fail(f"train steps ({label}) launched {train_launches[fused]}, expected {want}")
        steps[fused] = (st, step, gen)

    # ---- 6. train kernels timed on one train step's own inputs ----
    st, step, gen = steps[True]
    records = []
    orig = ma.masked_mha

    def recording(q, k, v, allow, s, rate=0.0, seeds=None):
        out = orig(q, k, v, allow, s, rate, seeds)
        rec = {"q": q.detach(), "k": k.detach(), "v": v.detach(), "allow": allow, "s": s,
               "rate": rate, "seeds": seeds}
        records.append(rec)
        out.register_hook(lambda gr, rec=rec: rec.__setitem__("g", gr.detach()))
        return out

    ma.masked_mha = recording
    try:
        st, _ = step(st, batch, gen)
    finally:
        ma.masked_mha = orig
    if len(records) != 4 or not all("g" in r for r in records):
        fail(f"recorded {len(records)} attention calls with gradients in one train step")

    train_rows = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                          terms={"bytes": 0.0, "operations": 0.0})
                  for n in ("fwd", "bwd_dq", "bwd_dkv")}

    def add(row, err, kms, pms, bound, lms):
        r = train_rows[row]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        for key, val in (("ms", kms), ("plain_ms", pms), ("library_ms", lms)):
            r[key] += val
        r["bound_ms"] += bound[0]
        r["terms"][bound[1]] += bound[0]

    for rec in records:
        q, k, v, allow, s, rate, sd, gout = (rec[n] for n in
                                             ("q", "k", "v", "allow", "s", "rate", "seeds", "g"))
        allow_t = allow.transpose(1, 2).contiguous()
        out, lse = ma.masked_mha_forward(q, k, v, allow, s, rate, sd)
        dq, r = ma.masked_mha_bwd_dq(q, k, v, allow, s, gout, lse, rate, sd)
        dk, dv = ma.masked_mha_bwd_dkv(q, k, v, allow_t, s, gout, lse, r, rate, sd)
        ref_dq, ref_r = ma.masked_mha_bwd_dq_reference(q, k, v, allow, s, gout, rate, sd)
        ref_dk, ref_dv = ma.masked_mha_bwd_dkv_reference(q, k, v, allow, s, gout, ref_r, rate, sd)
        errs = {}
        for name, got, ref, tol in (
                ("fwd", out, ma.masked_mha_reference(q, k, v, allow, s, rate, sd), KERNEL_TOL),
                ("bwd_dq", dq, ref_dq, GRAD_TOL), ("bwd_dq r", r, ref_r, GRAD_TOL),
                ("bwd_dkv", dk, ref_dk, GRAD_TOL), ("bwd_dkv v", dv, ref_dv, GRAD_TOL)):
            err, ok = kernel_err(got, ref, tol)
            if not ok:
                fail(f"{name} disagrees with its plain version on train-path inputs "
                     f"{tuple(q.shape)} x Lk={k.shape[1]} (max_abs_err {err:.3e})")
            key = name.split()[0]
            errs[key] = max(errs.get(key, 0.0), err)

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        gt, mask = gout.transpose(1, 2), allow[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, dropout_p=rate,
                                                  scale=s)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), gt)

        lib_fwd = cuda_ms(sdpa)
        lib_bwd = max(cuda_ms(sdpa_fwd_bwd) - lib_fwd, 0.0)  # dq, dk, dv in one call
        fms = cuda_ms(lambda: ma.masked_mha_forward(q, k, v, allow, s, rate, sd))
        fpl = cuda_ms(lambda: ma.masked_mha_reference(q, k, v, allow, s, rate, sd))
        qms = cuda_ms(lambda: ma.masked_mha_bwd_dq(q, k, v, allow, s, gout, lse, rate, sd))
        qpl = cuda_ms(lambda: ma.masked_mha_bwd_dq_reference(q, k, v, allow, s, gout, rate, sd))
        kms = cuda_ms(lambda: ma.masked_mha_bwd_dkv(q, k, v, allow_t, s, gout, lse, r, rate, sd))
        kpl = cuda_ms(lambda: ma.masked_mha_bwd_dkv_reference(q, k, v, allow, s, gout, ref_r,
                                                              rate, sd))
        add("fwd", errs["fwd"], fms, fpl, attention_bound_ms(q, k, v, allow, True), lib_fwd)
        add("bwd_dq", errs["bwd_dq"], qms, qpl, attention_bwd_bound_ms(q, k, allow, "dq"),
            lib_bwd)
        add("bwd_dkv", errs["bwd_dkv"], kms, kpl, attention_bwd_bound_ms(q, k, allow, "dkv"),
            lib_bwd)
        log(f"train path {tuple(q.shape)} x Lk={k.shape[1]} bf16 rate {rate}: fwd {fms:.4f} "
            f"(plain {fpl:.4f}, sdpa {lib_fwd:.4f}), bwd dQ {qms:.4f} (plain {qpl:.4f}), "
            f"bwd dK/dV {kms:.4f} (plain {kpl:.4f}), sdpa backward {lib_bwd:.4f} ms; "
            f"allowed pairs {float(allow.float().mean()):.4f}; max_abs_err "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    for n, r in train_rows.items():
        log(f"{n} per train step (4 launches): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms = {r['ms'] / train_ms[True] * 100:.2f}% of the step")
    profile_table(lambda: step(st, batch, gen)[0], train_ms[True], "bf16 train step")

    # ---- 7. result lines ----
    by = max(bound_terms, key=bound_terms.get)
    kernels = [{
        "name": "masked_mha", "route": "cuda",
        "source": "nl_vsgg_tpu_torch/csrc/masked_attention.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_attention.py:143",
        "launches": launches["fwd"], "max_abs_err": max_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": by,
        "library_ms": totals["library_ms"],
    }]
    for n, replaces in (("fwd", 143), ("bwd_dq", 157), ("bwd_dkv", 157)):
        r = train_rows[n]
        kernels.append({
            "name": f"masked_mha_{n}_train" if n == "fwd" else f"masked_mha_{n}",
            "route": "cuda", "source": "nl_vsgg_tpu_torch/csrc/masked_attention.cu",
            "replaces": f"nl_vsgg_tpu/ops/pallas_attention.py:{replaces}",
            "launches": train_launches[True][n], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": max(r["terms"], key=r["terms"].get), "library_ms": r["library_ms"]})
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
