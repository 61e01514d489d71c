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
  7. the detector kernels against their plain versions at the detector
     path's shapes, float32 and bfloat16: RoIAlign on a (4, 38, 64, 1024) C4
     map with 300 rois a frame (degenerate, clamped and fully outside rois
     among them), the grouped 3x3 conv at its four geometry classes (c = 8
     at 152x256, 16 at 76x128, 32 at 38x64, 64 at 7x7 over 1200 crops), with
     and without the bias + ReLU epilogue;
  8. the detector path: `AttrRCNNTorch` (VinVL X152-C4 at full width and
     depth, random weights from a seeded generator) on 480x800 BGR frames
     (600x1000 after the resize, bucket 608x1024): in float32 on 4 frames
     the kernel path against the plain path on the same weights (C4 map,
     RPN logits and deltas, box-head logits, deltas and features at the same
     proposals, relative to each tensor's largest magnitude; the detections
     matched by frame, label and corners), with the launch counts of the
     trunk (45 grouped convs) and the box head (1 RoIAlign, 2 grouped
     convs); then the bf16 `detect_video` as a server answering two
     32-frame requests and `extract_box_features_frames` for 96 union boxes
     a video, each with the counts set to 0 just before and read just after
     (1 RoIAlign and 47 grouped convs a pass), ms per video, frames/s, peak
     memory, and bf16 union features against fp32 by correlation;
  9. both detector kernels timed on the inputs one bf16 `detect_video` gave
     them, beside their plain versions, cuDNN's grouped conv and the bound;
     a torch.profiler table of one bf16 `detect_video`;
 10. the `kernels` JSON line, then the device JSON line, last.

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
# the detector path (VinVL X152-C4): 480x800 BGR frames resize to 600x1000
# (bucket 608x1024, C4 map 38x64); the float32 kernel-vs-plain checks run on
# DET_CHECK_FRAMES frames, the bf16 server on two videos of DET_FRAMES
DET_FRAMES, DET_CHECK_FRAMES, DET_HW, UNION_BOXES = 32, 4, (480, 800), 96
# a detector kernel against its plain version in float32: sums in another
# order (16 products in RoIAlign, up to 9 * 64 in the conv) -> 1e-5 of the
# output's largest magnitude (bfloat16 as KERNEL_TOL)
DET_KERNEL_REL = 1e-5
# the float32 detector, kernel path vs plain path on the same weights and
# frames: the same math in another order through 50 residual blocks, the
# RPN and the C5 head -> 1e-4 of each tensor's largest magnitude
DET_PATH_TOL = 1e-4
# final detections, plain path's valid ones found in the kernel path's list
# (same frame and label, every corner within DET_MATCH_PX): random weights
# give near-tied candidate scores, so float32 noise may flip a few top-k or
# NMS decisions among them; at least 90% must match
DET_MATCH, DET_MATCH_PX = 0.9, 0.5
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


# ---------------------------------------------------------------- detector
def rel_err(out, ref) -> float:
    """max |out - ref| over the largest |ref|."""
    o, r = out.float(), ref.float()
    return float((o - r).abs().max() / r.abs().max().clamp(min=1e-30))


def det_kernel_err(out, ref) -> tuple[float, bool]:
    """A detector kernel against its plain version: float32 within
    DET_KERNEL_REL of the output's largest magnitude; bfloat16 as
    KERNEL_TOL (one rounding of an fp32 sum on each side)."""
    if str(ref.dtype) == "torch.float32":
        err = float((out - ref).abs().max())
        ok = err <= DET_KERNEL_REL * float(ref.abs().max()) and bool(out.isfinite().all())
        return err, ok
    return kernel_err(out, ref)


def detector_weights(seed: int, dev) -> dict:
    """Random full-width AttrRCNN weights from a seeded generator: convs at
    fan-in scale (He), the residual branches' last FrozenBN scales (bn3,
    downsample) 0.2 so that the C4 map stays O(1) through 50 blocks, other
    FrozenBN scales 1, biases 0, predictor weights N(0, 0.01^2)."""
    import torch
    from nl_vsgg_tpu_torch.detector.attr_rcnn import AttrRCNNModule
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in AttrRCNNModule().state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    for k, shp in shapes.items():
        if k.endswith(".weight"):
            std = (2.0 / float(np.prod(shp[1:]))) ** 0.5 if len(shp) == 4 else 0.01
            sd[k] = torch.randn(shp, generator=g, device=dev) * std
        elif k.endswith(".scale"):
            small = k.endswith(("bn3.scale", "downsample_bn.scale"))
            sd[k] = torch.full(shp, 0.2 if small else 1.0, device=dev)
        else:
            sd[k] = torch.zeros(shp, device=dev)
    return sd


def path_rois(g, n_frames: int, per_frame: int, H: int, W: int, dev):
    """(rois (R, 4), frame_idx (R,)) in image coordinates of an (H, W) C4
    map at stride 16: random boxes, and in each frame a degenerate, a
    fully outside, a whole-map and a past-the-edge roi."""
    import torch
    rois = []
    for _ in range(n_frames):
        xy = torch.rand(per_frame, 2, generator=g, device=dev) * torch.tensor(
            [W * 16.0, H * 16.0], device=dev)
        wh = 8 + torch.rand(per_frame, 2, generator=g, device=dev) * 400
        r = torch.cat([xy - 20, xy + wh], 1)
        r[:4] = torch.tensor([[0, 0, 0, 0], [-500, -500, -400, -400],
                              [0, 0, W * 16 - 1, H * 16 - 1],
                              [W * 16 - 8, H * 16 - 8, W * 16 + 40, H * 16 + 40]], device=dev)
        rois.append(r)
    fidx = torch.arange(n_frames, device=dev, dtype=torch.int32).repeat_interleave(per_frame)
    return torch.cat(rois), fidx


def detector_phases(dev, card) -> list[dict]:
    """Phases 7-9: the detector kernels against their plain versions, the
    detector path (fp32 kernel vs plain, bf16 serving), the kernels timed on
    the path's own inputs. Returns the two `kernels` rows."""
    import torch
    import torch.nn.functional as F

    import nl_vsgg_tpu_torch.detector.resnet as dresnet
    import nl_vsgg_tpu_torch.detector.roi_box as droi
    from nl_vsgg_tpu_torch.detector.attr_rcnn import AttrRCNNTorch
    from nl_vsgg_tpu_torch.detector.anchors import grid_anchors
    from nl_vsgg_tpu_torch.detector.rpn import select_proposals
    from nl_vsgg_tpu_torch.ops import grouped_conv as gc, roi_align as ra

    def reset():
        ra.reset_launches()
        gc.reset_launches()

    def launches():
        return {"roi_align": ra.LAUNCHES["roi_align"],
                "grouped_conv3x3": gc.LAUNCHES["grouped_conv3x3"]}

    # ---- 7. detector kernels vs plain versions at the path's shapes ----
    g = torch.Generator(device=dev).manual_seed(3)
    fmap = torch.randn(DET_CHECK_FRAMES, 38, 64, 1024, generator=g, device=dev)
    rois, fidx = path_rois(g, DET_CHECK_FRAMES, 300, 38, 64, dev)
    for dtype in (torch.float32, torch.bfloat16):
        fm = fmap.to(dtype)
        out = ra.roi_align(fm, rois, fidx, (14, 14), 1 / 16)
        torch.cuda.synchronize()
        err, ok = det_kernel_err(out, ra.roi_align_reference(fm, rois, fidx, (14, 14), 1 / 16))
        outside = float(out[1].float().abs().max())
        log(f"roi_align {str(dtype)[6:]} ({DET_CHECK_FRAMES}, 38, 64, 1024) x "
            f"{rois.shape[0]} rois 14x14: max_abs_err {err:.3e}, fully outside roi max |out| "
            f"{outside}")
        if not ok or outside != 0.0:
            fail(f"roi_align disagrees with its plain version at {dtype}")
    for N, Hc, Wc, C in ((DET_CHECK_FRAMES, 152, 256, 256), (DET_CHECK_FRAMES, 76, 128, 512),
                         (DET_CHECK_FRAMES, 38, 64, 1024), (DET_CHECK_FRAMES * 300, 7, 7, 2048)):
        c = C // 32
        x32 = torch.randn(N, Hc, Wc, C, generator=g, device=dev)
        w32 = torch.randn(3, 3, c, C, generator=g, device=dev) * (9 * c) ** -0.5
        bias = torch.randn(C, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            for b, relu in ((None, False), (bias, True)):
                out = gc.grouped_conv3x3(x, w, 32, b, relu)
                torch.cuda.synchronize()
                err, ok = det_kernel_err(out, gc.grouped_conv3x3_reference(x, w, 32, b, relu))
                log(f"grouped_conv3x3 {str(dtype)[6:]} ({N}, {Hc}, {Wc}, {C}) c={c} "
                    f"bias+relu={relu}: max_abs_err {err:.3e}")
                if not ok:
                    fail(f"grouped_conv3x3 disagrees with its plain version at {dtype} "
                         f"({N}, {Hc}, {Wc}, {C}) relu={relu}")
    del fmap, x32, w32, x, w, out

    # ---- 8. the detector path at full width ----
    t0 = time.perf_counter()
    sd = detector_weights(5, dev)
    rng = np.random.default_rng(2000)
    videos = [[rng.integers(0, 256, (*DET_HW, 3), dtype=np.uint8) for _ in range(DET_FRAMES)]
              for _ in range(2)]
    det32 = AttrRCNNTorch(sd, device=dev)
    plain32 = AttrRCNNTorch(sd, device=dev, fused=False)
    log(f"detector: VinVL X152-C4, {sum(v.numel() for v in sd.values())} weights (seeded), "
        f"2 synthetic videos of {DET_FRAMES} BGR frames {DET_HW[0]}x{DET_HW[1]} in "
        f"{time.perf_counter() - t0:.3f} s")

    # float32: kernel path vs plain path on the same weights and frames
    images, _, sizes = det32._prep(videos[0][:DET_CHECK_FRAMES])
    im_hw = torch.as_tensor(sizes, device=dev)
    with torch.inference_mode():
        reset()
        c4k = det32.module.features(images)
        trunk = launches()
        c4p = plain32.module.features(images)
        lk, dk = det32.module.rpn(c4k)
        lp, dp = plain32.module.rpn(c4p)
        anchors = torch.as_tensor(grid_anchors(c4k.shape[1], c4k.shape[2]), device=dev)
        props, _ = select_proposals(anchors, lk, dk, im_hw)
        pidx = torch.arange(DET_CHECK_FRAMES, device=dev, dtype=torch.int32).repeat_interleave(
            props.shape[1])
        reset()
        box_k = det32.module.box(c4k, props.reshape(-1, 4), pidx)
        head = launches()
        box_p = plain32.module.box(c4p, props.reshape(-1, 4), pidx)
        if any(launches()[k] != head[k] for k in head):
            fail("the plain detector path launched a kernel")
        errs = {"c4": rel_err(c4k, c4p), "rpn logits": rel_err(lk, lp),
                "rpn deltas": rel_err(dk, dp)}
        errs.update({n: rel_err(a, b) for n, a, b in zip(("cls logits", "box deltas",
                                                          "features"), box_k, box_p)})
        pk = det32.detect_packed(images, im_hw)
        pp = plain32.detect_packed(images, im_hw)
    log(f"detector fp32 kernel vs plain ({DET_CHECK_FRAMES} frames {tuple(images.shape)}, C4 "
        f"{tuple(c4k.shape)}, |C4| max {float(c4k.abs().max()):.3f}), error / max |ref|: "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f"; launches: trunk {trunk}, box head {head}")
    if trunk != {"roi_align": 0, "grouped_conv3x3": 45} or \
            head != {"roi_align": 1, "grouped_conv3x3": 2}:
        fail(f"detector launches: trunk {trunk} (want 45 grouped convs), box head {head} "
             f"(want 1 roi_align + 2 grouped convs)")
    worst = max(errs, key=errs.get)
    if errs[worst] > DET_PATH_TOL or not bool(pk.isfinite().all()):
        fail(f"detector fp32 kernel path differs from plain: {worst} {errs[worst]:.3e}")
    matched = total = 0
    for f in range(DET_CHECK_FRAMES):
        a, b = pp[f][pp[f, :, 7] > 0.5], pk[f][pk[f, :, 7] > 0.5]
        near = (a[:, None, :4] - b[None, :, :4]).abs().amax(-1) < DET_MATCH_PX
        matched += int((near & (a[:, None, 5] == b[None, :, 5])).any(1).sum())
        total += a.shape[0]
    share = matched / max(total, 1)
    log(f"detections fp32 kernel vs plain path: {matched}/{total} valid detections matched "
        f"(same frame and label, corners within {DET_MATCH_PX} px) = {share:.4f}")
    if total < 10 * DET_CHECK_FRAMES or share < DET_MATCH:
        fail(f"detections: {matched}/{total} matched, need {DET_MATCH}")
    del c4k, c4p, box_k, box_p, plain32

    # bfloat16: a server answering two requests (one video each)
    det16 = AttrRCNNTorch(sd, compute_dtype="bfloat16", device=dev)
    det16.detect_video(videos[0][:2])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    video_ms = []
    outs = []
    for v in videos:
        t0 = time.perf_counter()
        outs.append(det16.detect_video(v))
        video_ms.append((time.perf_counter() - t0) * 1e3)
    served = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"detect_video bf16: {[round(t, 3) for t in video_ms]} ms per video of {DET_FRAMES} "
        f"frames (host clock, frames in and detections out), "
        f"{2 * DET_FRAMES / sum(video_ms) * 1e3:.1f} frames/s, launches {served}, "
        f"peak device memory {peak:.2f} GiB")
    if served != {"roi_align": 2, "grouped_conv3x3": 2 * 47}:
        fail(f"two detect_video calls launched {served}, expected 2 roi_align and 94 "
             f"grouped convs")
    for out in outs:
        if len(out) != DET_FRAMES or any(
                d["features"].shape != (100, 2048) or not np.isfinite(d["features"]).all()
                or not np.isfinite(d["boxes"]).all() or d["valid"].sum() < 10 for d in out):
            fail("detect_video: a frame lacks 100 finite detections with >= 10 valid")

    # union features: 96 boxes a video spread over its frames
    ub = []
    for _ in videos:
        xy = rng.uniform(0, [DET_HW[1] - 60, DET_HW[0] - 60], (UNION_BOXES, 2))
        wh = rng.uniform(20, 300, (UNION_BOXES, 2))
        ub.append((np.concatenate([xy, xy + wh], 1).astype(np.float32),
                   rng.integers(0, DET_FRAMES, UNION_BOXES)))
    reset()
    t0 = time.perf_counter()
    feats = [det16.extract_box_features_frames(v, b, fi) for v, (b, fi) in zip(videos, ub)]
    union_ms = (time.perf_counter() - t0) * 1e3 / 2
    unioned = launches()
    log(f"extract_box_features_frames bf16: {UNION_BOXES} boxes a video, {union_ms:.3f} ms "
        f"per video, launches {unioned}")
    if unioned != {"roi_align": 2, "grouped_conv3x3": 2 * 47} or any(
            f.shape != (UNION_BOXES, 7, 7, 2048) or not np.isfinite(f).all() for f in feats):
        fail(f"extract_box_features_frames: launches {unioned} or bad features")
    sel = ub[0][1] < DET_CHECK_FRAMES
    f32 = det32.extract_box_features_frames(videos[0][:DET_CHECK_FRAMES], ub[0][0][sel],
                                            ub[0][1][sel]).ravel()
    f16 = det16.extract_box_features_frames(videos[0][:DET_CHECK_FRAMES], ub[0][0][sel],
                                            ub[0][1][sel]).ravel()
    corr = float(np.corrcoef(f32, f16)[0, 1])
    ratio = float(np.abs(f16).mean() / np.abs(f32).mean())
    log(f"union features bf16 vs fp32 ({int(sel.sum())} boxes): correlation {corr:.5f}, "
        f"mean |f| ratio {ratio:.4f}")
    if corr < 0.99 or not 0.9 < ratio < 1.1:
        fail("bf16 union features do not track fp32")
    del det32

    # ---- 9. detector kernels timed on one bf16 detect_video's own inputs ----
    convs, aligns = [], []
    orig_conv, orig_align = dresnet.grouped_conv3x3, droi.roi_align

    def conv_rec(x, w, groups, bias=None, relu=False, out_dtype=None):
        convs.append((x, w, groups, bias, relu))
        return orig_conv(x, w, groups, bias, relu, out_dtype)

    def align_rec(*args, **kw):
        aligns.append((args, kw))
        return orig_align(*args, **kw)

    dresnet.grouped_conv3x3, droi.roi_align = conv_rec, align_rec
    try:
        det16.detect_video(videos[1])
    finally:
        dresnet.grouped_conv3x3, droi.roi_align = orig_conv, orig_align
    if len(convs) != 47 or len(aligns) != 1:
        fail(f"recorded {len(convs)} grouped convs and {len(aligns)} roi_aligns in one pass")

    conv_row = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, max_abs_err=0.0,
                    terms={"bytes": 0.0, "operations": 0.0})
    classes = {}
    for x, w, groups, b, relu in convs:
        err, ok = det_kernel_err(gc.grouped_conv3x3(x, w, groups, b, relu),
                                 gc.grouped_conv3x3_reference(x, w, groups, b, relu))
        if not ok:
            fail(f"grouped_conv3x3 disagrees with its plain version on path inputs "
                 f"{tuple(x.shape)}")
        xl = x.permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bl = b.to(x.dtype)
        kms = cuda_ms(lambda: gc.grouped_conv3x3(x, w, groups, b, relu), iters=5, warmup=1)
        pms = cuda_ms(lambda: gc.grouped_conv3x3_reference(x, w, groups, b, relu), iters=3,
                      warmup=1)
        lms = cuda_ms(lambda: F.conv2d(xl, wl, bl, padding=1, groups=groups), iters=5,
                      warmup=1)
        c = x.shape[3] // groups
        el = x.element_size()
        t_bytes = ((2 * x.numel() + w.numel()) * el + b.numel() * 4) / HBM_BYTES_PER_S
        t_ops = 18.0 * c * x.numel() / PEAK_OPS[str(x.dtype)]
        bms = max(t_bytes, t_ops) * 1e3
        conv_row["terms"]["bytes" if t_bytes >= t_ops else "operations"] += bms
        conv_row["max_abs_err"] = max(conv_row["max_abs_err"], err)
        for key, val in (("ms", kms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
            conv_row[key] += val
        cl = classes.setdefault(tuple(x.shape), [0, 0.0, 0.0, 0.0, 0.0])
        for i, val in enumerate((1, kms, pms, lms, bms)):
            cl[i] += val
    for shape, (n, kms, pms, lms, bms) in classes.items():
        log(f"grouped_conv3x3 bf16 {shape} x {n}: kernel {kms:.4f} ms, plain {pms:.4f}, cuDNN "
            f"{lms:.4f}, bound {bms:.4f} ms (sums over the pass's {n} calls)")

    args, kw = aligns[0]
    out = ra.roi_align(*args, **kw)
    ref = ra.roi_align_reference(*args, **kw)
    align_err, ok = det_kernel_err(out, ref)
    if not ok:
        fail("roi_align disagrees with its plain version on path inputs")
    fm, rois_p, fidx_p = args[:3]
    ams = cuda_ms(lambda: ra.roi_align(*args, **kw), iters=10, warmup=2)
    apl = cuda_ms(lambda: ra.roi_align_reference(*args, **kw), iters=2, warmup=1)
    sr = kw.get("sampling_ratio", 2)
    t_bytes = (fm.numel() * fm.element_size() + (rois_p.numel() + fidx_p.numel()) * 4
               + out.numel() * out.element_size()) / HBM_BYTES_PER_S
    t_ops = 8.0 * sr * sr * out.numel() / PEAK_OPS["torch.float32"]  # 4 taps x (mul, add)
    abound = max(t_bytes, t_ops) * 1e3
    log(f"roi_align path inputs: map {tuple(fm.shape)} {str(fm.dtype)[6:]}, "
        f"{rois_p.shape[0]} rois -> {tuple(out.shape)} {str(out.dtype)[6:]}: kernel {ams:.4f} "
        f"ms, plain {apl:.4f} ms, bound {abound:.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}), max_abs_err {align_err:.3e}")
    per_video = sum(video_ms) / 2
    log(f"per bf16 video: grouped convs {conv_row['ms']:.3f} ms "
        f"({conv_row['ms'] / per_video * 100:.1f}% of {per_video:.3f} ms), roi_align "
        f"{ams:.4f} ms; card {card}")
    profile_table(lambda: det16.detect_video(videos[1]), per_video, "bf16 detect_video", n=1)

    return [{
        "name": "roi_align", "route": "cuda", "source": "nl_vsgg_tpu_torch/csrc/roi_align.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_roi_align.py:163",
        "launches": served["roi_align"], "max_abs_err": align_err, "ms": ams, "plain_ms": apl,
        "bound_ms": abound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }, {
        "name": "grouped_conv3x3", "route": "cuda",
        "source": "nl_vsgg_tpu_torch/csrc/grouped_conv.cu",
        "replaces": "nl_vsgg_tpu/ops/pallas_grouped_conv.py:148",
        "launches": served["grouped_conv3x3"], "max_abs_err": conv_row["max_abs_err"],
        "ms": conv_row["ms"], "plain_ms": conv_row["plain_ms"],
        "bound_ms": conv_row["bound_ms"],
        "bound_by": max(conv_row["terms"], key=conv_row["terms"].get),
        "library_ms": conv_row["library_ms"],
    }]


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

    # ---- 7-9. the detector path ----
    del models, batches, batch, steps, st, step, records, captured
    torch.cuda.empty_cache()
    det_rows = detector_phases(dev, card)

    # ---- 10. result lines ----
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
    kernels += det_rows
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
