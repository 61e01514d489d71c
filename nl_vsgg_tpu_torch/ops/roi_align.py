"""RoIAlign over channel-last feature maps: the CUDA kernel's wrapper and its
plain version.

Port of nl_vsgg_tpu/ops/roi_align_mm.py (`roi_align_mm`,
`roi_align_mm_frames`), the function that the Pallas kernels
`roi_align_pallas_tiled` and `roi_align_pallas`
(nl_vsgg_tpu/ops/pallas_roi_align.py) also compute; the kernel is
`csrc/roi_align.cu`. Semantics (maskrcnn's legacy, not aligned, RoIAlign):

  * roi corners times `spatial_scale`, roi width and height clamped to >= 1;
  * `sampling_ratio` x `sampling_ratio` fixed samples per bin, averaged;
  * a sample outside [-1, len] along an axis contributes 0; an in-range
    sample is clamped to [0, len - 1] and interpolated bilinearly.

Layout: fmap (F, H, W, C) (or one (H, W, C) map), rois (R, 4) xyxy,
frame_idx (R,) picks each roi's map; the output is (R, ph, pw, C). The
arithmetic is float32 whatever the map's type; the output is in
`out_dtype` (default: the map's type).

`roi_align` takes the plain version only for tensors on the CPU; on CUDA it
launches the kernel or raises. `LAUNCHES["roi_align"]` counts launches;
`reset_launches()` sets it to 0. `roi_align_frames` is the JAX package's
name for the stacked-map form (nl_vsgg_tpu/ops/roi_align.py:99).

`roi_pool` is the legacy max RoIPool (nl_vsgg_tpu/ops/roi_align.py:117),
which the JAX package computes in XLA, outside any Pallas kernel: its port
is plain torch on the map's device, no hand kernel.

The kernel runs one block a roi: the block puts each output bin's merged
axis taps (ph row bins, pw column bins) in shared memory, then its threads
walk output columns, 8 channels a thread, forming each map row's x pass
once (`kernel_plan` gives the route and the shared memory; the kernel makes
the same choice).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64  # rois per step of the plain version
MAX_SAMPLING = 4        # csrc/roi_align.cu MAX_S
BIN_BYTES = 4 + 16 * MAX_SAMPLING   # one output bin's merged taps (csrc BinTaps)
TAP_SMEM_MAX = 48 * 1024
THREADS = 256

LAUNCHES = {"roi_align": 0}


def reset_launches() -> None:
    LAUNCHES["roi_align"] = 0


# ----------------------------------------------------------- plain version
def _axis_weights(start: torch.Tensor, bin_size: torch.Tensor, n_bins: int,
                  n_samples: int, axis_len: int) -> torch.Tensor:
    """(R, n_bins, axis_len) float32 bilinear weights along one axis,
    averaged over each bin's samples (roi_align_mm._axis_weights per roi)."""
    dev = start.device
    offs = (torch.arange(n_samples, device=dev, dtype=torch.float32) + 0.5) / n_samples
    bins = torch.arange(n_bins, device=dev, dtype=torch.float32)
    pos = start[:, None, None] + (bins[:, None] + offs[None, :]) * bin_size[:, None, None]
    in_range = (pos >= -1.0) & (pos <= axis_len)
    p = pos.clamp(0.0, axis_len - 1)
    p0 = torch.floor(p)
    frac = p - p0
    i0 = p0.long()
    i1 = (i0 + 1).clamp(max=axis_len - 1)
    idx = torch.arange(axis_len, device=dev)
    w0 = torch.where(in_range, 1.0 - frac, 0.0)[..., None] * (i0[..., None] == idx)
    w1 = torch.where(in_range, frac, 0.0)[..., None] * (i1[..., None] == idx)
    return (w0 + w1).sum(dim=2) / n_samples


def roi_align_reference(fmap: torch.Tensor, rois: torch.Tensor,
                        frame_idx: torch.Tensor | None = None,
                        output_size: tuple[int, int] = (7, 7),
                        spatial_scale: float = 1.0 / 16, sampling_ratio: int = 2,
                        out_dtype=None) -> torch.Tensor:
    """The separable form of roi_align_mm in float32: per roi, out =
    Wy fmap Wx^T with Wy (ph, H) and Wx (pw, W) the averaged bilinear
    weights. Rois are taken _CHUNK at a time to bound the (_CHUNK, ph, W, C)
    intermediate."""
    fmap, rois, frame_idx = _check(fmap, rois, frame_idx)
    F_, H, W, C = fmap.shape
    ph, pw = output_size
    out = torch.empty((rois.shape[0], ph, pw, C), dtype=out_dtype or fmap.dtype,
                      device=fmap.device)
    r = rois.float() * spatial_scale
    roi_w = (r[:, 2] - r[:, 0]).clamp(min=1.0)
    roi_h = (r[:, 3] - r[:, 1]).clamp(min=1.0)
    wy = _axis_weights(r[:, 1], roi_h / ph, ph, sampling_ratio, H)   # (R, ph, H)
    wx = _axis_weights(r[:, 0], roi_w / pw, pw, sampling_ratio, W)   # (R, pw, W)
    for s in range(0, rois.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        maps = fmap[frame_idx[sl].long()].float()                    # (n, H, W, C)
        t = torch.einsum("nph,nhwc->npwc", wy[sl], maps)
        out[sl] = torch.einsum("nqw,npwc->npqc", wx[sl], t).to(out.dtype)
    return out


def kernel_plan(C: int, output_size: tuple[int, int], sampling_ratio: int,
                aligned: bool = True) -> dict:
    """How csrc/roi_align.cu runs a call: `route` "vec8" (8 channels a
    thread, 16-byte loads and stores: C % 8 == 0 and 16-byte aligned map
    and output) or "scalar"; `smem`, the bytes of the ph + pw bins' merged
    taps a block, the same for every roi whatever its window (the map is
    not staged); `fits`, whether the kernel takes it."""
    ph, pw = output_size
    smem = BIN_BYTES * (ph + pw)
    return {"route": "vec8" if C % 8 == 0 and aligned else "scalar", "smem": smem,
            "threads": THREADS,
            "fits": 1 <= sampling_ratio <= MAX_SAMPLING and smem <= TAP_SMEM_MAX}


# ------------------------------------------------------------------ checks
def _check(fmap, rois, frame_idx):
    """-> (fmap (F, H, W, C), rois (R, 4), frame_idx (R,) int32)."""
    if fmap.dim() == 3:
        fmap = fmap[None]
    if fmap.dim() != 4:
        raise ValueError(f"fmap must be (F, H, W, C) or (H, W, C), got {tuple(fmap.shape)}")
    if rois.dim() != 2 or rois.shape[1] != 4:
        raise ValueError(f"rois must be (R, 4) xyxy, got {tuple(rois.shape)}")
    if frame_idx is None:
        if fmap.shape[0] != 1:
            raise ValueError(f"{fmap.shape[0]} maps need a frame_idx per roi")
        frame_idx = torch.zeros(rois.shape[0], dtype=torch.int32, device=rois.device)
    if frame_idx.shape != (rois.shape[0],):
        raise ValueError(f"frame_idx must be ({rois.shape[0]},), got {tuple(frame_idx.shape)}")
    if {fmap.device, rois.device, frame_idx.device} != {fmap.device}:
        raise ValueError("fmap, rois and frame_idx must lie on one device")
    if fmap.dtype not in _DTYPES:
        raise TypeError(f"fmap must be float32 or bfloat16, got {fmap.dtype}")
    if frame_idx.numel() and (int(frame_idx.min()) < 0 or int(frame_idx.max()) >= fmap.shape[0]):
        raise ValueError(f"frame_idx out of range [0, {fmap.shape[0]})")
    return fmap, rois, frame_idx.int()


# ----------------------------------------------------------------- wrapper
def roi_align(fmap: torch.Tensor, rois: torch.Tensor, frame_idx: torch.Tensor | None = None,
              output_size: tuple[int, int] = (7, 7), spatial_scale: float = 1.0 / 16,
              sampling_ratio: int = 2, out_dtype=None) -> torch.Tensor:
    """(R, ph, pw, C) crops of `fmap` at `rois` (each from its frame)."""
    if fmap.device.type == "cpu":
        return roi_align_reference(fmap, rois, frame_idx, output_size, spatial_scale,
                                   sampling_ratio, out_dtype)
    fmap, rois, frame_idx = _check(fmap, rois, frame_idx)
    out_dtype = out_dtype or fmap.dtype
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    F_, H, W, C = fmap.shape
    ph, pw = output_size
    if not kernel_plan(C, output_size, sampling_ratio)["fits"]:
        raise ValueError(f"the roi_align kernel takes sampling_ratio 1..{MAX_SAMPLING} and "
                         f"a tap table of <= {TAP_SMEM_MAX} bytes; got {sampling_ratio}, "
                         f"{output_size}")
    fmap = fmap.contiguous()
    rois = rois.float().contiguous()
    out = torch.empty((rois.shape[0], ph, pw, C), dtype=out_dtype, device=fmap.device)
    if rois.shape[0] == 0:
        return out
    with torch.cuda.device(fmap.device):
        rc = _fn()(_DTYPES[fmap.dtype], _DTYPES[out_dtype], fmap.data_ptr(), rois.data_ptr(),
                   frame_idx.contiguous().data_ptr(), out.data_ptr(), rois.shape[0], F_, H, W,
                   C, ph, pw, float(spatial_scale), sampling_ratio,
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed: cudaError {rc}")
    LAUNCHES["roi_align"] += 1
    return out


def roi_align_frames(fmaps: torch.Tensor, rois: torch.Tensor, frame_idx: torch.Tensor,
                     output_size: tuple[int, int] = (7, 7), spatial_scale: float = 1.0 / 16,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign where roi i crops frame frame_idx[i] of the stacked (F, H,
    W, C) maps: `roi_align` with the frame index required."""
    return roi_align(fmaps, rois, frame_idx, output_size, spatial_scale, sampling_ratio)


ROI_POOL_CHUNK = 32   # rois a step: bounds the gathered windows' memory


def roi_pool(fmap: torch.Tensor, rois: torch.Tensor, output_size: tuple[int, int] = (7, 7),
             spatial_scale: float = 1.0 / 16) -> torch.Tensor:
    """Max RoIPool (fasterRCNN csrc ROIPool_cuda.cu) on one (H, W, C) map:
    roi corners scaled and rounded half to even, bin edges floor / ceil of
    the roi's integer extent, each bin the max over its window clipped to
    the map, an empty bin 0. (R, ph, pw, C) in the map's dtype. The max is
    separable: over each x bin's columns, then over each y bin's rows of
    that, gathered window by window a chunk of rois at a time."""
    H, W, C = fmap.shape
    ph, pw = output_size
    dev = fmap.device
    out = fmap.new_empty((rois.shape[0], ph, pw, C))
    q = torch.round(rois.float() * spatial_scale).long()

    def edges(lo, hi, n, length):   # (R, n) bin starts and ends, clipped
        size = (hi - lo + 1).clamp(min=1)[:, None]
        b = torch.arange(n, device=dev)[None]
        start = lo[:, None] + torch.div(b * size, n, rounding_mode="floor")
        end = lo[:, None] - torch.div(-(b + 1) * size, n, rounding_mode="floor")
        return start.clamp(0, length), end.clamp(0, length)

    neg = torch.tensor(float("-inf"), dtype=fmap.dtype, device=dev)
    for c0 in range(0, rois.shape[0], ROI_POOL_CHUNK):
        r = q[c0:c0 + ROI_POOL_CHUNK].to(dev)
        ys, ye = edges(r[:, 1], r[:, 3], ph, H)
        xs, xe = edges(r[:, 0], r[:, 2], pw, W)
        kx = int((xe - xs).max().clamp(min=1))
        ky = int((ye - ys).max().clamp(min=1))
        xi = xs[..., None] + torch.arange(kx, device=dev)          # (Rc, pw, kx)
        yi = ys[..., None] + torch.arange(ky, device=dev)          # (Rc, ph, ky)
        cols = fmap[:, xi.clamp(max=W - 1)]                         # (H, Rc, pw, kx, C)
        cols = torch.where((xi < xe[..., None])[None, ..., None], cols, neg).amax(3)
        cols = cols.permute(1, 0, 2, 3)                             # (Rc, H, pw, C)
        rows = cols[torch.arange(r.shape[0], device=dev)[:, None, None],
                    yi.clamp(max=H - 1)]                            # (Rc, ph, ky, pw, C)
        best = torch.where((yi < ye[..., None])[..., None, None], rows, neg).amax(2)
        out[c0:c0 + ROI_POOL_CHUNK] = torch.where(best.isfinite(), best, 0.0)
    return out


def _fn():
    fn = _build.load("roi_align").roi_align
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn
