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
`reset_launches()` sets it to 0.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64  # rois per step of the plain version

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


def _fn():
    fn = _build.load("roi_align").roi_align
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn
