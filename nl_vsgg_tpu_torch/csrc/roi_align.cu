// RoIAlign over channel-last feature maps for Hopper (sm_90a).
//
// Replaces nl_vsgg_tpu/ops/pallas_roi_align.py::roi_align_pallas_tiled
// (_kernel_tiled) and ::roi_align_pallas (_kernel): both compute the
// function of nl_vsgg_tpu/ops/roi_align_mm.py, maskrcnn's legacy (not
// aligned) RoIAlign:
//
//   out[r, p, q, c] = 1/S^2 sum_{sy, sx} bilinear(fmap[f_r, :, :, c], y(p, sy), x(q, sx))
//
// with y = y1 + (p + (sy + 0.5) / S) * bin_h, bin_h = max(y2 - y1, 1) / ph
// on the scaled roi (likewise x), S = sampling_ratio; a sample outside
// [-1, len] along an axis contributes 0, an in-range one is clamped to
// [0, len - 1] (the reference's bilinear_interpolate boundary rule).
//
// Layout. fmap is (F, H, W, C) contiguous (fp32 or bf16), rois (R, 4) fp32
// xyxy in image coordinates, frame_idx (R,) int32 picks each roi's map, out
// is (R, ph, pw, C) contiguous in the output type (fp32 or bf16). The
// arithmetic is fp32 whatever the types: reading a bf16 map and writing
// bf16 gives the values of aligning the bf16-rounded map in fp32 and
// rounding the crops, with half the bytes.
//
// Bound. On the detector path (32 frames x 300 rois, 14x14 crops of the
// C=1024 C4 map in bf16) the output, 1.93e9 elements, is 3.85 GB against a
// 5 MB map per frame that stays in the 50 MB L2: the kernel is bound by the
// output write, about 1.15 ms at 3.35 TB/s. The products are 4 * S^2 per
// output element, far below the card's rate.
//
// Design. The TPU kernels cast RoIAlign as two small matmuls per roi (Wy
// fmap Wx^T) to feed the MXU. Here there is nothing to gain from that: one
// block per (roi, output bin) computes the bin's S^2 sample positions and
// bilinear weights once per thread (a handful of scalar ops), and its
// threads then walk the channels, neighbouring threads on neighbouring
// channels, so every one of the 4 S^2 tap reads and the output write is a
// coalesced row segment. When C % 8 == 0 each thread takes 8 neighbouring
// channels with 16-byte loads (bf16; two for fp32) and stores: the first
// version, one channel a thread, issued 8x the load instructions and took
// 24.1 ms on the path's (9600, 14, 14, 1024) bf16 crops. The sums are fp32
// in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;  // C = 1024 in 8-channel vectors: one pass
constexpr int MAX_S = 4;  // sampling_ratio limit (S^2 samples in registers)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One axis' sample: the two taps and their weights (0 outside [-1, len]).
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap axis_tap(float pos, int len) {
  Tap t;
  const bool in_range = pos >= -1.0f && pos <= (float)len;
  const float p = fminf(fmaxf(pos, 0.0f), (float)(len - 1));
  const float p0 = floorf(p);
  const float frac = p - p0;
  t.i0 = (int)p0;
  t.i1 = min(t.i0 + 1, len - 1);
  t.w0 = in_range ? 1.0f - frac : 0.0f;
  t.w1 = in_range ? frac : 0.0f;
  return t;
}

// 8 neighbouring channels as fp32: two 16-byte loads of fp32, one of bf16.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

template <typename TI, typename TO, bool VEC8>
__global__ void __launch_bounds__(THREADS)
roi_align_kernel(const TI* __restrict__ fmap, const float* __restrict__ rois,
                 const int* __restrict__ frame_idx, TO* __restrict__ out, int H, int W,
                 int C, int ph, int pw, float scale, int S) {
  const long long bin = blockIdx.x;  // r * ph * pw + p * pw + q
  const int q = (int)(bin % pw);
  const int p = (int)((bin / pw) % ph);
  const long long r = bin / ((long long)pw * ph);
  const float x1 = rois[r * 4 + 0] * scale;
  const float y1 = rois[r * 4 + 1] * scale;
  const float roi_w = fmaxf(rois[r * 4 + 2] * scale - x1, 1.0f);
  const float roi_h = fmaxf(rois[r * 4 + 3] * scale - y1, 1.0f);
  const float bin_w = roi_w / pw, bin_h = roi_h / ph;
  Tap ty[MAX_S], tx[MAX_S];
  for (int s = 0; s < S; ++s) {
    const float off = ((float)s + 0.5f) / S;
    ty[s] = axis_tap(y1 + ((float)p + off) * bin_h, H);
    tx[s] = axis_tap(x1 + ((float)q + off) * bin_w, W);
  }
  const float inv = 1.0f / (float)(S * S);
  const TI* base = fmap + (long long)frame_idx[r] * H * W * C;
  TO* dst = out + bin * C;
  constexpr int V = VEC8 ? 8 : 1;
  for (int c = threadIdx.x * V; c < C; c += THREADS * V) {
    float acc[V];
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int sy = 0; sy < S; ++sy) {
      const TI* row0 = base + (long long)ty[sy].i0 * W * C + c;
      const TI* row1 = base + (long long)ty[sy].i1 * W * C + c;
      for (int sx = 0; sx < S; ++sx) {
        const long long o0 = (long long)tx[sx].i0 * C, o1 = (long long)tx[sx].i1 * C;
        if constexpr (VEC8) {
          float a[8], b[8], d[8], e[8];
          load8(row0 + o0, a);
          load8(row0 + o1, b);
          load8(row1 + o0, d);
          load8(row1 + o1, e);
          for (int i = 0; i < 8; ++i)
            acc[i] += ty[sy].w0 * (tx[sx].w0 * a[i] + tx[sx].w1 * b[i])
                      + ty[sy].w1 * (tx[sx].w0 * d[i] + tx[sx].w1 * e[i]);
        } else {
          acc[0] += ty[sy].w0 * (tx[sx].w0 * to_f(row0[o0]) + tx[sx].w1 * to_f(row0[o1]))
                    + ty[sy].w1 * (tx[sx].w0 * to_f(row1[o0]) + tx[sx].w1 * to_f(row1[o1]));
        }
      }
    }
    if constexpr (VEC8) {
      for (int i = 0; i < 8; ++i) acc[i] *= inv;
      store8(dst + c, acc);
    } else {
      dst[c] = from_f<TO>(acc[0] * inv);
    }
  }
}

template <typename TI, typename TO>
int launch(const void* fmap, const void* rois, const void* frame_idx, void* out, int R, int H,
           int W, int C, int ph, int pw, float scale, int S, cudaStream_t stream) {
  const long long blocks = (long long)R * ph * pw;
  if (C % 8 == 0)
    roi_align_kernel<TI, TO, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const TI*>(fmap), static_cast<const float*>(rois),
        static_cast<const int*>(frame_idx), static_cast<TO*>(out), H, W, C, ph, pw, scale, S);
  else
    roi_align_kernel<TI, TO, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const TI*>(fmap), static_cast<const float*>(rois),
        static_cast<const int*>(frame_idx), static_cast<TO*>(out), H, W, C, ph, pw, scale, S);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 = ok). frame_idx values must lie in [0, F) (the wrapper
// checks them).
extern "C" int roi_align(int in_dtype, int out_dtype, const void* fmap, const void* rois,
                         const void* frame_idx, void* out, int R, int F, int H, int W, int C,
                         int ph, int pw, float scale, int sampling_ratio, void* stream) {
  if (R <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || ph <= 0 || pw <= 0 ||
      sampling_ratio <= 0 || sampling_ratio > MAX_S || (long long)R * ph * pw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale,
                                sampling_ratio, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale,
                                        sampling_ratio, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale,
                                        sampling_ratio, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw,
                                                scale, sampling_ratio, s);
  return (int)cudaErrorInvalidValue;
}
