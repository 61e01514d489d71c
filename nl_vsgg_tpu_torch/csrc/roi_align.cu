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
// Design. The first version gave every (roi, bin) its own block, which
// recomputed the roi's geometry and read 4 S^2 = 16 map taps for each
// 16-byte store: neighbouring bins share taps but ran on other SMs, so the
// same map elements came from L2 again and again (about 62 GB for 3.85 GB
// written). Here one block owns one roi, all channels:
//   * its threads first put the roi's output bins in shared memory, ph
//     along y and pw along x, each as its S samples' bilinear taps merged:
//     the rising map rows (or columns) a bin reads and each one's summed
//     weight (times 1/S; nothing outside [-1, len], no second tap where a
//     sample is clamped to the last row or column). A bin narrower than a
//     map pixel has 2-3 taps, not 2 S = 4;
//   * then each thread takes one output column q and 8 neighbouring
//     channels (16-byte loads and stores; neighbouring threads on
//     neighbouring channels) and walks the output rows p. The roi is done
//     as two separable passes, out = Wy (map Wx^T): the x pass turns one
//     map row into U(y) = sum over column bin q's taps of w row[x] (one
//     load a tap, a bin's loads issued together: one straight-line body
//     for each tap count), held in registers; the y pass adds w U(y) over
//     row bin p's taps. A bin's rows rise and the next bin starts at or past the
//     row before the last, so the thread keeps the last two rows' U and
//     forms each map row's U once: a map element is read at most once for
//     each column bin that taps it, not 4 S^2 times for each output, and
//     the neighbouring columns of one roi share those rows in the SM's L1.
// The shared memory is the bins' taps alone, 68 (ph + pw) bytes (1904 at
// 14x14), whatever the window: a roi over the whole map takes the same as
// any other, and blocks an SM are bounded by registers. Taps outside the
// map read nothing, so a roi wholly outside writes exact zeros.
// Rois are taken in the order given (frame order on the path keeps one
// frame's map in L2); any frame_idx order is right. When C % 8 != 0, or the
// map or the output is not 16-byte aligned, a thread takes one channel.
// The sums are fp32 in registers. On an H100 at the path's inputs it takes
// about 2.2 ms a pass against the 1.2 ms bound, its loads and stores
// overlapped: without the tap loads 1.66 ms, without the stores 1.83
// (PERF.md, from kernel_variants).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;  // blocks an SM asked of the compiler (it caps registers)
constexpr int MAX_S = 4;      // sampling_ratio limit (a column bin's 2 S taps in registers)
constexpr int TAP_SMEM_MAX = 48 * 1024;  // the tap table (no opt-in above 48 KB)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One axis' sample: the first tap's index and both taps' weights, times
// 1/S; the second tap is i0 + 1 and its weight is 0 where it would be
// clamped (there the sample's fraction is 0).
struct Tap {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ Tap axis_tap(float pos, int len, float inv_s) {
  Tap t;
  const bool in_range = pos >= -1.0f && pos <= (float)len;
  const float p = fminf(fmaxf(pos, 0.0f), (float)(len - 1));
  const float p0 = floorf(p);
  const float frac = p - p0;
  t.i0 = (int)p0;
  t.w0 = in_range ? (1.0f - frac) * inv_s : 0.0f;
  t.w1 = in_range && t.i0 + 1 < len ? frac * inv_s : 0.0f;
  return t;
}

// One output bin along one axis: its S samples' taps merged, the indices
// rising, each with the sum of its weights; zero weights left out (a bin
// wholly outside the map has none).
struct BinTaps {
  int n;
  int idx[2 * MAX_S];
  float w[2 * MAX_S];
};

__device__ __forceinline__ void add_tap(BinTaps& b, int i, float w) {
  if (w == 0.0f) return;
  if (b.n > 0 && b.idx[b.n - 1] == i) {
    b.w[b.n - 1] += w;
  } else if (b.n > 1 && b.idx[b.n - 2] == i) {
    b.w[b.n - 2] += w;
  } else {
    b.idx[b.n] = i;
    b.w[b.n] = w;
    ++b.n;
  }
}

// Bin `bin` of an axis of `len` from `start`, `size` a bin, S samples,
// written in place (shared memory: indexed stores, not register selects).
__device__ void bin_taps(BinTaps& b, float start, float size, int bin, int len, int S) {
  b.n = 0;
  const float inv_s = 1.0f / (float)S;
  for (int s = 0; s < S; ++s) {
    const Tap t = axis_tap(start + ((float)bin + ((float)s + 0.5f) / S) * size, len, inv_s);
    add_tap(b, t.i0, t.w0);
    add_tap(b, t.i0 + 1, t.w1);
  }
}

// V = 8 neighbouring channels as fp32 by one 16-byte load (two for fp32),
// or V = 1 channel.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
template <int V, typename T> __device__ __forceinline__ void load(const T* p, float v[V]) {
  if constexpr (V == 8)
    load8(p, v);
  else
    v[0] = to_f(*p);
}
template <int V, typename T> __device__ __forceinline__ void store(T* p, const float v[V]) {
  if constexpr (V == 8)
    store8(p, v);
  else
    *p = from_f<T>(v[0]);
}

// The x pass of one map row: u = sum over the column bin's N merged taps
// of w row[x] (xo holds x * C), its N loads issued before any is used.
template <typename TI, int V, int N>
__device__ __forceinline__ void x_pass_n(const TI* row, const int* xo, const float* xw,
                                         float u[V]) {
  float a[N][V];
#pragma unroll
  for (int j = 0; j < N; ++j) load<V>(row + xo[j], a[j]);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    u[i] = xw[0] * a[0][i];
#pragma unroll
    for (int j = 1; j < N; ++j) u[i] += xw[j] * a[j][i];
  }
}

// The same for a bin of n <= T taps: one straight-line body for each n (a
// loop over n with a guard per tap would wait on each load in turn).
template <typename TI, int V, int T, int N = 1>
__device__ __forceinline__ void x_pass(const TI* row, int n, const int* xo, const float* xw,
                                       float u[V]) {
  if constexpr (N == 1) {
    if (n == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) u[i] = 0.0f;
      return;
    }
  }
  if (n == N) {
    x_pass_n<TI, V, N>(row, xo, xw, u);
  } else if constexpr (N < T) {
    x_pass<TI, V, T, N + 1>(row, n, xo, xw, u);
  }
}

// T = 2 S_max taps a bin: 4 for S <= 2 (the path), 8 up to S = 4.
template <typename TI, typename TO, int V, int T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
roi_align_kernel(const TI* __restrict__ fmap, const float* __restrict__ rois,
                 const int* __restrict__ frame_idx, TO* __restrict__ out, int H, int W,
                 int C, int ph, int pw, float scale, int S) {
  extern __shared__ BinTaps bins[];  // ph row bins, then pw column bins
  const long long r = blockIdx.x;
  const float x1 = rois[r * 4 + 0] * scale;
  const float y1 = rois[r * 4 + 1] * scale;
  const float roi_w = fmaxf(rois[r * 4 + 2] * scale - x1, 1.0f);
  const float roi_h = fmaxf(rois[r * 4 + 3] * scale - y1, 1.0f);
  for (int i = threadIdx.x; i < ph + pw; i += THREADS) {
    if (i < ph)
      bin_taps(bins[i], y1, roi_h / ph, i, H, S);
    else
      bin_taps(bins[i], x1, roi_w / pw, i - ph, W, S);
  }
  __syncthreads();

  const TI* base = fmap + (long long)frame_idx[r] * H * W * C;
  const long long row_stride = (long long)W * C;
  const int CV = C / V;  // channel groups a pixel
  for (int item = threadIdx.x; item < pw * CV; item += THREADS) {
    const int q = item / CV;
    const int c = (item - q * CV) * V;
    const BinTaps& bx = bins[ph + q];
    const int nx = bx.n;
    int xo[T];
    float xw[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      xo[j] = j < nx ? bx.idx[j] * C : 0;
      xw[j] = j < nx ? bx.w[j] : 0.0f;
    }
    const TI* col = base + c;
    TO* dst = out + (r * ph * pw + q) * C + c;
    // the x passes of the two map rows met last (every row's at most once:
    // a bin's rows rise, and the next bin starts at or past the row before
    // the last)
    float ua[V], ub[V];
    int ya = -1, yb = -1;
    for (int p = 0; p < ph; ++p) {
      const BinTaps& by = bins[p];
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      for (int j = 0; j < by.n; ++j) {
        const int y = by.idx[j];
        const float w = by.w[j];
        if (y == ya) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += w * ua[i];
        } else {
          if (y != yb) {
#pragma unroll
            for (int i = 0; i < V; ++i) ua[i] = ub[i];
            ya = yb;
            x_pass<TI, V, T>(col + y * row_stride, nx, xo, xw, ub);
            yb = y;
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += w * ub[i];
        }
      }
      store<V>(dst + (long long)p * pw * C, acc);
    }
  }
}

template <typename TI, typename TO, int V, int T>
int launch_t(const void* fmap, const void* rois, const void* frame_idx, void* out, int R, int H,
             int W, int C, int ph, int pw, float scale, int S, cudaStream_t stream) {
  const size_t smem = sizeof(BinTaps) * (size_t)(ph + pw);
  roi_align_kernel<TI, TO, V, T><<<(unsigned)R, THREADS, smem, stream>>>(
      static_cast<const TI*>(fmap), static_cast<const float*>(rois),
      static_cast<const int*>(frame_idx), static_cast<TO*>(out), H, W, C, ph, pw, scale, S);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch(const void* fmap, const void* rois, const void* frame_idx, void* out, int R, int H,
           int W, int C, int ph, int pw, float scale, int S, cudaStream_t stream) {
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(fmap) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && S <= 2)
    return launch_t<TI, TO, 8, 4>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale, S,
                                  stream);
  if (vec)
    return launch_t<TI, TO, 8, 2 * MAX_S>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale,
                                          S, stream);
  if (S <= 2)
    return launch_t<TI, TO, 1, 4>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale, S,
                                  stream);
  return launch_t<TI, TO, 1, 2 * MAX_S>(fmap, rois, frame_idx, out, R, H, W, C, ph, pw, scale, S,
                                        stream);
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t (0 = ok). frame_idx values must lie in [0, F) (the wrapper
// checks them). One block a roi: R <= 2^31 - 1.
extern "C" int roi_align(int in_dtype, int out_dtype, const void* fmap, const void* rois,
                         const void* frame_idx, void* out, int R, int F, int H, int W, int C,
                         int ph, int pw, float scale, int sampling_ratio, void* stream) {
  if (R <= 0 || F <= 0 || H <= 0 || W <= 0 || C <= 0 || ph <= 0 || pw <= 0 ||
      sampling_ratio <= 0 || sampling_ratio > MAX_S ||
      sizeof(BinTaps) * (size_t)(ph + pw) > (size_t)TAP_SMEM_MAX)
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
