// The packed grouped 3x3 conv of the ablation probe and its ablation
// variants, as an implicit GEMM on the tensor cores, for Hopper (sm_90a).
//
// Replaces tools/probe_pallas_ablate.py: `make` (call :87, body :47-84),
// the NHWC kernel, and `make_bt` (call :135, body :111-130), the same
// kernel over a block-major layout. Both time variants of the stage-4
// grouped conv of the VinVL trunk with its groups packed block-diagonally
// into 128-channel super-groups, so that every tap is one dense 128 x 128
// product, to find what bounds such a kernel.
//
// Geometry. xp is the input with its 2 halo rows: (N, H + 2, W, C) in NHWC
// or (C/128, N, H + 2, W, 128) block-major; w the packed weights
// (3, 3, 128, C) HWIO or (3, 3, C/128, 128, 128); out (N, H, W, C) or
// (C/128, N, H, W, 128). With blk(o) = o / 128, the variants are
//   FULL      out[n,h,w,o] = sum_{dh,dw,i} xp[n, h+dh, w+dw-1, blk(o)*128+i] w[dh,dw,i,o],
//             xp zero outside [0, W) in w (VALID in H, SAME in W);
//   MM_ONLY   the nine tap products with no shift:
//             out[n,h,w,o] = sum_{t,i} xp[n, h, w, blk(o)*128+i] w[t/3, t%3, i, o];
//   MM1_ONLY  the same with the one product of tap 0: w[0, 0];
//   ADD_ONLY  no products: nine adds of 0.001, each where its tap lies in
//             bounds in W (0.009 inside, 0.006 at the W edges);
//   CENTER    the one product of the centre tap: xp[n, h+1, w, .] @ w[1, 1]
//             (the probe's block-major `bt-mm1`, taps[:1] = (1, 0)).
// Every variant stages the same tiles (input and each tap's weights that
// it uses); they differ only in what is done with them, so FULL minus
// ADD_ONLY is the products' share and FULL minus MM_ONLY the shifts'.
//
// Bound. FULL and MM_ONLY do 18 * 128 operations a stored output element:
// at (8, 38, 64, 1024) 45.9 GFLOP, 46 us at 989 TFLOP/s, against 84 MB of
// x, w and out (25 us at 3.35 TB/s): bound by the tensor cores. One
// product is 5.1 GFLOP, so MM1_ONLY and CENTER are bound by bytes (25 us).
//
// Design. The TPU kernel ran each tap as a full-height matmul into VMEM and
// then added shifted slices of the result: a way around VMEM, and what
// bound it. Here a block owns TH output rows x W columns of one image and
// one super-group: it stages the TH + 2 input rows of that super-group,
// with a zero column on each side (the W edges), in shared memory, and then,
// tap by tap, the tap's 128 x 128 weights. The 9 taps run as mma.sync
// products over shifted views of the staged rows (the shift is only an
// offset of each lane's ldmatrix row address) into fp32 registers. Warps
// take 32 pixels x 64 channels each (TH * W / 32 x 2 warps). Staged rows
// are padded to 136 bf16 so that ldmatrix reads no bank twice. The
// float32 instantiation, which the chip check holds against cuDNN, runs
// the same tiles through scalar FMAs in the same fragment layout (no
// float32 tensor-core product is exact enough). A simple first version:
// plain 16-byte loads, one weight buffer, no cp.async / TMA pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int CB = 128;          // channels of a super-group
constexpr int MAX_THREADS = 512;
enum Variant { FULL = 0, MM_ONLY = 1, MM1_ONLY = 2, ADD_ONLY = 3, CENTER = 4 };

struct Geo {
  int N, H, W, C, TH, nb;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// staged row stride in elements: 128 channels and 16 bytes of padding
template <typename T>
struct Stride {
  static constexpr int PS = CB + 16 / (int)sizeof(T);
};

template <typename T, int V, bool BT>
__global__ void __launch_bounds__(MAX_THREADS)
ablate_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              const Geo g) {
  constexpr int E = 16 / (int)sizeof(T);   // elements of a 16-byte vector
  constexpr int PS = Stride<T>::PS;
  constexpr int VPR = CB / E;              // vectors of 128 channels
  constexpr int TAPS = (V == MM1_ONLY || V == CENTER) ? 1 : 9;
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);     // [CB][PS]: one tap's (in, out) weights
  T* in_s = w_s + CB * PS;                 // [TH + 2][W + 2][PS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n = blockIdx.y, b = blockIdx.z;
  const int h0 = blockIdx.x * g.TH;
  const int WP = g.W + 2, HP = g.H + 2;

  // the input rows h0 .. h0 + TH + 1 of super-group b, zero columns at 0 and W + 1
  const int n_vec = (g.TH + 2) * WP * VPR;
  for (int idx = tid; idx < n_vec; idx += nthreads) {
    const int v = idx % VPR, pix = idx / VPR;
    const int c = pix % WP, hr = h0 + pix / WP, wc = c - 1;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (hr < HP && wc >= 0 && wc < g.W) {
      const long long off =
          BT ? ((((long long)b * g.N + n) * HP + hr) * g.W + wc) * CB
             : (((long long)n * HP + hr) * g.W + wc) * g.C + (long long)b * CB;
      val = *reinterpret_cast<const uint4*>(x + off + v * E);
    }
    *reinterpret_cast<uint4*>(in_s + pix * PS + v * E) = val;
  }

  const int wm = warp >> 1, wn = warp & 1;  // 32 pixels x 64 channels a warp
  // this lane's ldmatrix row (bf16) and its accumulator rows (scalar path
  // and epilogue), as offsets of the unshifted staged pixel
  int a_off[2], c_off[2][2], c_col[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int p = wm * 32 + mi * 16 + (lane & 15);
    a_off[mi] = ((p / g.W) * WP + p % g.W) * PS + (lane >> 4) * 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      c_off[mi][half] = ((q / g.W) * WP + q % g.W) * PS;
      c_col[mi][half] = q % g.W;
    }
  }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

  for (int t = 0; t < TAPS; ++t) {
    const int wt = V == CENTER ? 4 : t;        // the tap whose weights are used
    int dh = t / 3, dwp = t % 3;               // the view's shift (dwp: padded column)
    if (V == MM_ONLY || V == MM1_ONLY) { dh = 0; dwp = 1; }
    if (V == CENTER) { dh = 1; dwp = 1; }
    __syncthreads();  // the input is staged; the previous tap's weights are read
    for (int idx = tid; idx < CB * VPR; idx += nthreads) {
      const int v = idx % VPR, k = idx / VPR;
      const long long off = BT ? (((long long)wt * g.nb + b) * CB + k) * CB
                               : ((long long)wt * CB + k) * g.C + (long long)b * CB;
      *reinterpret_cast<uint4*>(w_s + k * PS + v * E) =
          *reinterpret_cast<const uint4*>(w + off + v * E);
    }
    __syncthreads();
    const int shift = (dh * WP + dwp) * PS;
    if constexpr (V == ADD_ONLY) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int wc = c_col[mi][half] + dwp - 1;
          const float add = (wc >= 0 && wc < g.W) ? 0.001f : 0.0f;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            acc[mi][ni][2 * half] += add;
            acc[mi][ni][2 * half + 1] += add;
          }
        }
    } else if constexpr (sizeof(T) == 2) {
      const T* b_lane =
          w_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * PS + wn * 64 + (lane >> 4) * 8;
#pragma unroll 2
      for (int k0 = 0; k0 < CB; k0 += 16)
        warp_mma_32x64(acc, in_s + a_off[0] + shift + k0, in_s + a_off[1] + shift + k0,
                       b_lane + k0 * PS);
    } else {
      // float32: the same output elements a lane owns in the mma layout
      for (int mi = 0; mi < 2; ++mi)
        for (int half = 0; half < 2; ++half) {
          const T* ap = in_s + c_off[mi][half] + shift;
          for (int ni = 0; ni < 8; ++ni) {
            const T* bp = w_s + wn * 64 + ni * 8 + (lane & 3) * 2;
            float s0 = acc[mi][ni][2 * half], s1 = acc[mi][ni][2 * half + 1];
            for (int k = 0; k < CB; ++k) {
              const float a = ap[k];
              s0 += a * bp[k * PS];
              s1 += a * bp[k * PS + 1];
            }
            acc[mi][ni][2 * half] = s0;
            acc[mi][ni][2 * half + 1] = s1;
          }
        }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      const int h = h0 + q / g.W, wc = q % g.W;
      if (h >= g.H) continue;
      const long long base = BT ? ((((long long)b * g.N + n) * g.H + h) * g.W + wc) * CB
                                : (((long long)n * g.H + h) * g.W + wc) * g.C + (long long)b * CB;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        store2(out + base + wn * 64 + ni * 8 + (lane & 3) * 2, acc[mi][ni][2 * half],
               acc[mi][ni][2 * half + 1]);
    }
}

template <typename T, int V, bool BT>
int launch(const void* x, const void* w, void* out, const Geo& g, cudaStream_t s) {
  constexpr int PS = Stride<T>::PS;
  const size_t smem = sizeof(T) * ((size_t)CB * PS + (size_t)(g.TH + 2) * (g.W + 2) * PS);
  cudaError_t e = cudaFuncSetAttribute(ablate_kernel<T, V, BT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.H + g.TH - 1) / g.TH, g.N, g.nb);
  ablate_kernel<T, V, BT><<<grid, g.TH * g.W * 2, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int variant, int block_major, const void* x, const void* w, void* out,
             const Geo& g, cudaStream_t s) {
  if (!block_major) {
    switch (variant) {
      case FULL: return launch<T, FULL, false>(x, w, out, g, s);
      case MM_ONLY: return launch<T, MM_ONLY, false>(x, w, out, g, s);
      case MM1_ONLY: return launch<T, MM1_ONLY, false>(x, w, out, g, s);
      case ADD_ONLY: return launch<T, ADD_ONLY, false>(x, w, out, g, s);
    }
  } else {
    switch (variant) {
      case FULL: return launch<T, FULL, true>(x, w, out, g, s);
      case CENTER: return launch<T, CENTER, true>(x, w, out, g, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 FULL, 1 MM_ONLY, 2 MM1_ONLY,
// 3 ADD_ONLY (NHWC, block_major = 0); 0 FULL, 4 CENTER (block_major = 1).
// H is the output's height (x has H + 2 rows); C % 128 == 0; TH output rows
// a block with TH * W a multiple of 32 and at most 256. Tensors contiguous
// and 16-byte aligned. Returns the launch's cudaError_t (0 = ok).
extern "C" int grouped_conv_ablate(int dtype, int variant, int block_major, const void* x,
                                   const void* w, void* out, int N, int H, int W, int C, int TH,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % CB || TH <= 0 || (TH * W) % 32 ||
      TH * W * 2 > MAX_THREADS || N > 65535 || C / CB > 65535)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.TH = TH; g.nb = C / CB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(variant, block_major, x, w, out, g, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(variant, block_major, x, w, out, g, s);
  return (int)cudaErrorInvalidValue;
}
