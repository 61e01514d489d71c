// Grouped 3x3 convolution, stride 1, zero padding 1, channel-last, with an
// optional fused per-channel bias and ReLU, for Hopper (sm_90a).
//
// Replaces nl_vsgg_tpu/ops/pallas_grouped_conv.py::grouped_conv3x3 (body
// _kernel): the conv2 + FrozenBN + ReLU of the ResNeXt-152 bottlenecks at
// stride 1 (the FrozenBN scale folded into the weights by the caller):
//
//   out[n, h, w, o] = relu(bias[o] + sum_{dy, dx, i} x[n, h+dy-1, w+dx-1, g(o)*c + i]
//                                                   * w[dy, dx, i, o])
//
// with c = C / groups channels per group, g(o) = o / c, x zero outside the
// image.
//
// Layout. x is (N, H, W, C) contiguous, w the unpacked HWIO kernel
// (3, 3, c, C) contiguous, both fp32 or both bf16; bias (C,) fp32 or null;
// out (N, H, W, C) contiguous in the output type. fp32 sums.
//
// Bound. 18 c operations per output element against about 2 + 2 bytes of
// x and out in bf16: 36 (c = 8) to 288 (c = 64) operations per byte, at or
// below the card's ~295 for the tensor cores, so the function is bound by
// memory in principle: the trunk's c = 8 conv at 32 x 152 x 256 x 256 moves
// 1.27 GB in bf16, 0.38 ms at 3.35 TB/s.
//
// Design. The TPU kernel packs groups block-diagonally into 128-lane
// super-groups so that each tap is one dense MXU matmul; that trick fills
// only c/128 of the systolic array and has no reason to exist on Hopper.
// Here a block takes one tile of output pixels (up to 128: an 8x16 patch,
// or several whole small images, so the C5 head's 7x7 crops are tiled over
// N too) for CB = 64 output channels, i.e. 64 / c whole groups (or part of
// one group when c > 64). It stages that tile's input channels with the
// 1-pixel halo, and the groups' 9 c x 64 weights, in shared memory as fp32,
// in chunks of at most 16 input channels per group. Each thread owns 4
// consecutive output channels of one group (they read the same input
// values) over 8 pixels: per (tap, input channel) one float4 weight read
// and 8 input reads feed 32 fp32 FMAs held in registers. The epilogue adds
// the bias, clamps at 0 and stores in the output type. No tensor cores:
// this simple version runs on the CUDA cores (wgmma is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CB = 64;             // output channels per block
constexpr int THREADS = 256;
constexpr int QUADS = CB / 4;      // 4-channel groups of a block
constexpr int LANES = THREADS / QUADS;  // pixel lanes
constexpr int PPT = 8;             // pixels per thread
constexpr int PMAX = LANES * PPT;  // pixels per block
constexpr int KCMAX = 16;          // input channels per group per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Geo {
  int N, H, W, C, c;
  int NB, TH, TW;       // images, rows and columns of an output tile
  int tiles_h, tiles_w;
  int KC, CHS, PS;      // input channels per group per chunk, per chunk, pixel stride in smem
  int relu;
};

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
grouped_conv3x3_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                       const float* __restrict__ bias, TO* __restrict__ out, const Geo g) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);   // [9][KC][CB]
  float* in_s = w_s + 9 * g.KC * CB;              // [NB][TH+2][TW+2][PS]

  const int tid = threadIdx.x;
  const int cb0 = blockIdx.y * CB;
  const int cin0 = (cb0 / g.c) * g.c;
  int t = blockIdx.x;
  const int tw = t % g.tiles_w;
  t /= g.tiles_w;
  const int th = t % g.tiles_h;
  const int n0 = (t / g.tiles_h) * g.NB;
  const int h0 = th * g.TH, w0 = tw * g.TW;
  const int HT = g.TH + 2, WT = g.TW + 2;
  const int P = g.NB * g.TH * g.TW;

  const int quad = tid % QUADS, lane = tid / QUADS;
  const int o0 = quad * 4;
  const int gl = (cb0 + o0) / g.c - cb0 / g.c;   // the thread's group within the block
  int poff[PPT];
  for (int k = 0; k < PPT; ++k) {
    const int pix = lane + LANES * k;
    if (pix < P) {
      const int nb = pix / (g.TH * g.TW), py = (pix / g.TW) % g.TH, px = pix % g.TW;
      poff[k] = ((nb * HT + py) * WT + px) * g.PS + gl * g.KC;
    } else {
      poff[k] = 0;  // computed on a valid address, never stored
    }
  }
  float acc[PPT][4];
  for (int k = 0; k < PPT; ++k)
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.0f;

  const int n_in = g.NB * HT * WT * g.CHS;
  const int n_w = 9 * g.KC * CB;
  for (int kc0 = 0; kc0 < g.c; kc0 += g.KC) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < n_in; idx += THREADS) {
      const int q = idx % g.CHS;
      int pix = idx / g.CHS;
      const int xx = pix % WT;
      pix /= WT;
      const int yy = pix % HT;
      const int n = n0 + pix / HT;
      const int h = h0 - 1 + yy, ww = w0 - 1 + xx;
      const int ch = cin0 + (q / g.KC) * g.c + kc0 + q % g.KC;
      float v = 0.0f;
      if (n < g.N && h >= 0 && h < g.H && ww >= 0 && ww < g.W)
        v = to_f(x[(((long long)n * g.H + h) * g.W + ww) * g.C + ch]);
      in_s[(pix * WT + xx) * g.PS + q] = v;
    }
    for (int idx = tid; idx < n_w; idx += THREADS) {
      const int o = idx % CB;
      const int j = (idx / CB) % g.KC;
      const int tap = idx / (CB * g.KC);
      w_s[idx] = to_f(w[((long long)tap * g.c + kc0 + j) * g.C + cb0 + o]);
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * WT + tap % 3) * g.PS;
      for (int j = 0; j < g.KC; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(&w_s[(tap * g.KC + j) * CB + o0]);
        for (int k = 0; k < PPT; ++k) {
          const float v = in_s[poff[k] + shift + j];
          acc[k][0] += v * wv.x;
          acc[k][1] += v * wv.y;
          acc[k][2] += v * wv.z;
          acc[k][3] += v * wv.w;
        }
      }
    }
  }

  float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (bias != nullptr)
    for (int i = 0; i < 4; ++i) b[i] = bias[cb0 + o0 + i];
  for (int k = 0; k < PPT; ++k) {
    const int pix = lane + LANES * k;
    if (pix >= P) continue;
    const int n = n0 + pix / (g.TH * g.TW);
    const int h = h0 + (pix / g.TW) % g.TH, ww = w0 + pix % g.TW;
    if (n >= g.N || h >= g.H || ww >= g.W) continue;
    TO* dst = out + (((long long)n * g.H + h) * g.W + ww) * g.C + cb0 + o0;
    for (int i = 0; i < 4; ++i) {
      float v = acc[k][i] + b[i];
      if (g.relu) v = fmaxf(v, 0.0f);
      dst[i] = from_f<TO>(v);
    }
  }
}

template <typename TI, typename TO>
int launch(const void* x, const void* w, const void* bias, void* out, const Geo& g,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (9 * (size_t)g.KC * CB
                                       + (size_t)g.NB * (g.TH + 2) * (g.TW + 2) * g.PS);
  cudaError_t e = cudaFuncSetAttribute(grouped_conv3x3_kernel<TI, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((g.N + g.NB - 1) / g.NB) * g.tiles_h * g.tiles_w;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, g.C / CB);
  grouped_conv3x3_kernel<TI, TO><<<grid, THREADS, smem, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w), static_cast<const float*>(bias),
      static_cast<TO*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// in_dtype / out_dtype: 0 = float32, 1 = bfloat16; c = C / groups; bias may
// be null. Takes C % 64 == 0, c dividing 64 or a multiple of it, c % 4 == 0.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int grouped_conv3x3(int in_dtype, int out_dtype, const void* x, const void* w,
                               const void* bias, void* out, int N, int H, int W, int C, int c,
                               int relu, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || c <= 0 || C % CB || C % c || c % 4 ||
      (CB % c && c % CB))
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.c = c; g.relu = relu;
  g.TW = W < 16 ? W : 16;
  g.TH = H < PMAX / g.TW ? H : PMAX / g.TW;
  g.NB = 1;
  if (g.TH == H && g.TW == W) {  // whole small images: tile over N as well
    g.NB = PMAX / (H * W);
    if (g.NB > N) g.NB = N;
    if (g.NB < 1) g.NB = 1;
  }
  g.tiles_h = (H + g.TH - 1) / g.TH;
  g.tiles_w = (W + g.TW - 1) / g.TW;
  g.KC = c < KCMAX ? c : KCMAX;
  g.CHS = (c <= CB ? CB / c : 1) * g.KC;
  g.PS = g.CHS + 1;  // odd pixel stride: neighbouring pixels fall in other banks
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return launch<float, float>(x, w, bias, out, g, s);
  if (in_dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(x, w, bias, out, g, s);
  if (in_dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(x, w, bias, out, g, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, out, g, s);
  return (int)cudaErrorInvalidValue;
}
