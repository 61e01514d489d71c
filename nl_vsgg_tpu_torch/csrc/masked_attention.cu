// Masked multi-head attention, forward, for Hopper (sm_90a).
//
// Replaces the forward of nl_vsgg_tpu/ops/pallas_attention.py::fused_masked_mha
// (_fwd_kernel, built by _build.fwd_call) without dropout: the function
// MaskedMHA needs in eval mode,
//
//   out[b, q, h, :] = sum_k softmax_k(scale * q.k over allow[b, q, k]) * v[b, k, h, :]
//
// where a query row with no allowed key gives 0 (never NaN).
//
// Layout. q is (B, Lq, H, D), k and v are (B, Lk, H, D), with the head and
// dim axes packed (head stride D, dim stride 1) and arbitrary batch and
// token strides, so the wrapper passes the q/k/v column blocks of the fused
// projection output as they are. allow is a contiguous (B, Lq, Lk) bool
// mask (1 byte); out is a contiguous (B, Lq, H, D) tensor of the input type.
// fp32 or bf16 inputs, fp32 accumulation.
//
// Head dim. STTran's head dim is 1936 / 8 = 242, not a multiple of 8: a
// head's slice of a bf16 row starts 484 bytes in, so 16-byte vector loads
// do not line up. The kernel handles the tail itself (element loads, lane
// i takes dims i, i+32, ...) instead of having the wrapper zero-pad to 256,
// which would cost one more read and write of q, k and v. Any D <= 256.
//
// Bound. At the serving shapes (B = 64 videos, H = 8, bf16) one STTran
// forward launches this kernel 4 times (96x96 spatial encoder, two 192x192
// decoder layers, one 96x192 last decoder layer). Reading q, k, v and the
// 1-byte mask once and writing out once moves about 0.62 GB (0.65 GB with
// the TPU kernel's fp32 bias). The masks are sparse: a relation attends to
// the relations of its own frame (encoder) or its own 2-frame window
// (decoder), about 3% of the (q, k) pairs at those shapes, so the products
// over the allowed pairs are about 1.5 GFLOP of the 50 GFLOP a dense pass
// would do. The function is memory-bound on an H100: about 0.19 ms at
// 3.35 TB/s.
//
// Design. One warp per (video, query row, head), the heads of a row in
// neighbouring warps of one block (they share the mask row). The warp scans
// the row's mask 32 keys at a time, takes the allowed ones from a warp
// ballot and visits only those: lane i holds dims
// i, i+32, ... of q, of the running output and of each visited k and v row,
// a dot product is a warp shuffle reduction, and the online softmax state
// (running max, running sum) is uniform across the warp. The running max
// starts at -inf; the first allowed key rescales the empty sum by exp(-inf)
// = 0, and a row that meets no allowed key keeps a zero sum and writes 0.
// The work is the allowed pairs' (what the data needs), not Lq x Lk. A row
// re-reads the k/v rows of its window from L2; each is read from device
// memory about once per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;             // (query row, head) pairs per block
constexpr int THREADS = WARPS * 32;
constexpr int DMAX = 256;            // largest head dim
constexpr int SLOTS = DMAX / 32;     // dims per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  int B, Lq, Lk, H, D;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;  // batch / token strides, elements
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const unsigned char* __restrict__ allow,
                      T* __restrict__ out, Args a) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // row * H + h
  if (w >= (long long)a.B * a.Lq * a.H) return;  // whole warps leave together
  const long long row = w / a.H;                // b * Lq + qi
  const int h = (int)(w % a.H);
  const int b = (int)(row / a.Lq), qi = (int)(row % a.Lq);
  const int D = a.D;
  const unsigned char* arow = allow + row * a.Lk;

  const T* qp = q + b * a.q_sb + qi * a.q_sl + (long long)h * D;
  const T* kb = k + b * a.k_sb + (long long)h * D;
  const T* vb = v + b * a.v_sb + (long long)h * D;
  float qv[SLOTS], acc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < D ? to_f(qp[d]) : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < a.Lk; k0 += 32) {
    const int kj = k0 + lane;
    unsigned live = __ballot_sync(0xffffffffu, kj < a.Lk && arow[kj]);
    while (live) {  // warp-uniform: every lane walks the same keys
      const int key = k0 + __ffs(live) - 1;
      live &= live - 1;
      const T* kp = kb + key * a.k_sl;
      const T* vp = vb + key * a.v_sl;
      float part = 0.f, vv[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int d = lane + 32 * j;
        const bool in = d < D;
        part += in ? qv[j] * to_f(kp[d]) : 0.f;
        vv[j] = in ? to_f(vp[d]) : 0.f;
      }
      const float s = warp_sum(part) * a.scale;
      const float m_new = fmaxf(m, s);
      const float alpha = __expf(m - m_new);  // 0 while m is still -inf
      const float p = __expf(s - m_new);
      l = l * alpha + p;
      m = m_new;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) acc[j] = acc[j] * alpha + p * vv[j];
    }
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;  // no allowed key -> 0
  T* o = out + w * D;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    if (d < D) o[d] = from_f<T>(acc[j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* allow, void* out,
           const Args& a, cudaStream_t stream) {
  const long long warps = (long long)a.B * a.Lq * a.H;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  masked_mha_fwd_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(allow), static_cast<T*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t (0 = ok).
extern "C" int masked_mha_fwd(int dtype, const void* q, const void* k, const void* v,
                              const void* allow, void* out, int B, int Lq, int Lk, int H,
                              int D, long long q_sb, long long q_sl, long long k_sb,
                              long long k_sl, long long v_sb, long long v_sl, float scale,
                              void* stream) {
  if (D < 1 || D > DMAX || B < 1 || Lq < 1 || Lk < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, allow, out, a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, allow, out, a, s);
  return (int)cudaErrorInvalidValue;
}
