// Masked multi-head attention for Hopper (sm_90a): the forward, with
// probability dropout and the log-sum-exp, and the two backward kernels.
//
// Replaces nl_vsgg_tpu/ops/pallas_attention.py::fused_masked_mha: the
// forward _fwd_kernel (built by _build.fwd_call) and the backward
// _bwd_kernel (built by _build.bwd_call), with the dropout keep mask of
// _keep_mask regenerated in both. The function MaskedMHA needs is
//
//   p[b, h, q, k]   = softmax_k(scale * q.k over allow[b, q, k])
//   out[b, q, h, :] = sum_k p * keep(b, h, q, k) / (1 - rate) * v[b, k, h, :]
//
// where a query row with no allowed key gives 0 (never NaN), and keep is a
// Bernoulli(1 - rate) bit (all ones at rate 0).
//
// Layout. q is (B, Lq, H, D), k and v are (B, Lk, H, D), g (the output's
// gradient) is (B, Lq, H, D), all with the head and dim axes packed (head
// stride D, dim stride 1) and arbitrary batch and token strides, so the
// wrapper passes the q/k/v column blocks of the fused projection output as
// they are. allow is a contiguous (B, Lq, Lk) bool mask (1 byte) and allowT
// its contiguous (B, Lk, Lq) transpose. out, dq, dk and dv are contiguous
// tensors of the input type; lse and r are contiguous (B, H, Lq) float32;
// seeds is (B,) int32, one per video. fp32 or bf16 inputs, fp32 sums.
//
// Head dim. STTran's head dim is 1936 / 8 = 242, not a multiple of 8: a
// head's slice of a bf16 row starts 484 bytes in, so 16-byte vector loads
// do not line up. The kernels load per element (lane i takes dims i, i+32,
// ...) instead of having the wrapper zero-pad to 256, which would cost one
// more read and write of q, k, v and g. Any D <= 256.
//
// Dropout bits. A stateless counter hash of (video seed, head, query, key):
// three rounds of murmur3's 32-bit finalizer over the key mixed in one
// coordinate at a time, compared on raw uint32 bits against
// rate * 2^32 as _keep_mask does. The hash uses only xor, shifts and
// 32-bit multiplies whose low half is kept, so the plain PyTorch version
// (ops/masked_attention.py::dropout_bits) computes the same bits with int64
// tensor ops, the kernel is held against it with dropout on, and the
// forward and backward regenerate the same mask without storing it. The
// bits are not the TPU's stream (nor need to be).
//
// Bound. At the training path's shapes (B = 64 videos, H = 8, bf16) a train
// step launches the forward 4 times (96x96 spatial encoder, two 192x192
// decoder layers, one 96x192 last decoder layer) and each backward kernel 4
// times. Each kernel is memory-bound on an H100: the masks leave about 3%
// of the (q, k) pairs allowed, so the products over the allowed pairs are a
// few GFLOP against about 0.6 GB (forward) to 1 GB (backward) of q, k, v,
// g and outputs to move once.
//
// Design. One warp per (video, query row, head) in the forward and in the
// dQ kernel, one warp per (video, key row, head) in the dK/dV kernel, the
// heads of a row in neighbouring warps of one block (they share the mask
// row). A warp scans its mask row 32 entries at a time, takes the allowed
// ones from a warp ballot and visits only those, so the work follows the
// allowed pairs, not Lq x Lk. Lane i holds dims i, i+32, ... of its rows; a
// dot product is a warp shuffle reduction. The forward's online softmax
// starts its running max at -inf: the first allowed key rescales the empty
// sum by exp(-inf) = 0, and a row that meets no allowed key keeps a zero
// sum, writes 0 and stores the lse sentinel -1e30.
//
// Backward, after _bwd_kernel's math (dP~ = g.v, dP = keep / (1 - rate) dP~,
// r = sum_k p dP, dS = p (dP - r) scale), in two launches with no atomics,
// so the result is deterministic:
//   (a) dQ, row-major like the forward: p = exp(s - lse) recomputed per
//       allowed key; a first pass sums r in fp32 (not from g.out, which in
//       bf16 would carry the output's rounding), a second sums
//       dQ = sum_k dS k; r is written for (b).
//   (b) dK and dV, one warp per key row walking the key's allowed queries
//       in allowT: dV = sum_q p keep / (1 - rate) g_q, dK = sum_q dS q_q.
// A row or column with no allowed pair writes exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // (row, head) pairs per block
constexpr int THREADS = WARPS * 32;
constexpr int DMAX = 256;            // largest head dim
constexpr int SLOTS = DMAX / 32;     // dims per lane
constexpr float LSE_EMPTY = -1e30f;  // lse of a row with no allowed key
// Resident blocks per SM asked of the compiler (it caps registers to fit).
// On an H100 at the training shapes the train forward (dropout + lse) at 6
// and dK/dV at 4 ran faster than at the compiler's own choice (56 and 80
// registers; PERF.md); the eval forward and dQ ran no faster, and keep it.
constexpr int TRAIN_FWD_MIN_BLOCKS = 6;
constexpr int DKV_MIN_BLOCKS = 4;

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

// murmur3's 32-bit finalizer; the plain version's `_fmix32` is the same.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the (seed, head, query) part of the hash, once per row
__device__ __forceinline__ uint32_t row_key(int seed, int h, int q) {
  const uint32_t a = fmix32((uint32_t)seed ^ ((uint32_t)(h + 1) * 0x9E3779B9u));
  return fmix32(a ^ ((uint32_t)(q + 1) * 0x85EBCA77u));
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t rkey, int k) {
  return fmix32(rkey ^ ((uint32_t)(k + 1) * 0xC2B2AE3Du));
}

struct Args {
  int B, Lq, Lk, H, D;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl;  // batch / token strides
  float scale;
  uint32_t threshold;  // drop when bits < threshold (rate * 2^32)
  float keep_scale;    // 1 / (1 - rate)
};

// ---------------------------------------------------------------- forward
template <typename T, bool DROP, bool LSE>
__global__ void __launch_bounds__(THREADS, DROP && LSE ? TRAIN_FWD_MIN_BLOCKS : 1)
masked_mha_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const unsigned char* __restrict__ allow,
                      const int* __restrict__ seeds, T* __restrict__ out,
                      float* __restrict__ lse, Args a) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // row * H + h
  if (w >= (long long)a.B * a.Lq * a.H) return;  // whole warps leave together
  const long long row = w / a.H;                // b * Lq + qi
  const int h = (int)(w % a.H);
  const int b = (int)(row / a.Lq), qi = (int)(row % a.Lq);
  const int D = a.D;
  const unsigned char* arow = allow + row * a.Lk;
  const uint32_t rkey = DROP ? row_key(seeds[b], h, qi) : 0u;

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
      // dropout acts on the normalized p: the sum l stays undropped
      float pv = p;
      if (DROP) pv = drop_bits(rkey, key) >= a.threshold ? p * a.keep_scale : 0.f;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) acc[j] = acc[j] * alpha + pv * vv[j];
    }
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;  // no allowed key -> 0
  T* o = out + w * D;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    if (d < D) o[d] = from_f<T>(acc[j] * inv);
  }
  if (LSE && lane == 0)
    lse[((long long)b * a.H + h) * a.Lq + qi] = l > 0.f ? m + logf(l) : LSE_EMPTY;
}

// ------------------------------------------------------------ backward: dQ
template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS)
masked_mha_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const unsigned char* __restrict__ allow,
                         const float* __restrict__ lse, const int* __restrict__ seeds,
                         T* __restrict__ dq, float* __restrict__ r_out, Args a) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // row * H + h
  if (w >= (long long)a.B * a.Lq * a.H) return;
  const long long row = w / a.H;
  const int h = (int)(w % a.H);
  const int b = (int)(row / a.Lq), qi = (int)(row % a.Lq);
  const int D = a.D;
  const unsigned char* arow = allow + row * a.Lk;
  const uint32_t rkey = DROP ? row_key(seeds[b], h, qi) : 0u;
  const long long stat = ((long long)b * a.H + h) * a.Lq + qi;
  const float L = lse[stat];

  const T* qp = q + b * a.q_sb + qi * a.q_sl + (long long)h * D;
  const T* gp = g + b * a.g_sb + qi * a.g_sl + (long long)h * D;
  const T* kb = k + b * a.k_sb + (long long)h * D;
  const T* vb = v + b * a.v_sb + (long long)h * D;
  float qv[SLOTS], gv[SLOTS], acc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    qv[j] = d < D ? to_f(qp[d]) : 0.f;
    gv[j] = d < D ? to_f(gp[d]) : 0.f;
    acc[j] = 0.f;
  }

  // pass 0 sums r = sum_k p dP; pass 1 sums dQ = sum_k p (dP - r) scale k
  float r = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < a.Lk; k0 += 32) {
      const int kj = k0 + lane;
      unsigned live = __ballot_sync(0xffffffffu, kj < a.Lk && arow[kj]);
      while (live) {
        const int key = k0 + __ffs(live) - 1;
        live &= live - 1;
        const T* kp = kb + key * a.k_sl;
        const T* vp = vb + key * a.v_sl;
        float ps = 0.f, pg = 0.f, kv[SLOTS];
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          const int d = lane + 32 * j;
          const bool in = d < D;
          kv[j] = in ? to_f(kp[d]) : 0.f;
          ps += qv[j] * kv[j];
          pg += in ? gv[j] * to_f(vp[d]) : 0.f;
        }
        const float p = __expf(warp_sum(ps) * a.scale - L);
        float dp = warp_sum(pg);
        if (DROP) dp = drop_bits(rkey, key) >= a.threshold ? dp * a.keep_scale : 0.f;
        if (pass == 0) {
          r += p * dp;
        } else {
          const float ds = p * (dp - r) * a.scale;
#pragma unroll
          for (int j = 0; j < SLOTS; ++j) acc[j] += ds * kv[j];
        }
      }
    }
  }

  T* o = dq + w * D;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    if (d < D) o[d] = from_f<T>(acc[j]);
  }
  if (lane == 0) r_out[stat] = r;
}

// ------------------------------------------------------- backward: dK, dV
template <typename T, bool DROP>
__global__ void __launch_bounds__(THREADS, DKV_MIN_BLOCKS)
masked_mha_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const unsigned char* __restrict__ allow_t,
                          const float* __restrict__ lse, const float* __restrict__ r_in,
                          const int* __restrict__ seeds, T* __restrict__ dk,
                          T* __restrict__ dv, Args a) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // key row * H + h
  if (w >= (long long)a.B * a.Lk * a.H) return;
  const long long krow = w / a.H;               // b * Lk + kj
  const int h = (int)(w % a.H);
  const int b = (int)(krow / a.Lk), kj = (int)(krow % a.Lk);
  const int D = a.D;
  const unsigned char* acol = allow_t + krow * a.Lq;
  const int seed = DROP ? seeds[b] : 0;
  const float* lse_b = lse + ((long long)b * a.H + h) * a.Lq;
  const float* r_b = r_in + ((long long)b * a.H + h) * a.Lq;

  const T* kp = k + b * a.k_sb + kj * a.k_sl + (long long)h * D;
  const T* vp = v + b * a.v_sb + kj * a.v_sl + (long long)h * D;
  const T* qb = q + b * a.q_sb + (long long)h * D;
  const T* gb = g + b * a.g_sb + (long long)h * D;
  float kv[SLOTS], vv[SLOTS], dk_acc[SLOTS], dv_acc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    kv[j] = d < D ? to_f(kp[d]) : 0.f;
    vv[j] = d < D ? to_f(vp[d]) : 0.f;
    dk_acc[j] = 0.f;
    dv_acc[j] = 0.f;
  }

  for (int q0 = 0; q0 < a.Lq; q0 += 32) {
    const int qj = q0 + lane;
    unsigned live = __ballot_sync(0xffffffffu, qj < a.Lq && acol[qj]);
    while (live) {
      const int qi = q0 + __ffs(live) - 1;
      live &= live - 1;
      const T* qp = qb + qi * a.q_sl;
      const T* gp = gb + qi * a.g_sl;
      float ps = 0.f, pg = 0.f, qv[SLOTS], gv[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int d = lane + 32 * j;
        const bool in = d < D;
        qv[j] = in ? to_f(qp[d]) : 0.f;
        gv[j] = in ? to_f(gp[d]) : 0.f;
        ps += qv[j] * kv[j];
        pg += gv[j] * vv[j];
      }
      // an allowed (q, k) pair means row q has a key: its lse is real
      const float p = __expf(warp_sum(ps) * a.scale - lse_b[qi]);
      float dp = warp_sum(pg), pt = p;
      if (DROP) {
        const bool keep = drop_bits(row_key(seed, h, qi), kj) >= a.threshold;
        dp = keep ? dp * a.keep_scale : 0.f;
        pt = keep ? p * a.keep_scale : 0.f;
      }
      const float ds = p * (dp - r_b[qi]) * a.scale;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        dv_acc[j] += pt * gv[j];
        dk_acc[j] += ds * qv[j];
      }
    }
  }

  T* ok = dk + w * D;
  T* ov = dv + w * D;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int d = lane + 32 * j;
    if (d < D) {
      ok[d] = from_f<T>(dk_acc[j]);
      ov[d] = from_f<T>(dv_acc[j]);
    }
  }
}

unsigned blocks_for(long long warps) { return (unsigned)((warps + WARPS - 1) / WARPS); }

bool bad_shape(int B, int Lq, int Lk, int H, int D) {
  return D < 1 || D > DMAX || B < 1 || Lq < 1 || Lk < 1 || H < 1;
}

Args make_args(int B, int Lq, int Lk, int H, int D, long long q_sb, long long q_sl,
               long long k_sb, long long k_sl, long long v_sb, long long v_sl,
               long long g_sb, long long g_sl, float scale, unsigned threshold,
               float keep_scale) {
  return Args{B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
              scale, threshold, keep_scale};
}

template <typename T, bool DROP, bool LSE>
int fwd(const void* q, const void* k, const void* v, const void* allow, const void* seeds,
        void* out, void* lse, const Args& a, cudaStream_t s) {
  masked_mha_fwd_kernel<T, DROP, LSE><<<blocks_for((long long)a.B * a.Lq * a.H), THREADS, 0,
                                        s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(allow), static_cast<const int*>(seeds),
      static_cast<T*>(out), static_cast<float*>(lse), a);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_any(const void* q, const void* k, const void* v, const void* allow, const void* seeds,
            void* out, void* lse, const Args& a, cudaStream_t s) {
  if (seeds == nullptr)
    return lse == nullptr ? fwd<T, false, false>(q, k, v, allow, seeds, out, lse, a, s)
                          : fwd<T, false, true>(q, k, v, allow, seeds, out, lse, a, s);
  return lse == nullptr ? fwd<T, true, false>(q, k, v, allow, seeds, out, lse, a, s)
                        : fwd<T, true, true>(q, k, v, allow, seeds, out, lse, a, s);
}

template <typename T, bool DROP>
int bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* allow,
           const void* lse, const void* seeds, void* dq, void* r, const Args& a,
           cudaStream_t s) {
  masked_mha_bwd_dq_kernel<T, DROP><<<blocks_for((long long)a.B * a.Lq * a.H), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const unsigned char*>(allow),
      static_cast<const float*>(lse), static_cast<const int*>(seeds), static_cast<T*>(dq),
      static_cast<float*>(r), a);
  return (int)cudaGetLastError();
}

template <typename T, bool DROP>
int bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* allow_t,
            const void* lse, const void* r, const void* seeds, void* dk, void* dv,
            const Args& a, cudaStream_t s) {
  masked_mha_bwd_dkv_kernel<T, DROP><<<blocks_for((long long)a.B * a.Lk * a.H), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const unsigned char*>(allow_t),
      static_cast<const float*>(lse), static_cast<const float*>(r),
      static_cast<const int*>(seeds), static_cast<T*>(dk), static_cast<T*>(dv), a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Dropout is on when `seeds` is not null
// (threshold = rate * 2^32, keep_scale = 1 / (1 - rate)); `lse` may be null
// (the eval forward). Each returns the launch's cudaError_t (0 = ok).
extern "C" int masked_mha_fwd(int dtype, const void* q, const void* k, const void* v,
                              const void* allow, const void* seeds, void* out, void* lse,
                              int B, int Lq, int Lk, int H, int D, long long q_sb,
                              long long q_sl, long long k_sb, long long k_sl,
                              long long v_sb, long long v_sl, float scale,
                              unsigned threshold, float keep_scale, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 0, 0,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_any<float>(q, k, v, allow, seeds, out, lse, a, s);
  if (dtype == 1) return fwd_any<__nv_bfloat16>(q, k, v, allow, seeds, out, lse, a, s);
  return (int)cudaErrorInvalidValue;
}

// dQ and r (B, H, Lq) from the forward's lse; dq is (B, Lq, H, D) contiguous.
extern "C" int masked_mha_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                 const void* g, const void* allow, const void* lse,
                                 const void* seeds, void* dq, void* r, int B, int Lq,
                                 int Lk, int H, int D, long long q_sb, long long q_sl,
                                 long long k_sb, long long k_sl, long long v_sb,
                                 long long v_sl, long long g_sb, long long g_sl,
                                 float scale, unsigned threshold, float keep_scale,
                                 void* stream) {
  if (bad_shape(B, Lq, Lk, H, D)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = seeds != nullptr;
  if (dtype == 0)
    return drop ? bwd_dq<float, true>(q, k, v, g, allow, lse, seeds, dq, r, a, s)
                : bwd_dq<float, false>(q, k, v, g, allow, lse, seeds, dq, r, a, s);
  if (dtype == 1)
    return drop ? bwd_dq<__nv_bfloat16, true>(q, k, v, g, allow, lse, seeds, dq, r, a, s)
                : bwd_dq<__nv_bfloat16, false>(q, k, v, g, allow, lse, seeds, dq, r, a, s);
  return (int)cudaErrorInvalidValue;
}

// dK and dV (B, Lk, H, D) contiguous, from allowT (B, Lk, Lq), lse and r.
extern "C" int masked_mha_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                  const void* g, const void* allow_t, const void* lse,
                                  const void* r, const void* seeds, void* dk, void* dv,
                                  int B, int Lq, int Lk, int H, int D, long long q_sb,
                                  long long q_sl, long long k_sb, long long k_sl,
                                  long long v_sb, long long v_sl, long long g_sb,
                                  long long g_sl, float scale, unsigned threshold,
                                  float keep_scale, void* stream) {
  if (bad_shape(B, Lq, Lk, H, D)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = seeds != nullptr;
  if (dtype == 0)
    return drop ? bwd_dkv<float, true>(q, k, v, g, allow_t, lse, r, seeds, dk, dv, a, s)
                : bwd_dkv<float, false>(q, k, v, g, allow_t, lse, r, seeds, dk, dv, a, s);
  if (dtype == 1)
    return drop ? bwd_dkv<__nv_bfloat16, true>(q, k, v, g, allow_t, lse, r, seeds, dk, dv, a, s)
                : bwd_dkv<__nv_bfloat16, false>(q, k, v, g, allow_t, lse, r, seeds, dk, dv, a, s);
  return (int)cudaErrorInvalidValue;
}
