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
// of one head do not line up. The forward, dK/dV and the per-element dQ
// route load per element (lane i takes dims i, i+32, ...) instead of having
// the wrapper zero-pad to 256, which would cost one more read and write of
// q, k, v and g; the staged dQ route copies whole token rows (all heads),
// which do line up, and each warp reads its head's slice from shared
// memory. Any D <= 256.
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
//       allowed key, r = sum_k p dP summed in fp32 (not from g.out, which
//       in bf16 would carry the output's rounding) and written for (b),
//       then dQ = sum_k dS k. Two routes, chosen by the wrapper from
//       dtype, shapes and alignment before the launch:
//       - staged (bf16, H <= 8, D even, 16-byte aligned rows and token
//         strides, H * D * 2 a multiple of 16; the training path): one block a
//         (video, query row), one warp a head. The block compacts the
//         mask row into a list of allowed keys in shared memory (one
//         ballot a warp), and brings the q and g rows and the listed keys'
//         k and v rows (all heads: 3872 bytes a row at H * D = 1936) into
//         shared memory by 16-byte cp.async, KC keys a chunk through a
//         ring of STAGES chunks, the next chunk in flight while one is
//         used. One walk over the list forms each (key, head)'s p and dP
//         (two warp sums, a chunk's keys interleaved, lanes on bf16 dim
//         pairs) and sums r = sum p dP, sum p dP k and sum p k
//         beside them, so dQ = scale (sum p dP k - r sum p k) is ready at
//         the walk's end: no key row is read twice and nothing is stored
//         per key. The difference of the two sums is taken in fp32 and
//         rounded once to bf16 (the route is bf16 only). On an H100 at the
//         training shapes it takes about 0.62 ms a step against a 0.23 ms
//         bound: the walk's arithmetic and shuffles about 0.25 ms, the key
//         rows' copies from L2 about 0.16 (PERF.md, from kernel_variants);
//       - per element (fp32, odd D, other views): one warp a (row, head),
//         lane i loading dims i, i + 32, ... of each allowed key's rows,
//         a first walk over the keys summing r, a second summing dQ.
//   (b) dK and dV, one warp per key row walking the key's allowed queries
//       in allowT: dV = sum_q p keep / (1 - rate) g_q, dK = sum_q dS q_q.
// A row or column with no allowed pair writes exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int WARPS = 8;             // (row, head) pairs per block
constexpr int THREADS = WARPS * 32;
constexpr int DMAX = 256;            // largest head dim
constexpr int SLOTS = DMAX / 32;     // dims per lane
constexpr float LSE_EMPTY = -1e30f;  // lse of a row with no allowed key
// Resident blocks per SM asked of the compiler (it caps registers to fit).
// On an H100 at the training shapes the train forward (dropout + lse) at 6
// and dK/dV at 4 ran faster than at the compiler's own choice (56 and 80
// registers; PERF.md); the eval forward and the per-element dQ ran no
// faster, and keep it.
constexpr int TRAIN_FWD_MIN_BLOCKS = 6;
constexpr int DKV_MIN_BLOCKS = 4;
constexpr int KC = 2;                // keys a cp.async chunk of the staged dQ route (warp_sum4)
constexpr int STAGES = 2;            // chunks in its ring
constexpr int DQ_MIN_BLOCKS = 3;     // its blocks an SM asked of the compiler (<= 85 registers)
constexpr int PAIRS = DMAX / 64;     // bf16 dim pairs a lane in the staged dQ route
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use on sm_90

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
        float ps = 0.f, pg = 0.f, kv[SLOTS];  // q and g read from shared memory, not
                                              // held: registers for 4 blocks an SM
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

// ----------------------------------------------- backward: dQ, staged route
// Dims 2 i and 2 i + 1 of a bf16 row in shared memory (4-byte aligned).
// (bf16 is the top half of an fp32: one shift or mask a dim)
__device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int i) {
  const uint32_t u = reinterpret_cast<const uint32_t*>(row)[i];
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// The warp sums of four values (two keys' q.k and g.v) in 10 shuffles, not
// 20: the first two rounds send each lane half of the values it does not
// keep, the last three sum one value a lane, four broadcasts return them.
__device__ __forceinline__ void warp_sum4(float& a0, float& b0, float& a1, float& b1) {
  const int lane = threadIdx.x & 31;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float x0 = hi16 ? b0 : a0, x1 = hi16 ? b1 : a1;
  x0 += __shfl_xor_sync(0xffffffffu, hi16 ? a0 : b0, 16);
  x1 += __shfl_xor_sync(0xffffffffu, hi16 ? a1 : b1, 16);
  float z = hi8 ? x1 : x0;
  z += __shfl_xor_sync(0xffffffffu, hi8 ? x0 : x1, 8);
  z += __shfl_xor_sync(0xffffffffu, z, 4);
  z += __shfl_xor_sync(0xffffffffu, z, 2);
  z += __shfl_xor_sync(0xffffffffu, z, 1);
  a0 = __shfl_sync(0xffffffffu, z, 0);  // lanes 0-7 hold a0, 8-15 a1, 16-23 b0, 24-31 b1
  a1 = __shfl_sync(0xffffffffu, z, 8);
  b0 = __shfl_sync(0xffffffffu, z, 16);
  b1 = __shfl_sync(0xffffffffu, z, 24);
}

// Shared memory of one block: the q and g rows, a ring of STAGES chunks of
// KC keys' k rows then their v rows, the key list. The wrapper's
// dq_staged_smem_bytes is the same sum.
size_t dq_staged_smem(int Lk, int H, int D) {
  const size_t E = (size_t)H * D;
  return (2 + 2 * STAGES * KC) * E * sizeof(__nv_bfloat16) + (size_t)Lk * sizeof(int);
}

template <bool DROP>
__global__ void __launch_bounds__(THREADS, DQ_MIN_BLOCKS)
masked_mha_bwd_dq_staged_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ g,
                                const unsigned char* __restrict__ allow,
                                const float* __restrict__ lse, const int* __restrict__ seeds,
                                __nv_bfloat16* __restrict__ dq, float* __restrict__ r_out,
                                Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[WARPS];
  const int E = a.H * a.D;   // elements a token row, all heads
  const int PIECES = E / 8;  // 16-byte copies a row
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // q row, then dq row
  __nv_bfloat16* gs = qs + E;
  __nv_bfloat16* ring = gs + E;  // stage t: rows 2 KC t + j (k) and 2 KC t + KC + j (v)
  int* keys = reinterpret_cast<int*>(ring + 2 * STAGES * KC * E);

  const long long row = blockIdx.x;  // b * Lq + qi
  const int b = (int)(row / a.Lq), qi = (int)(row % a.Lq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = warp;  // H <= WARPS: warps past H only copy
  const int D = a.D;
  const __nv_bfloat16* kb = k + b * a.k_sb;
  const __nv_bfloat16* vb = v + b * a.v_sb;

  const __nv_bfloat16* qp = q + b * a.q_sb + qi * a.q_sl;
  const __nv_bfloat16* gp = g + b * a.g_sb + qi * a.g_sl;
  for (int i = threadIdx.x; i < PIECES; i += THREADS) {
    cp_async16(qs + 8 * i, qp + 8 * i, true);
    cp_async16(gs + 8 * i, gp + 8 * i, true);
  }
  cp_async_commit();
  float L = 0.f;  // loaded beside the mask row, not after it
  uint32_t rkey = 0u;
  if (h < a.H) {
    L = lse[((long long)b * a.H + h) * a.Lq + qi];
    if (DROP) rkey = row_key(seeds[b], h, qi);
  }

  // the allowed keys of this query row, in order: THREADS mask bytes a
  // round, one ballot a warp, the warps' counts summed in shared memory
  const unsigned char* arow = allow + row * a.Lk;
  int nk = 0;
  for (int k0 = 0; k0 < a.Lk; k0 += THREADS) {
    const int kj = k0 + threadIdx.x;
    const bool on = kj < a.Lk && arow[kj];
    const unsigned live = __ballot_sync(0xffffffffu, on);
    if (lane == 0) counts[warp] = __popc(live);
    __syncthreads();
    int before = nk;
    for (int w = 0; w < warp; ++w) before += counts[w];
    if (on) keys[before + __popc(live & ((1u << lane) - 1u))] = kj;
    for (int w = 0; w < WARPS; ++w) nk += counts[w];
    __syncthreads();
  }
  const int chunks = (nk + KC - 1) / KC;

  // chunk c of the list into ring stage c % STAGES, one cp.async group
  // (empty past the list, so that every chunk's group keeps its place)
  auto stage = [&](int c) {
    const int c0 = c * KC, n = min(KC, nk - c0);
    __nv_bfloat16* st = ring + (c % STAGES) * 2 * KC * E;
    for (int j = 0; j < n; ++j) {
      const long long key = keys[c0 + j];
      for (int piece = threadIdx.x; piece < PIECES; piece += THREADS) {
        cp_async16(st + j * E + 8 * piece, kb + key * a.k_sl + 8 * piece, true);
        cp_async16(st + (KC + j) * E + 8 * piece, vb + key * a.v_sl + 8 * piece, true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) stage(c);

  // lane i holds dim pairs i, i + 32, ... of its head (D even: a head's
  // slice starts on 4 bytes in shared memory)
  const int D2 = D / 2;
  float2 qv[PAIRS], gv[PAIRS], pdk[PAIRS], pk[PAIRS];
  float r = 0.f;
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) pdk[j] = pk[j] = make_float2(0.f, 0.f);
  // one walk over the list: p and dP of each (key, head) from two warp
  // sums, and in the same pass r = sum p dP, sum p dP k and sum p k, so
  // that dQ = scale (sum p dP k - r sum p k) needs no second walk. A
  // chunk's keys are taken together: their 2 KC warp sums interleave.
  for (int c = 0; c < chunks; ++c) {
    stage(c + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    if (c == 0 && h < a.H) {
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) {
        const int i = lane + 32 * j;
        qv[j] = i < D2 ? pair(qs + h * D, i) : make_float2(0.f, 0.f);
        gv[j] = i < D2 ? pair(gs + h * D, i) : make_float2(0.f, 0.f);
      }
    }
    if (h < a.H) {
      const __nv_bfloat16* st = ring + (c % STAGES) * 2 * KC * E + h * D;
      const int n = min(KC, nk - c * KC);
      // no branch around a load: a key past the chunk's n reads key 0 and
      // a dim pair past D / 2 reads the last one, both with weight 0 (the
      // staged rows are finite), so the loads of a chunk issue together;
      // the k values stay in registers for the sums of p dP k and p k
      float ps[KC], pg[KC];
      float2 kk[KC][PAIRS];
#pragma unroll
      for (int j = 0; j < KC; ++j) ps[j] = pg[j] = 0.f;
#pragma unroll
      for (int jj = 0; jj < PAIRS; ++jj) {
        const int i = min(lane + 32 * jj, D2 - 1);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          const int jr = j < n ? j : 0;
          kk[j][jj] = pair(st + jr * E, i);
          const float2 vv = pair(st + (KC + jr) * E, i);
          ps[j] += qv[jj].x * kk[j][jj].x + qv[jj].y * kk[j][jj].y;
          pg[j] += gv[jj].x * vv.x + gv[jj].y * vv.y;
        }
      }
      static_assert(KC == 2, "warp_sum4 sums two keys' products");
      warp_sum4(ps[0], pg[0], ps[1], pg[1]);
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const float p = j < n ? __expf(ps[j] * a.scale - L) : 0.f;
        float dp = pg[j];
        if (DROP && j < n)
          dp = drop_bits(rkey, keys[c * KC + j]) >= a.threshold ? dp * a.keep_scale : 0.f;
        ps[j] = p;       // the key's p
        pg[j] = p * dp;  // and p dP (0 past n)
        r += pg[j];
      }
#pragma unroll
      for (int jj = 0; jj < PAIRS; ++jj) {
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          pdk[jj].x += pg[j] * kk[j][jj].x;
          pdk[jj].y += pg[j] * kk[j][jj].y;
          pk[jj].x += ps[j] * kk[j][jj].x;
          pk[jj].y += ps[j] * kk[j][jj].y;
        }
      }
    }
    __syncthreads();  // stage c % STAGES is refilled next
  }
  cp_async_wait<0>();  // the q and g rows when the list is empty
  __syncthreads();

  // the dQ row through shared memory, out by 16-byte stores
  if (h < a.H) {
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int i = lane + 32 * j;
      if (i < D2)
        reinterpret_cast<__nv_bfloat162*>(qs + h * D)[i] = __floats2bfloat162_rn(
            (pdk[j].x - r * pk[j].x) * a.scale, (pdk[j].y - r * pk[j].y) * a.scale);
    }
    if (lane == 0) r_out[((long long)b * a.H + h) * a.Lq + qi] = r;
  }
  __syncthreads();
  uint4* o = reinterpret_cast<uint4*>(dq + row * E);
  for (int i = threadIdx.x; i < PIECES; i += THREADS) o[i] = reinterpret_cast<const uint4*>(qs)[i];
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

template <bool DROP>
int bwd_dq_staged(const void* q, const void* k, const void* v, const void* g, const void* allow,
                  const void* lse, const void* seeds, void* dq, void* r, const Args& a,
                  cudaStream_t s) {
  const size_t smem = dq_staged_smem(a.Lk, a.H, a.D);
  cudaError_t e = cudaFuncSetAttribute(masked_mha_bwd_dq_staged_kernel<DROP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  masked_mha_bwd_dq_staged_kernel<DROP><<<(unsigned)((long long)a.B * a.Lq), THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const unsigned char*>(allow), static_cast<const float*>(lse),
      static_cast<const int*>(seeds), static_cast<__nv_bfloat16*>(dq), static_cast<float*>(r),
      a);
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

// The staged dQ route (bf16 only): the same arguments and outputs as
// masked_mha_bwd_dq. It refuses (cudaErrorInvalidValue) H > 8, odd D, rows that
// are not whole 16-byte pieces, pointers or token strides off 16-byte
// alignment, and shared memory past a block's limit; the wrapper checks
// the same before choosing it.
extern "C" int masked_mha_bwd_dq_staged(int dtype, const void* q, const void* k, const void* v,
                                        const void* g, const void* allow, const void* lse,
                                        const void* seeds, void* dq, void* r, int B, int Lq,
                                        int Lk, int H, int D, long long q_sb, long long q_sl,
                                        long long k_sb, long long k_sl, long long v_sb,
                                        long long v_sl, long long g_sb, long long g_sl,
                                        float scale, unsigned threshold, float keep_scale,
                                        void* stream) {
  const auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (dtype != 1 || bad_shape(B, Lq, Lk, H, D) || H > WARPS || D % 2 || (H * D) % 8 ||
      off16(q) || off16(k) || off16(v) || off16(g) || off16(dq) ||
      (q_sb | q_sl | k_sb | k_sl | v_sb | v_sl | g_sb | g_sl) % 8 != 0 ||
      dq_staged_smem(Lk, H, D) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seeds != nullptr ? bwd_dq_staged<true>(q, k, v, g, allow, lse, seeds, dq, r, a, s)
                          : bwd_dq_staged<false>(q, k, v, g, allow, lse, seeds, dq, r, a, s);
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
