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
// of one head do not line up. The per-element routes load per element (lane
// i takes dims i, i+32, ...) instead of having the wrapper zero-pad to 256,
// which would cost one more read and write of q, k, v and g; the staged
// routes copy whole token rows, or the 16-byte window around a group of 2
// heads' slice of them, which do line up, and read a head's bf16 pairs
// from shared memory with 32-bit loads. The staged routes take D <= 256;
// the tiled and per-element routes D <= 320: their kernels are
// instantiated for the dims a lane holds, 8 (D <= 256) or 10 (D <= 320,
// DSG-DETR's tracklet encoder: 2376 / 8 = 297), the launch picking the
// smaller that fits; the tiled routes copy the 16-byte window around a
// head's float32 slice.
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
// Routes. Each kernel has three, the forward four, one launch each, chosen
// by the wrapper from dtype, shapes and alignment before the launch
// (ops/masked_attention.py: fwd_route, dq_route, dkv_route, on three rules,
// staged_layout, resident_layout and tiled_layout, tried in that order):
//   - staged (bf16, H <= 8, D even, 16-byte aligned rows and token strides,
//     H * D * 2 a multiple of 16; the serving and training paths' column
//     blocks of the fused projection);
//   - resident, the forward only (fp32, Lk <= 128, D <= 128, any number of
//     heads, 16-byte aligned rows and token strides, H * D a multiple of 4;
//     CLIP's towers): a block a (video, head, tile of 64 query rows) holds
//     every key's k and v in shared memory and each warp its 16 rows'
//     scores in registers; see "resident route" below;
//   - tiled (fp32, H <= 8, D <= 320, odd D too, 16-byte aligned rows and
//     token strides, H * D a multiple of 4; DSG-DETR's tracklet encoder):
//     a block a (video, tile of 16 rows taken in the wrapper's row order,
//     head), the tile's union of allowed columns staged once; see "tiled
//     routes" below;
//   - per element (bf16 with odd D or D > 256, other views, H > 8): one
//     warp per (video, row, head), the heads of a row in neighbouring warps
//     of one block (they share the mask row). A warp scans its mask row 32 entries at a time,
//     takes the allowed ones from a warp ballot and visits only those, so
//     the work follows the allowed pairs, not Lq x Lk; lane i holds dims i,
//     i+32, ... of its rows, a dot product is a warp shuffle reduction.
//
// Forward, staged: one block a (video, tile of 16 consecutive query rows, 2
// heads). All the rows of a frame (spatial) or a window (temporal) allow
// the same keys and sit in consecutive slots, so the block compacts the
// union of its rows' allowed keys into a list (a 16-bit word a key: which
// rows allow it) and brings the listed keys' k and v slices in once a tile,
// 8 keys a cp.async chunk through a 2-chunk ring. Per chunk the 4 warps of
// a head form the 16 x 8 scores S = Q K^T on the tensor cores (mma.sync
// m16n8k16, each a quarter of the head dim's k-steps with its q fragments
// in registers, the partial sums added through shared memory); each warp
// (a quarter of the output dims) masks them by the words, runs the
// online softmax (running max from -inf: the first allowed key rescales the
// empty sum by exp(-inf) = 0; a row with no allowed key keeps a zero sum,
// writes 0 and stores the lse sentinel -1e30), drops out p (the row key
// hashed once a (row, head)) and adds P~ V (m16n8k16). The per-element
// forward keeps the same softmax, one key at a time.
//
// Backward, after _bwd_kernel's math (dP~ = g.v, dP = keep / (1 - rate) dP~,
// r = sum_k p dP, dS = p (dP - r) scale), in two launches with no atomics,
// so the result is deterministic:
//   (a) dQ, row-major like the forward: p = exp(s - lse) recomputed per
//       allowed key, r = sum_k p dP summed in fp32 (not from g.out, which
//       in bf16 would carry the output's rounding) and written for (b),
//       then dQ = sum_k dS k.
//       - staged: one block a (video, query row), one warp a head. The
//         block compacts the mask row into a list of allowed keys in shared
//         memory (one ballot a warp), and brings the q and g rows and the
//         listed keys' k and v rows (all heads: 3872 bytes a row at H * D =
//         1936) into shared memory by 16-byte cp.async, KC keys a chunk
//         through a ring of STAGES chunks. One walk over the list forms
//         each (key, head)'s p and dP (two warp sums, a chunk's keys
//         interleaved, lanes on bf16 dim pairs) and sums r = sum p dP, sum
//         p dP k and sum p k beside them, so dQ = scale (sum p dP k - r sum
//         p k) is ready at the walk's end: no key row is read twice and
//         nothing is stored per key. The difference is taken in fp32 and
//         rounded once to bf16;
//       - per element: a first walk over the keys summing r, a second
//         summing dQ.
//   (b) dK and dV from the transposed mask allowT: dV = sum_q p keep /
//       (1 - rate) g_q, dK = sum_q dS q_q.
//       - staged: one block a (video, tile of 16 key rows, 2 heads); the
//         tile's k and v slices stay in shared memory, the union of its
//         allowed queries is listed with 16-bit words, each listed query's
//         lse, r and dropout row key are copied once a head, and its q and g
//         slices come through the ring. Per chunk of 8 queries the 2 warps
//         of a head form S^T = K Q^T and dP~^T = V g^T on m16n8k16 (half
//         the k-steps each, the partial sums added through shared memory);
//         each (half of the dims) then forms p~ and dS for the allowed
//         pairs and adds p~^T g and dS^T q (m16n8k16) to its fp32 dV and
//         dK sums;
//       - per element: one warp per key row walking its allowed queries.
// The staged routes' second products take p~ and dS split into two bf16
// parts (hi + the rounding rest), so they keep about 16 bits and the
// outputs match fp32 sums to one bf16 rounding. A row or column with no
// allowed pair writes exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "cp_async.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int WARPS = 8;             // (row, head) pairs per block
constexpr int THREADS = WARPS * 32;
constexpr int DMAX = 320;            // largest head dim (per-element routes)
constexpr int STAGED_DMAX = 256;     // largest head dim of the staged routes
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
constexpr int PAIRS = STAGED_DMAX / 64;  // bf16 dim pairs a lane in the staged dQ route
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use on sm_90

// The per-element kernels hold SLOTS dims a lane (8 up to D = 256, 10 up to
// 320). The 10-dim instantiations ask for fewer resident blocks in the
// same proportion, so the compiler's register cap grows with the dims; the
// 8-dim ones keep the counts above.
constexpr int slots_for(int D) { return D <= 256 ? 8 : 10; }
constexpr int min_blocks_for(int blocks, int slots) {
  return blocks * 8 / slots > 1 ? blocks * 8 / slots : 1;
}

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
template <typename T, int SLOTS, bool DROP, bool LSE>
__global__ void __launch_bounds__(THREADS,
                                  DROP && LSE ? min_blocks_for(TRAIN_FWD_MIN_BLOCKS, SLOTS) : 1)
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
template <typename T, int SLOTS, bool DROP>
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

// The indices j < n whose mask bits are not 0, in order, into list (and
// their bits, up to 16, into lbits unless it is null); returns their count. NT mask
// columns a round, one ballot a warp, the warps' counts summed in shared
// memory. Every thread of the block calls it.
template <int NT, typename Bits>
__device__ int compact_list(int n, Bits bits_of, int* list, uint16_t* lbits, int* counts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int total = 0;
  for (int j0 = 0; j0 < n; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const unsigned bits = j < n ? bits_of(j) : 0u;
    const bool on = bits != 0u;
    const unsigned live = __ballot_sync(0xffffffffu, on);
    if (lane == 0) counts[warp] = __popc(live);
    __syncthreads();
    int before = total;
    for (int w = 0; w < warp; ++w) before += counts[w];
    if (on) {
      const int at = before + __popc(live & ((1u << lane) - 1u));
      list[at] = j;
      if (lbits != nullptr) lbits[at] = (uint16_t)bits;
    }
    for (int w = 0; w < NT / 32; ++w) total += counts[w];
    __syncthreads();
  }
  return total;
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

  // the allowed keys of this query row, in order
  const unsigned char* arow = allow + row * a.Lk;
  const int nk = compact_list<THREADS>(
      a.Lk, [&](int kj) { return (unsigned)arow[kj]; }, keys, nullptr, counts);
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

// ------------------------------------ staged routes over 16-row mma tiles
// The forward and dK/dV staged routes run on the tensor cores. One block
// takes (video, a tile of TILE consecutive rows, a group of HG heads) and
// brings the 16-byte window around its heads' slice of each token row in by
// 16-byte cp.async (2 heads a block, 3 blocks an SM; a 2-head slice starts
// only on 8 bytes, and 8-byte copies cost twice the instructions). The
// warps of a head split S's k-steps (their partial sums meet in shared
// memory) and the output dims. A head's slice starts 4 bytes off 16 (484 bytes at D =
// 242), which ldmatrix cannot read; the mma fragments are bf16 pairs, read
// by 32-bit shared loads, and outputs leave through shared memory by
// coalesced 8-byte stores.
// Probabilities and dS enter the second product split into two bf16 parts
// (hi + lo, the rounding rest), so the products keep about 16 bits and the
// outputs agree with fp32 sums to one bf16 rounding.
constexpr int TILE = 16;     // rows a block: the mma's m
constexpr int HG = 2;        // heads a block
constexpr int CK = 8;        // keys (forward) or queries (dK/dV) a cp.async chunk: the mma's n / k
// Warps a head (its "parts"): a part forms k-steps part, part + PARTS, ...
// of S's 16 and sums output tiles part * 32 / PARTS, ... of the head's 32
// 8-dim tiles. dK/dV holds two outputs' sums a warp and forms two products
// a k-step, so it takes fewer, larger parts.
constexpr int FWD_PARTS = 4;
constexpr int DKV_PARTS = 2;

// A staged kernel's own shared memory: each lane's `sums` partial 16 x 8
// tiles (a float4 each) and a count a warp. The wrapper's _plan is the same.
constexpr size_t static_smem(int parts, int sums) {
  return (size_t)parts * HG * 32 * 16 * sums + (size_t)parts * HG * 4;
}

// dims d, d + 1 of a bf16 row in shared memory (d even), 0 past D
__device__ __forceinline__ uint32_t pair_bits(const __nv_bfloat16* row, int d, int D) {
  return d < D ? *reinterpret_cast<const uint32_t*>(row + d) : 0u;
}

// dim d of two rows, packed as the low and high half of a b32
__device__ __forceinline__ uint32_t column_pair(const __nv_bfloat16* r0, const __nv_bfloat16* r1,
                                                int d, int D) {
  if (d >= D) return 0u;
  const unsigned short* a = reinterpret_cast<const unsigned short*>(r0);
  const unsigned short* b = reinterpret_cast<const unsigned short*>(r1);
  return (uint32_t)a[d] | ((uint32_t)b[d] << 16);
}

// x and y as bf16 pairs hi + lo, lo the rounding rest of hi
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc (16 x 8 output tile) += (A_hi + A_lo) @ B for a 16 x 8 A given as
// its hi and lo fragments and an 8 x 8 B fragment b, in one m16n8k16: A_hi
// and A_lo side by side along k, B stacked on itself.
__device__ __forceinline__ void mma_split(float (&acc)[4], const uint32_t (&hi)[2],
                                          const uint32_t (&lo)[2], uint32_t b) {
  const uint32_t af[4] = {hi[0], hi[1], lo[0], lo[1]};
  mma_bf16_16816(acc, af, b, b);
}

// One k-step of 16 dims of an S tile: s (16 rows x 8) += A rows (a row
// g / g + 8 of `a`, stride lda) . B rows (row g of `b`, stride ldb), dims
// 16 kk .. 16 kk + 15, 0 past D.
__device__ __forceinline__ void mma_rows(float (&s)[4], const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb, int kk, int D) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int d0 = 16 * kk + 2 * t, d1 = d0 + 8;
  const uint32_t af[4] = {pair_bits(a + g * lda, d0, D), pair_bits(a + (g + 8) * lda, d0, D),
                          pair_bits(a + g * lda, d1, D), pair_bits(a + (g + 8) * lda, d1, D)};
  mma_bf16_16816(s, af, pair_bits(b + g * ldb, d0, D), pair_bits(b + g * ldb, d1, D));
}

// A group's window of a token row: its heads' slice [h0 D, (h0 + nh) D)
// widened to 16-byte bounds, which stay inside the row (rows are whole
// 16-byte pieces), so it is copied by 16-byte cp.async; the slice starts
// `shift` elements into it (0 or 4: h0 D is a multiple of 4 for even D).
struct Window {
  int start, len, shift;
};

__device__ __forceinline__ Window group_window(int h0, int nh, int D) {
  const int start = (h0 * D) & ~7, end = ((h0 + nh) * D + 7) & ~7;
  return Window{start, end - start, h0 * D - start};
}

// Shared row stride of a window: at least the widest window (HG heads and
// 8 elements), and 8 mod 16 elements, so that the fragments' 32-bit loads
// of 8 rows at 4 columns fall in 32 different banks. The wrapper's
// _shared_row is the same.
__host__ __device__ __forceinline__ int shared_row(int H, int D) {
  const int w = min(H, HG) * D + 8;
  return w + (24 - w % 16) % 16;
}

// `rows` rows of `len` elements (a multiple of 8) from src (token stride sl)
// to dst (row stride ld) by 16-byte cp.async, a warp a row; rows n .. rows
// - 1 zero-filled.
template <int NT>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                                          long long sl, int n, int rows, int len) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NT / 32) {
    const bool in = r < n;
    const __nv_bfloat16* s = src + (in ? r * sl : 0);
    for (int e = 8 * lane; e < len; e += 256) cp_async16(dst + r * ld + e, s + e, in);
  }
}

// `rows` rows of `len` elements (a multiple of 4) from shared memory (row
// stride ld) to dst (token stride sl) by 8-byte stores, a warp a row.
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long sl,
                                           const __nv_bfloat16* src, int ld, int rows, int len) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += NT / 32)
    for (int e = 4 * lane; e < len; e += 128)
      *reinterpret_cast<uint2*>(dst + r * sl + e) =
          *reinterpret_cast<const uint2*>(src + r * ld + e);
}

// An output tile's fragment (rows g and g + 8, dims d and d + 1) into
// shared memory as bf16 pairs, scaled by f0 (row g) and f1 (row g + 8).
__device__ __forceinline__ void put_tile(__nv_bfloat16* rows, int ld, int g, int d,
                                         const float (&c)[4], float f0, float f1) {
  *reinterpret_cast<__nv_bfloat162*>(rows + g * ld + d) =
      __floats2bfloat162_rn(c[0] * f0, c[1] * f0);
  *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8) * ld + d) =
      __floats2bfloat162_rn(c[2] * f1, c[3] * f1);
}

// The listed rows c0 .. c0 + CK - 1 of two token-row tensors (list[] token
// indices, n of them left; `len` elements, a multiple of 8) into two CK-row
// blocks of dst by 16-byte cp.async, zero-filled past n.
template <int NT>
__device__ __forceinline__ void gather_chunk(__nv_bfloat16* dst, int ld, const int* list, int n,
                                             const __nv_bfloat16* x, long long x_sl,
                                             const __nv_bfloat16* y, long long y_sl, int len) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < CK; j += NT / 32) {
    const bool in = j < n;
    const long long tok = in ? list[j] : 0;
    const __nv_bfloat16* xs = x + tok * x_sl;
    const __nv_bfloat16* ys = y + tok * y_sl;
    for (int e = 8 * lane; e < len; e += 256) {
      cp_async16(dst + j * ld + e, xs + e, in);
      cp_async16(dst + (CK + j) * ld + e, ys + e, in);
    }
  }
}

// ---------------------------------------------- forward, staged route
// One block a (video, tile of TILE query rows, HG heads), PARTS HG warps:
// warp w takes head w % HG of the group and part w / HG of its k-steps (its
// q fragments held in registers) and of its output dims. The
// block compacts the union of its rows' allowed keys (a TILE-bit word a
// key, bit t for tile row t) and brings the listed keys' k and v slices
// through a ring of FWD_STAGES chunks of CK keys, so a key's rows cross
// from L2 once a tile. For each chunk the PARTS warps of a head form the 16
// x 8 scores S = Q K^T together (each its k-steps on m16n8k16, the partial
// sums exchanged through shared memory), and each masks them by the bits,
// runs the online softmax of its rows (row max over a lane quad),
// applies dropout (the row key hashed once a (row, head)) and adds P~ V
// for its PART_NT output tiles (P~ in hi and lo parts, one m16n8k16).
constexpr int FWD_STAGES = 2;      // chunks in the ring
constexpr int FWD_MIN_BLOCKS = 3;  // its blocks an SM asked of the compiler

// Shared memory of one block: the tile's q slices, the ring of k and v
// slices, the key list and its row bits. The wrapper's
// fwd_staged_smem_bytes is the same sum.
size_t fwd_staged_smem(int Lk, int H, int D) {
  const size_t EG = shared_row(H, D);
  return (TILE + 2 * FWD_STAGES * CK) * EG * sizeof(__nv_bfloat16) +
         (size_t)Lk * (sizeof(int) + sizeof(uint16_t));
}

template <bool DROP, bool LSE>
__global__ void __launch_bounds__(FWD_PARTS * HG * 32, FWD_MIN_BLOCKS)
masked_mha_fwd_staged_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const unsigned char* __restrict__ allow,
                             const int* __restrict__ seeds, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, Args a) {
  constexpr int PARTS = FWD_PARTS, PART_NT = 32 / PARTS, PART_KS = 16 / PARTS;
  constexpr int NT = PARTS * HG * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[NT / 32];
  __shared__ float4 partial[NT];  // each lane's partial S of its warp's k-steps
  const int D = a.D, EG = shared_row(a.H, D);  // shared row stride
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // TILE q slices
  __nv_bfloat16* ring = qs + TILE * EG;  // stage: CK k slices, then CK v slices
  int* keys = reinterpret_cast<int*>(ring + 2 * FWD_STAGES * CK * EG);
  uint16_t* kbits = reinterpret_cast<uint16_t*>(keys + a.Lk);

  const int groups = (a.H + HG - 1) / HG, tiles = (a.Lq + TILE - 1) / TILE;
  const int grp = blockIdx.x % groups, tile = (blockIdx.x / groups) % tiles;
  const int b = blockIdx.x / (groups * tiles);
  const int q0 = tile * TILE, nrows = min(TILE, a.Lq - q0);
  const int h0 = grp * HG, nh = min(HG, a.H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int hl = warp % HG, part = warp / HG, h = h0 + hl;
  const bool live = hl < nh;  // warp-uniform
  const Window win = group_window(h0, nh, D);
  const __nv_bfloat16* kb = k + b * a.k_sb + win.start;
  const __nv_bfloat16* vb = v + b * a.v_sb + win.start;

  copy_rows<NT>(qs, EG, q + b * a.q_sb + q0 * a.q_sl + win.start, a.q_sl, nrows, TILE, win.len);
  cp_async_commit();
  // the dropout row keys of this lane's rows g and g + 8, once
  const uint32_t rkey0 = DROP && live ? row_key(seeds[b], h, q0 + g) : 0u;
  const uint32_t rkey1 = DROP && live ? row_key(seeds[b], h, q0 + g + 8) : 0u;

  const unsigned char* arow = allow + ((long long)b * a.Lq + q0) * a.Lk;
  const int nk = compact_list<NT>(
      a.Lk,
      [&](int kj) {
        unsigned bits = 0u;  // the tile's mask bytes of this column, loaded together
#pragma unroll
        for (int r = 0; r < TILE; ++r)
          if (r < nrows) bits |= (arow[(long long)r * a.Lk + kj] ? 1u : 0u) << r;
        return bits;
      },
      keys, kbits, counts);
  const int chunks = (nk + CK - 1) / CK;
  auto stage = [&](int c) {
    if (c * CK < nk)
      gather_chunk<NT>(ring + (c % FWD_STAGES) * 2 * CK * EG, EG, keys + c * CK,
                       nk - c * CK, kb, a.k_sl, vb, a.v_sl, win.len);
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < FWD_STAGES - 1; ++c) stage(c);

  // rows g (r = 0) and g + 8 (r = 1): running max and sum (this lane's
  // columns; the quad's sum at the end); acc[i]: output tile part * PART_NT + i
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[PART_NT][4];
#pragma unroll
  for (int i = 0; i < PART_NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int ntiles = (D + 7) / 8;
  const __nv_bfloat16* qh = qs + win.shift + hl * D;
  uint32_t qf[PART_KS][4];  // A fragments of this warp's k-steps, once the q rows land
  for (int c = 0; c < chunks; ++c) {
    stage(c + FWD_STAGES - 1);
    cp_async_wait<FWD_STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* kr = ring + (c % FWD_STAGES) * 2 * CK * EG + win.shift + hl * D;
    const __nv_bfloat16* vr = kr + CK * EG;
    if (live) {
      // this warp's k-steps of S: s[0], s[1] row g, key slots 2t, 2t + 1;
      // s[2], s[3] row g + 8
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PART_KS; ++j) {
        const int d0 = 16 * (part + PARTS * j) + 2 * t, d1 = d0 + 8;
        if (d0 - 2 * t >= D) break;
        if (c == 0) {
          qf[j][0] = pair_bits(qh + g * EG, d0, D);
          qf[j][1] = pair_bits(qh + (g + 8) * EG, d0, D);
          qf[j][2] = pair_bits(qh + g * EG, d1, D);
          qf[j][3] = pair_bits(qh + (g + 8) * EG, d1, D);
        }
        mma_bf16_16816(s, qf[j], pair_bits(kr + g * EG, d0, D), pair_bits(kr + g * EG, d1, D));
      }
      partial[threadIdx.x] = make_float4(s[0], s[1], s[2], s[3]);
    }
    __syncthreads();
    if (live) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};  // the head's S: its PARTS warps' sums
#pragma unroll
      for (int pp = 0; pp < PARTS; ++pp) {
        const float4 x = partial[(pp * HG + hl) * 32 + lane];
        s[0] += x.x;
        s[1] += x.y;
        s[2] += x.z;
        s[3] += x.w;
      }
      const int j0 = c * CK + 2 * t, j1 = j0 + 1;
      const unsigned w0 = j0 < nk ? kbits[j0] : 0u, w1 = j1 < nk ? kbits[j1] : 0u;
      const int key0 = j0 < nk ? keys[j0] : 0, key1 = j1 < nk ? keys[j1] : 0;
      float p[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool on0 = (w0 >> (g + 8 * r)) & 1u, on1 = (w1 >> (g + 8 * r)) & 1u;
        const float x0 = on0 ? s[2 * r] * a.scale : -INFINITY;
        const float x1 = on1 ? s[2 * r + 1] * a.scale : -INFINITY;
        float mx = fmaxf(x0, x1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);
        p[2 * r] = on0 ? __expf(x0 - m_new) : 0.f;
        p[2 * r + 1] = on1 ? __expf(x1 - m_new) : 0.f;
        l[r] = l[r] * alpha + p[2 * r] + p[2 * r + 1];
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < PART_NT; ++i) {
          acc[i][2 * r] *= alpha;
          acc[i][2 * r + 1] *= alpha;
        }
        // dropout acts on the normalized p: the sum l stays undropped
        if (DROP) {
          const uint32_t rk = r ? rkey1 : rkey0;
          p[2 * r] = drop_bits(rk, key0) >= a.threshold ? p[2 * r] * a.keep_scale : 0.f;
          p[2 * r + 1] = drop_bits(rk, key1) >= a.threshold ? p[2 * r + 1] * a.keep_scale : 0.f;
        }
      }
      uint32_t hi[2], lo[2];
      split_pair(p[0], p[1], hi[0], lo[0]);
      split_pair(p[2], p[3], hi[1], lo[1]);
#pragma unroll
      for (int i = 0; i < PART_NT; ++i) {
        const int nt = part * PART_NT + i;
        if (nt >= ntiles) break;
        mma_split(acc[i], hi, lo,
                  column_pair(vr + 2 * t * EG, vr + (2 * t + 1) * EG, nt * 8 + g, D));
      }
    }
    __syncthreads();  // stage c % FWD_STAGES is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();  // the q rows are free: the out rows go there

  if (live) {
    float inv[2], L[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = sum > 0.f ? 1.f / sum : 0.f;  // no allowed key -> 0
      L[r] = sum > 0.f ? m[r] + logf(sum) : LSE_EMPTY;
    }
#pragma unroll
    for (int i = 0; i < PART_NT; ++i) {
      const int d = (part * PART_NT + i) * 8 + 2 * t;
      if (d - 2 * t >= D) break;
      if (d < D) put_tile(qs + win.shift + hl * D, EG, g, d, acc[i], inv[0], inv[1]);
    }
    if (LSE && part == 0 && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (g + 8 * r < nrows) lse[((long long)b * a.H + h) * a.Lq + q0 + g + 8 * r] = L[r];
    }
  }
  __syncthreads();
  store_rows<NT>(out + (((long long)b * a.Lq + q0) * a.H + h0) * D, (long long)a.H * D,
                 qs + win.shift, EG, nrows, nh * D);
}

// -------------------------------------------- dK, dV, staged route
// One block a (video, tile of TILE key rows, HG heads), PARTS HG warps:
// warp w takes head w % HG of the group and part w / HG of its k-steps and
// of its output dims, for dK and dV both. The tile's k and v slices stay in
// shared memory; the block compacts the union of the tile's allowed
// queries (from allowT, a TILE-bit word a query), copies each listed
// query's lse, r and dropout row key for every head of the group into
// shared memory once, and brings the listed queries' q and g slices through
// a ring of DKV_STAGES chunks of CK queries. For each chunk the PARTS warps
// of a head form its 16 x 8 S^T = K Q^T and dP~^T = V g^T together on the
// tensor cores (partial sums exchanged through shared memory), then each
// forms p~ and dS = p (dP - r) scale for the allowed pairs and adds p~^T g
// and dS^T q to its PART_NT dV and dK output tiles (hi and lo parts, one
// m16n8k16): fp32 sums in registers, stored once.
constexpr int DKV_STAGES = 2;
constexpr int DKV_STAGED_MIN_BLOCKS = 3;  // its blocks an SM asked of the compiler

// Shared memory of one block: the tile's k and v slices, the ring of q and
// g slices, lse, r and the row key of each (listed query, head of the
// group), the query list and its row bits. The wrapper's
// dkv_staged_smem_bytes is the same sum.
size_t dkv_staged_smem(int Lq, int H, int D) {
  const size_t EG = shared_row(H, D);
  return (2 * TILE + 2 * DKV_STAGES * CK) * EG * sizeof(__nv_bfloat16) +
         (size_t)Lq * HG * 3 * sizeof(float) + (size_t)Lq * (sizeof(int) + sizeof(uint16_t));
}

template <bool DROP>
__global__ void __launch_bounds__(DKV_PARTS * HG * 32, DKV_STAGED_MIN_BLOCKS)
masked_mha_bwd_dkv_staged_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ g,
                                 const unsigned char* __restrict__ allow_t,
                                 const float* __restrict__ lse, const float* __restrict__ r_in,
                                 const int* __restrict__ seeds, __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, Args a) {
  constexpr int PARTS = DKV_PARTS, PART_NT = 32 / PARTS, PART_KS = 16 / PARTS;
  constexpr int NT = PARTS * HG * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[NT / 32];
  __shared__ float4 partial[2 * NT];  // each lane's partial S^T and dP~^T of its k-steps
  const int D = a.D, EG = shared_row(a.H, D);  // shared row stride
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // TILE k slices
  __nv_bfloat16* vs = ks + TILE * EG;                           // TILE v slices
  __nv_bfloat16* ring = vs + TILE * EG;  // stage: CK q slices, then CK g slices
  float* lses = reinterpret_cast<float*>(ring + 2 * DKV_STAGES * CK * EG);
  float* rs = lses + a.Lq * HG;
  uint32_t* rks = reinterpret_cast<uint32_t*>(rs + a.Lq * HG);
  int* qlist = reinterpret_cast<int*>(rks + a.Lq * HG);
  uint16_t* qbits = reinterpret_cast<uint16_t*>(qlist + a.Lq);

  const int groups = (a.H + HG - 1) / HG, tiles = (a.Lk + TILE - 1) / TILE;
  const int grp = blockIdx.x % groups, tile = (blockIdx.x / groups) % tiles;
  const int b = blockIdx.x / (groups * tiles);
  const int k0 = tile * TILE, nrows = min(TILE, a.Lk - k0);
  const int h0 = grp * HG, nh = min(HG, a.H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int hl = warp % HG, part = warp / HG, h = h0 + hl;
  const bool live = hl < nh;  // warp-uniform

  const Window win = group_window(h0, nh, D);
  copy_rows<NT>(ks, EG, k + b * a.k_sb + k0 * a.k_sl + win.start, a.k_sl, nrows, TILE, win.len);
  copy_rows<NT>(vs, EG, v + b * a.v_sb + k0 * a.v_sl + win.start, a.v_sl, nrows, TILE, win.len);
  cp_async_commit();

  const unsigned char* acol = allow_t + ((long long)b * a.Lk + k0) * a.Lq;
  const int nq = compact_list<NT>(
      a.Lq,
      [&](int qj) {
        unsigned bits = 0u;  // the tile's mask bytes of this column, loaded together
#pragma unroll
        for (int r = 0; r < TILE; ++r)
          if (r < nrows) bits |= (acol[(long long)r * a.Lq + qj] ? 1u : 0u) << r;
        return bits;
      },
      qlist, qbits, counts);
  // each listed query's lse, r and dropout row key for every head of the
  // group, once (an allowed pair means the query row has a key: its lse is
  // real)
  for (int i = threadIdx.x; i < nq * nh; i += NT) {
    const int slot = i / nh, hh = i - slot * nh, qi = qlist[slot];
    const long long at = ((long long)b * a.H + h0 + hh) * a.Lq + qi;
    lses[slot * HG + hh] = lse[at];
    rs[slot * HG + hh] = r_in[at];
    if (DROP) rks[slot * HG + hh] = row_key(seeds[b], h0 + hh, qi);
  }
  const int chunks = (nq + CK - 1) / CK;
  const __nv_bfloat16* qb = q + b * a.q_sb + win.start;
  const __nv_bfloat16* gb = g + b * a.g_sb + win.start;
  auto stage = [&](int c) {
    if (c * CK < nq)
      gather_chunk<NT>(ring + (c % DKV_STAGES) * 2 * CK * EG, EG, qlist + c * CK,
                       nq - c * CK, qb, a.q_sl, gb, a.g_sl, win.len);
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < DKV_STAGES - 1; ++c) stage(c);

  float acck[PART_NT][4], accv[PART_NT][4];
#pragma unroll
  for (int i = 0; i < PART_NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[i][e] = accv[i][e] = 0.f;
  const int ntiles = (D + 7) / 8;
  const __nv_bfloat16* kh = ks + win.shift + hl * D;
  const __nv_bfloat16* vh = vs + win.shift + hl * D;
  for (int c = 0; c < chunks; ++c) {
    stage(c + DKV_STAGES - 1);
    cp_async_wait<DKV_STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* qr = ring + (c % DKV_STAGES) * 2 * CK * EG + win.shift + hl * D;
    const __nv_bfloat16* gr = qr + CK * EG;
    if (live) {
      // this warp's k-steps of S^T and dP~^T: [0], [1] key row gq, query
      // slots 2t, 2t + 1; [2], [3] key row gq + 8
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PART_KS; ++j) {
        const int kk = part + PARTS * j;
        if (16 * kk >= D) break;
        mma_rows(s, kh, EG, qr, EG, kk, D);
        mma_rows(dp, vh, EG, gr, EG, kk, D);
      }
      partial[2 * threadIdx.x] = make_float4(s[0], s[1], s[2], s[3]);
      partial[2 * threadIdx.x + 1] = make_float4(dp[0], dp[1], dp[2], dp[3]);
    }
    __syncthreads();
    if (live) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};  // the head's sums
#pragma unroll
      for (int pp = 0; pp < PARTS; ++pp) {
        const int at = 2 * ((pp * HG + hl) * 32 + lane);
        const float4 x = partial[at], y = partial[at + 1];
        s[0] += x.x;
        s[1] += x.y;
        s[2] += x.z;
        s[3] += x.w;
        dp[0] += y.x;
        dp[1] += y.y;
        dp[2] += y.z;
        dp[3] += y.w;
      }
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // query slot 2t + e
        const int j = c * CK + 2 * t + e;
        const bool in = j < nq;
        const unsigned w = in ? qbits[j] : 0u;
        const float L = in ? lses[j * HG + hl] : 0.f, R = in ? rs[j * HG + hl] : 0.f;
        const uint32_t rk = DROP && in ? rks[j * HG + hl] : 0u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // key row gq + 8 r
          const int row = gq + 8 * r;
          const bool on = (w >> row) & 1u;
          const float p = __expf(s[2 * r + e] * a.scale - L);
          const bool keep = !DROP || drop_bits(rk, k0 + row) >= a.threshold;
          const float kscale = DROP ? a.keep_scale : 1.f;
          const float dpk = keep ? dp[2 * r + e] * kscale : 0.f;
          pv[2 * r + e] = on && keep ? p * kscale : 0.f;
          ds[2 * r + e] = on ? p * (dpk - R) * a.scale : 0.f;
        }
      }
      uint32_t vhi[2], vlo[2], khi[2], klo[2];
      split_pair(pv[0], pv[1], vhi[0], vlo[0]);
      split_pair(pv[2], pv[3], vhi[1], vlo[1]);
      split_pair(ds[0], ds[1], khi[0], klo[0]);
      split_pair(ds[2], ds[3], khi[1], klo[1]);
#pragma unroll
      for (int i = 0; i < PART_NT; ++i) {
        const int nt = part * PART_NT + i;
        if (nt >= ntiles) break;
        const int d = nt * 8 + gq;
        mma_split(accv[i], vhi, vlo, column_pair(gr + 2 * t * EG, gr + (2 * t + 1) * EG, d, D));
        mma_split(acck[i], khi, klo, column_pair(qr + 2 * t * EG, qr + (2 * t + 1) * EG, d, D));
      }
    }
    __syncthreads();  // stage c % DKV_STAGES is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();  // the k and v rows are free: the dk and dv rows go there

  if (live) {
#pragma unroll
    for (int i = 0; i < PART_NT; ++i) {
      const int d = (part * PART_NT + i) * 8 + 2 * t;
      if (d - 2 * t >= D) break;
      if (d < D) {
        put_tile(ks + win.shift + hl * D, EG, gq, d, acck[i], 1.f, 1.f);
        put_tile(vs + win.shift + hl * D, EG, gq, d, accv[i], 1.f, 1.f);
      }
    }
  }
  __syncthreads();
  const long long o = (((long long)b * a.Lk + k0) * a.H + h0) * D;
  store_rows<NT>(dk + o, (long long)a.H * D, ks + win.shift, EG, nrows, nh * D);
  store_rows<NT>(dv + o, (long long)a.H * D, vs + win.shift, EG, nrows, nh * D);
}

// ------------------------------------------------------- backward: dK, dV
template <typename T, int SLOTS, bool DROP>
__global__ void __launch_bounds__(THREADS, min_blocks_for(DKV_MIN_BLOCKS, SLOTS))
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

// ------------------------------------------------ tiled routes (float32)
// The float32 routes up to D = DMAX (DSG-DETR's tracklet encoder: 8 heads
// of 297 over 128 boxes, each box allowed the boxes of its tracklet). One
// block takes (video, tile of TT rows, head): the forward and dQ a tile of
// query rows, dK/dV a tile of key rows. The wrapper hands each kernel an
// order of its rows (ops/masked_attention.py::row_order: by the first
// allowed column, empty rows last) and tile t takes the rows at places TT t
// .. TT t + TT - 1 of it, so the rows of one tracklet share a tile and the
// union of their allowed columns is that tracklet (in any order the result
// is the same, with less reuse: each row writes its own slot). The block
// copies its rows' windows of the head's slice into shared memory, lists
// the union of their allowed columns once (a TT-bit word a column) and
// brings the listed columns' windows in by chunks of TCK columns by
// 16-byte cp.async. A window is the 16 bytes around the slice, which starts
// h D floats into a row (1188 h bytes at D = 297, off 16 for odd h). A
// column crosses from L2 once a tile, not once a row as on the per-element
// route.
// The products run on the tensor cores in about float32 accuracy: each
// operand is split into a TF32 part and the rest, and a 16 x 8 x 8 product
// is three mma.sync m16n8k8 (lo hi + hi lo + hi hi; TF32 alone keeps about
// three digits, short of the 1e-4 gate). The TPARTS warps of a block split
// the head dim's k-steps of the scores (their partial sums meet in shared
// memory) and its 8-dim output tiles. Per chunk:
//   - forward: S = Q K^T, the online softmax of rows g and g + 8 on a lane
//     quad (as the staged forward), dropout, acc += P~ V;
//   - dQ: S = Q K^T and dP~ = G V^T, p = exp(s - lse), w = p dP, and, as
//     the staged dQ, r = sum w, acc1 += W K and acc2 += P K in one walk:
//     dQ = scale (acc1 - r acc2);
//   - dK/dV (key tiles over the union of their allowed queries, each
//     listed query's lse, r and dropout row key copied once): S^T = K Q^T,
//     dP~^T = V G^T, dS = p (dP - r) scale, dK += dS Q, dV += P~ G.
// Sums in fp32 in registers, no atomics: deterministic. Bound: at the
// tracklet shapes 0.31 GB of compulsory traffic (0.093 ms) against 2.5
// GFLOP forward, so bytes. A first design summed on the CUDA cores (lanes
// split the head dim, as on the per-element route); its walks issued about
// 1,000 instructions a warp per chunk and bounded it. These issue about a
// third of that, and what bounds them is each chunk's three block syncs
// (copy, partial sums, refill) over few resident blocks: so the ring is one
// chunk deep, and the shared memory a second stage would take holds more
// blocks instead (tools/kernel_variants.py: tiled-stages-2).
constexpr int TT = 16;         // rows a tile: the mma's m
constexpr int TCK = 8;         // columns a cp.async chunk: the scores' n, P V's k
constexpr int TSTAGES = 1;     // chunks in the ring (see above)
constexpr int TPARTS = 4;      // warps a block: each k-step ks % TPARTS, output tile % TPARTS
constexpr int TILED_THREADS = TPARTS * 32;
constexpr int TPART_NT = (DMAX / 8 + TPARTS - 1) / TPARTS;  // output 8-dim tiles a warp
constexpr int WT_LD = 12;      // row stride of a warp's 16 x 8 weight tile (conflict-free)
constexpr int FWD_TILED_BLOCKS = 5;  // blocks an SM asked of the compiler, as shared
constexpr int BWD_TILED_BLOCKS = 3;  // memory allows at the tracklet shapes

// Floats a staged row: the widest window of a head's slice (D + 6 floats
// rounded down to 16 bytes), 4 mod 8 floats, so the fragments' loads of 8
// rows at 4 columns fall in 32 different banks.
__host__ __device__ constexpr int tiled_row(int D) { return ((D + 6) & ~3) | 4; }

// A 16-row tile of output dims in the scores' layout (acc[i]: output tile
// part + TPARTS i, rows g and g + 8, dims 2t, 2t + 1; row r scaled by f[r])
// into the tile's windows ts (row stride ld, the head's dims from 0), then
// rows[] of out (token stride sl) by coalesced stores, a warp a row: the
// caller syncs the block before and after.
__device__ __forceinline__ void put_acc(float* ts, int ld, const float (&acc)[TPART_NT][4],
                                        const float (&f)[2], int D) {
  const int part = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < TPART_NT; ++i) {
    const int d = 8 * (part + TPARTS * i) + 2 * t;
    if (d - 2 * t >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (d < D) ts[(g + 8 * r) * ld + d] = acc[i][2 * r] * f[r];
      if (d + 1 < D) ts[(g + 8 * r) * ld + d + 1] = acc[i][2 * r + 1] * f[r];
    }
  }
}

__device__ __forceinline__ void store_tile(float* out, long long sl, const int* rows,
                                           const float* ts, int ld, int D) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < TT; r += TPARTS) {
    if (rows[r] < 0) continue;
    float* o = out + rows[r] * sl;
    for (int d = lane; d < D; d += 32) o[d] = ts[r * ld + d];
  }
}

// Shared memory of one tiled block over `n` columns: `row_tiles` (1 or 2)
// tiles of TT row windows, the ring of TSTAGES chunks of TCK windows of two
// tensors, with `stats` (dK/dV) each listed query's lse, r and dropout row
// key, the column list and its row bits. The wrapper's tiled_smem_bytes is
// the same sum.
size_t tiled_smem(int n, int D, int row_tiles, bool stats) {
  return ((size_t)row_tiles * TT + (size_t)TSTAGES * 2 * TCK) * tiled_row(D) * sizeof(float) +
         (stats ? (size_t)n * 3 * sizeof(float) : 0) + (size_t)n * (sizeof(int) + sizeof(uint16_t));
}

// A tiled kernel's own shared memory: a count a warp, the tile's rows,
// each lane's `sums` partial 16 x 8 tiles (a float4 each) and each warp's
// `sums` weight tiles. The wrapper's tiled_plan is the same.
constexpr size_t tiled_static_smem(int sums) {
  return (size_t)TPARTS * 4 + TT * 4 + (size_t)TILED_THREADS * 16 * sums +
         (size_t)TPARTS * TT * WT_LD * 4 * sums;
}

// A head's window of a float row: its slice [h D, (h + 1) D) widened to
// 16-byte bounds, inside the row (rows are whole 16-byte pieces); the slice
// starts `shift` floats into it.
__device__ __forceinline__ Window head_window(int h, int D) {
  const int start = (h * D) & ~3, end = ((h + 1) * D + 3) & ~3;
  return Window{start, end - start, h * D - start};
}

// Bit t: tile row t (token rows[t] of the video's mask mb, n columns) allows
// column j.
__device__ __forceinline__ unsigned tile_bits(const unsigned char* mb, const int* rows, int n,
                                              int j) {
  unsigned bits = 0u;
#pragma unroll
  for (int t = 0; t < TT; ++t)
    if (rows[t] >= 0) bits |= (mb[(long long)rows[t] * n + j] ? 1u : 0u) << t;
  return bits;
}

// The tile's rows: the tokens at places TT tile .. TT tile + TT - 1 of the
// video's order (L of them), -1 past L. Every thread calls it.
__device__ __forceinline__ void tile_rows(int* rows, const long long* order, int b, int L,
                                          int tile) {
  if (threadIdx.x < TT) {
    const int at = tile * TT + threadIdx.x;
    rows[threadIdx.x] = at < L ? (int)order[(long long)b * L + at] : -1;
  }
  __syncthreads();
}

// The windows (`len` floats, a multiple of 4) of tokens list[0 .. count) of
// x, then (y not null) of y, into rows 0 .. count - 1 and count .. 2 count
// - 1 of dst (row stride ld) by 16-byte cp.async, a warp a row; a place at
// or past n, or a token of -1, is zero-filled.
__device__ __forceinline__ void copy_windows(float* dst, int ld, const int* list, int count,
                                             int n, const float* x, long long x_sl,
                                             const float* y, long long y_sl, int len) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < (y != nullptr ? 2 : 1) * count; j += TPARTS) {
    const int at = j % count;
    const int tok = at < n ? list[at] : -1;
    const bool in = tok >= 0;
    const float* src = (j < count ? x + (in ? tok : 0) * x_sl : y + (in ? tok : 0) * y_sl);
    for (int e = 4 * lane; e < len; e += 128) cp_async16(dst + j * ld + e, src + e, in);
  }
}

// The A fragment of one k-step, split: rows g and g + 8 of x (row stride
// ld) over dims 8 ks .. 8 ks + 7 of the head, 0 past D.
__device__ __forceinline__ void rows_a(const float* x, int ld, int ks, int D, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d0 = 8 * ks + t, d1 = d0 + 4;
  const bool in0 = d0 < D, in1 = d1 < D;
  const float a[4] = {in0 ? x[g * ld + d0] : 0.f, in0 ? x[(g + 8) * ld + d0] : 0.f,
                      in1 ? x[g * ld + d1] : 0.f, in1 ? x[(g + 8) * ld + d1] : 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

// One k-step of the scores: s (16 x 8: rows g, g + 8, columns 2t, 2t + 1)
// += X rows . Y rows over dims 8 ks .. 8 ks + 7 of the head (row stride ld,
// 0 past D).
__device__ __forceinline__ void dot_step(float (&s)[4], const float* x, const float* y, int ld,
                                         int ks, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int d0 = 8 * ks + t, d1 = d0 + 4;
  uint32_t ah[4], al[4];
  rows_a(x, ld, ks, D, ah, al);
  mma_3xtf32(s, ah, al, d0 < D ? y[g * ld + d0] : 0.f, d1 < D ? y[g * ld + d1] : 0.f);
}

// The B fragment of output tile nt from a chunk's TCK rows (row stride ld):
// dims 8 nt + g of columns t and t + 4. Dims past D give outputs that are
// never stored.
__device__ __forceinline__ float2 chunk_b(const float* y, int ld, int nt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return make_float2(y[t * ld + 8 * nt + g], y[(t + 4) * ld + 8 * nt + g]);
}

// A 16 x 8 weight tile held in the scores' layout (c: rows g, g + 8,
// columns 2t, 2t + 1) as the products' A fragment (rows g, g + 8, columns
// t, t + 4), split: through the warp's tile wt in shared memory.
__device__ __forceinline__ void weights_a(float* wt, const float (&c)[4], uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  wt[g * WT_LD + 2 * t] = c[0];
  wt[g * WT_LD + 2 * t + 1] = c[1];
  wt[(g + 8) * WT_LD + 2 * t] = c[2];
  wt[(g + 8) * WT_LD + 2 * t + 1] = c[3];
  __syncwarp();
  const float a[4] = {wt[g * WT_LD + t], wt[(g + 8) * WT_LD + t], wt[g * WT_LD + t + 4],
                      wt[(g + 8) * WT_LD + t + 4]};
  __syncwarp();  // the tile is written again next chunk
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

// ------------------------------------------------ forward, tiled route
template <bool DROP, bool LSE>
__global__ void __launch_bounds__(TILED_THREADS, FWD_TILED_BLOCKS)
masked_mha_fwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const unsigned char* __restrict__ allow,
                            const long long* __restrict__ order, const int* __restrict__ seeds,
                            float* __restrict__ out, float* __restrict__ lse, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[TPARTS];
  __shared__ int rows[TT];
  __shared__ float4 partial[TILED_THREADS];  // each lane's partial S of its warp's k-steps
  __shared__ float wts[TPARTS][TT * WT_LD];
  const int D = a.D, RS = tiled_row(D), KS = (D + 7) / 8;
  float* qs = reinterpret_cast<float*>(smem);  // the tile's q windows
  float* ring = qs + TT * RS;                  // stage: TCK k windows, then TCK v windows
  int* keys = reinterpret_cast<int*>(ring + TSTAGES * 2 * TCK * RS);
  uint16_t* kbits = reinterpret_cast<uint16_t*>(keys + a.Lk);

  const int tiles = (a.Lq + TT - 1) / TT;
  const int h = blockIdx.x % a.H, tile = (blockIdx.x / a.H) % tiles;
  const int b = blockIdx.x / (a.H * tiles);
  const int part = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  tile_rows(rows, order, b, a.Lq, tile);
  const Window win = head_window(h, D);
  copy_windows(qs, RS, rows, TT, TT, q + b * a.q_sb + win.start, a.q_sl, nullptr, 0, win.len);
  cp_async_commit();
  const unsigned char* mb = allow + (long long)b * a.Lq * a.Lk;
  const int nk = compact_list<TILED_THREADS>(
      a.Lk, [&](int kj) { return tile_bits(mb, rows, a.Lk, kj); }, keys, kbits, counts);
  const int chunks = (nk + TCK - 1) / TCK;
  const float* kb = k + b * a.k_sb + win.start;
  const float* vb = v + b * a.v_sb + win.start;
  auto stage = [&](int c) {
    if (c * TCK < nk)
      copy_windows(ring + (c % TSTAGES) * 2 * TCK * RS, RS, keys + c * TCK, TCK, nk - c * TCK,
                   kb, a.k_sl, vb, a.v_sl, win.len);
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TSTAGES - 1; ++c) stage(c);

  // the dropout row keys of this lane's rows g and g + 8, once
  const uint32_t rkey0 = DROP && rows[g] >= 0 ? row_key(seeds[b], h, rows[g]) : 0u;
  const uint32_t rkey1 = DROP && rows[g + 8] >= 0 ? row_key(seeds[b], h, rows[g + 8]) : 0u;
  // rows g (r = 0) and g + 8 (r = 1): running max and this lane's part of
  // the sum; acc[i]: output tile part + TPARTS i
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[TPART_NT][4];
#pragma unroll
  for (int i = 0; i < TPART_NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float* qh = qs + win.shift;
  for (int c = 0; c < chunks; ++c) {
    stage(c + TSTAGES - 1);
    cp_async_wait<TSTAGES - 1>();
    __syncthreads();
    const float* kr = ring + (c % TSTAGES) * 2 * TCK * RS + win.shift;
    const float* vr = kr + TCK * RS;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = part; ks < KS; ks += TPARTS) dot_step(s, qh, kr, RS, ks, D);
    partial[threadIdx.x] = make_float4(s[0], s[1], s[2], s[3]);
    __syncthreads();
    s[0] = s[1] = s[2] = s[3] = 0.f;  // the head's S: the parts' sums
#pragma unroll
    for (int pp = 0; pp < TPARTS; ++pp) {
      const float4 x = partial[pp * 32 + lane];
      s[0] += x.x;
      s[1] += x.y;
      s[2] += x.z;
      s[3] += x.w;
    }
    const int j0 = c * TCK + 2 * t, j1 = j0 + 1;
    const unsigned w0 = j0 < nk ? kbits[j0] : 0u, w1 = j1 < nk ? kbits[j1] : 0u;
    const int key0 = j0 < nk ? keys[j0] : 0, key1 = j1 < nk ? keys[j1] : 0;
    float p[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool on0 = (w0 >> (g + 8 * r)) & 1u, on1 = (w1 >> (g + 8 * r)) & 1u;
      const float x0 = on0 ? s[2 * r] * a.scale : -INFINITY;
      const float x1 = on1 ? s[2 * r + 1] * a.scale : -INFINITY;
      float mx = fmaxf(x0, x1);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);
      p[2 * r] = on0 ? __expf(x0 - m_new) : 0.f;
      p[2 * r + 1] = on1 ? __expf(x1 - m_new) : 0.f;
      l[r] = l[r] * alpha + p[2 * r] + p[2 * r + 1];
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < TPART_NT; ++i) {
        acc[i][2 * r] *= alpha;
        acc[i][2 * r + 1] *= alpha;
      }
      // dropout acts on the normalized p: the sum l stays undropped
      if (DROP) {
        const uint32_t rk = r ? rkey1 : rkey0;
        p[2 * r] = drop_bits(rk, key0) >= a.threshold ? p[2 * r] * a.keep_scale : 0.f;
        p[2 * r + 1] = drop_bits(rk, key1) >= a.threshold ? p[2 * r + 1] * a.keep_scale : 0.f;
      }
    }
    uint32_t ph[4], pl[4];
    weights_a(wts[part], p, ph, pl);
#pragma unroll
    for (int i = 0; i < TPART_NT; ++i) {
      const int nt = part + TPARTS * i;
      if (nt >= KS) break;
      const float2 bv = chunk_b(vr, RS, nt);
      mma_3xtf32(acc[i], ph, pl, bv.x, bv.y);
    }
    __syncthreads();  // stage c % TSTAGES and the partial sums are written next
  }
  cp_async_wait<0>();

  __syncthreads();  // the q windows are free: the output rows go there
  float inv[2], L[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = sum > 0.f ? 1.f / sum : 0.f;  // no allowed key -> 0
    L[r] = sum > 0.f ? m[r] + logf(sum) : LSE_EMPTY;
  }
  put_acc(qs, RS, acc, inv, D);
  __syncthreads();
  store_tile(out + ((long long)b * a.Lq * a.H + h) * D, (long long)a.H * D, rows, qs, RS, D);
  if (LSE && part == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[g + 8 * r] >= 0) lse[((long long)b * a.H + h) * a.Lq + rows[g + 8 * r]] = L[r];
  }
}

// ---------------------------------------------- dQ and dK/dV, tiled route
// One kernel for both backward launches: dQ (DKV false) over query tiles,
// its rows' q and g against the listed keys' k and v; dK/dV (DKV true)
// over key tiles, its rows' k and v against the listed queries' q and g.
// `mask` is allow (dQ) or allowT (dK/dV); out0, out1 are dq and r (dQ) or
// dk and dv (dK/dV).
template <bool DROP, bool DKV>
__global__ void __launch_bounds__(TILED_THREADS, BWD_TILED_BLOCKS)
masked_mha_bwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ g,
                            const unsigned char* __restrict__ mask,
                            const long long* __restrict__ order, const float* __restrict__ lse,
                            const float* __restrict__ r_in, const int* __restrict__ seeds,
                            float* __restrict__ out0, float* __restrict__ out1, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int counts[TPARTS];
  __shared__ int rows[TT];
  __shared__ float4 partial[2 * TILED_THREADS];  // each lane's partial S and dP~ of its k-steps
  __shared__ float wts[TPARTS][2][TT * WT_LD];
  const int D = a.D, RS = tiled_row(D), KS = (D + 7) / 8;
  const int L = DKV ? a.Lk : a.Lq, N = DKV ? a.Lq : a.Lk;  // tile rows, listed columns
  float* xs = reinterpret_cast<float*>(smem);  // the tile's windows: q, g (dQ) or k, v (dK/dV)
  float* ring = xs + 2 * TT * RS;             // stage: TCK k (q) windows, then TCK v (g)
  float* lses = ring + TSTAGES * 2 * TCK * RS;  // dK/dV: each listed query's lse, r, row key
  float* rs = lses + (DKV ? N : 0);
  uint32_t* rks = reinterpret_cast<uint32_t*>(rs + (DKV ? N : 0));
  int* cols = reinterpret_cast<int*>(rks + (DKV ? N : 0));
  uint16_t* cbits = reinterpret_cast<uint16_t*>(cols + N);

  const int tiles = (L + TT - 1) / TT;
  const int h = blockIdx.x % a.H, tile = (blockIdx.x / a.H) % tiles;
  const int b = blockIdx.x / (a.H * tiles);
  const int part = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, t = lane & 3;
  tile_rows(rows, order, b, L, tile);
  const Window win = head_window(h, D);
  // row side x1, x2 and column side y1, y2, at the window
  const float* x1 = (DKV ? k + b * a.k_sb : q + b * a.q_sb) + win.start;
  const float* x2 = (DKV ? v + b * a.v_sb : g + b * a.g_sb) + win.start;
  const float* y1 = (DKV ? q + b * a.q_sb : k + b * a.k_sb) + win.start;
  const float* y2 = (DKV ? g + b * a.g_sb : v + b * a.v_sb) + win.start;
  const long long x1_sl = DKV ? a.k_sl : a.q_sl, x2_sl = DKV ? a.v_sl : a.g_sl;
  const long long y1_sl = DKV ? a.q_sl : a.k_sl, y2_sl = DKV ? a.g_sl : a.v_sl;
  copy_windows(xs, RS, rows, TT, TT, x1, x1_sl, x2, x2_sl, win.len);
  cp_async_commit();
  const unsigned char* mb = mask + (long long)b * L * N;
  const int nc = compact_list<TILED_THREADS>(
      N, [&](int j) { return tile_bits(mb, rows, N, j); }, cols, cbits, counts);
  if (DKV) {
    // each listed query's lse, r and dropout row key, once (an allowed pair
    // means the query row has a key: its lse is real)
    for (int i = threadIdx.x; i < nc; i += TILED_THREADS) {
      const long long at = ((long long)b * a.H + h) * a.Lq + cols[i];
      lses[i] = lse[at];
      rs[i] = r_in[at];
      if (DROP) rks[i] = row_key(seeds[b], h, cols[i]);
    }
  }
  const int chunks = (nc + TCK - 1) / TCK;
  auto stage = [&](int c) {
    if (c * TCK < nc)
      copy_windows(ring + (c % TSTAGES) * 2 * TCK * RS, RS, cols + c * TCK, TCK, nc - c * TCK,
                   y1, y1_sl, y2, y2_sl, win.len);
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < TSTAGES - 1; ++c) stage(c);

  // dQ: this lane's rows gi and gi + 8 (r = 0, 1): lse and dropout row key
  float Lrow[2] = {0.f, 0.f};
  uint32_t rkey[2] = {0u, 0u};
  if (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rows[gi + 8 * r];
      if (row < 0) continue;
      Lrow[r] = lse[((long long)b * a.H + h) * a.Lq + row];
      if (DROP) rkey[r] = row_key(seeds[b], h, row);
    }
  }
  // acc1: dQ's sum p dP k (dK); acc2: sum p k (dV); rsum: dQ's r parts
  float acc1[TPART_NT][4], acc2[TPART_NT][4], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TPART_NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[i][e] = acc2[i][e] = 0.f;
  const float* xh1 = xs + win.shift;
  const float* xh2 = xh1 + TT * RS;
  for (int c = 0; c < chunks; ++c) {
    stage(c + TSTAGES - 1);
    cp_async_wait<TSTAGES - 1>();
    __syncthreads();
    const float* yr1 = ring + (c % TSTAGES) * 2 * TCK * RS + win.shift;
    const float* yr2 = yr1 + TCK * RS;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = part; ks < KS; ks += TPARTS) {
      dot_step(s, xh1, yr1, RS, ks, D);
      dot_step(dp, xh2, yr2, RS, ks, D);
    }
    partial[2 * threadIdx.x] = make_float4(s[0], s[1], s[2], s[3]);
    partial[2 * threadIdx.x + 1] = make_float4(dp[0], dp[1], dp[2], dp[3]);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = dp[e] = 0.f;  // the head's S and dP~: the parts' sums
#pragma unroll
    for (int pp = 0; pp < TPARTS; ++pp) {
      const float4 x = partial[2 * (pp * 32 + lane)], y = partial[2 * (pp * 32 + lane) + 1];
      s[0] += x.x;
      s[1] += x.y;
      s[2] += x.z;
      s[3] += x.w;
      dp[0] += y.x;
      dp[1] += y.y;
      dp[2] += y.z;
      dp[3] += y.w;
    }
    // the weights of pairs (row gi + 8 r, column 2t + e)
    float w1[4], w2[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = c * TCK + 2 * t + e;
      const bool in = j < nc;
      const unsigned w = in ? cbits[j] : 0u;
      const float Lc = DKV && in ? lses[j] : 0.f, Rc = DKV && in ? rs[j] : 0.f;
      const uint32_t rkc = DKV && DROP && in ? rks[j] : 0u;
      const int col = in ? cols[j] : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool on = (w >> (gi + 8 * r)) & 1u;
        const float p = on ? __expf(s[2 * r + e] * a.scale - (DKV ? Lc : Lrow[r])) : 0.f;
        bool keep = true;
        if (DROP)
          keep = DKV ? drop_bits(rkc, rows[gi + 8 * r]) >= a.threshold
                     : drop_bits(rkey[r], col) >= a.threshold;
        const float ks_ = DROP ? a.keep_scale : 1.f;
        const float dpk = keep ? dp[2 * r + e] * ks_ : 0.f;
        if (DKV) {
          w1[2 * r + e] = p * (dpk - Rc) * a.scale;  // dS
          w2[2 * r + e] = keep ? p * ks_ : 0.f;     // p~
        } else {
          w1[2 * r + e] = p * dpk;  // p dP
          w2[2 * r + e] = p;
          rsum[r] += p * dpk;
        }
      }
    }
    uint32_t ah1[4], al1[4], ah2[4], al2[4];
    weights_a(wts[part][0], w1, ah1, al1);
    weights_a(wts[part][1], w2, ah2, al2);
#pragma unroll
    for (int i = 0; i < TPART_NT; ++i) {
      const int nt = part + TPARTS * i;
      if (nt >= KS) break;
      const float2 b1 = chunk_b(yr1, RS, nt);
      mma_3xtf32(acc1[i], ah1, al1, b1.x, b1.y);
      const float2 b2 = DKV ? chunk_b(yr2, RS, nt) : b1;
      mma_3xtf32(acc2[i], ah2, al2, b2.x, b2.y);
    }
    __syncthreads();  // stage c % TSTAGES and the partial sums are written next
  }
  cp_async_wait<0>();

  __syncthreads();  // the tile's windows are free: the output rows go there
  float rr[2] = {0.f, 0.f};
  const float one[2] = {1.f, 1.f};
  const long long osl = (long long)a.H * D;
  float* o0 = out0 + ((long long)b * L * a.H + h) * D;
  if (DKV) {
    put_acc(xs, RS, acc1, one, D);
    put_acc(xs + TT * RS, RS, acc2, one, D);
    __syncthreads();
    store_tile(o0, osl, rows, xs, RS, D);
    store_tile(out1 + ((long long)b * L * a.H + h) * D, osl, rows, xs + TT * RS, RS, D);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rr[r] = rsum[r] + __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rr[r] += __shfl_xor_sync(0xffffffffu, rr[r], 2);
    }
    // dQ = scale (sum p dP k - r sum p k), row by row
#pragma unroll
    for (int i = 0; i < TPART_NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][e] -= rr[e >> 1] * acc2[i][e];
    const float sc[2] = {a.scale, a.scale};
    put_acc(xs, RS, acc1, sc, D);
    __syncthreads();
    store_tile(o0, osl, rows, xs, RS, D);
  }
  if (!DKV && part == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[gi + 8 * r] >= 0) out1[((long long)b * a.H + h) * a.Lq + rows[gi + 8 * r]] = rr[r];
  }
}

// ------------------------------------------ forward, resident route (float32)
// Short sequences and narrow heads: Lk <= RESIDENT_MAX_KEYS and D <=
// RESIDENT_MAX_HEAD_DIM, any number of heads (CLIP's towers: ViT-B/32's 12
// heads of 64 over 50 tokens, every pair allowed, and its text tower's 8
// heads of 64 over 77 tokens, causal). A head's k and v windows for every
// key fit one block's shared memory (2 x 80 rows of 68 floats at the text
// tower), so one block of RPARTS warps takes (video, head, tile of RROWS
// query rows), copies those windows and its rows' q windows once by 16-byte
// cp.async (the tiled routes' windows and row stride), and syncs once. Each
// warp then works alone on 16 rows:
//   - S = Q K^T over all the keys, 16 x Lk in registers (3xTF32 mma.sync,
//     as the tiled routes);
//   - its rows' allow bytes read straight from the mask, an exact two-pass
//     softmax over the whole row (the max, then the sum of exp, each over a
//     lane quad), dropout with the same row key and bits as the other
//     routes (the sum stays undropped);
//   - acc = P~ V, P~ re-laid as A fragments through the warp's tile, V's
//     fragments from shared memory; out = acc / sum, lse = max + log(sum),
//     0 and LSE_EMPTY on a row with no allowed key.
// No key list, no row order, no running rescale, no exchange between warps.
// The warp's scores and outputs stay in registers: the kernel is
// instantiated for 8 or 16 key tiles (Lk <= 64 or 128) and 8 or 16 output
// tiles (D <= 64 or 128), the launch picking the smallest that holds them.
// Bound: at the vision tower's (32, 50, 12, 64), 19.7 MB of q, k, v, out
// and mask to move once against 0.4 GFLOP, so bytes (5.9 us at 3.35 TB/s);
// 384 blocks of 45 KB make one wave on 132 SMs.
constexpr int RESIDENT_MAX_KEYS = 128;      // a warp's 16 x Lk scores in registers
constexpr int RESIDENT_MAX_HEAD_DIM = 128;  // and its 16 x D outputs
constexpr int RROWS = 64;                   // query rows a block
constexpr int RPARTS = 4;                   // warps a block: TT rows each
static_assert(RROWS == RPARTS * TT, "a warp takes one 16-row tile");
constexpr int RESIDENT_THREADS = RPARTS * 32;

// Shared memory of one resident block: every key's v and k windows (Lk
// rounded up to 8, the rows past Lk zero) and the tile's RROWS q windows,
// `tiled_row` floats a row. The wrapper's resident_plan is the same sum.
size_t resident_smem(int Lk, int D) {
  return ((size_t)2 * ((Lk + 7) & ~7) + RROWS) * tiled_row(D) * sizeof(float);
}

// The kernel's own: each warp's 16 x 8 weight tile.
constexpr size_t resident_static_smem() { return (size_t)RPARTS * TT * WT_LD * sizeof(float); }

template <int NKT, int NDT, bool DROP, bool LSE>
__global__ void __launch_bounds__(RESIDENT_THREADS)
masked_mha_fwd_resident_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v,
                               const unsigned char* __restrict__ allow,
                               const int* __restrict__ seeds, float* __restrict__ out,
                               float* __restrict__ lse, Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float wts[RPARTS][TT * WT_LD];
  const int D = a.D, RS = tiled_row(D), KS = (D + 7) / 8, NK = (a.Lk + 7) / 8;
  // v first: P V's fragment loads of dims past D may run past a row's window
  float* vs = reinterpret_cast<float*>(smem);
  float* ks = vs + 8 * NK * RS;
  float* qs = ks + 8 * NK * RS;
  const int tiles = (a.Lq + RROWS - 1) / RROWS;
  const int tile = blockIdx.x % tiles, h = (blockIdx.x / tiles) % a.H;
  const int b = blockIdx.x / (tiles * a.H);
  const int part = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const Window win = head_window(h, D);
  const int q0 = tile * RROWS;
  {
    const int pieces = win.len / 4, rows = 16 * NK + RROWS;
    const float* vb = v + b * a.v_sb + win.start;
    const float* kb = k + b * a.k_sb + win.start;
    const float* qb = q + b * a.q_sb + win.start;
    for (int i = threadIdx.x; i < rows * pieces; i += RESIDENT_THREADS) {
      const int j = i / pieces, e = 4 * (i - j * pieces);
      const float* src;
      bool in;
      if (j < 8 * NK) {
        in = j < a.Lk;
        src = vb + (in ? j : 0) * a.v_sl;
      } else if (j < 16 * NK) {
        in = j - 8 * NK < a.Lk;
        src = kb + (in ? j - 8 * NK : 0) * a.k_sl;
      } else {
        in = q0 + j - 16 * NK < a.Lq;
        src = qb + (in ? q0 + j - 16 * NK : 0) * a.q_sl;
      }
      cp_async16(vs + j * RS + e, src + e, in);
    }
    cp_async_commit();
  }

  // while the copies fly: rows r0 (r = 0) and r0 + 8 (r = 1) of this lane,
  // key 8 nt + 2 t + c allowed as bit 2 nt + c, and their dropout row keys
  const int r0 = q0 + 16 * part + g;
  uint32_t bits[2] = {0u, 0u}, rkey[2] = {0u, 0u};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Lq) continue;
    const unsigned char* arow = allow + ((long long)b * a.Lq + row) * a.Lk;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = 8 * nt + 2 * t + c;
        if (key < a.Lk && arow[key]) bits[r] |= 1u << (2 * nt + c);
      }
    if (DROP) rkey[r] = row_key(seeds[b], h, row);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (q0 + 16 * part >= a.Lq) return;  // every row of this warp lies past Lq

  float s[NKT][4];
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const float* qw = qs + 16 * part * RS + win.shift;
  const float* kw = ks + win.shift;
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ah[4], al[4];
    rows_a(qw, RS, kk, D, ah, al);
    const int d0 = 8 * kk + t, d1 = d0 + 4;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt) {
      if (nt >= NK) break;
      const float* kr = kw + (8 * nt + g) * RS;
      mma_3xtf32(s[nt], ah, al, d0 < D ? kr[d0] : 0.f, d1 < D ? kr[d1] : 0.f);
    }
  }

  float inv[2], L[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if ((bits[r] >> (2 * nt + c)) & 1u) m = fmaxf(m, s[nt][2 * r + c] * a.scale);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = 0.f;
#pragma unroll
    for (int nt = 0; nt < NKT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool on = (bits[r] >> (2 * nt + c)) & 1u;
        float p = on ? __expf(s[nt][2 * r + c] * a.scale - m) : 0.f;
        l += p;
        // dropout acts on the normalized p: the sum l stays undropped
        if (DROP) p = drop_bits(rkey[r], 8 * nt + 2 * t + c) >= a.threshold ? p * a.keep_scale : 0.f;
        s[nt][2 * r + c] = p;
      }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // no allowed key -> 0
    L[r] = l > 0.f ? m + logf(l) : LSE_EMPTY;
  }

  float acc[NDT][4];
#pragma unroll
  for (int nd = 0; nd < NDT; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const float* vw = vs + win.shift;
#pragma unroll
  for (int nt = 0; nt < NKT; ++nt) {
    if (nt >= NK) break;
    uint32_t ph[4], pl[4];
    weights_a(wts[part], s[nt], ph, pl);
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd) {
      if (nd >= KS) break;
      const float2 bv = chunk_b(vw + 8 * nt * RS, RS, nd);
      mma_3xtf32(acc[nd], ph, pl, bv.x, bv.y);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= a.Lq) continue;
    float* o = out + (((long long)b * a.Lq + row) * a.H + h) * D;
#pragma unroll
    for (int nd = 0; nd < NDT; ++nd) {
      const int d = 8 * nd + 2 * t;
      if (d >= D) break;
      const float x0 = acc[nd][2 * r] * inv[r], x1 = acc[nd][2 * r + 1] * inv[r];
      if (D % 2 == 0) {  // d even: 8-byte aligned
        *reinterpret_cast<float2*>(o + d) = make_float2(x0, x1);
      } else {
        o[d] = x0;
        if (d + 1 < D) o[d + 1] = x1;
      }
    }
    if (LSE && t == 0) lse[((long long)b * a.H + h) * a.Lq + row] = L[r];
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
  auto kernel = slots_for(a.D) == 8 ? masked_mha_fwd_kernel<T, 8, DROP, LSE>
                                    : masked_mha_fwd_kernel<T, 10, DROP, LSE>;
  kernel<<<blocks_for((long long)a.B * a.Lq * a.H), THREADS, 0, s>>>(
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
  auto kernel = slots_for(a.D) == 8 ? masked_mha_bwd_dq_kernel<T, 8, DROP>
                                    : masked_mha_bwd_dq_kernel<T, 10, DROP>;
  kernel<<<blocks_for((long long)a.B * a.Lq * a.H), THREADS, 0, s>>>(
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
  auto kernel = slots_for(a.D) == 8 ? masked_mha_bwd_dkv_kernel<T, 8, DROP>
                                    : masked_mha_bwd_dkv_kernel<T, 10, DROP>;
  kernel<<<blocks_for((long long)a.B * a.Lk * a.H), THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<const unsigned char*>(allow_t),
      static_cast<const float*>(lse), static_cast<const float*>(r),
      static_cast<const int*>(seeds), static_cast<T*>(dk), static_cast<T*>(dv), a);
  return (int)cudaGetLastError();
}

// True for what the staged routes cannot take: not bf16, more heads than
// WARPS, a head dim that is odd or above STAGED_DMAX, rows that are not
// whole 16-byte pieces, pointers
// or token and batch strides (or-ed together) off 16-byte alignment.
bool staged_refuses(int dtype, int B, int Lq, int Lk, int H, int D,
                    std::initializer_list<const void*> ptrs, long long strides) {
  bool off = false;
  for (const void* p : ptrs) off |= reinterpret_cast<uintptr_t>(p) % 16 != 0;
  return dtype != 1 || bad_shape(B, Lq, Lk, H, D) || D > STAGED_DMAX || H > WARPS || D % 2 ||
         (H * D) % 8 || off || strides % 8 != 0;
}

template <bool DROP, bool LSE>
int fwd_staged(const void* q, const void* k, const void* v, const void* allow, const void* seeds,
               void* out, void* lse, const Args& a, cudaStream_t s) {
  auto kernel = masked_mha_fwd_staged_kernel<DROP, LSE>;
  const size_t smem = fwd_staged_smem(a.Lk, a.H, a.D);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)a.B * ((a.Lq + TILE - 1) / TILE) * ((a.H + HG - 1) / HG);
  kernel<<<(unsigned)blocks, FWD_PARTS * HG * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const unsigned char*>(allow),
      static_cast<const int*>(seeds), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      a);
  return (int)cudaGetLastError();
}

template <bool DROP>
int bwd_dkv_staged(const void* q, const void* k, const void* v, const void* g,
                   const void* allow_t, const void* lse, const void* r, const void* seeds,
                   void* dk, void* dv, const Args& a, cudaStream_t s) {
  auto kernel = masked_mha_bwd_dkv_staged_kernel<DROP>;
  const size_t smem = dkv_staged_smem(a.Lq, a.H, a.D);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)a.B * ((a.Lk + TILE - 1) / TILE) * ((a.H + HG - 1) / HG);
  kernel<<<(unsigned)blocks, DKV_PARTS * HG * 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<const unsigned char*>(allow_t), static_cast<const float*>(lse),
      static_cast<const float*>(r), static_cast<const int*>(seeds),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a);
  return (int)cudaGetLastError();
}

// True for what the tiled routes cannot take: not float32, more heads than
// WARPS, a head dim past DMAX, rows that are not whole 16-byte pieces (H D
// a multiple of 4), pointers or token and batch strides (or-ed together)
// off 16-byte alignment.
bool tiled_refuses(int dtype, int B, int Lq, int Lk, int H, int D,
                   std::initializer_list<const void*> ptrs, long long strides) {
  bool off = false;
  for (const void* p : ptrs) off |= reinterpret_cast<uintptr_t>(p) % 16 != 0;
  return dtype != 0 || bad_shape(B, Lq, Lk, H, D) || H > WARPS || (H * D) % 4 || off ||
         strides % 4 != 0;
}

unsigned tiled_blocks(const Args& a, int rows) {
  return (unsigned)((long long)a.B * ((rows + TT - 1) / TT) * a.H);
}

template <bool DROP, bool LSE>
int fwd_tiled(const void* q, const void* k, const void* v, const void* allow, const void* order,
              const void* seeds, void* out, void* lse, const Args& a, cudaStream_t s) {
  auto kernel = masked_mha_fwd_tiled_kernel<DROP, LSE>;
  const size_t smem = tiled_smem(a.Lk, a.D, 1, false);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiled_blocks(a, a.Lq), TILED_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(allow), static_cast<const long long*>(order),
      static_cast<const int*>(seeds), static_cast<float*>(out), static_cast<float*>(lse), a);
  return (int)cudaGetLastError();
}

// dQ (DKV false: mask = allow, out0 = dq, out1 = r) or dK/dV (DKV true:
// mask = allowT, out0 = dk, out1 = dv)
template <bool DROP, bool DKV>
int bwd_tiled(const void* q, const void* k, const void* v, const void* g, const void* mask,
              const void* order, const void* lse, const void* r, const void* seeds, void* out0,
              void* out1, const Args& a, cudaStream_t s) {
  auto kernel = masked_mha_bwd_tiled_kernel<DROP, DKV>;
  const size_t smem = tiled_smem(DKV ? a.Lq : a.Lk, a.D, 2, DKV);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<tiled_blocks(a, DKV ? a.Lk : a.Lq), TILED_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<const unsigned char*>(mask),
      static_cast<const long long*>(order), static_cast<const float*>(lse),
      static_cast<const float*>(r), static_cast<const int*>(seeds), static_cast<float*>(out0),
      static_cast<float*>(out1), a);
  return (int)cudaGetLastError();
}

// True for what the resident route cannot take: not float32, more keys
// than RESIDENT_MAX_KEYS, a head dim past RESIDENT_MAX_HEAD_DIM, rows that
// are not whole 16-byte pieces (H D a multiple of 4), pointers or token and
// batch strides (or-ed together) off 16-byte alignment. Any number of heads.
bool resident_refuses(int dtype, int B, int Lq, int Lk, int H, int D,
                      std::initializer_list<const void*> ptrs, long long strides) {
  bool off = false;
  for (const void* p : ptrs) off |= reinterpret_cast<uintptr_t>(p) % 16 != 0;
  return dtype != 0 || bad_shape(B, Lq, Lk, H, D) || Lk > RESIDENT_MAX_KEYS ||
         D > RESIDENT_MAX_HEAD_DIM || (H * D) % 4 || off || strides % 4 != 0;
}

template <int NKT, int NDT, bool DROP, bool LSE>
int fwd_resident_at(const void* q, const void* k, const void* v, const void* allow,
                    const void* seeds, void* out, void* lse, const Args& a, cudaStream_t s) {
  auto kernel = masked_mha_fwd_resident_kernel<NKT, NDT, DROP, LSE>;
  const size_t smem = resident_smem(a.Lk, a.D);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)a.B * a.H * ((a.Lq + RROWS - 1) / RROWS);
  kernel<<<(unsigned)blocks, RESIDENT_THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(allow), static_cast<const int*>(seeds),
      static_cast<float*>(out), static_cast<float*>(lse), a);
  return (int)cudaGetLastError();
}

// the instantiation whose registers hold Lk keys' scores and D output dims
template <bool DROP, bool LSE>
int fwd_resident(const void* q, const void* k, const void* v, const void* allow,
                 const void* seeds, void* out, void* lse, const Args& a, cudaStream_t s) {
  if (a.Lk <= 64)
    return a.D <= 64 ? fwd_resident_at<8, 8, DROP, LSE>(q, k, v, allow, seeds, out, lse, a, s)
                     : fwd_resident_at<8, 16, DROP, LSE>(q, k, v, allow, seeds, out, lse, a, s);
  return a.D <= 64 ? fwd_resident_at<16, 8, DROP, LSE>(q, k, v, allow, seeds, out, lse, a, s)
                   : fwd_resident_at<16, 16, DROP, LSE>(q, k, v, allow, seeds, out, lse, a, s);
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
// masked_mha_bwd_dq. It refuses (cudaErrorInvalidValue) H > 8, odd D or D > 256, rows that
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
  if (staged_refuses(dtype, B, Lq, Lk, H, D, {q, k, v, g, dq},
                     q_sb | q_sl | k_sb | k_sl | v_sb | v_sl | g_sb | g_sl) ||
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

// The staged forward route (bf16 only): the arguments and outputs of
// masked_mha_fwd. It refuses (cudaErrorInvalidValue) what staged_refuses
// names and shared memory past a block's limit; the wrapper's fwd_plan and
// fwd_route check the same first.
extern "C" int masked_mha_fwd_staged(int dtype, const void* q, const void* k, const void* v,
                                     const void* allow, const void* seeds, void* out,
                                     void* lse, int B, int Lq, int Lk, int H, int D,
                                     long long q_sb, long long q_sl, long long k_sb,
                                     long long k_sl, long long v_sb, long long v_sl,
                                     float scale, unsigned threshold, float keep_scale,
                                     void* stream) {
  if (staged_refuses(dtype, B, Lq, Lk, H, D, {q, k, v, out},
                     q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) ||
      fwd_staged_smem(Lk, H, D) + static_smem(FWD_PARTS, 1) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 0, 0,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seeds == nullptr)
    return lse == nullptr ? fwd_staged<false, false>(q, k, v, allow, seeds, out, lse, a, s)
                          : fwd_staged<false, true>(q, k, v, allow, seeds, out, lse, a, s);
  return lse == nullptr ? fwd_staged<true, false>(q, k, v, allow, seeds, out, lse, a, s)
                        : fwd_staged<true, true>(q, k, v, allow, seeds, out, lse, a, s);
}

// The staged dK/dV route (bf16 only): the arguments and outputs of
// masked_mha_bwd_dkv. It refuses what masked_mha_fwd_staged refuses (the
// wrapper's dkv_plan and dkv_route check the same first).
extern "C" int masked_mha_bwd_dkv_staged(int dtype, const void* q, const void* k, const void* v,
                                         const void* g, const void* allow_t, const void* lse,
                                         const void* r, const void* seeds, void* dk, void* dv,
                                         int B, int Lq, int Lk, int H, int D, long long q_sb,
                                         long long q_sl, long long k_sb, long long k_sl,
                                         long long v_sb, long long v_sl, long long g_sb,
                                         long long g_sl, float scale, unsigned threshold,
                                         float keep_scale, void* stream) {
  if (staged_refuses(dtype, B, Lq, Lk, H, D, {q, k, v, g, dk, dv},
                     q_sb | q_sl | k_sb | k_sl | v_sb | v_sl | g_sb | g_sl) ||
      dkv_staged_smem(Lq, H, D) + static_smem(DKV_PARTS, 2) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seeds != nullptr
             ? bwd_dkv_staged<true>(q, k, v, g, allow_t, lse, r, seeds, dk, dv, a, s)
             : bwd_dkv_staged<false>(q, k, v, g, allow_t, lse, r, seeds, dk, dv, a, s);
}

// The tiled routes (float32 only): the arguments and outputs of
// masked_mha_fwd, masked_mha_bwd_dq and masked_mha_bwd_dkv, with `order`
// after the mask: (B, Lq) int64 (the forward and dQ) or (B, Lk) int64
// (dK/dV), each video's rows in the order its tiles take them
// (ops/masked_attention.py::row_order). They refuse (cudaErrorInvalidValue)
// what tiled_refuses names and shared memory past a block's limit; the
// wrapper's tiled_layout and tiled_plan check the same first.
extern "C" int masked_mha_fwd_tiled(int dtype, const void* q, const void* k, const void* v,
                                    const void* allow, const void* order, const void* seeds,
                                    void* out, void* lse, int B, int Lq, int Lk, int H, int D,
                                    long long q_sb, long long q_sl, long long k_sb,
                                    long long k_sl, long long v_sb, long long v_sl, float scale,
                                    unsigned threshold, float keep_scale, void* stream) {
  if (tiled_refuses(dtype, B, Lq, Lk, H, D, {q, k, v}, q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) ||
      tiled_smem(Lk, D, 1, false) + tiled_static_smem(1) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 0, 0,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seeds == nullptr)
    return lse == nullptr ? fwd_tiled<false, false>(q, k, v, allow, order, seeds, out, lse, a, s)
                          : fwd_tiled<false, true>(q, k, v, allow, order, seeds, out, lse, a, s);
  return lse == nullptr ? fwd_tiled<true, false>(q, k, v, allow, order, seeds, out, lse, a, s)
                        : fwd_tiled<true, true>(q, k, v, allow, order, seeds, out, lse, a, s);
}

extern "C" int masked_mha_bwd_dq_tiled(int dtype, const void* q, const void* k, const void* v,
                                       const void* g, const void* allow, const void* order,
                                       const void* lse, const void* seeds, void* dq, void* r,
                                       int B, int Lq, int Lk, int H, int D, long long q_sb,
                                       long long q_sl, long long k_sb, long long k_sl,
                                       long long v_sb, long long v_sl, long long g_sb,
                                       long long g_sl, float scale, unsigned threshold,
                                       float keep_scale, void* stream) {
  if (tiled_refuses(dtype, B, Lq, Lk, H, D, {q, k, v, g},
                    q_sb | q_sl | k_sb | k_sl | v_sb | v_sl | g_sb | g_sl) ||
      tiled_smem(Lk, D, 2, false) + tiled_static_smem(2) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seeds != nullptr
             ? bwd_tiled<true, false>(q, k, v, g, allow, order, lse, nullptr, seeds, dq, r, a, s)
             : bwd_tiled<false, false>(q, k, v, g, allow, order, lse, nullptr, seeds, dq, r, a,
                                       s);
}

extern "C" int masked_mha_bwd_dkv_tiled(int dtype, const void* q, const void* k, const void* v,
                                        const void* g, const void* allow_t, const void* order,
                                        const void* lse, const void* r, const void* seeds,
                                        void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
                                        long long q_sb, long long q_sl, long long k_sb,
                                        long long k_sl, long long v_sb, long long v_sl,
                                        long long g_sb, long long g_sl, float scale,
                                        unsigned threshold, float keep_scale, void* stream) {
  if (tiled_refuses(dtype, B, Lq, Lk, H, D, {q, k, v, g},
                    q_sb | q_sl | k_sb | k_sl | v_sb | v_sl | g_sb | g_sl) ||
      tiled_smem(Lq, D, 2, true) + tiled_static_smem(2) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, g_sb, g_sl,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return seeds != nullptr
             ? bwd_tiled<true, true>(q, k, v, g, allow_t, order, lse, r, seeds, dk, dv, a, s)
             : bwd_tiled<false, true>(q, k, v, g, allow_t, order, lse, r, seeds, dk, dv, a, s);
}

// The resident forward route (float32 only): the arguments and outputs of
// masked_mha_fwd. It refuses (cudaErrorInvalidValue) what resident_refuses
// names and shared memory past a block's limit; the wrapper's
// resident_layout and resident_plan check the same first.
extern "C" int masked_mha_fwd_resident(int dtype, const void* q, const void* k, const void* v,
                                       const void* allow, const void* seeds, void* out,
                                       void* lse, int B, int Lq, int Lk, int H, int D,
                                       long long q_sb, long long q_sl, long long k_sb,
                                       long long k_sl, long long v_sb, long long v_sl,
                                       float scale, unsigned threshold, float keep_scale,
                                       void* stream) {
  if (resident_refuses(dtype, B, Lq, Lk, H, D, {q, k, v},
                       q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) ||
      resident_smem(Lk, D) + resident_static_smem() > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(B, Lq, Lk, H, D, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, 0, 0,
                           scale, threshold, keep_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (seeds == nullptr)
    return lse == nullptr ? fwd_resident<false, false>(q, k, v, allow, seeds, out, lse, a, s)
                          : fwd_resident<false, true>(q, k, v, allow, seeds, out, lse, a, s);
  return lse == nullptr ? fwd_resident<true, false>(q, k, v, allow, seeds, out, lse, a, s)
                        : fwd_resident<true, true>(q, k, v, allow, seeds, out, lse, a, s);
}
