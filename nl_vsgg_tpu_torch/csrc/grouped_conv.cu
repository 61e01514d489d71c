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
// 1.27 GB in bf16, 0.38 ms at 3.35 TB/s. On mma.sync, which reaches well
// under the 989 TFLOP/s of wgmma, the C5 head's c = 64 conv is bound by the
// products as much as by its bytes.
//
// Design, bf16 inputs (route "tc", the path detect_video serves). The TPU
// kernel packs groups block-diagonally into 128-lane super-groups so that
// each tap is one dense MXU matmul; on Hopper that would do 128/c times the needed
// products. Here each group is its own implicit GEMM on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 sums): M is output pixels, N the
// group's c output channels, K = 9 c ordered (tap, input channel), the row
// order of the HWIO weights, so k-step s takes weight rows 16 s .. 16 s + 15.
// A lane's A address for k-step s is its pixel's staged neighbourhood
// shifted by the tap of row 16 s + 8 (lane / 16) and offset by that row's
// input channel: no im2col. c = 16 is one tap a k-step, c = 32 two steps a
// tap, c = 64 four; for c = 8 the two 8x8 halves of an A fragment come from
// two taps, and K = 72 is padded to 80 with zero weight rows.
//  - Slabs and resident weights. A block owns a slab of 64 output channels
//    (64 / c whole groups: 8 groups at c = 8, 4 at 16, 2 at 32, one at 64),
//    stages the slab's 9 c x 64 weights into shared memory once (9, 18, 36,
//    72 KB) and walks many pixel tiles with them: a persistent grid of
//    blocks_per_slab x C / 64 blocks, one block an SM (blocks_per_slab is
//    the SM count over the slab count, from the caller's plan).
//  - Tiles. Up to 256 output pixels: TH rows x TW (<= 64) columns of one
//    image in the trunk (4 x 64 at 38x64 to 152x256), or NB whole images
//    (5 of the C5 head's 7x7 crops) with their own zero border; each is
//    staged with its 1-pixel halo as (NB, TH + 2, TW + 2) pixels of 64
//    channels, a pixel 144 bytes apart so that the 8 rows one ldmatrix phase
//    reads fall in 8 different 4-bank groups. Tiles are numbered with the
//    column block fastest, so the blocks of a slab run neighbouring tiles at
//    the same time and their halo re-reads hit L2.
//  - Staging overlapped. Tiles come through a 2-stage ring of cp.async
//    16-byte copies; a copy outside the image has src-size 0 and fills
//    zeros, so the product loop has no branch. The loads of tile i + 1 are
//    in flight while the warps run tile i.
//  - Warps. 8 warps, each 32 pixels (two m16 tiles) x the slab's 64
//    channels (eight n8 tiles, 64 fp32 accumulators a lane; 162-179
//    registers, no spills). Per k-step and group: two ldmatrix.x4 for A,
//    c / 16 ldmatrix.x4.trans for B (one per pair of groups at c = 8),
//    2 c / 8 mma.sync. On the card a 3-stage ring was no faster
//    (nl_vsgg_tpu_torch/tools/kernel_variants.py), and 16 warps of one m16
//    tile or 4 warps of four were slower (PERF.md). c = 64 does 1.1 TFLOP
//    a call at about 250 TFLOP/s; the products and their ldmatrix feeds
//    are what is left, and wgmma, whose A and B come from shared memory in
//    its own tile layouts, is the next step.
//  - Epilogue in fp32 from the accumulators: bias, ReLU, conversion, then
//    4-byte (bf16 pairs) or 8-byte (fp32 pairs) stores straight from the
//    fragments, two of which fill a 32-byte sector. Staging the bf16 tile
//    through shared memory for 16-byte stores was slower on the card at 3 of
//    the 4 classes (one more barrier a tile; PERF.md), so it is not
//    done.
//
// Design, float32 inputs (route "3xtf32": the default of `preprocess
// features`, of the union provider and of the sgdet / sgcls test CLI, which
// run the detector in float32). One TF32 product keeps about 3 digits, too
// few for the 1e-5 the float32 path is held to, so each product is formed
// as three (mma.sync.m16n8k8, tf32 in, fp32 sums; csrc/mma_tf32.cuh): each
// operand split into hi = TF32(x) and lo = x - hi, A_lo B_hi + A_hi B_lo +
// A_hi B_hi. The bound at the path's 47 calls a 32-frame pass (4.29 TFLOP,
// 54.3 GB of fp32 x and out) is 16.2 ms of bytes: the operations take 8.7
// ms even at TF32's 495 TFLOP/s (64.0 on the CUDA cores at 67). This
// design's own floor, three TF32 products each, is 26.0 ms.
// The implicit GEMM is the bf16 route's, with k8 steps: c = 8 is one tap a
// k-step and 9 c is a multiple of 8, so no tap is padded and no fragment
// straddles two taps.
//  - Blocks, resident weights, persistent grid and cp.async ring as above,
//    at 4 bytes an element. A block owns a 64-channel slab at c <= 32
//    (weights 18, 36, 72 KB) and half of the one group at c = 64 (32
//    output channels, all 64 inputs staged: 72 KB where the whole group's
//    144 KB would leave room for only two 2-crop stages). Tiles of at most
//    128 output pixels at c <= 32 (8 x 16 in the trunk) and 256 at c = 64
//    (five 7x7 crops, 245 rows of 256), `ops/grouped_conv.tf32_plan`. A
//    tile of whole images (the head's crops) stages only their pixels and
//    reads its zero border from one zero pixel (each A row keeps a mask of
//    the taps that fall inside its image); any other tile stages its halo.
//  - Swizzle, no padding. A staged pixel's 64 channels and a weight row's
//    columns are rows of floats whose 8-float groups are XOR-permuted:
//    channel ch of the pixel at staged row y, column x of image n at
//    ch ^ 8 ((x + (n TH + y) TW) & 3), weight column o of row r at
//    o ^ 8 ((r / 2) & 3). A lane takes k = 2 t and 2 t + 1 of a step as its
//    fragment columns t and t + 4, so an A row pair is one 8-byte load; the
//    4 pixels a half-warp reads are 4 consecutive output pixels, whose
//    swizzles differ, and the 4 weight rows a warp's B loads read differ in
//    theirs: both conflict-free. The swizzle of a lane's A rows at a tap is
//    (g + dx + dy TW) & 3 (less TW + 1 on whole-image tiles), the same for
//    all four rows.
//  - Warps. 8 warps, each 32 pixels (two m16 tiles) x 32 channels (four n8
//    tiles, 32 fp32 accumulators a lane): 4 x 2 on a 64-channel slab, 8 x 1
//    on a half group. Per k-step a warp loads and splits its two A tiles
//    once and each n8 tile's B once, and runs 3 mma.sync a pair. At c = 8
//    an A tile feeds one n8 tile, so the splits cost about as much as the
//    products; at c = 32 and 64 it feeds four.
//  - Epilogue as the bf16 route's, in fp32 or bf16.
// Other group widths (c % 4 == 0, c dividing 64 or a multiple of it) take
// route "fma", the first kernel, on the CUDA cores with scalar FMAs: a block
// takes one tile of up to 128 output pixels for 64 output channels, stages
// it and the groups' weights in fp32 in chunks of 16 input channels, and
// each thread sums 4 channels x 8 pixels. Its own C entry also lets it be
// timed beside the 3xtf32 route at the path's widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------- bf16: tensor cores
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_PIXELS = TC_WARPS * 32;  // output pixels a tile
constexpr int SLAB = 64;                  // output channels a block
constexpr int SPS = SLAB + 8;             // staged pixel / weight row stride (bf16)
constexpr int STAGES = 2;
constexpr int SMEM_MAX = 232448;          // a block's shared memory on sm_90

struct Plan {
  int N, H, W, C;
  int TH, TW, NB;          // a tile: NB images x TH rows x TW columns
  int tiles_h, tiles_w, tiles;
  int per_slab, relu;
};

__host__ __device__ constexpr int weight_rows(int c) { return (9 * c + 15) / 16 * 16; }

__host__ __device__ inline int stage_elems(const Plan& p) {
  return p.NB * (p.TH + 2) * (p.TW + 2) * SPS;
}

// tile t -> its first image, row and column
__device__ __forceinline__ void tile_origin(const Plan& p, int t, int& n0, int& h0, int& w0) {
  w0 = (t % p.tiles_w) * p.TW;
  t /= p.tiles_w;
  h0 = (t % p.tiles_h) * p.TH;
  n0 = (t / p.tiles_h) * p.NB;
}

// start the cp.async copies of tile t's halo'd input (the slab's 64
// channels, 8 x 16 bytes a pixel) into a ring slot
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ x, const Plan& p,
                                           int t, int cs0, __nv_bfloat16* dst) {
  int n0, h0, w0;
  tile_origin(p, t, n0, h0, w0);
  const int WT = p.TW + 2, HT = p.TH + 2;
  const int n_vec = p.NB * HT * WT * 8;
  for (int idx = threadIdx.x; idx < n_vec; idx += TC_THREADS) {
    const int v = idx & 7, px = idx >> 3;
    const int xx = px % WT, yy = (px / WT) % HT, n = n0 + px / (WT * HT);
    const int h = h0 - 1 + yy, ww = w0 - 1 + xx;
    const bool ok = n < p.N && h >= 0 && h < p.H && ww >= 0 && ww < p.W;
    const __nv_bfloat16* src =
        ok ? x + (((long long)n * p.H + h) * p.W + ww) * p.C + cs0 + v * 8 : x;
    cp_async16(dst + px * SPS + v * 8, src, ok);
  }
}

template <int CG, typename TO>
__global__ void __launch_bounds__(TC_THREADS, 1)
conv_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias, TO* __restrict__ out, const Plan p) {
  constexpr int KR = weight_rows(CG);   // 80, 144, 288, 576
  constexpr int KS = KR / 16;           // k-steps: 5, 9, 18, 36
  constexpr int G = SLAB / CG;          // groups a slab
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [KR][SPS]
  __nv_bfloat16* in_s = w_s + KR * SPS;                          // [STAGES][stage]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs0 = blockIdx.y * SLAB;
  const int WT = p.TW + 2, HT = p.TH + 2;
  const int tile_px = p.NB * p.TH * p.TW;
  const int stage = stage_elems(p);

  // the slab's weights, once: rows (tap, i) >= 9 c are the zero tap
  for (int idx = threadIdx.x; idx < KR * 8; idx += TC_THREADS) {
    const int r = idx >> 3, v = idx & 7;
    const bool ok = r < 9 * CG;
    cp_async16(w_s + r * SPS + v * 8, ok ? w + (long long)r * p.C + cs0 + v * 8 : w, ok);
  }
  if ((int)blockIdx.x < p.tiles) stage_tile(x, p, blockIdx.x, cs0, in_s);
  cp_async_commit();

  // this lane's two A rows (pixels) as staged offsets of their 3x3
  // neighbourhood's corner; rows past the tile read pixel 0 and are not stored
  int a_off[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    int q = warp * 32 + mi * 16 + (lane & 15);
    if (q >= tile_px) q = 0;
    const int nb = q / (p.TH * p.TW), r = (q / p.TW) % p.TH, col = q % p.TW;
    a_off[mi] = ((nb * HT + r) * WT + col) * SPS;
  }
  const int k_half = (lane >> 4) * 8;  // the lane's half of a k16 step
  const __nv_bfloat16* b_lane =
      w_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * SPS + (lane >> 4) * 8;
  float bv[8][2];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[ni][j] = bias != nullptr ? bias[cs0 + ni * 8 + (lane & 3) * 2 + j] : 0.0f;

  for (int it = 0;; ++it) {
    const int t = blockIdx.x + it * p.per_slab;
    if (t >= p.tiles) break;
    const int tn = t + p.per_slab;
    if (tn < p.tiles) stage_tile(x, p, tn, cs0, in_s + ((it + 1) % STAGES) * stage);
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and, on the first pass, the weights) landed
    __syncthreads();

    const __nv_bfloat16* src = in_s + (it % STAGES) * stage;
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int kr = 16 * s + k_half;
      const int tap = kr / CG < 9 ? kr / CG : 8;   // the zero tap reads tap 8
      const int shift = ((tap / 3) * WT + tap % 3) * SPS + kr % CG;
      const __nv_bfloat16* a0 = src + a_off[0] + shift;
      const __nv_bfloat16* a1 = src + a_off[1] + shift;
      const __nv_bfloat16* bs = b_lane + 16 * s * SPS;
      if constexpr (CG == 8) {
#pragma unroll
        for (int gp = 0; gp < G / 2; ++gp) {   // one B load for two groups
          uint32_t bf[4], a[2][4];
          ldmatrix_x4_trans(bf, bs + gp * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int g = 2 * gp + h;
            ldmatrix_x4(a[0], a0 + g * 8);
            ldmatrix_x4(a[1], a1 + g * 8);
            mma_bf16_16816(acc[0][g], a[0], bf[2 * h], bf[2 * h + 1]);
            mma_bf16_16816(acc[1][g], a[1], bf[2 * h], bf[2 * h + 1]);
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          uint32_t a[2][4];
          ldmatrix_x4(a[0], a0 + g * CG);
          ldmatrix_x4(a[1], a1 + g * CG);
#pragma unroll
          for (int np = 0; np < CG / 16; ++np) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, bs + g * CG + np * 16);
            const int ni = g * (CG / 8) + 2 * np;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16_16816(acc[mi][ni], a[mi], bf[0], bf[1]);
              mma_bf16_16816(acc[mi][ni + 1], a[mi], bf[2], bf[3]);
            }
          }
        }
      }
    }

    int n0, h0, w0;
    tile_origin(p, t, n0, h0, w0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = warp * 32 + mi * 16 + (lane >> 2) + half * 8;
        if (q >= tile_px) continue;
        const int n = n0 + q / (p.TH * p.TW);
        const int h = h0 + (q / p.TW) % p.TH, ww = w0 + q % p.TW;
        if (n >= p.N || h >= p.H || ww >= p.W) continue;
        TO* dst = out + (((long long)n * p.H + h) * p.W + ww) * p.C + cs0 + (lane & 3) * 2;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          float v0 = acc[mi][ni][2 * half] + bv[ni][0];
          float v1 = acc[mi][ni][2 * half + 1] + bv[ni][1];
          if (p.relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          store2(dst + ni * 8, v0, v1);
        }
      }
    __syncthreads();   // every warp is done with this slot before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int CG, typename TO>
int launch_tc(const void* x, const void* w, const void* bias, void* out, const Plan& p,
              cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * ((size_t)weight_rows(CG) * SPS + (size_t)STAGES * stage_elems(p));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv_tc_kernel<CG, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.per_slab, p.C / SLAB);
  conv_tc_kernel<CG, TO><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<TO*>(out), p);
  return (int)cudaGetLastError();
}

template <typename TO>
int dispatch_tc(int c, const void* x, const void* w, const void* bias, void* out, const Plan& p,
                cudaStream_t s) {
  switch (c) {
    case 8: return launch_tc<8, TO>(x, w, bias, out, p, s);
    case 16: return launch_tc<16, TO>(x, w, bias, out, p, s);
    case 32: return launch_tc<32, TO>(x, w, bias, out, p, s);
    case 64: return launch_tc<64, TO>(x, w, bias, out, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------ fp32: 3xTF32 tensor cores
constexpr int TF_THREADS = 256;   // 8 warps, each 32 pixels x 32 channels
constexpr int TF_ROW = 64;        // floats a staged pixel: the slab's (or the group's) inputs

// output channels a block: a 64-channel slab, or half of c = 64's one
// group, whose 144 KB of weights would leave room for no more than two
// 2-crop stages; and the output pixels a tile, 32 a warp along the pixels
__host__ __device__ constexpr int tf_block_c(int c) { return c == 64 ? 32 : SLAB; }
__host__ __device__ constexpr int tf_pixels(int c) { return 32 * 8 / (tf_block_c(c) / 32); }

// a tile of whole images (TH = H, TW = W: the C5 head's crops) stages only
// their pixels, its zero border read from one shared zero pixel; any other
// tile stages its 1-pixel halo
__host__ __device__ inline bool tf_whole(const Plan& p) { return p.TH == p.H && p.TW == p.W; }
__host__ __device__ inline int tf_stage_floats(const Plan& p) {
  return (tf_whole(p) ? p.NB * p.TH * p.TW : p.NB * (p.TH + 2) * (p.TW + 2)) * TF_ROW;
}

// start the cp.async copies of tile t's input (64 channels from xc0, 16 x
// 16 bytes a staged pixel, swizzled) into a ring slot
__device__ __forceinline__ void stage_tile_f32(const float* __restrict__ x, const Plan& p, int t,
                                               int xc0, float* dst) {
  int n0, h0, w0;
  tile_origin(p, t, n0, h0, w0);
  const int halo = tf_whole(p) ? 0 : 1;
  const int WT = p.TW + 2 * halo, HT = p.TH + 2 * halo;
  const int n_vec = p.NB * HT * WT * 16;
  for (int idx = threadIdx.x; idx < n_vec; idx += TF_THREADS) {
    const int v = idx & 15, px = idx >> 4;
    const int xx = px % WT, yy = (px / WT) % HT, nb = px / (WT * HT);
    const int n = n0 + nb, h = h0 - halo + yy, ww = w0 - halo + xx;
    const bool ok = n < p.N && h >= 0 && h < p.H && ww >= 0 && ww < p.W;
    const float* src = ok ? x + (((long long)n * p.H + h) * p.W + ww) * p.C + xc0 + v * 4 : x;
    const int sw = ((xx + (nb * p.TH + yy) * p.TW) & 3) << 3;
    cp_async16(dst + px * TF_ROW + ((v * 4) ^ sw), src, ok);
  }
}

template <int CG, typename TO>
__global__ void __launch_bounds__(TF_THREADS, 1)
conv_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, TO* __restrict__ out, const Plan p) {
  constexpr int BC = tf_block_c(CG);          // output channels a block: 64, or 32 at c = 64
  constexpr int WN = BC / 32, WM = 8 / WN;    // warps along the channels and the pixels
  constexpr int KR = 9 * CG;                  // weight rows: 72, 144, 288, 576
  constexpr int KPT = CG / 8;                 // k-steps a tap
  constexpr int GW = CG < 32 ? 32 / CG : 1;   // groups in a warp's 32 channels
  constexpr int NPG = 4 / GW;                 // a group's n8 tiles in the warp
  constexpr int ZP = KR * BC;                 // the zero pixel, after the weights
  // the taps unrolled at c <= 32; a loop at c = 64, whose 72 unrolled
  // k-steps ran 1.5x slower on the card (the code outgrows the i-cache)
  constexpr int TAP_UNROLL = CG == 64 ? 1 : 9;
  extern __shared__ __align__(16) float smem_f[];   // [KR][BC] weights, zero pixel, ring

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % WM, wn = warp / WM;   // the warp's 32 pixels and 32 channels
  const int cs0 = blockIdx.y * BC, xc0 = cs0 & ~63;
  const bool whole = tf_whole(p);
  const int WT = whole ? p.TW : p.TW + 2, HT = whole ? p.TH : p.TH + 2;
  const int tile_px = p.NB * p.TH * p.TW;
  const int stage = tf_stage_floats(p);

  // the block's weights, once; the zero pixel
  for (int idx = threadIdx.x; idx < KR * BC / 4; idx += TF_THREADS) {
    const int r = idx / (BC / 4), v = idx % (BC / 4);
    cp_async16(smem_f + r * BC + ((v * 4) ^ (((r >> 1) & 3) << 3)),
               w + (long long)r * p.C + cs0 + v * 4, true);
  }
  if (threadIdx.x < TF_ROW) smem_f[ZP + threadIdx.x] = 0.0f;
  if ((int)blockIdx.x < p.tiles) stage_tile_f32(x, p, blockIdx.x, xc0, smem_f + ZP + TF_ROW);
  cp_async_commit();

  // this lane's four A rows, pixels q = 32 wm + 16 mi + 8 h + g: the staged
  // offset of tap (0, 0)'s pixel (tap (dy, dx) adds dy WT + dx pixels) plus
  // the lane's k pair 2 t (and, below 64 channels a group, the warp's
  // first input channel), and the taps whose pixel is staged (all of them
  // unless the tile holds whole images; the others read the zero pixel).
  // Rows past the tile read pixel 0 and are not stored.
  const int lc = 2 * tq + (CG < 64 ? wn * 32 : 0);
  int a_off[2][2], taps[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int q = wm * 32 + mi * 16 + h * 8 + g;
      if (q >= tile_px) q = 0;
      const int nb = q / (p.TH * p.TW), r = (q / p.TW) % p.TH, col = q % p.TW;
      a_off[mi][h] = (((nb * HT + r) * WT + col) - (whole ? WT + 1 : 0)) * TF_ROW + lc;
      taps[mi][h] = 0x1ff;
      if (whole)
        for (int tap = 0; tap < 9; ++tap) {
          const int y = r + tap / 3 - 1, xx = col + tap % 3 - 1;
          if (y < 0 || y >= p.TH || xx < 0 || xx >= p.TW) taps[mi][h] &= ~(1 << tap);
        }
    }
  // B of n8 tile ni: rows 8 s + 2 t and + 1 of the k-step, column n of the
  // warp's 32 (both rows swizzled by 8 t)
  int b_off[4];
  float bv[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    b_off[ni] = 2 * tq * BC + (((wn * 32 + ni * 8) ^ (tq << 3)) + g);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[ni][j] = bias != nullptr ? bias[cs0 + wn * 32 + ni * 8 + tq * 2 + j] : 0.0f;
  }

  for (int it = 0;; ++it) {
    const int t = blockIdx.x + it * p.per_slab;
    if (t >= p.tiles) break;
    const int tn = t + p.per_slab;
    if (tn < p.tiles)
      stage_tile_f32(x, p, tn, xc0, smem_f + ZP + TF_ROW + ((it + 1) % STAGES) * stage);
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and, on the first pass, the weights) landed
    __syncthreads();

    const int sb = ZP + TF_ROW + (it % STAGES) * stage;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

#pragma unroll TAP_UNROLL
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int shift = sb + (dy * WT + dx) * TF_ROW;
      const int sw = ((g + dx + dy * p.TW - (whole ? p.TW + 1 : 0)) & 3) << 3;
      int row[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          row[mi][h] = (taps[mi][h] >> tap) & 1 ? a_off[mi][h] + shift : ZP + lc;
#pragma unroll
      for (int gi = 0; gi < GW; ++gi)
#pragma unroll
        for (int kk = 0; kk < KPT; ++kk) {
          const int col = (gi * CG + kk * 8) ^ sw;   // the k-step's input channels, swizzled
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float2 r0 = *reinterpret_cast<const float2*>(smem_f + row[mi][0] + col);
            const float2 r1 = *reinterpret_cast<const float2*>(smem_f + row[mi][1] + col);
            split_tf32(r0.x, ah[mi][0], al[mi][0]);
            split_tf32(r1.x, ah[mi][1], al[mi][1]);
            split_tf32(r0.y, ah[mi][2], al[mi][2]);
            split_tf32(r1.y, ah[mi][3], al[mi][3]);
          }
          const float* wk = smem_f + (tap * KPT + kk) * 8 * BC;   // the group's rows 8 s ..
#pragma unroll
          for (int nn = 0; nn < NPG; ++nn) {
            const int ni = gi * NPG + nn;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(wk[b_off[ni]], bh0, bl0);
            split_tf32(wk[b_off[ni] + BC], bh1, bl1);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              mma_3xtf32_parts(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);
          }
        }
    }

    int n0, h0, w0;
    tile_origin(p, t, n0, h0, w0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = wm * 32 + mi * 16 + half * 8 + g;
        if (q >= tile_px) continue;
        const int n = n0 + q / (p.TH * p.TW);
        const int h = h0 + (q / p.TW) % p.TH, ww = w0 + q % p.TW;
        if (n >= p.N || h >= p.H || ww >= p.W) continue;
        TO* dst = out + (((long long)n * p.H + h) * p.W + ww) * p.C + cs0 + wn * 32 + tq * 2;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          float v0 = acc[mi][ni][2 * half] + bv[ni][0];
          float v1 = acc[mi][ni][2 * half + 1] + bv[ni][1];
          if (p.relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          store2(dst + ni * 8, v0, v1);
        }
      }
    __syncthreads();   // every warp is done with this slot before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <int CG, typename TO>
int launch_3xtf32(const void* x, const void* w, const void* bias, void* out, const Plan& p,
                  cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)9 * CG * tf_block_c(CG) + TF_ROW +
                                       (size_t)STAGES * tf_stage_floats(p));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv_3xtf32_kernel<CG, TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.per_slab, p.C / tf_block_c(CG));
  conv_3xtf32_kernel<CG, TO><<<grid, TF_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<TO*>(out), p);
  return (int)cudaGetLastError();
}

template <typename TO>
int dispatch_3xtf32(int c, const void* x, const void* w, const void* bias, void* out,
                    const Plan& p, cudaStream_t s) {
  switch (c) {
    case 8: return launch_3xtf32<8, TO>(x, w, bias, out, p, s);
    case 16: return launch_3xtf32<16, TO>(x, w, bias, out, p, s);
    case 32: return launch_3xtf32<32, TO>(x, w, bias, out, p, s);
    case 64: return launch_3xtf32<64, TO>(x, w, bias, out, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------- fp32: the CUDA-core body
constexpr int CB = 64;             // output channels per block
constexpr int THREADS = 256;
constexpr int QUADS = CB / 4;      // 4-channel groups of a block
constexpr int LANES = THREADS / QUADS;  // pixel lanes
constexpr int PPT = 8;             // pixels per thread
constexpr int PMAX = LANES * PPT;  // pixels per block
constexpr int KCMAX = 16;          // input channels per group per chunk

struct Geo {
  int N, H, W, C, c;
  int NB, TH, TW;       // images, rows and columns of an output tile
  int tiles_h, tiles_w;
  int KC, CHS, PS;      // input channels per group per chunk, per chunk, pixel stride in smem
  int relu;
};

template <typename TO>
__global__ void __launch_bounds__(THREADS)
fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
        v = x[(((long long)n * g.H + h) * g.W + ww) * g.C + ch];
      in_s[(pix * WT + xx) * g.PS + q] = v;
    }
    for (int idx = tid; idx < n_w; idx += THREADS) {
      const int o = idx % CB;
      const int j = (idx / CB) % g.KC;
      const int tap = idx / (CB * g.KC);
      w_s[idx] = w[((long long)tap * g.c + kc0 + j) * g.C + cb0 + o];
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

template <typename TO>
int launch_fma(const void* x, const void* w, const void* bias, void* out, int N, int H, int W,
               int C, int c, int relu, cudaStream_t stream) {
  if (C % CB || c % 4 || (CB % c && c % CB)) return (int)cudaErrorInvalidValue;
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
  const size_t smem = sizeof(float) * (9 * (size_t)g.KC * CB
                                       + (size_t)g.NB * (g.TH + 2) * (g.TW + 2) * g.PS);
  cudaError_t e = cudaFuncSetAttribute(fma_kernel<TO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((g.N + g.NB - 1) / g.NB) * g.tiles_h * g.tiles_w;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, g.C / CB);
  fma_kernel<TO><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<TO*>(out), g);
  return (int)cudaGetLastError();
}

// the caller's tile plan for an (N, H, W, C) map, checked: tiles of at
// most max_px output pixels, 64-channel slabs, x, w and out 16-byte aligned
bool make_plan(Plan& p, const void* x, const void* w, const void* out, int N, int H, int W,
               int C, int relu, int TH, int TW, int NB, int per_slab, int max_px) {
  if (C % SLAB || C / SLAB > 65535 || TH <= 0 || TW <= 0 || NB <= 0 || per_slab <= 0 ||
      TH * TW * NB > max_px ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return false;
  p.N = N; p.H = H; p.W = W; p.C = C; p.TH = TH; p.TW = TW; p.NB = NB;
  p.tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  const long long tiles = (long long)((N + NB - 1) / NB) * p.tiles_h * p.tiles_w;
  if (tiles >= (1LL << 31)) return false;
  p.tiles = (int)tiles;
  p.per_slab = per_slab;
  p.relu = relu;
  return true;
}

bool bad_args(int out_dtype, int N, int H, int W, int C, int c) {
  return N <= 0 || H <= 0 || W <= 0 || C <= 0 || c <= 0 || C % c || out_dtype < 0 ||
         out_dtype > 1;
}

}  // namespace

// One C entry a route, each refusing what it does not take with
// cudaErrorInvalidValue before any launch (ops/grouped_conv.conv_route
// picks the route by the same rules). out_dtype: 0 = float32, 1 =
// bfloat16; c = C / groups; bias (fp32) may be null; returns the launch's
// cudaError_t (0 = ok).
//   grouped_conv3x3_tc      bf16 x and w (tensor cores): c in {8, 16, 32,
//                           64}, C % 64 == 0, x, w and out 16-byte aligned,
//                           the caller's tile plan (`tile_plan`): TH x TW
//                           output pixels of NB images a tile (TH TW NB <=
//                           256), per_slab blocks for each 64 output
//                           channels.
//   grouped_conv3x3_3xtf32  fp32 x and w (3xTF32 tensor cores): the same
//                           rules, with `tf32_plan`'s tiles (TH TW NB <=
//                           128, 256 at c = 64) and per_slab blocks for
//                           each 64 output channels (32 at c = 64).
//   grouped_conv3x3_fma     fp32 x and w (CUDA cores): C % 64 == 0, c % 4
//                           == 0, c dividing 64 or a multiple of it; the
//                           plan arguments are not read.
extern "C" int grouped_conv3x3_tc(int out_dtype, const void* x, const void* w, const void* bias,
                                  void* out, int N, int H, int W, int C, int c, int relu, int TH,
                                  int TW, int NB, int per_slab, void* stream) {
  Plan p;
  if (bad_args(out_dtype, N, H, W, C, c) ||
      !make_plan(p, x, w, out, N, H, W, C, relu, TH, TW, NB, per_slab, TC_PIXELS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return dispatch_tc<float>(c, x, w, bias, out, p, s);
  return dispatch_tc<__nv_bfloat16>(c, x, w, bias, out, p, s);
}

extern "C" int grouped_conv3x3_3xtf32(int out_dtype, const void* x, const void* w,
                                      const void* bias, void* out, int N, int H, int W, int C,
                                      int c, int relu, int TH, int TW, int NB, int per_slab,
                                      void* stream) {
  Plan p;
  if (bad_args(out_dtype, N, H, W, C, c) ||
      !make_plan(p, x, w, out, N, H, W, C, relu, TH, TW, NB, per_slab, tf_pixels(c)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return dispatch_3xtf32<float>(c, x, w, bias, out, p, s);
  return dispatch_3xtf32<__nv_bfloat16>(c, x, w, bias, out, p, s);
}

extern "C" int grouped_conv3x3_fma(int out_dtype, const void* x, const void* w, const void* bias,
                                   void* out, int N, int H, int W, int C, int c, int relu,
                                   int TH, int TW, int NB, int per_slab, void* stream) {
  (void)TH; (void)TW; (void)NB; (void)per_slab;
  if (bad_args(out_dtype, N, H, W, C, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch_fma<float>(x, w, bias, out, N, H, W, C, c, relu, s);
  return launch_fma<__nv_bfloat16>(x, w, bias, out, N, H, W, C, c, relu, s);
}
