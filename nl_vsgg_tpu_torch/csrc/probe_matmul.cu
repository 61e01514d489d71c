// y = x @ w, x (M, 128) and w (128, 128) bf16, fp32 sums, y (M, 128) bf16,
// for Hopper (sm_90a): the matmul kernel of the launch-overhead probe.
//
// Replaces tools/probe_pallas_overhead.py's mm-pallas kernel (call :105),
// a one-step (20480, 128) @ (128, 128) jnp.dot with fp32 accumulation whose
// time the probe sets beside the plain XLA dot (mm-xla; here torch.matmul
// stands beside it as the library row).
//
// Bound. 2 M 128^2 operations against 2 (M 128 + 128^2 + M 128) bytes: 64
// operations a byte, far below the card's ~295 for bf16 tensor cores, so
// the product is bound by memory: at M = 20480, 10.5 MB, 3.1 us at
// 3.35 TB/s (0.67 GFLOP would take 0.68 us at 989 TFLOP/s).
//
// Design. A block that loads w and 128 rows synchronously behind one
// barrier overlaps no load with a product, and M / 128 = 160 such blocks
// over 132 SMs run a second serial wave. So a persistent grid of one block
// an SM (at most one a 32-row tile) keeps w
// resident: it is staged once into shared memory and then held in
// registers as B fragments, each of the 8 warps (2 x 4) owning 32 output
// columns (8 k-slices x 4 n8 tiles, 64 registers). The block walks its
// 32-row tiles of x (tiles blockIdx, blockIdx + grid, ...: 640 tiles at
// M = 20480, at most 5 a block) through a 4-stage ring of cp.async 16-byte
// copies, so three tiles' loads are in flight while a tile is multiplied
// and stored; rows past M are zero-filled and not stored. Per tile a warp
// does 8 ldmatrix.x4 for A (16 rows, padded to 136 bf16 so the eight rows
// of a phase fall in other banks) and 32 mma.sync.m16n8k16, then rounds the
// fp32 sums to bf16 pairs into a shared result tile, which leaves as
// coalesced 16-byte rows (the fragments' own 4-byte pairs would be 8
// half-sector writes a store instruction).
//
// What still bounds it, from ablations on the card
// (nl_vsgg_tpu_torch/tools/kernel_variants.py, PERF.md): every block reads
// all of w from L2 (132 x 32 KB; leaving that out saves about 1.5 us of
// 7.4 at M = 20480), and each block's 5 tiles run one after another (the
// products' share about 2.0 us, the stores' 0.7). Two independent 8-warp
// teams a block, a cluster of 2 blocks sharing w through distributed
// shared memory, 2 or more blocks an SM, and two sets of partial sums were
// each slower (builds of those variants are not kept).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 32;       // rows of x a tile
constexpr int KN = 128;      // the depth and width of w
constexpr int PS = KN + 8;   // shared-memory row stride in bf16
constexpr int THREADS = 256;
constexpr int STAGES = 4;
constexpr int VPR = KN * 2 / 16;  // 16-byte vectors a row

__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ x, int M,
                                           long long m0, __nv_bfloat16* dst) {
  for (int idx = threadIdx.x; idx < BM * VPR; idx += THREADS) {
    const int v = idx % VPR, r = idx / VPR;
    const bool ok = m0 + r < M;
    cp_async16(dst + r * PS + v * 8, ok ? x + (m0 + r) * KN + v * 8 : x, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
probe_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [KN][PS]
  __nv_bfloat16* a_s = w_s + KN * PS;                           // [STAGES][BM][PS]
  __nv_bfloat16* o_s = a_s + STAGES * BM * PS;                  // [BM][PS]: results
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (M + BM - 1) / BM;
  const int step = gridDim.x;

  // group 0: the first tile and w; groups 1 .. STAGES - 2: the next tiles.
  // Every block reads all of w from L2: each starts at another row, so the
  // blocks do not all ask the same L2 lines at once.
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    const int t = blockIdx.x + j * step;
    if (t < tiles) stage_rows(x, M, (long long)t * BM, a_s + j * BM * PS);
    if (j == 0)
      for (int idx = threadIdx.x; idx < KN * VPR; idx += THREADS) {
        const int v = idx % VPR, k = (idx / VPR + blockIdx.x * 8) % KN;
        cp_async16(w_s + k * PS + v * 8, w + k * KN + v * 8, true);
      }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();

  const int wm = warp >> 2, wn = warp & 3;  // 16 rows x 32 columns a warp
  uint32_t bf[8][2][4];                     // w's B fragments for the warp's columns
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4_trans(bf[ks][np], w_s + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PS +
                                        wn * 32 + np * 16 + (lane >> 4) * 8);

  for (int j = 0;; ++j) {
    const int t = blockIdx.x + j * step;
    if (t >= tiles) break;
    const int tp = t + (STAGES - 1) * step;   // prefetch into the slot read at j - 1
    if (tp < tiles) stage_rows(x, M, (long long)tp * BM, a_s + ((j + STAGES - 1) % STAGES) * BM * PS);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();              // tile t landed
    __syncthreads();

    const __nv_bfloat16* a_lane =
        a_s + (j % STAGES) * BM * PS + (wm * 16 + (lane & 15)) * PS + (lane >> 4) * 8;
    float acc[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ni][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, a_lane + ks * 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16_16816(acc[ni], a, bf[ks][ni >> 1][2 * (ni & 1)], bf[ks][ni >> 1][2 * (ni & 1) + 1]);
    }
    // results through shared memory, then out as coalesced 16-byte rows
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + (lane >> 2) + half * 8;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<__nv_bfloat162*>(o_s + r * PS + wn * 32 + ni * 8 + (lane & 3) * 2) =
            __floats2bfloat162_rn(acc[ni][2 * half], acc[ni][2 * half + 1]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * VPR; idx += THREADS) {
      const int v = idx % VPR, r = idx / VPR;
      const long long row = (long long)t * BM + r;
      if (row < M)
        *reinterpret_cast<uint4*>(y + row * KN + v * 8) =
            *reinterpret_cast<const uint4*>(o_s + r * PS + v * 8);
    }
    __syncthreads();   // every warp is done with this slot and o_s before they are refilled
  }
  cp_async_wait<0>();
}

}  // namespace

// x (M, 128), w (128, 128), y (M, 128), all bf16, contiguous and 16-byte
// aligned; blocks: the persistent grid (the caller passes min(tiles of 32
// rows, SM count)). Returns the launch's cudaError_t (0 = ok).
extern "C" int probe_matmul(const void* x, const void* w, void* y, int M, int blocks,
                            void* stream) {
  if (M <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(__nv_bfloat16) * (KN + (STAGES + 1) * BM) * PS);
  cudaError_t e = cudaFuncSetAttribute(probe_matmul_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  probe_matmul_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), M);
  return (int)cudaGetLastError();
}
