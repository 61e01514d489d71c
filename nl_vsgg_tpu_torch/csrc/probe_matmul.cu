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
// Design. A block takes 128 rows of x and the whole of w into shared
// memory (rows padded to 136 bf16, 272 bytes, so the eight rows that one
// ldmatrix phase reads fall in different banks), then 8 warps, 4 x 2, each
// compute a 32 x 64 tile on the tensor cores: per k-slice of 16, two
// ldmatrix.x4 for A, four ldmatrix.x4.trans for B (w arrives K x N
// row-major), sixteen mma.sync.m16n8k16. The epilogue rounds the fp32 sums
// to bf16 pairs. A simple first version: no cp.async, TMA or wgmma, and no
// overlap of one block's loads with another's products beyond what the
// SM's other resident blocks give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;      // rows of x a block
constexpr int KN = 128;      // the depth and width of w
constexpr int PS = KN + 8;   // shared-memory row stride in bf16
constexpr int THREADS = 256;
constexpr int VPR = KN * 2 / 16;  // 16-byte vectors a row

__global__ void __launch_bounds__(THREADS)
probe_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [KN][PS]
  __nv_bfloat16* a_s = w_s + KN * PS;                           // [BM][PS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long m0 = (long long)blockIdx.x * BM;

  for (int idx = tid; idx < KN * VPR; idx += THREADS) {
    const int v = idx % VPR, k = idx / VPR;
    *reinterpret_cast<uint4*>(w_s + k * PS + v * 8) =
        *reinterpret_cast<const uint4*>(w + k * KN + v * 8);
  }
  for (int idx = tid; idx < BM * VPR; idx += THREADS) {
    const int v = idx % VPR, r = idx / VPR;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) val = *reinterpret_cast<const uint4*>(x + (m0 + r) * KN + v * 8);
    *reinterpret_cast<uint4*>(a_s + r * PS + v * 8) = val;
  }
  __syncthreads();

  const int wm = warp >> 1, wn = warp & 1;
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;
  const __nv_bfloat16* a0 = a_s + (wm * 32 + (lane & 15)) * PS + (lane >> 4) * 8;
  const __nv_bfloat16* a1 = a0 + 16 * PS;
  const __nv_bfloat16* b = w_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * PS + wn * 64 +
                           (lane >> 4) * 8;
#pragma unroll
  for (int k0 = 0; k0 < KN; k0 += 16) warp_mma_32x64(acc, a0 + k0, a1 + k0, b + k0 * PS);

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(y + row * KN + col) =
            __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
}

}  // namespace

// x (M, 128), w (128, 128), y (M, 128), all bf16, contiguous and 16-byte
// aligned. Returns the launch's cudaError_t (0 = ok).
extern "C" int probe_matmul(const void* x, const void* w, void* y, int M, void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(__nv_bfloat16) * (KN + BM) * PS);
  cudaError_t e = cudaFuncSetAttribute(probe_matmul_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (M + BM - 1) / BM;
  probe_matmul_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), M);
  return (int)cudaGetLastError();
}
