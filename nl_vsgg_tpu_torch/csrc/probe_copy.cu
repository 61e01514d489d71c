// y = 2 x, float32 or bfloat16, for Hopper (sm_90a): the copy kernel of the
// launch-overhead probe.
//
// Replaces the three copy kernels of tools/probe_pallas_overhead.py
// (tiny-copy, call :67; slab-copy, :75; slab-copy-g8, :84), which time what
// one pallas_call costs beyond its work.
//
// Units. The probe splits its bytes into units of work: one for tiny-copy
// and slab-copy, eight for slab-copy-g8 (one image each, the JAX probe's 8
// grid steps). A Pallas grid step has a whole TensorCore to itself; a
// Hopper block is 1/132 of the card. So a unit is not a block here: unit u
// owns the 16-byte vectors [u per, (u + 1) per) with per = ceil(nvec /
// units), and is spread over blocks_per_unit blocks (gridDim.x; the units
// are gridDim.y), which the caller sizes so that the units together fill
// the card (ops/probe_copy.copy_plan). What the probe still shows is what
// splitting the same bytes into 8 independent units costs on Hopper.
//
// Bound. Pure data movement: each element read once and written once, no
// arithmetic worth counting. The probe's shapes are 128 KiB (tiny, launch
// cost dominates) and 5.24 MB of bf16 (slab), 1.6 us at 3.35 TB/s.
//
// Design. Each thread issues up to DEPTH independent 16-byte loads before
// its stores (one where the grid has a thread for every vector of a unit):
// with T = blocks_per_unit x THREADS threads on a unit, thread g takes
// vectors v0 + g + j T (j < DEPTH), then strides by DEPTH T, so
// neighbouring threads read neighbouring addresses and a block keeps up to
// 8 KB in flight. The plan gives a small unit at least a block an SM (one
// vector a thread) and a large one CHUNK = DEPTH x THREADS vectors a
// block. The host passes `per`, so no thread divides 64-bit integers before
// its first load. The elements past the last whole vector go to the first
// threads of the last unit's first block. With BULK a block instead streams
// the chunks v0 + (blockIdx.x + k blocks_per_unit) CHUNK through a 2-slot
// shared-memory ring of 1-D bulk async copies
// (cp.async.bulk, completion on an mbarrier: Hopper's TMA without a tensor
// map) and each thread doubles and stores from shared memory; the two are
// compared on the card by tools/kernel_variants. Doubling is exact in both
// types, so the plain version `x * 2` agrees bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int DEPTH = 2;                  // 16-byte loads in flight a thread
constexpr int CHUNK = THREADS * DEPTH;    // vectors a block moves a pass
constexpr bool BULK = false;              // bulk async copies in place of loads
template <typename T> constexpr int E_OF = 16 / sizeof(T);   // elements a vector

__device__ __forceinline__ uint4 twice(uint4 v, float) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x *= 2.0f; f.y *= 2.0f; f.z *= 2.0f; f.w *= 2.0f;
  return *reinterpret_cast<uint4*>(&f);
}

__device__ __forceinline__ uint4 twice(uint4 v, __nv_bfloat16) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(2.0f * f.x, 2.0f * f.y);
  }
  return v;
}

__device__ __forceinline__ float twice1(float v) { return 2.0f * v; }
__device__ __forceinline__ __nv_bfloat16 twice1(__nv_bfloat16 v) {
  return __float2bfloat16(2.0f * __bfloat162float(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: the slot's barrier expects `bytes`, then the bulk copy of
// those bytes from device memory completes them
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// wait for the barrier's phase `parity` to complete; a copy that never
// lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1u << 22)) __trap();
  }
}

template <typename T>
__device__ void bulk_body(const uint4* __restrict__ xv, uint4* __restrict__ yv, long long v0,
                          long long v1) {
  __shared__ __align__(128) uint4 buf[2][CHUNK];
  __shared__ __align__(8) uint64_t bar[2];
  const long long stride = (long long)gridDim.x * CHUNK;
  const long long first = v0 + (long long)blockIdx.x * CHUNK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long start, int s) {
    if (start < v1)
      bulk_load(buf[s], xv + start, (uint32_t)(min((long long)CHUNK, v1 - start) * 16), &bar[s]);
  };
  if (threadIdx.x == 0) issue(first, 0);
  int k = 0;
  for (long long start = first; start < v1; start += stride, ++k) {
    const int s = k & 1;
    if (threadIdx.x == 0) issue(start + stride, s ^ 1);  // slot s ^ 1 was freed by the barrier
    bar_wait(&bar[s], (k >> 1) & 1);
    const int cnt = (int)min((long long)CHUNK, v1 - start);
    for (int j = threadIdx.x; j < cnt; j += THREADS) yv[start + j] = twice(buf[s][j], T());
    __syncthreads();
  }
}

// Idx: int where every vector index fits 31 bits (the probe's shapes), else
// long long; D: the loads a thread keeps in flight (1 where the grid has a
// thread for every vector of a unit)
template <typename T, typename Idx, int D>
__global__ void __launch_bounds__(THREADS)
probe_copy_kernel(const T* __restrict__ x, T* __restrict__ y, Idx n, Idx nvec, Idx per,
                  int units) {
  constexpr int E = 16 / sizeof(T);
  // a unit past the last vector has v1 <= v0 and no pass
  const Idx v0 = per * (Idx)blockIdx.y, v1 = min(nvec, v0 + per);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  if constexpr (BULK) {
    bulk_body<T>(xv, yv, v0, v1);
  } else {
    const Idx t_all = (Idx)gridDim.x * THREADS;
    for (Idx i0 = v0 + (Idx)blockIdx.x * THREADS + threadIdx.x; i0 < v1; i0 += D * t_all) {
      uint4 r[D];
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (i0 + j * t_all < v1) r[j] = __ldg(xv + i0 + j * t_all);
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (i0 + j * t_all < v1) yv[i0 + j * t_all] = twice(r[j], T());
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == units - 1 && threadIdx.x < E) {
    const Idx e = nvec * E + threadIdx.x;
    if (e < n) y[e] = twice1(x[e]);
  }
}

template <typename T, typename Idx, int D>
void launch_as(const void* x, void* y, long long n, long long per, int units,
               int blocks_per_unit, cudaStream_t s) {
  probe_copy_kernel<T, Idx, D><<<dim3(blocks_per_unit, units), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), (Idx)n, (Idx)(n / E_OF<T>), (Idx)per, units);
}

template <typename T>
int launch(const void* x, void* y, long long n, long long per, int units, int blocks_per_unit,
           cudaStream_t s) {
  const bool one = (long long)blocks_per_unit * THREADS >= per;
  // (DEPTH + 1) x the grid's threads past the last index must still fit
  if (n + (long long)(DEPTH + 1) * blocks_per_unit * THREADS * E_OF<T> < (1LL << 31)) {
    if (one) launch_as<T, int, 1>(x, y, n, per, units, blocks_per_unit, s);
    else launch_as<T, int, DEPTH>(x, y, n, per, units, blocks_per_unit, s);
  } else {
    if (one) launch_as<T, long long, 1>(x, y, n, per, units, blocks_per_unit, s);
    else launch_as<T, long long, DEPTH>(x, y, n, per, units, blocks_per_unit, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x and y 16-byte aligned, n elements;
// units >= 1 (at most 65535) of `per` = ceil(n / (16 / element size) / units)
// vectors; blocks_per_unit >= 1. Returns the launch's cudaError_t (0 = ok).
extern "C" int probe_copy(int dtype, const void* x, void* y, long long n, long long per,
                          int units, int blocks_per_unit, void* stream) {
  const long long nvec = dtype == 0 ? n / 4 : n / 8;
  if (n <= 0 || units <= 0 || units > 65535 || blocks_per_unit <= 0 ||
      per != (nvec + units - 1) / units)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, per, units, blocks_per_unit, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, per, units, blocks_per_unit, s);
  return (int)cudaErrorInvalidValue;
}
