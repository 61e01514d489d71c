// y = 2 x, float32 or bfloat16, for Hopper (sm_90a): the copy kernel of the
// launch-overhead probe.
//
// Replaces the three copy kernels of tools/probe_pallas_overhead.py
// (tiny-copy, call :67; slab-copy, :75; slab-copy-g8, :84), which time what
// one pallas_call costs beyond its work. The TPU's grid steps have no
// meaning on Hopper, so the block count is an argument and the probe maps
// its rows onto it: tiny-copy one block, slab-copy a grid that fills every
// SM, slab-copy-g8 eight blocks (one per image), which shows what a grid
// too small for the card costs.
//
// Bound. Pure data movement: each element read once and written once, no
// arithmetic worth counting. The probe's shapes are 128 KiB (tiny, launch
// cost dominates) and 5.24 MB of bf16 (slab), 1.6 us at 3.35 TB/s.
//
// Design. A grid-stride loop over 16-byte vectors (4 floats or 8 bf16 a
// thread a step, neighbouring threads on neighbouring addresses); the
// elements past the last whole vector go to the first threads of the grid.
// Doubling is exact in both types, so the plain version `x * 2` agrees bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
probe_copy_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  constexpr int E = 16 / sizeof(T);
  const long long nvec = n / E;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long i = t0; i < nvec; i += stride) yv[i] = twice(xv[i], T());
  const long long tail = nvec * E + t0;
  if (tail < n && t0 < E) y[tail] = twice1(x[tail]);
}

template <typename T>
int launch(const void* x, void* y, long long n, int blocks, cudaStream_t s) {
  probe_copy_kernel<T><<<blocks, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                   n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x and y 16-byte aligned, n elements;
// blocks >= 1. Returns the launch's cudaError_t (0 = ok).
extern "C" int probe_copy(int dtype, const void* x, void* y, long long n, int blocks,
                          void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, n, blocks, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, n, blocks, s);
  return (int)cudaErrorInvalidValue;
}
