// Asynchronous 16-byte copies from device memory into shared memory
// (cp.async, sm_80 and later), shared by csrc/grouped_conv.cu and
// csrc/probe_matmul.cu.
//
// A thread starts copies, closes them into a group with cp_async_commit(),
// and cp_async_wait<n>() returns once at most n of its groups are still in
// flight; a __syncthreads() after the wait makes every thread's copies
// visible to the block. A copy with valid = false reads nothing and writes
// 16 zero bytes (the src-size operand is 0), so halos and ragged edges are
// zero-filled without a branch around the copy; its source pointer must
// still be a device address (callers pass the tensor's base).

#pragma once

#include <cstdint>

#include "mma_bf16.cuh"

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(smem)), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
