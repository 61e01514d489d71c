// The packed grouped 3x3 conv of the ablation probe and its ablation
// variants, as an implicit GEMM on the tensor cores, for Hopper (sm_90a).
//
// Replaces tools/probe_pallas_ablate.py: `make` (call :87, body :47-84),
// the NHWC kernel, and `make_bt` (call :135, body :111-130), the same
// kernel over a block-major layout. Both time variants of the stage-4
// grouped conv of the VinVL trunk with its groups packed block-diagonally
// into 128-channel super-groups, so that every tap is one dense 128 x 128
// product, to find what bounds such a kernel.
//
// Geometry. xp is the input with its 2 halo rows: (N, H + 2, W, C) in NHWC
// or (C/128, N, H + 2, W, 128) block-major; w the packed weights
// (3, 3, 128, C) HWIO or (3, 3, C/128, 128, 128); out (N, H, W, C) or
// (C/128, N, H, W, 128). With blk(o) = o / 128, the variants are
//   FULL      out[n,h,w,o] = sum_{dh,dw,i} xp[n, h+dh, w+dw-1, blk(o)*128+i] w[dh,dw,i,o],
//             xp zero outside [0, W) in w (VALID in H, SAME in W);
//   MM_ONLY   the nine tap products with no shift:
//             out[n,h,w,o] = sum_{t,i} xp[n, h, w, blk(o)*128+i] w[t/3, t%3, i, o];
//   MM1_ONLY  the same with the one product of tap 0: w[0, 0];
//   ADD_ONLY  no products: nine adds of 0.001, each where its tap lies in
//             bounds in W (0.009 inside, 0.006 at the W edges);
//   CENTER    the one product of the centre tap: xp[n, h+1, w, .] @ w[1, 1]
//             (the probe's block-major `bt-mm1`, taps[:1] = (1, 0)).
// Every variant stages the same tiles (input and each tap's weights that
// it uses); they differ only in what is done with them, so FULL minus
// ADD_ONLY is the products' share and FULL minus MM_ONLY the shifts'.
//
// Bound. FULL and MM_ONLY do 18 * 128 operations a stored output element:
// at (8, 38, 64, 1024) 45.9 GFLOP, 46 us at 989 TFLOP/s, against 84 MB of
// x, w and out (25 us at 3.35 TB/s): bound by the tensor cores. One
// product is 5.1 GFLOP, so MM1_ONLY and CENTER are bound by bytes (25 us).
//
// Design. The TPU kernel ran each tap as a full-height matmul into VMEM and
// then added shifted slices of the result: a way around VMEM, and what
// bound it. Here every tap is a product over a shifted view of input rows
// staged in shared memory, on the tensor cores (bf16 in, fp32 sums; the
// shift is only an offset of each lane's ldmatrix row address). Two routes,
// chosen by the caller before the launch (ops/grouped_conv_ablate.kernel_plan)
// and checked again here:
//
// "ring" (bf16; TH * W a multiple of 64, at most 256, W a multiple of 8). A
// persistent block owns one image and one super-group and walks a part of
// its output rows (gridDim.x parts, the caller sizing them to fill the SMs)
// in tiles of TH rows x W columns x 128 channels.
//  - Products on wgmma (m64n128k16): a warpgroup takes 64 output pixels x
//    all 128 channels; A, the shifted input pixels, comes from registers
//    (ldmatrix: a one-pixel shift breaks a shared-memory descriptor's 8-row
//    core matrices), B, the tap's weights, from shared memory through a
//    descriptor (MN-major, 128-byte swizzle). The k loop runs in two halves,
//    the second half's A loads overlapping the first half's products.
//  - Copies by the Tensor Memory Accelerator: thread 0 issues 2-D tensor
//    copies (64 channels x 128 rows of weights, 64 channels x W pixels of
//    input) that land 128-byte swizzled, with completion on mbarriers; no
//    thread spends instructions on addresses.
//  - Input rows are staged once a block: a ring of 2 TH + 2 row slots holds
//    the tile's TH + 2 input rows and the next tile's TH new ones, copied
//    while the current tile's taps run and waited for at the next tile's
//    first step. A row is W pixels with no halo: a lane whose shifted column
//    falls outside [0, W) points its ldmatrix row at a zero row.
//  - Tap weights (128 x 128, 32 KB) stream through a ring of 2 or 3 slots
//    (3 where shared memory allows), a full and an empty mbarrier a slot: the
//    warps do not meet at a block barrier between taps, and the copies run
//    stages - 1 taps ahead of the products.
//  - The tile's epilogue goes through shared memory (the slots of the tile's
//    first TH input rows, free by then) and leaves in coalesced 16-byte
//    stores.
// At TH = 4, W = 64: 512 threads, (2 x 32 KB) + (10 x 16 KB) + 256 B + the
// barriers = 229,680 bytes of shared memory, one block an SM. What bounds it
// (PERF.md, from tools/kernel_variants): without the products the steps
// alone take about half the time; with them the two add rather than overlap.
//
// "tile" (the first design; float32, and bf16 tiles the ring does not take:
// TH * W a multiple of 32 and at most 256). A block owns TH output rows x W
// columns of one image and one super-group: it stages the TH + 2 input rows,
// with a zero column on each side, and then, tap by tap, the tap's 128 x 128
// weights into one buffer with plain 16-byte loads; the taps run on
// mma.sync. Warps take 32 pixels x 64 channels each; staged rows are padded
// to 136 bf16. The float32 instantiation, which the chip check holds against
// cuDNN, runs the same tiles through scalar FMAs in the same fragment layout
// (no float32 tensor-core product is exact enough).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int CB = 128;          // channels of a super-group
constexpr int MAX_THREADS = 512;
enum Variant { FULL = 0, MM_ONLY = 1, MM1_ONLY = 2, ADD_ONLY = 3, CENTER = 4 };

struct Geo {
  int N, H, W, C, TH, nb, parts, stages;
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// staged row stride in elements: 128 channels and 16 bytes of padding
template <typename T>
struct Stride {
  static constexpr int PS = CB + 16 / (int)sizeof(T);
};

template <typename T, int V, bool BT>
__global__ void __launch_bounds__(MAX_THREADS)
ablate_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
              const Geo g) {
  constexpr int E = 16 / (int)sizeof(T);   // elements of a 16-byte vector
  constexpr int PS = Stride<T>::PS;
  constexpr int VPR = CB / E;              // vectors of 128 channels
  constexpr int TAPS = (V == MM1_ONLY || V == CENTER) ? 1 : 9;
  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);     // [CB][PS]: one tap's (in, out) weights
  T* in_s = w_s + CB * PS;                 // [TH + 2][W + 2][PS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int n = blockIdx.y, b = blockIdx.z;
  const int h0 = blockIdx.x * g.TH;
  const int WP = g.W + 2, HP = g.H + 2;

  // the input rows h0 .. h0 + TH + 1 of super-group b, zero columns at 0 and W + 1
  const int n_vec = (g.TH + 2) * WP * VPR;
  for (int idx = tid; idx < n_vec; idx += nthreads) {
    const int v = idx % VPR, pix = idx / VPR;
    const int c = pix % WP, hr = h0 + pix / WP, wc = c - 1;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (hr < HP && wc >= 0 && wc < g.W) {
      const long long off =
          BT ? ((((long long)b * g.N + n) * HP + hr) * g.W + wc) * CB
             : (((long long)n * HP + hr) * g.W + wc) * g.C + (long long)b * CB;
      val = *reinterpret_cast<const uint4*>(x + off + v * E);
    }
    *reinterpret_cast<uint4*>(in_s + pix * PS + v * E) = val;
  }

  const int wm = warp >> 1, wn = warp & 1;  // 32 pixels x 64 channels a warp
  // this lane's ldmatrix row (bf16) and its accumulator rows (scalar path
  // and epilogue), as offsets of the unshifted staged pixel
  int a_off[2], c_off[2][2], c_col[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int p = wm * 32 + mi * 16 + (lane & 15);
    a_off[mi] = ((p / g.W) * WP + p % g.W) * PS + (lane >> 4) * 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      c_off[mi][half] = ((q / g.W) * WP + q % g.W) * PS;
      c_col[mi][half] = q % g.W;
    }
  }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

  for (int t = 0; t < TAPS; ++t) {
    const int wt = V == CENTER ? 4 : t;        // the tap whose weights are used
    int dh = t / 3, dwp = t % 3;               // the view's shift (dwp: padded column)
    if (V == MM_ONLY || V == MM1_ONLY) { dh = 0; dwp = 1; }
    if (V == CENTER) { dh = 1; dwp = 1; }
    __syncthreads();  // the input is staged; the previous tap's weights are read
    for (int idx = tid; idx < CB * VPR; idx += nthreads) {
      const int v = idx % VPR, k = idx / VPR;
      const long long off = BT ? (((long long)wt * g.nb + b) * CB + k) * CB
                               : ((long long)wt * CB + k) * g.C + (long long)b * CB;
      *reinterpret_cast<uint4*>(w_s + k * PS + v * E) =
          *reinterpret_cast<const uint4*>(w + off + v * E);
    }
    __syncthreads();
    const int shift = (dh * WP + dwp) * PS;
    if constexpr (V == ADD_ONLY) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int wc = c_col[mi][half] + dwp - 1;
          const float add = (wc >= 0 && wc < g.W) ? 0.001f : 0.0f;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            acc[mi][ni][2 * half] += add;
            acc[mi][ni][2 * half + 1] += add;
          }
        }
    } else if constexpr (sizeof(T) == 2) {
      const T* b_lane =
          w_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * PS + wn * 64 + (lane >> 4) * 8;
#pragma unroll 2
      for (int k0 = 0; k0 < CB; k0 += 16)
        warp_mma_32x64(acc, in_s + a_off[0] + shift + k0, in_s + a_off[1] + shift + k0,
                       b_lane + k0 * PS);
    } else {
      // float32: the same output elements a lane owns in the mma layout
      for (int mi = 0; mi < 2; ++mi)
        for (int half = 0; half < 2; ++half) {
          const T* ap = in_s + c_off[mi][half] + shift;
          for (int ni = 0; ni < 8; ++ni) {
            const T* bp = w_s + wn * 64 + ni * 8 + (lane & 3) * 2;
            float s0 = acc[mi][ni][2 * half], s1 = acc[mi][ni][2 * half + 1];
            for (int k = 0; k < CB; ++k) {
              const float a = ap[k];
              s0 += a * bp[k * PS];
              s1 += a * bp[k * PS + 1];
            }
            acc[mi][ni][2 * half] = s0;
            acc[mi][ni][2 * half + 1] = s1;
          }
        }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      const int h = h0 + q / g.W, wc = q % g.W;
      if (h >= g.H) continue;
      const long long base = BT ? ((((long long)b * g.N + n) * g.H + h) * g.W + wc) * CB
                                : (((long long)n * g.H + h) * g.W + wc) * g.C + (long long)b * CB;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        store2(out + base + wn * 64 + ni * 8 + (lane & 3) * 2, acc[mi][ni][2 * half],
               acc[mi][ni][2 * half + 1]);
    }
}

template <typename T, int V, bool BT>
int launch(const void* x, const void* w, void* out, const Geo& g, cudaStream_t s) {
  constexpr int PS = Stride<T>::PS;
  const size_t smem = sizeof(T) * ((size_t)CB * PS + (size_t)(g.TH + 2) * (g.W + 2) * PS);
  cudaError_t e = cudaFuncSetAttribute(ablate_kernel<T, V, BT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.H + g.TH - 1) / g.TH, g.N, g.nb);
  ablate_kernel<T, V, BT><<<grid, g.TH * g.W * 2, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int variant, int block_major, const void* x, const void* w, void* out,
             const Geo& g, cudaStream_t s) {
  if (!block_major) {
    switch (variant) {
      case FULL: return launch<T, FULL, false>(x, w, out, g, s);
      case MM_ONLY: return launch<T, MM_ONLY, false>(x, w, out, g, s);
      case MM1_ONLY: return launch<T, MM1_ONLY, false>(x, w, out, g, s);
      case ADD_ONLY: return launch<T, ADD_ONLY, false>(x, w, out, g, s);
    }
  } else {
    switch (variant) {
      case FULL: return launch<T, FULL, true>(x, w, out, g, s);
      case CENTER: return launch<T, CENTER, true>(x, w, out, g, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------ the ring route
constexpr int WG_PIXELS = 64;            // output pixels a warpgroup
constexpr int RING_MAX_PIXELS = 256;     // output pixels a tile: at most 4 warpgroups
constexpr int PIXEL_BYTES = CB * 2;      // a staged pixel: 128 bf16, as two 128-byte halves
constexpr int HALF_BYTES = 64 * CB * 2;  // one 64-channel half of a tap's weights
constexpr int TAP_BYTES = 2 * HALF_BYTES;
constexpr int MAX_W_STAGES = 3;          // tap weight slots, where shared memory allows (else 2)
constexpr int SMEM_MAX = 232448;         // a block's shared memory on sm_90
constexpr bool RING_BODY = true;         // false: ring launches run the tile body
constexpr int W_LOADS = 2;               // 2: every step's tap weights; 1: each slot's once; 0: none
constexpr bool X_LOADS = true;           // the input rows' copies

__host__ __device__ inline size_t ring_smem(int TH, int W, int stages) {
  return (size_t)stages * TAP_BYTES + (size_t)(2 * TH + 2) * W * PIXEL_BYTES + PIXEL_BYTES +
         (size_t)(2 * stages + 2) * sizeof(uint64_t);
}

// the 16-byte chunk v (0..7) of 128-byte row r: the 128-byte swizzle that
// the tensor copies write (address bits 4-6 XOR bits 7-9)
__device__ __forceinline__ int swz(int r, int v) { return ((v ^ (r & 7)) << 4); }

// ldmatrix from a shared-space address (mma_bf16.cuh's take generic pointers)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma's B descriptor for one k16 step of a tap slot: MN-major (the
// output channels contiguous), 128-byte swizzle; two 64-channel atoms
// HALF_BYTES apart (leading byte offset), 8-row groups of k 1024 bytes
// apart (stride byte offset); the slot 1024-byte aligned
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(HALF_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving accumulator accesses across the async products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32) += a (64 x 16, bf16, this warp's 16 rows in registers)
// @ b (16 x 128, bf16, shared memory)
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the barrier's phase `parity` to complete; a phase that never
// completes traps (a launch error) instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// a 64-channel x `rows` box of a 2-D tensor map (TMA), 128-byte swizzled,
// into shared memory; completes `bytes` on the barrier
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

// The ring kernel: G = TH W / 64 warpgroups, 64 output pixels x 128
// channels each, on wgmma. Step s of the block is tap s % TAPS of tile
// s / TAPS; its weights go to slot s % stages. Thread 0 issues the tensor
// copies of step s + stages - 1 when every warp has released step s - 1
// (empty[slot]); full[slot] completes when the tap's weights have landed.
// The next tile's new row j is copied with step tile TAPS + stages - 1 + j
// (at most the next tile's first): by then the step that last used the slot
// was the last of the tile before, so every row slot the copy overwrites is
// free. A tile's rows complete rows_full[tile % 2], which the warps wait for
// at the tile's first step only. A row slot is two 128-byte halves of W
// pixels ([2][W][128 B]).
template <int V, bool BT>
__global__ void __launch_bounds__(2 * RING_MAX_PIXELS, 1)
ring_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            __nv_bfloat16* __restrict__ out, const Geo g) {
  constexpr int TAPS = (V == MM1_ONLY || V == CENTER) ? 1 : 9;
  extern __shared__ __align__(1024) unsigned char ring_smem_buf[];
  const int stages = g.stages;                         // tap slots: 2 or 3
  unsigned char* w_s = ring_smem_buf;                  // [stages][2 halves][128 k][128 B]
  unsigned char* rows_s = w_s + stages * TAP_BYTES;    // [R][2 halves][W][128 B]
  const int R = 2 * g.TH + 2;                          // input row slots
  const int half_bytes = g.W * 128, row_bytes = g.W * PIXEL_BYTES;
  unsigned char* zero_s = rows_s + R * row_bytes;      // the W halo: 2 x 128 zero bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(zero_s + PIXEL_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* rows_full = empty + stages;                // a tile's rows, by tile parity

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.y, b = blockIdx.z;
  const int HP = g.H + 2;
  const int per_part = (g.H + g.parts - 1) / g.parts;
  const int r0 = blockIdx.x * per_part, r1 = min(g.H, r0 + per_part);
  if (r0 >= r1) return;
  const int tiles = (r1 - r0 + g.TH - 1) / g.TH;
  const int steps = tiles * TAPS;

  if (tid < PIXEL_BYTES / 16) reinterpret_cast<uint4*>(zero_s)[tid] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(&full[i], 1);                           // thread 0's arrival and the bytes
      bar_init(&empty[i], blockDim.x / 32);            // every warp
    }
    bar_init(&rows_full[0], 1);
    bar_init(&rows_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: the tensor copies of step s into slot s % stages
  auto issue = [&](int s) {
    const int slot = s % stages, tile = s / TAPS;
    uint64_t* bar = &full[slot];
    if (W_LOADS == 2 || (W_LOADS == 1 && s < stages)) {
      const int wt = V == CENTER ? 4 : s % TAPS;
      const int row = BT ? (wt * g.nb + b) * CB : wt * CB;
      for (int h = 0; h < 2; ++h) {
        bar_expect(bar, HALF_BYTES);
        tma_load(w_s + slot * TAP_BYTES + h * HALF_BYTES, &map_w, (BT ? 0 : b * CB) + h * 64,
                 row, bar);
      }
    }
    bar_arrive(bar);
    // input row hr of tile tn into slot hr % R
    auto row_copy = [&](int tn, int hr) {
      uint64_t* rbar = &rows_full[tn & 1];
      if (X_LOADS && hr < HP) {
        const int pix = (BT ? (b * g.N + n) * HP + hr : n * HP + hr) * g.W;
        for (int h = 0; h < 2; ++h) {
          bar_expect(rbar, half_bytes);
          tma_load(rows_s + (hr % R) * row_bytes + h * half_bytes, &map_x,
                   (BT ? 0 : b * CB) + h * 64, pix, rbar);
        }
      }
    };
    if (s == 0) {
      for (int r = 0; r < g.TH + 2; ++r) row_copy(0, r0 + r);
      bar_arrive(&rows_full[0]);
    }
    for (int tn = max(1, tile); tn <= tile + 1 && tn < tiles; ++tn)
      for (int j = 0; j < g.TH; ++j)
        if (min((tn - 1) * TAPS + stages - 1 + j, tn * TAPS) == s) {
          row_copy(tn, r0 + tn * g.TH + 2 + j);
          if (j == g.TH - 1) bar_arrive(&rows_full[tn & 1]);   // the tile's last new row
        }
  };
  if (tid == 0)
    for (int s = 0; s < stages - 1 && s < steps; ++s) issue(s);

  const int m0 = (warp >> 2) * WG_PIXELS + (warp & 3) * 16;   // this warp's 16 pixels
  const int a_tr = (m0 + (lane & 15)) / g.W, a_col = (m0 + (lane & 15)) % g.W;
  const int a_hi = lane >> 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int s = 0; s < steps; ++s) {
    const int slot = s % stages, tile = s / TAPS, t = s % TAPS;
    const int h0 = r0 + tile * g.TH;
    if (tid == 0 && s + stages - 1 < steps) {          // refill the slot of step s - 1
      if (s > 0) bar_wait(&empty[(s - 1) % stages], ((s - 1) / stages) & 1);
      issue(s + stages - 1);
    }
    if (t == 0) bar_wait(&rows_full[tile & 1], (tile >> 1) & 1);
    bar_wait(&full[slot], (s / stages) & 1);

    int dh = t / 3, dwp = t % 3;              // the view's shift (dwp: column + 1)
    if (V == MM_ONLY || V == MM1_ONLY) { dh = 0; dwp = 1; }
    if (V == CENTER) { dh = 1; dwp = 1; }
    if constexpr (V == ADD_ONLY) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wc = (m0 + (lane >> 2) + half * 8) % g.W + dwp - 1;
        const float add = (wc >= 0 && wc < g.W) ? 0.001f : 0.0f;
#pragma unroll
        for (int ni = 0; ni < 16; ++ni) {
          acc[ni * 4 + 2 * half] += add;
          acc[ni * 4 + 2 * half + 1] += add;
        }
      }
    } else {
      const int c = a_col + dwp - 1;
      const bool in = c >= 0 && c < g.W;
      // this lane's A pixel (the zero row outside [0, W)): its first half,
      // the second half_stride further
      const uint32_t pix = smem_u32(in ? rows_s + ((h0 + a_tr + dh) % R) * row_bytes + c * 128
                                       : zero_s);
      const int half_stride = in ? half_bytes : 128, key = in ? c : 0;
      const uint32_t wslot = smem_u32(w_s + slot * TAP_BYTES);
      // two halves of k: the second half's A loads overlap the first's products
      uint32_t a[CB / 16][4];
      fence_acc(acc);
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
        for (int ks = kh * 4; ks < kh * 4 + 4; ++ks)
          ldsm_x4(a[ks], pix + kh * half_stride + swz(key, (2 * ks + a_hi) & 7));
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = kh * 4; ks < kh * 4 + 4; ++ks)
          wgmma_64x128x16(acc, a[ks], b_desc(wslot + ks * 2048));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
    }

    if (t == TAPS - 1) {
      // The tile's epilogue, through shared memory: the slots of input rows
      // h0 .. h0 + TH - 1 are free until thread 0 refills them (after this
      // step's empty), and one holds an output row. Written from the
      // fragments, then stored 16 coalesced bytes a thread.
      __syncthreads();                        // every warp is done with the rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + (lane >> 2) + half * 8;
        const int col = q % g.W;
        unsigned char* px = rows_s + ((h0 + q / g.W) % R) * row_bytes + col * 128 +
                            (lane & 3) * 4;
#pragma unroll
        for (int ni = 0; ni < 16; ++ni)
          *reinterpret_cast<__nv_bfloat162*>(px + (ni >> 3) * half_bytes + swz(col, ni & 7)) =
              __floats2bfloat162_rn(acc[ni * 4 + 2 * half], acc[ni * 4 + 2 * half + 1]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      __syncthreads();
      for (int idx = tid; idx < g.TH * g.W * 16; idx += blockDim.x) {
        const int q = idx >> 4, v = idx & 15, col = q % g.W, h = h0 + q / g.W;
        if (h >= r1) break;                   // rows past the part: the tile's last
        const long long base =
            BT ? ((((long long)b * g.N + n) * g.H + h) * g.W + col) * CB
               : (((long long)n * g.H + h) * g.W + col) * g.C + (long long)b * CB;
        *reinterpret_cast<uint4*>(out + base + v * 8) = *reinterpret_cast<const uint4*>(
            rows_s + ((h0 + q / g.W) % R) * row_bytes + (v >> 3) * half_bytes + col * 128 +
            swz(col, v & 7));
      }
      // these generic accesses come before the tensor copies that refill the slots
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);  // this warp is done with the step
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (rows, inner) row-major tensor, read in boxes of 64 x box_rows,
// 128-byte swizzled
bool tensor_map(CUtensorMap* map, const void* base, unsigned long long inner,
                unsigned long long rows, unsigned box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, rows}, strides[1] = {inner * 2};
  const cuuint32_t box[2] = {64, box_rows}, elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int V, bool BT>
int launch_ring(const void* x, const void* w, void* out, Geo g, cudaStream_t s) {
  const int pixels = g.TH * g.W;
  // a one-tap variant's next rows are copied at its next tile's own step,
  // which is only safe two slots deep
  constexpr bool one_tap = V == MM1_ONLY || V == CENTER;
  g.stages = !one_tap && ring_smem(g.TH, g.W, MAX_W_STAGES) <= SMEM_MAX ? MAX_W_STAGES : 2;
  const size_t smem = ring_smem(g.TH, g.W, g.stages);
  if (pixels % WG_PIXELS || pixels > RING_MAX_PIXELS || g.W % 8 || g.W > 256 ||
      smem > SMEM_MAX || g.parts < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  const unsigned long long HP = g.H + 2;
  const bool ok = BT ? tensor_map(&map_x, x, CB, (unsigned long long)g.nb * g.N * HP * g.W, g.W) &&
                           tensor_map(&map_w, w, CB, 9ull * g.nb * CB, CB)
                     : tensor_map(&map_x, x, g.C, (unsigned long long)g.N * HP * g.W, g.W) &&
                           tensor_map(&map_w, w, g.C, 9ull * CB, CB);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ring_kernel<V, BT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // a warpgroup a 64 pixels
  ring_kernel<V, BT><<<dim3(g.parts, g.N, g.nb), 2 * pixels, smem, s>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

int dispatch_ring(int variant, int block_major, const void* x, const void* w, void* out,
                  const Geo& g, cudaStream_t s) {
  if (!RING_BODY) return dispatch<__nv_bfloat16>(variant, block_major, x, w, out, g, s);
  if (!block_major) {
    switch (variant) {
      case FULL: return launch_ring<FULL, false>(x, w, out, g, s);
      case MM_ONLY: return launch_ring<MM_ONLY, false>(x, w, out, g, s);
      case MM1_ONLY: return launch_ring<MM1_ONLY, false>(x, w, out, g, s);
      case ADD_ONLY: return launch_ring<ADD_ONLY, false>(x, w, out, g, s);
    }
  } else {
    switch (variant) {
      case FULL: return launch_ring<FULL, true>(x, w, out, g, s);
      case CENTER: return launch_ring<CENTER, true>(x, w, out, g, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 FULL, 1 MM_ONLY, 2 MM1_ONLY,
// 3 ADD_ONLY (NHWC, block_major = 0); 0 FULL, 4 CENTER (block_major = 1).
// route: 0 "tile" (TH * W a multiple of 32 and at most 256, any dtype; parts
// unused), 1 "ring" (bf16; TH * W a multiple of 64 and at most 256; `parts`
// blocks an image and super-group, each a run of ceil(H / parts) output
// rows). H is the output's height (x has H + 2 rows); C % 128 == 0. Tensors
// contiguous and 16-byte aligned. Returns the launch's cudaError_t (0 = ok).
extern "C" int grouped_conv_ablate(int dtype, int variant, int block_major, int route,
                                   const void* x, const void* w, void* out, int N, int H,
                                   int W, int C, int TH, int parts, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % CB || TH <= 0 || N > 65535 ||
      C / CB > 65535 || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.N = N; g.H = H; g.W = W; g.C = C; g.TH = TH; g.nb = C / CB; g.parts = parts; g.stages = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || parts < 1 || parts > 65535) return (int)cudaErrorInvalidValue;
    return dispatch_ring(variant, block_major, x, w, out, g, s);
  }
  if ((TH * W) % 32 || TH * W * 2 > MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(variant, block_major, x, w, out, g, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(variant, block_major, x, w, out, g, s);
  return (int)cudaErrorInvalidValue;
}
