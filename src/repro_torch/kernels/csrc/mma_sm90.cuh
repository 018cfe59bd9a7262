// PTX helpers shared by the tensor-core flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) for Hopper (sm_90a): asynchronous copies,
// ldmatrix, mma.sync m16n8k16 bf16 with fp32 accumulators, MUFU.EX2, and
// the fragment indices of the operands, plus the row loader that stages a
// bf16 tile in shared memory for ldmatrix.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16-byte asynchronous copy; bytes past src_bytes (0 or 16) are zeroed.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a.b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, one MUFU.EX2 (a few ulp; -1e30 * log2(e) gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The m16n8 accumulators of n tiles 2t and 2t+1, rounded to bf16, as the
// m16k16 A fragment of k-step t.
template <int NT>
__device__ __forceinline__ void to_a_frags(const float (&c)[NT][4],
                                           uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int t = 0; t < NT / 2; ++t) {
    a[t][0] = pack_bf16(c[2 * t][0], c[2 * t][1]);
    a[t][1] = pack_bf16(c[2 * t][2], c[2 * t][3]);
    a[t][2] = pack_bf16(c[2 * t + 1][0], c[2 * t + 1][1]);
    a[t][3] = pack_bf16(c[2 * t + 1][2], c[2 * t + 1][3]);
  }
}

// ldmatrix row / column of this lane within a 16x16 tile: for an A operand
// stored [m][k] and for a B operand stored [k][n] (read with .trans) ...
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
// ... and for a B operand stored [n][k] (two n8 tiles).
__device__ __forceinline__ int b_row(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_col(int lane) {
  return ((lane >> 3) & 1) * 8;
}

// Rows [r0, r0 + ROWS) of a (.., D) bf16 operand with row stride rs into a
// ROWS x (KD + 8) shared tile, columns [0, dpad), zeros past n rows or D
// columns, by a block of THREADS threads.  vec: each thread copies one
// 16-byte column chunk of every (THREADS / (KD / 8))-th row with cp.async,
// its pointers computed once (the copies land at the next wait); else
// plain 2-byte loads.  FULLD: D == KD, no column to mask.
template <int THREADS, int ROWS, int KD, bool FULLD>
__device__ __forceinline__ void load_tile_rows(bf16* dst, const bf16* src,
                                               int64_t rs, int r0, int n,
                                               int D, int dpad, bool vec) {
  constexpr int LDS = KD + 8, CH = KD / 8, RSTEP = THREADS / CH;
  static_assert(ROWS % RSTEP == 0, "rows per pass must divide the tile");
  if (vec) {
    const int r = threadIdx.x / CH, c = (threadIdx.x % CH) * 8;
    if (!FULLD && c >= dpad) return;
    const bool col_ok = FULLD || c < D;
    const bf16* s = src + (r0 + r) * rs + c;
    const uint32_t d = smem_addr(dst + r * LDS + c);
#pragma unroll
    for (int m = 0; m < ROWS / RSTEP; ++m) {
      const bool ok = col_ok && r0 + r + m * RSTEP < n;
      cp_async16(d + m * RSTEP * LDS * 2, ok ? s + m * RSTEP * rs : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * KD; e += THREADS) {
      const int r = e / KD, c = e % KD;
      if (c >= dpad) continue;
      const int i = r0 + r;
      dst[r * LDS + c] =
          (i < n && c < D) ? src[i * rs + c] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace
