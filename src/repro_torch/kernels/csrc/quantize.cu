// Group-wise int8 quantize / dequantize for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernels `quantize_pallas` (body `_quant_kernel`) and
// `dequantize_pallas` (body `_dequant_kernel`) of
// src/repro/kernels/quantize.py.  Same function, bit for bit: per group of
// 1024 values, scale = absmax / 127 (1.0 for an all-zero group),
// q = clip(round_half_even(x / scale), -127, 127) as int8; dequantize is
// q * scale in fp32, optionally rounded once to bf16 on the way out (which
// is the same number as the fp32 result cast afterwards).
//
// Bit-exactness.  The reference rounds half to even and divides x by the
// scale with a correctly rounded fp32 divide, so this file uses __fdiv_rn
// and __float2int_rn (never roundf, never x * (1/scale)), and must be built
// without --use_fast_math.  The scale itself is absmax times the fp32
// constant 1/127, not absmax / 127: XLA rewrites the reference's division
// by the constant 127 into that product (measured in the JAX package's
// interpret mode, where it differs from a true divide by one ulp in some
// groups), and the port matches what the reference computes.
//
// What bounds it on this card.  Each kernel does a handful of operations
// per element and reads/writes each byte once: bound by bytes (input width
// + 1 byte of int8 per element, plus 4 bytes per 1024-value group).
//
// What the design does about it.  One warp owns one group: each lane
// loads 32 values in 16-byte (fp32) or 8-byte (bf16) vectors, neighbouring
// lanes on neighbouring addresses, so loads coalesce; the group's absmax is
// a warp shuffle reduction, with no shared memory and no block barrier.
// Eight warps (eight groups, the TPU kernel's tile) make a block.  The
// quantizer reads the gradient in its own dtype (fp32 or bf16) and widens
// in registers, which is exact, so the caller needs no fp32 copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 1024;
constexpr int WARPS = 8;
constexpr int PER_LANE = GROUP / 32;  // 32 values, as 8 vectors of 4

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 x;
  *reinterpret_cast<__nv_bfloat162*>(&x.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&x.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = x;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t n_groups) {
  const int lane = threadIdx.x & 31;
  const int64_t grp = static_cast<int64_t>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
  if (grp >= n_groups) return;
  const T* xg = x + grp * GROUP;
  float v[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE / 4; ++i)
    load4(xg + (i * 32 + lane) * 4, v + 4 * i);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float scale = m > 0.f ? __fmul_rn(m, 1.0f / 127.0f) : 1.0f;
  int8_t* qg = q + grp * GROUP;
#pragma unroll
  for (int i = 0; i < PER_LANE / 4; ++i) {
    char4 c;
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = __float2int_rn(__fdiv_rn(v[4 * i + j], scale));
      r[j] = min(127, max(-127, r[j]));
    }
    c.x = static_cast<signed char>(r[0]);
    c.y = static_cast<signed char>(r[1]);
    c.z = static_cast<signed char>(r[2]);
    c.w = static_cast<signed char>(r[3]);
    *reinterpret_cast<char4*>(qg + (i * 32 + lane) * 4) = c;
  }
  if (lane == 0) scales[grp] = scale;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int64_t n_groups) {
  const int lane = threadIdx.x & 31;
  const int64_t grp = static_cast<int64_t>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
  if (grp >= n_groups) return;
  const float scale = scales[grp];
  const int8_t* qg = q + grp * GROUP;
  T* og = out + grp * GROUP;
#pragma unroll
  for (int i = 0; i < PER_LANE / 4; ++i) {
    const int off = (i * 32 + lane) * 4;
    const char4 c = *reinterpret_cast<const char4*>(qg + off);
    const float v[4] = {static_cast<float>(c.x) * scale,
                        static_cast<float>(c.y) * scale,
                        static_cast<float>(c.z) * scale,
                        static_cast<float>(c.w) * scale};
    store4(og + off, v);
  }
}

dim3 grid_for(int64_t n_groups) {
  return dim3(static_cast<unsigned>((n_groups + WARPS - 1) / WARPS));
}

}  // namespace

// x: contiguous (n_groups, 1024), dtype 0 float32 / 1 bfloat16; q: int8 of
// the same shape; scales: contiguous (n_groups,) fp32.  Returns a
// cudaError_t.
extern "C" int quantize(const void* x, void* q, void* scales,
                        int64_t n_groups, int dtype, void* stream) {
  if (n_groups < 1 || (n_groups + WARPS - 1) / WARPS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  switch (dtype) {
    case 0:
      quantize_kernel<float><<<grid_for(n_groups), WARPS * 32, 0, st>>>(
          static_cast<const float*>(x), qp, sp, n_groups);
      break;
    case 1:
      quantize_kernel<__nv_bfloat16><<<grid_for(n_groups), WARPS * 32, 0,
                                       st>>>(
          static_cast<const __nv_bfloat16*>(x), qp, sp, n_groups);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: contiguous int8 (n_groups, 1024); scales (n_groups,) fp32; out of the
// same shape as q, dtype 0 float32 / 1 bfloat16.  Returns a cudaError_t.
extern "C" int dequantize(const void* q, const void* scales, void* out,
                          int64_t n_groups, int dtype, void* stream) {
  if (n_groups < 1 || (n_groups + WARPS - 1) / WARPS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  switch (dtype) {
    case 0:
      dequantize_kernel<float><<<grid_for(n_groups), WARPS * 32, 0, st>>>(
          qp, sp, static_cast<float*>(out), n_groups);
      break;
    case 1:
      dequantize_kernel<__nv_bfloat16><<<grid_for(n_groups), WARPS * 32, 0,
                                         st>>>(
          qp, sp, static_cast<__nv_bfloat16*>(out), n_groups);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
