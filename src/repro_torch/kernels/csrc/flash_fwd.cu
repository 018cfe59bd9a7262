// Flash-attention forward pass for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_fwd_pallas` (body `_fwd_kernel`) of
// src/repro/kernels/flash_attention.py.  Same function: online-softmax
// attention of q (B, n_kv, G, S, D) over k, v (B, n_kv, Sk, D) with causal,
// sliding-window and prefix-LM masks built from indices, returning `out` in
// q's dtype and the fp32 log-sum-exp `lse = m + log(max(l, 1e-30))`.  q head
// (h, g) reads kv head h, so GQA needs no repeated k/v.
//
// What bounds it on this card.  At the serving slice's shape (B=4, 32
// heads, S=1024, D=128, causal, bf16) the work is ~34 GFLOP of causal
// products over ~134 MB of q/k/v/out: ~256 FLOP per byte, just under the
// H100's bf16 ridge of ~295, so a tensor-core kernel would be bound by
// bytes.  This first kernel multiplies on the fp32 CUDA cores (scalar FMA),
// whose 67 TFLOP/s peak makes it bound by operations instead.
//
// What the design does about it.
//   * One thread block per (64-row q tile, batch x head); the q tile is
//     staged once in shared memory and reused over the whole kv sweep.
//   * k/v tiles of 64 rows are staged in shared memory as fp32; each of the
//     256 threads owns a 4x4 patch of the 64x64 score tile and 4 rows of the
//     output accumulator, so every shared-memory read feeds 4 FMAs.  Row
//     strides are odd, so the 16 threads of a half-warp hit 16 banks.
//   * kv tiles that the causal or window mask hides entirely are skipped,
//     which halves the causal work.  A finite sentinel (-1e30, as in the
//     TPU kernel) marks masked scores, so a row whose first visited tile is
//     wholly masked accumulates values that the next tile's
//     alpha = exp(-1e30 - m) = 0 wipes out; columns past Sk get -inf and
//     never count.
//   * The running max, sum and accumulator stay in registers in fp32; the
//     probabilities go through shared memory for the P.V product.
// Tensor cores (mma.sync / wgmma) and TMA are the next step.
//
// q, k, v and out are read and written through their strides (the last
// dimension must be contiguous), so the wrapper passes permuted views of
// the model's (B, S, H, D) tensors without copies.  Any D <= 256 and any
// ragged S or Sk is handled by masking.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int64_t q_sb, q_sh, q_sg, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_sg, o_ss;
  int B, H, G, S, Sk, D, ld;
  int causal, window, prefix;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sum / max over the 16 threads of a half-warp (they share one row set).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NC = output columns per thread (D <= 16 * NC).
template <typename T, int NC>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int ld = p.ld;
  constexpr int ldp = BK + 1;
  float* sQ = smem;             // BQ x ld
  float* sK = sQ + BQ * ld;     // BK x ld
  float* sV = sK + BK * ld;     // BK x ld
  float* sP = sV + BK * ld;     // BQ x ldp

  const int tid = threadIdx.x;
  const int tx = tid & 15;      // score columns tx + 16c, output cols tx + 16cc
  const int ty = tid >> 4;      // rows ty + 16r
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int g = bh % p.G;
  const int h = (bh / p.G) % p.H;
  const int b = bh / (p.G * p.H);
  const int D = p.D;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                g * p.q_sg;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e - (e / D) * D;
    const int qi = q0 + r;
    sQ[r * ld + c] = qi < p.S ? to_f32(qp[qi * p.q_ss + c]) : 0.f;
  }

  // kv range this q tile can see; wholly masked tiles are skipped.
  int hi = p.Sk;
  if (p.causal) hi = min(p.Sk, max(q0 + BQ, p.prefix));
  int lo = 0;
  if (p.window > 0 && p.prefix == 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / BK) * BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int e = tid; e < BK * D; e += NTHREADS) {
      const int r = e / D, c = e - (e / D) * D;
      const int ki = k0 + r;
      const bool in = ki < p.Sk;
      sK[r * ld + c] = in ? to_f32(kp[ki * p.k_ss + c]) : 0.f;
      sV[r * ld + c] = in ? to_f32(vp[ki * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * ld + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * ld + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ki = k0 + tx + 16 * c;
        bool allow = true;
        if (p.causal) allow = ki <= qi;
        if (p.window) allow = allow && (qi - ki) < p.window;
        if (p.prefix) allow = allow || ki < p.prefix;
        float val = allow ? s[r][c] * p.scale : NEG;
        if (ki >= p.Sk) val = -INFINITY;
        s[r][c] = val;
        mx = fmaxf(mx, val);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pv = expf(s[r][c] - m_new);
        sP[(ty + 16 * r) * ldp + tx + 16 * c] = pv;
        rs += pv;
      }
      rs = half_warp_sum(rs);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) acc[r][cc] *= alpha;
    }
    __syncthreads();

    const int jn = min(BK, p.Sk - k0);
    for (int j = 0; j < jn; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty + 16 * r) * ldp + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float vv = sV[j * ld + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(pv[r], vv, acc[r][cc]);
        }
      }
    }
  }

  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + g * p.o_sg;
  float* lp = p.lse + (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= p.S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) op[qi * p.o_ss + d] = from_f32<T>(acc[r][cc] / lc);
    }
    if (tx == 0) lp[qi] = m[r] + logf(lc);
  }
}

template <typename T, int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(BQ + 2 * BK) * p.ld + BQ * (BK + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H * p.G);
  flash_fwd_kernel<T, NC><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 4>(p, stream);
  if (p.D <= 128) return launch<T, 8>(p, stream);
  return launch<T, 16>(p, stream);
}

}  // namespace

// dims: B, H (= n_kv), G, S, Sk, D.
// strides (in elements): q b,h,g,s; k b,h,s; v b,h,s; out b,h,g,s.  The last
// dimension of each is contiguous.  lse is a contiguous (B, H, G, S) fp32.
// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, const int64_t* dims,
                         const int64_t* strides, int dtype, int causal,
                         int window, int prefix, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = out;
  p.lse = static_cast<float*>(lse);
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.G = static_cast<int>(dims[2]);
  p.S = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  p.D = static_cast<int>(dims[5]);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sg = strides[2];
  p.q_ss = strides[3];
  p.k_sb = strides[4]; p.k_sh = strides[5]; p.k_ss = strides[6];
  p.v_sb = strides[7]; p.v_sh = strides[8]; p.v_ss = strides[9];
  p.o_sb = strides[10]; p.o_sh = strides[11]; p.o_sg = strides[12];
  p.o_ss = strides[13];
  p.ld = (p.D % 2 == 0) ? p.D + 1 : p.D;
  p.causal = causal;
  p.window = window;
  p.prefix = prefix;
  p.scale = scale;
  if (p.D < 1 || p.D > 256 || p.S < 1 || p.Sk < 1 ||
      static_cast<int64_t>(p.B) * p.H * p.G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_for_d<float>(p, st));
    case 1: return static_cast<int>(launch_for_d<__nv_bfloat16>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
