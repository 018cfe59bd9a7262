// Flash-attention backward pass for Hopper (sm_90a), plain C interface:
// two kernels, a dq pass and a dk/dv pass.
//
// Replaces the TPU kernel `flash_bwd_pallas` of
// src/repro/kernels/flash_attention.py: `_bwd_dq_kernel` (dq pass) and
// `_bwd_dkv_kernel` (dk/dv pass).  Same function: with q, dO
// (B, n_kv, G, S, D), k, v (B, n_kv, Sk, D), the forward's fp32
// log-sum-exp `lse` and `delta = rowsum(dO * O)` (both (B, n_kv, G, S)
// fp32), the probabilities are recomputed as p = exp(s * scale + mask - lse)
// with the causal / sliding-window / prefix-LM masks built from indices
// and the finite -1e30 sentinel, and
//   ds = p * (dO.v^T - delta) * scale,
//   dq = ds.k                 (one q tile, all kv tiles),
//   dk = sum ds^T.q, dv = sum p^T.dO  (one kv tile, all G groups and q
//                                       tiles),
// each accumulated in fp32 and written once in its input's dtype.  Each
// output has exactly one writer block, so both passes are deterministic
// (no atomics).
//
// What bounds it on this card.  At the training slice's shape (B=2, 32
// heads, S=4096, D=128, causal, bf16) the dq pass does 3 products of the
// causal triangle (q.k, dO.v, ds.k) and the dk/dv pass 4 (q.k, dO.v, p.dO,
// ds.q): ~0.41 and ~0.55 TFLOP against ~0.2 GB of operands, far above the
// H100's bf16 ridge, so a tensor-core kernel would be bound by operations.
// This first version multiplies on the fp32 CUDA cores (scalar FMA, 67
// TFLOP/s peak), the design of the forward kernel.
//
// What the design does about it.
//   * Tiles of 16*R rows (R = 4, or 2 for D > 128 so that a block stays
//     under the 227 KB of shared memory); 256 threads, each owning an RxR
//     patch of the score tile and R rows x NC columns of its fp32
//     accumulators, so every shared-memory read feeds R FMAs.  Operand
//     tiles are staged in shared memory as fp32 with odd row strides.
//   * dq: one block per (q tile, batch x head x group), looping over kv
//     tiles; dk/dv: one block per (kv tile, batch x head), looping over the
//     G query groups and the q tiles, which sums GQA groups in registers.
//   * Tiles that the causal or window mask hides entirely are skipped (a
//     tile that `prefix` opens never is); within a tile the mask is exact,
//     ragged rows and columns past S or Sk get p = 0.
//
// All tensors are read and written through their strides (the last
// dimension must be contiguous), so the wrapper passes permuted views of
// the model's (B, S, H, D) tensors and gets dq/dk/dv back in that layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sh, q_sg, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_sg, do_ss;
  int64_t dq_sb, dq_sh, dq_sg, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
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

__device__ __forceinline__ bool allowed(const Params& p, int qi, int ki) {
  bool allow = true;
  if (p.causal) allow = ki <= qi;
  if (p.window) allow = allow && (qi - ki) < p.window;
  if (p.prefix) allow = allow || ki < p.prefix;
  return allow;
}

// Stage rows [r0, r0 + rows) of a (.., D) operand as fp32, zeros past n.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t sstride,
                                      int r0, int rows, int n, int D, int ld) {
  for (int e = threadIdx.x; e < rows * D; e += NTHREADS) {
    const int r = e / D, c = e - (e / D) * D;
    const int i = r0 + r;
    dst[r * ld + c] = i < n ? to_f32(src[i * sstride + c]) : 0.f;
  }
}

// ---------------------------------------------------------------- dq pass
template <typename T, int R, int NC>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int BQ = 16 * R, BK = 16 * R, ldp = BK + 1;
  extern __shared__ float smem[];
  const int ld = p.ld;
  float* sQ = smem;            // BQ x ld
  float* sDO = sQ + BQ * ld;   // BQ x ld
  float* sK = sDO + BQ * ld;   // BK x ld
  float* sV = sK + BK * ld;    // BK x ld
  float* sDS = sV + BK * ld;   // BQ x ldp

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int g = bh % p.G, h = (bh / p.G) % p.H, b = bh / (p.G * p.H);
  const int D = p.D;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                g * p.q_sg;
  const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb +
                 h * p.do_sh + g * p.do_sg;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t row0 = (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;

  stage(sQ, qp, p.q_ss, q0, BQ, p.S, D, ld);
  stage(sDO, dop, p.do_ss, q0, BQ, p.S, D, ld);
  float lse_r[R], dlt_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + ty + 16 * r;
    lse_r[r] = qi < p.S ? p.lse[row0 + qi] : 0.f;
    dlt_r[r] = qi < p.S ? p.delta[row0 + qi] : 0.f;
  }

  // kv range this q tile can see (as in the forward kernel).
  int hi = p.Sk;
  if (p.causal) hi = min(p.Sk, max(q0 + BQ, p.prefix));
  int lo = 0;
  if (p.window > 0 && p.prefix == 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / BK) * BK;

  float acc[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) acc[r][cc] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sDS reads are done
    stage(sK, kp, p.k_ss, k0, BK, p.Sk, D, ld);
    stage(sV, vp, p.v_ss, k0, BK, p.Sk, D, ld);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qv[r] = sQ[(ty + 16 * r) * ld + d];
        ov[r] = sDO[(ty + 16 * r) * ld + d];
      }
#pragma unroll
      for (int c = 0; c < R; ++c) {
        kv[c] = sK[(tx + 16 * c) * ld + d];
        vv[c] = sV[(tx + 16 * c) * ld + d];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int ki = k0 + tx + 16 * c;
        const float val = allowed(p, qi, ki) ? s[r][c] * p.scale : NEG;
        const float pv =
            (qi < p.S && ki < p.Sk) ? expf(val - lse_r[r]) : 0.f;
        sDS[(ty + 16 * r) * ldp + tx + 16 * c] =
            pv * (dp[r][c] - dlt_r[r]) * p.scale;
      }
    }
    __syncthreads();

    const int jn = min(BK, p.Sk - k0);
    for (int j = 0; j < jn; ++j) {
      float dsv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dsv[r] = sDS[(ty + 16 * r) * ldp + j];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int d = tx + 16 * cc;
        if (d < D) {
          const float kk = sK[j * ld + d];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][cc] = fmaf(dsv[r], kk, acc[r][cc]);
        }
      }
    }
  }

  T* dqp = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh + g * p.dq_sg;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= p.S) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) dqp[qi * p.dq_ss + d] = from_f32<T>(acc[r][cc]);
    }
  }
}

// ------------------------------------------------------------- dk/dv pass
template <typename T, int R, int NC>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int BQ = 16 * R, BK = 16 * R, ldp = BQ + 1;
  extern __shared__ float smem[];
  const int ld = p.ld;
  float* sK = smem;            // BK x ld
  float* sV = sK + BK * ld;    // BK x ld
  float* sQ = sV + BK * ld;    // BQ x ld
  float* sDO = sQ + BQ * ld;   // BQ x ld
  float* sP = sDO + BQ * ld;   // BK x ldp (p transposed: kv rows, q cols)
  float* sDS = sP + BK * ldp;  // BK x ldp
  float* sL = sDS + BK * ldp;  // BQ
  float* sD = sL + BQ;         // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int h = bh % p.H, b = bh / p.H;
  const int D = p.D;

  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  stage(sK, kp, p.k_ss, k0, BK, p.Sk, D, ld);
  stage(sV, vp, p.v_ss, k0, BK, p.Sk, D, ld);

  // q range that can see this kv tile.  A tile holding a prefix column is
  // seen by every query.
  int qlo = 0, qhi = p.S;
  if (!(p.prefix > 0 && k0 < p.prefix)) {
    if (p.causal) qlo = min(k0, p.S);
    if (p.window > 0) qhi = min(p.S, min(k0 + BK, p.Sk) - 1 + p.window);
  }
  qlo = (qlo / BQ) * BQ;

  float dk[R][NC], dv[R][NC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) dk[r][cc] = dv[r][cc] = 0.f;

  for (int g = 0; g < p.G; ++g) {
    const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                  g * p.q_sg;
    const T* dop = static_cast<const T*>(p.dout) + b * p.do_sb +
                   h * p.do_sh + g * p.do_sg;
    const int64_t row0 = (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;
    for (int q0 = qlo; q0 < qhi; q0 += BQ) {
      __syncthreads();  // the previous tile's sQ/sDO/sP/sDS reads are done
      stage(sQ, qp, p.q_ss, q0, BQ, p.S, D, ld);
      stage(sDO, dop, p.do_ss, q0, BQ, p.S, D, ld);
      if (tid < BQ) {
        const int qi = q0 + tid;
        sL[tid] = qi < p.S ? p.lse[row0 + qi] : 0.f;
        sD[tid] = qi < p.S ? p.delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      // transposed score patch: kv rows ty + 16r, q columns tx + 16c
      float s[R][R], dp[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) s[r][c] = dp[r][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], qv[R], ov[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          kv[r] = sK[(ty + 16 * r) * ld + d];
          vv[r] = sV[(ty + 16 * r) * ld + d];
        }
#pragma unroll
        for (int c = 0; c < R; ++c) {
          qv[c] = sQ[(tx + 16 * c) * ld + d];
          ov[c] = sDO[(tx + 16 * c) * ld + d];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) {
            s[r][c] = fmaf(kv[r], qv[c], s[r][c]);
            dp[r][c] = fmaf(vv[r], ov[c], dp[r][c]);
          }
      }

#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ki = k0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int qc = tx + 16 * c, qi = q0 + qc;
          const float val = allowed(p, qi, ki) ? s[r][c] * p.scale : NEG;
          const float pv =
              (qi < p.S && ki < p.Sk) ? expf(val - sL[qc]) : 0.f;
          sP[(ty + 16 * r) * ldp + qc] = pv;
          sDS[(ty + 16 * r) * ldp + qc] = pv * (dp[r][c] - sD[qc]) * p.scale;
        }
      }
      __syncthreads();

      const int jn = min(BQ, p.S - q0);
      for (int j = 0; j < jn; ++j) {
        float pv[R], dsv[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pv[r] = sP[(ty + 16 * r) * ldp + j];
          dsv[r] = sDS[(ty + 16 * r) * ldp + j];
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = tx + 16 * cc;
          if (d < D) {
            const float qq = sQ[j * ld + d];
            const float oo = sDO[j * ld + d];
#pragma unroll
            for (int r = 0; r < R; ++r) {
              dv[r][cc] = fmaf(pv[r], oo, dv[r][cc]);
              dk[r][cc] = fmaf(dsv[r], qq, dk[r][cc]);
            }
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvp = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ki = k0 + ty + 16 * r;
    if (ki >= p.Sk) continue;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) {
        dkp[ki * p.dk_ss + d] = from_f32<T>(dk[r][cc]);
        dvp[ki * p.dv_ss + d] = from_f32<T>(dv[r][cc]);
      }
    }
  }
}

template <typename T, int R, int NC>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int BT = 16 * R;
  const size_t smem =
      (static_cast<size_t>(4 * BT) * p.ld + BT * (BT + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, R, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BT - 1) / BT, p.B * p.H * p.G);
  flash_bwd_dq_kernel<T, R, NC><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int R, int NC>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int BT = 16 * R;
  const size_t smem = (static_cast<size_t>(4 * BT) * p.ld +
                       2 * BT * (BT + 1) + 2 * BT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, R, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BT - 1) / BT, p.B * p.H);
  flash_bwd_dkv_kernel<T, R, NC><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// D <= 64: 64-row tiles, 4 columns a thread; D <= 128: 64-row tiles, 8
// columns; D <= 256: 32-row tiles (shared memory), 16 columns.
template <typename T>
cudaError_t launch_for_d(const Params& p, bool dkv, cudaStream_t stream) {
  if (p.D <= 64)
    return dkv ? launch_dkv<T, 4, 4>(p, stream) : launch_dq<T, 4, 4>(p, stream);
  if (p.D <= 128)
    return dkv ? launch_dkv<T, 4, 8>(p, stream) : launch_dq<T, 4, 8>(p, stream);
  return dkv ? launch_dkv<T, 2, 16>(p, stream)
             : launch_dq<T, 2, 16>(p, stream);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        const int64_t* dims, const int64_t* st, int dtype, int causal,
        int window, int prefix, float scale, void* stream, bool dkv) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = static_cast<int>(dims[0]);
  p.H = static_cast<int>(dims[1]);
  p.G = static_cast<int>(dims[2]);
  p.S = static_cast<int>(dims[3]);
  p.Sk = static_cast<int>(dims[4]);
  p.D = static_cast<int>(dims[5]);
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_sg = st[2]; p.q_ss = st[3];
  p.k_sb = st[4]; p.k_sh = st[5]; p.k_ss = st[6];
  p.v_sb = st[7]; p.v_sh = st[8]; p.v_ss = st[9];
  p.do_sb = st[10]; p.do_sh = st[11]; p.do_sg = st[12]; p.do_ss = st[13];
  p.dq_sb = st[14]; p.dq_sh = st[15]; p.dq_sg = st[16]; p.dq_ss = st[17];
  p.dk_sb = st[18]; p.dk_sh = st[19]; p.dk_ss = st[20];
  p.dv_sb = st[21]; p.dv_sh = st[22]; p.dv_ss = st[23];
  p.ld = (p.D % 2 == 0) ? p.D + 1 : p.D;
  p.causal = causal;
  p.window = window;
  p.prefix = prefix;
  p.scale = scale;
  if (p.D < 1 || p.D > 256 || p.S < 1 || p.Sk < 1 ||
      static_cast<int64_t>(p.B) * p.H * p.G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_for_d<float>(p, dkv, s));
    case 1: return static_cast<int>(launch_for_d<__nv_bfloat16>(p, dkv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dims: B, H (= n_kv), G, S, Sk, D.
// strides (in elements): q b,h,g,s; k b,h,s; v b,h,s; dout b,h,g,s;
// dq b,h,g,s; dk b,h,s; dv b,h,s.  The last dimension of each is
// contiguous; lse and delta are contiguous (B, H, G, S) fp32.  dtype: 0
// float32, 1 bfloat16 (all of q, k, v, dout, dq, dk, dv).  Each call
// launches one kernel and returns a cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            const int64_t* dims, const int64_t* strides,
                            int dtype, int causal, int window, int prefix,
                            float scale, void* stream) {
  return run(q, k, v, dout, lse, delta, dq, dk, dv, dims, strides, dtype,
             causal, window, prefix, scale, stream, false);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             const int64_t* dims, const int64_t* strides,
                             int dtype, int causal, int window, int prefix,
                             float scale, void* stream) {
  return run(q, k, v, dout, lse, delta, dq, dk, dv, dims, strides, dtype,
             causal, window, prefix, scale, stream, true);
}
