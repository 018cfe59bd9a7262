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
//                                       tiles).
// Each output has exactly one writer block, so both passes are
// deterministic (no atomics).  A fused one-pass design (5 products, dq
// summed with fp32 atomics) would give that up.
//
// What bounds it on this card.  At the training slice's shape (B=2, 32
// heads, S=4096, D=128, causal, bf16) each product over the causal
// triangle is 2*B*H*D*S(S+1)/2 = 1.375e11 FLOP; the dq pass does 3 (q.k,
// dO.v, ds.k) and the dk/dv pass 4 (q.k, dO.v, p^T.dO, ds^T.q) against
// ~0.2 GB of operands, far above the H100's bf16 ridge: both passes are
// bound by operations, and only the tensor cores (989 TFLOP/s bf16, dense)
// can approach the bound.
//
// bf16 inputs take one of two routes, which the caller chooses (route 2 or
// 1, see the C interface at the end).
//
// The wgmma route (the *_wg kernels; bf16, D in {64, 128, 256}, every
// operand 16-byte aligned: every model's training shape), designed for
// Hopper's tensor cores and copy engine:
//   * Three warpgroups a block.  Warpgroup 2 produces: its first thread
//     keeps a ring of 2 stages of the streamed tiles (k/v in the dq pass;
//     q/dO in the dk/dv pass) in flight by TMA, full and empty mbarriers a
//     stage; its first warp copies the tiles' lse/delta rows with 4-byte
//     cp.async (a TMA box must start 16-byte aligned, a row of odd S does
//     not), each lane's copies counted by the stage's barrier.  It gives
//     its registers to the two consumer warpgroups (setmaxnreg 24 / 240).
//   * Loads by TMA from 5-D (q, dO: D, S, G, H, B) and 4-D (k, v) tensor
//     maps over the wrapper's strided views, boxes of 64 columns, 128-byte
//     swizzle, rows past S or Sk filled with zeros.  The maps are built on
//     the host at every call (cuTensorMapEncodeTiled, found in the
//     libcuda the process has loaded) and passed as __grid_constant__.
//   * Products on wgmma, bf16 operands, fp32 accumulators, 64-row
//     warpgroup tiles: s = q.k^T and dp = dO.v^T with both operands read
//     from shared memory along D; dq += ds.k, dv += p^T.dO and dk += ds^T.q
//     with ds or p from registers (the accumulator fragment of s is the A
//     fragment) and k, dO or q read across their rows (wgmma's transpose
//     flag), so no operand is transposed by hand.  s and dp are committed
//     as two groups, and p = exp(s - lse) is computed while dp's products
//     still run.
//   * All of D in one block.  dq: 128 q rows a block, 64 a consumer, k/v
//     tiles of 64 rows (32 at D = 256, so that the 128 accumulators of a
//     64 x 256 dq fit the 240 registers).  dk/dv: 128 kv rows a block at
//     D <= 128, each consumer 64 rows with both accumulators; at D = 256
//     dk and dv (128 registers each) do not fit one warpgroup, so 64 kv
//     rows a block, one consumer computes s^T, p^T and dv, the other dp^T,
//     ds^T and dk, and p^T passes between them in fp32 through shared
//     memory (both hold the same fragment layout).
//   * The G query groups of a kv head are split over blockIdx.z in the
//     dk/dv pass where its blocks would be too few (the wrapper's
//     _dkv_chunks): each chunk of groups sums into fp32 partials, and a
//     second kernel sums the partials in chunk order and rounds to bf16
//     once, so each output keeps one writer and stays deterministic.
//   * The rounding points, the masks and the tile skipping are those of
//     the mma route below.
//   * No trap in the consumers' code: ptxas then compiles it to the
//     block's entry register count (168) instead of 240, and the
//     accumulators spill; only the producer's waits carry a watchdog.
//
// The mma route (the *_tc kernels: bf16 with other D, or views that are not
// 16-byte aligned):
//   * Every product runs on the tensor cores as
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, fp32 accumulators in
//     registers, operands fed by ldmatrix (.trans for the operand read
//     across its rows: k in ds.k, q and dO in the dk/dv pass).
//   * Rounding: s = q.k and dP = dO.v are exact products summed in fp32;
//     p = exp(s*scale - lse) and ds = p*(dP - delta)*scale are fp32 and
//     are rounded to bf16 once, as the A operand of the second-stage
//     products (p before p^T.dO, ds before ds.k and ds^T.q); dq, dk and dv
//     are summed in fp32 and rounded to bf16 once, when stored.
//   * Operands sit in shared memory as bf16 (half the bytes of fp32), in
//     rows of KD + 8 elements (KD = D rounded up to 64, 128 or 256): the
//     16-byte pad puts the 8 rows of each ldmatrix 8x8 load in distinct
//     banks.  Columns from D up to the next multiple of 16 are zero, so D
//     = 40, 80, ... take whole k-steps of 16; zeros change no product.
//   * Loads are 16-byte cp.async.cg into a ring of 2 stages: the next
//     streamed tile (k/v in the dq pass; q/dO with their lse/delta rows in
//     the dk/dv pass) loads while the current one multiplies, one barrier
//     an iteration.  The tile that stays (q/dO, resp. k/v) is loaded once
//     per block.  Each thread's copy addresses are computed once a tile
//     (every instruction besides the HMMAs competes with them for the warp
//     schedulers' dispatch slots); rows past S or Sk are zero-filled by
//     the copy itself.  A pointer or stride that is not 16-byte aligned,
//     or D not a multiple of 8, takes plain 2-byte loads into the same
//     layout.
//   * The mask is applied per element only in the 16-row warp patches
//     that the causal / window / prefix boundary or a ragged edge crosses;
//     elsewhere p = 2^(s*scale*log2(e) - lse*log2(e)), one FFMA and one
//     MUFU.EX2.  D == 128 has its own instances with no column guards.
//   * 64 resident rows per block, 4 warps of 16 rows; each warp keeps its
//     16 x D output accumulators in registers.  dk/dv: each warp computes
//     S^T = K.Q^T and dP^T = V.dO^T for its 16 kv rows against 64 streamed
//     q rows; p and ds stay in registers (the m16n8 accumulators of two
//     adjacent n8 tiles are exactly the m16k16 A fragment) and feed
//     p^T.dO and ds^T.q directly, with no round trip through shared
//     memory.  dq: ds stays in registers as the A operand of ds.k.  At
//     D=128 the dq pass takes 70 KB of shared memory (3 blocks an SM), the
//     dk/dv pass 106 KB (2 blocks an SM).  D > 128 splits the output
//     columns over two blocks (blockIdx.z), each recomputing the scores,
//     so that the accumulators fit in registers.
//   * dq: one block per (q tile, batch x head x group), the longest causal
//     q tiles first (blockIdx.x reversed) so the tail is short; dk/dv: one
//     block per (kv tile, batch x head), looping over the G query groups
//     and the q tiles, which sums GQA groups in registers.
//   * Tiles that the causal or window mask hides entirely are skipped (a
//     tile that `prefix` opens never is); within a tile the mask is exact,
//     ragged rows and columns past S or Sk get p = 0.
//
// fp32 inputs (dtype 0) keep the first design, scalar FMA on the CUDA
// cores with fp32 tiles in shared memory (the templates without _tc):
// TF32 tensor cores would not hold the fp32 limits of 4e-3 elementwise
// and 1e-3 per row block, and fp32 is a test-only dtype on the card.
//
// All tensors are read and written through their strides (the last
// dimension must be contiguous), so the wrapper passes permuted views of
// the model's (B, S, H, D) tensors and gets dq/dk/dv back in that layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

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
  int vec;  // bf16 path: every operand row 16-byte aligned, D % 8 == 0
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ---------------------------------------------------------- fp32: dq pass
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

// ------------------------------------------------------- fp32: dk/dv pass
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

// ------------------------------------------------- bf16: tensor-core path
constexpr int TC_ROWS = 64;     // resident rows a block: 4 warps x 16
constexpr int TC_THREADS = 128;
constexpr float NEG2 = NEG * LOG2E;  // the mask sentinel in log2 units

// True when every (qi, ki) with qi in [qlo, qhi], ki in [klo, khi] lies in
// range and is allowed, so that the patch needs no per-element mask (a
// patch opened only partly by `prefix` takes the masked path).
__device__ __forceinline__ bool all_open(const Params& p, int qlo, int qhi,
                                         int klo, int khi) {
  if (qhi >= p.S || khi >= p.Sk) return false;
  bool open = true;
  if (p.causal) open = khi <= qlo;
  if (p.window) open = open && (qhi - klo) < p.window;
  if (p.prefix) open = open || khi < p.prefix;
  return open;
}

// fp32 rows [r0, r0 + ROWS) of lse or delta, zeros past n.
template <int ROWS>
__device__ __forceinline__ void load_f32(float* dst, const float* src, int r0,
                                         int n) {
  for (int e = threadIdx.x; e < ROWS; e += TC_THREADS) {
    const bool ok = r0 + e < n;
    cp_async4(smem_addr(dst + e), ok ? src + r0 + e : src, ok ? 4 : 0);
  }
}

// dq pass: q/dO tile of 64 rows resident, k/v tiles of BS rows streamed.
// FULLD: D == KD == DOUT (no padded or split columns).
template <int KD, int DOUT, int BS, bool FULLD, int MINB>
__global__ void __launch_bounds__(TC_THREADS, MINB)
    flash_bwd_dq_tc_kernel(Params p) {
  static_assert(!FULLD || DOUT == KD, "FULLD needs one column block");
  constexpr int LDS = KD + 8, NT = BS / 8, NO = DOUT / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);  // TC_ROWS x LDS
  bf16* sDO = sQ + TC_ROWS * LDS;                // TC_ROWS x LDS
  bf16* sK = sDO + TC_ROWS * LDS;                // 2 stages x BS x LDS
  bf16* sV = sK + 2 * BS * LDS;                  // 2 stages x BS x LDS

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n_tiles = (p.S + TC_ROWS - 1) / TC_ROWS;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * TC_ROWS;
  const int bh = blockIdx.y;
  const int g = bh % p.G, h = (bh / p.G) % p.H, b = bh / (p.G * p.H);
  const int c0 = FULLD ? 0 : blockIdx.z * DOUT;
  const int D = FULLD ? KD : p.D, dpad = FULLD ? KD : (D + 15) & ~15;
  const bool vec = p.vec != 0;

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh +
                   g * p.q_sg;
  const bf16* dop = static_cast<const bf16*>(p.dout) + b * p.do_sb +
                    h * p.do_sh + g * p.do_sg;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t row0 = (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;

  // kv range this q tile can see (as in the forward kernel).
  int hi = p.Sk;
  if (p.causal) hi = min(p.Sk, max(q0 + TC_ROWS, p.prefix));
  int lo = 0;
  if (p.window > 0 && p.prefix == 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / BS) * BS;
  const int n_kv = hi > lo ? (hi - lo + BS - 1) / BS : 0;

  load_tile_rows<TC_THREADS, TC_ROWS, KD, FULLD>(sQ, qp, p.q_ss, q0, p.S, D,
                                                 dpad, vec);
  load_tile_rows<TC_THREADS, TC_ROWS, KD, FULLD>(sDO, dop, p.do_ss, q0, p.S,
                                                 D, dpad, vec);
  if (n_kv > 0) {
    load_tile_rows<TC_THREADS, BS, KD, FULLD>(sK, kp, p.k_ss, lo, p.Sk, D,
                                              dpad, vec);
    load_tile_rows<TC_THREADS, BS, KD, FULLD>(sV, vp, p.v_ss, lo, p.Sk, D,
                                              dpad, vec);
  }
  cp_async_commit();

  // this thread's accumulator rows: qr and qr + 8
  const int qr = q0 + 16 * w + g8;
  const float c2 = p.scale * LOG2E;
  float lse2[2], dlts[2];  // lse in log2 units, delta * scale
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + 8 * r;
    lse2[r] = qi < p.S ? p.lse[row0 + qi] * LOG2E : 0.f;
    dlts[r] = qi < p.S ? p.delta[row0 + qi] * p.scale : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const bf16* aQ = sQ + (16 * w + a_row(lane)) * LDS + a_col(lane);
  const bf16* aDO = sDO + (16 * w + a_row(lane)) * LDS + a_col(lane);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = lo + it * BS;
    const bf16* cK = sK + (it & 1) * BS * LDS;
    const bf16* cV = sV + (it & 1) * BS * LDS;
    // tile `it` has landed, and every warp is done with tile it - 1, whose
    // stage the next tile now fills while this one multiplies
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_kv) {
      const int nxt = ((it + 1) & 1) * BS * LDS;
      load_tile_rows<TC_THREADS, BS, KD, FULLD>(sK + nxt, kp, p.k_ss, k0 + BS,
                                                p.Sk, D, dpad, vec);
      load_tile_rows<TC_THREADS, BS, KD, FULLD>(sV + nxt, vp, p.v_ss, k0 + BS,
                                                p.Sk, D, dpad, vec);
    }
    cp_async_commit();

    // s = q.k^T and dp = dO.v^T for this warp's 16 rows x BS columns
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD / 16; ++ks) {
      if (FULLD || ks * 16 < dpad) {
        uint32_t aq[4], ao[4];
        ldsm_x4(smem_addr(aQ + 16 * ks), aq);
        ldsm_x4(smem_addr(aDO + 16 * ks), ao);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (16 * np + b_row(lane)) * LDS + 16 * ks + b_col(lane);
          uint32_t bk[4], bv[4];
          ldsm_x4(smem_addr(cK + off), bk);
          ldsm_x4(smem_addr(cV + off), bv);
          mma_bf16(s[2 * np], aq, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
          mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }
    }

    // ds = p * (dp - delta) * scale in fp32, p = exp(s*scale + mask - lse);
    // the per-element mask only where this warp's 16 x BS patch needs it
    const bool open = all_open(p, q0 + 16 * w, q0 + 16 * w + 15, k0,
                               k0 + BS - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pv;
        if (open) {
          pv = exp2_approx(s[j][e] * c2 - lse2[e >> 1]);
        } else {
          const int qi = qr + (e >> 1) * 8;
          const int ki = k0 + 8 * j + 2 * t4 + (e & 1);
          const float val = allowed(p, qi, ki) ? s[j][e] * c2 : NEG2;
          pv = (qi < p.S && ki < p.Sk) ? exp2_approx(val - lse2[e >> 1])
                                       : 0.f;
        }
        s[j][e] = pv * (dp[j][e] * p.scale - dlts[e >> 1]);
      }
    uint32_t ads[NT / 2][4];
    to_a_frags<NT>(s, ads);

    // dq += ds.k, k read across its rows (.trans)
#pragma unroll
    for (int t = 0; t < NT / 2; ++t)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (FULLD || c0 + 16 * np < D) {
          uint32_t bk[4];
          ldsm_x4_t(smem_addr(cK + (16 * t + a_row(lane)) * LDS + c0 +
                              16 * np + a_col(lane)), bk);
          mma_bf16(acc[2 * np], ads[t], bk[0], bk[1]);
          mma_bf16(acc[2 * np + 1], ads[t], bk[2], bk[3]);
        }
      }
  }
  cp_async_wait_all();

  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
              g * p.dq_sg;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = qr + (e >> 1) * 8, d = c0 + 8 * n + 2 * t4 + (e & 1);
      if (qi < p.S && (FULLD || d < D))
        dqp[qi * p.dq_ss + d] = __float2bfloat16(acc[n][e]);
    }
}

// dk/dv pass: k/v tile of 64 rows resident, q/dO tiles of BS rows (and
// their lse/delta) streamed over the G groups and the q range.
template <int KD, int DOUT, int BS, bool FULLD, int MINB>
__global__ void __launch_bounds__(TC_THREADS, MINB)
    flash_bwd_dkv_tc_kernel(Params p) {
  static_assert(!FULLD || DOUT == KD, "FULLD needs one column block");
  constexpr int LDS = KD + 8, NT = BS / 8, NO = DOUT / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sK = reinterpret_cast<bf16*>(tc_smem);  // TC_ROWS x LDS
  bf16* sV = sK + TC_ROWS * LDS;                 // TC_ROWS x LDS
  bf16* sQ = sV + TC_ROWS * LDS;                 // 2 stages x BS x LDS
  bf16* sDO = sQ + 2 * BS * LDS;                 // 2 stages x BS x LDS
  float* sL = reinterpret_cast<float*>(sDO + 2 * BS * LDS);  // 2 x BS
  float* sD = sL + 2 * BS;                                    // 2 x BS

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * TC_ROWS;
  const int bh = blockIdx.y;
  const int h = bh % p.H, b = bh / p.H;
  const int c0 = FULLD ? 0 : blockIdx.z * DOUT;
  const int D = FULLD ? KD : p.D, dpad = FULLD ? KD : (D + 15) & ~15;
  const bool vec = p.vec != 0;

  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb +
                    h * p.do_sh;
  const int64_t rowb = static_cast<int64_t>(b * p.H + h) * p.G * p.S;

  // q range that can see this kv tile.  A tile holding a prefix column is
  // seen by every query.
  int qlo = 0, qhi = p.S;
  if (!(p.prefix > 0 && k0 < p.prefix)) {
    if (p.causal) qlo = min(k0, p.S);
    if (p.window > 0) qhi = min(p.S, min(k0 + TC_ROWS, p.Sk) - 1 + p.window);
  }
  qlo = (qlo / BS) * BS;
  const int n_q = qhi > qlo ? (qhi - qlo + BS - 1) / BS : 0;
  const int n_it = p.G * n_q;  // (group, q tile) pairs, group-major

  // load stream tile `it` (group it / n_q) into stage `st`
  auto load_stream = [&](int it, int st) {
    const int gg = it / n_q, q0 = qlo + (it - gg * n_q) * BS;
    load_tile_rows<TC_THREADS, BS, KD, FULLD>(
        sQ + st * BS * LDS, qb + gg * p.q_sg, p.q_ss, q0, p.S, D, dpad, vec);
    load_tile_rows<TC_THREADS, BS, KD, FULLD>(
        sDO + st * BS * LDS, dob + gg * p.do_sg, p.do_ss, q0, p.S, D, dpad,
        vec);
    load_f32<BS>(sL + st * BS, p.lse + rowb + gg * p.S, q0, p.S);
    load_f32<BS>(sD + st * BS, p.delta + rowb + gg * p.S, q0, p.S);
  };

  load_tile_rows<TC_THREADS, TC_ROWS, KD, FULLD>(sK, kp, p.k_ss, k0, p.Sk, D,
                                                 dpad, vec);
  load_tile_rows<TC_THREADS, TC_ROWS, KD, FULLD>(sV, vp, p.v_ss, k0, p.Sk, D,
                                                 dpad, vec);
  if (n_it > 0) load_stream(0, 0);
  cp_async_commit();

  // this thread's accumulator rows: kr and kr + 8
  const int kr = k0 + 16 * w + g8;
  const float c2 = p.scale * LOG2E;
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const bf16* aK = sK + (16 * w + a_row(lane)) * LDS + a_col(lane);
  const bf16* aV = sV + (16 * w + a_row(lane)) * LDS + a_col(lane);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int gg = it / n_q, q0 = qlo + (it - gg * n_q) * BS;
    const bf16* cQ = sQ + st * BS * LDS;
    const bf16* cDO = sDO + st * BS * LDS;
    const float* cL = sL + st * BS;
    const float* cD = sD + st * BS;
    // tile `it` has landed, and every warp is done with tile it - 1, whose
    // stage the next tile now fills while this one multiplies
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) load_stream(it + 1, st ^ 1);
    cp_async_commit();

    // s^T = k.q^T and dp^T = v.dO^T for this warp's 16 kv rows x BS q
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD / 16; ++ks) {
      if (FULLD || ks * 16 < dpad) {
        uint32_t ak[4], av[4];
        ldsm_x4(smem_addr(aK + 16 * ks), ak);
        ldsm_x4(smem_addr(aV + 16 * ks), av);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (16 * np + b_row(lane)) * LDS + 16 * ks + b_col(lane);
          uint32_t bq[4], bo[4];
          ldsm_x4(smem_addr(cQ + off), bq);
          ldsm_x4(smem_addr(cDO + off), bo);
          mma_bf16(s[2 * np], ak, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * np], av, bo[0], bo[1]);
          mma_bf16(dp[2 * np + 1], av, bo[2], bo[3]);
        }
      }
    }

    // p^T and ds^T in fp32 (s becomes p, dp becomes ds); the per-element
    // mask only where this warp's 16 x BS patch needs it
    const bool open = all_open(p, q0, q0 + BS - 1, k0 + 16 * w,
                               k0 + 16 * w + 15);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = 8 * j + 2 * t4 + c;
        const float l2 = cL[qc] * LOG2E, dls = cD[qc] * p.scale;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          float pv;
          if (open) {
            pv = exp2_approx(s[j][e] * c2 - l2);
          } else {
            const int ki = kr + 8 * r, qi = q0 + qc;
            const float val = allowed(p, qi, ki) ? s[j][e] * c2 : NEG2;
            pv = (qi < p.S && ki < p.Sk) ? exp2_approx(val - l2) : 0.f;
          }
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] * p.scale - dls);
        }
      }
    uint32_t ap[NT / 2][4], ads[NT / 2][4];
    to_a_frags<NT>(s, ap);
    to_a_frags<NT>(dp, ads);

    // dv += p^T.dO and dk += ds^T.q, dO and q read across their rows
#pragma unroll
    for (int t = 0; t < NT / 2; ++t)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (FULLD || c0 + 16 * np < D) {
          const int off = (16 * t + a_row(lane)) * LDS + c0 + 16 * np +
                          a_col(lane);
          uint32_t bo[4], bq[4];
          ldsm_x4_t(smem_addr(cDO + off), bo);
          ldsm_x4_t(smem_addr(cQ + off), bq);
          mma_bf16(dv[2 * np], ap[t], bo[0], bo[1]);
          mma_bf16(dv[2 * np + 1], ap[t], bo[2], bo[3]);
          mma_bf16(dk[2 * np], ads[t], bq[0], bq[1]);
          mma_bf16(dk[2 * np + 1], ads[t], bq[2], bq[3]);
        }
      }
  }
  cp_async_wait_all();

  bf16* dkp = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvp = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ki = kr + (e >> 1) * 8, d = c0 + 8 * n + 2 * t4 + (e & 1);
      if (ki < p.Sk && (FULLD || d < D)) {
        dkp[ki * p.dk_ss + d] = __float2bfloat16(dk[n][e]);
        dvp[ki * p.dv_ss + d] = __float2bfloat16(dv[n][e]);
      }
    }
}

// ------------------------------------------ bf16: wgmma + TMA path (_wg)
// Three warpgroups a block: two consumers (warpgroups 0 and 1) that run the
// products on wgmma, and a producer (warpgroup 2) whose first thread keeps
// WG_STAGES streamed tiles in flight by TMA (a ring of 2 stages: a third
// made the dk/dv pass ~5 % slower at D = 128 on an H100, and does not fit
// at D = 256).  The producer gives its registers to the consumers
// (setmaxnreg 24 / 240).
constexpr int WG_THREADS = 384;
constexpr int WG_STAGES = 2;
constexpr int WG_CONSUMER_WARPS = 8;
constexpr int WG_BQ = 64;        // q rows a streamed tile in the dk/dv pass

struct WgParams {
  CUtensorMap tq, tdo, tk, tv;
  Params p;
  float* part;  // dk/dv fp32 partials (2, chunks, B, H, Sk, D) if chunks > 1
  int chunks;
};

// The dk/dv pass's consumer roles: both accumulators, or (D == 256) dv
// with p, or dk with ds.
constexpr int kRoleBoth = 0, kRoleDv = 1, kRoleDk = 2;
template <int R>
struct Role {
  static constexpr int value = R;
};

// The same rows as fp32 partials, rows of 8 NO values.
template <int NO>
__device__ __forceinline__ void store_f32(const float (&acc)[NO][4],
                                          float* out, int r, int n, int t4) {
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ri = r + 8 * h;
      if (ri < n)
        *reinterpret_cast<float2*>(out + static_cast<int64_t>(ri) * 8 * NO +
                                   8 * j + 2 * t4) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

// dq pass: 128 resident q rows (64 a consumer warpgroup), k/v tiles of BK
// rows streamed.  s = q.k^T and dp = dO.v^T read q/dO and k/v along D
// (K-major); dq += ds.k takes ds from registers and reads k across its
// rows (MN-major).
template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dq_wg_kernel(const __grid_constant__ WgParams a) {
  constexpr int QROWS = 128, NT = BK / 8, NO = D / 8;
  constexpr uint32_t KV_BYTES = BK * D * 2;
  const Params& p = a.p;
  extern __shared__ unsigned char wg_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(wg_smem));  // D/64 x 128 x 64
  bf16* sDO = sQ + QROWS * D;
  bf16* sK = sDO + QROWS * D;                // WG_STAGES x D/64 x BK x 64
  bf16* sV = sK + WG_STAGES * BK * D;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + WG_STAGES * BK * D);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + WG_STAGES;

  const int n_tiles = (p.S + QROWS - 1) / QROWS;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.x)) * QROWS;
  const int bh = blockIdx.y;
  const int g = bh % p.G, h = (bh / p.G) % p.H, b = bh / (p.G * p.H);
  int hi = p.Sk;
  if (p.causal) hi = min(p.Sk, max(q0 + QROWS, p.prefix));
  int lo = 0;
  if (p.window > 0 && p.prefix == 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / BK) * BK;
  const int n_kv = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, WG_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warpgroup index, uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, 2 * QROWS * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_5d(sQ + c * QROWS * 64, &a.tq, qbar, 64 * c, q0, g, h, b);
        tma_load_5d(sDO + c * QROWS * 64, &a.tdo, qbar, 64 * c, q0, g, h, b);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % WG_STAGES, round = it / WG_STAGES;
        if (round > 0) mbar_wait_or_trap(empty + st, (round - 1) & 1);
        mbar_expect_tx(full + st, 2 * KV_BYTES);
        const int k0 = lo + it * BK;
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + (st * D + 64 * c) * BK, &a.tk, full + st, 64 * c,
                      k0, h, b);
          tma_load_4d(sV + (st * D + 64 * c) * BK, &a.tv, full + st, 64 * c,
                      k0, h, b);
        }
      }
    }
    return;
  }

  regs_inc<240>();
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int qr = q0w + 16 * w + g8;  // this thread's rows: qr and qr + 8
  const int64_t row0 = (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;
  const float c2 = p.scale * LOG2E;
  float lse2[2], dlts[2];  // lse in log2 units, delta * scale
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + 8 * r;
    lse2[r] = qi < p.S ? p.lse[row0 + qi] * LOG2E : 0.f;
    dlts[r] = qi < p.S ? p.delta[row0 + qi] * p.scale : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const uint32_t aQ = smem_addr(sQ) + wg * 64 * 128;
  const uint32_t aDO = smem_addr(sDO) + wg * 64 * 128;
  mbar_wait(qbar, 0);
  for (int it = 0; it < n_kv; ++it) {
    const int st = it % WG_STAGES;
    const int k0 = lo + it * BK;
    mbar_wait(full + st, (it / WG_STAGES) & 1);
    if (tile_live(p, q0w, q0w + 63, k0, k0 + BK - 1)) {
      const uint32_t tK = smem_addr(sK + st * BK * D);
      const uint32_t tV = smem_addr(sV + st * BK * D);
      float s[NT][4], dp[NT][4];
      // s = q.k^T, then dp = dO.v^T in a second group, so that p is
      // computed while dp's products run
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        WgmmaSS<BK>::run(s, kmajor(aQ, QROWS, ks), kmajor(tK, BK, ks), ks);
      wg_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        WgmmaSS<BK>::run(dp, kmajor(aDO, QROWS, ks), kmajor(tV, BK, ks), ks);
      wg_commit();
      wg_wait<1>();
      fence_acc(s);

      // p = exp(s*scale + mask - lse) in fp32; the per-element mask only
      // where this warp's 16 x BK patch needs it
      const bool open = all_open(p, q0w + 16 * w, q0w + 16 * w + 15, k0,
                                 k0 + BK - 1);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv;
          if (open) {
            pv = exp2_approx(s[j][e] * c2 - lse2[e >> 1]);
          } else {
            const int qi = qr + (e >> 1) * 8;
            const int ki = k0 + 8 * j + 2 * t4 + (e & 1);
            const float val = allowed(p, qi, ki) ? s[j][e] * c2 : NEG2;
            pv = (qi < p.S && ki < p.Sk) ? exp2_approx(val - lse2[e >> 1])
                                         : 0.f;
          }
          s[j][e] = pv;
        }
      // ds = p * (dp - delta) * scale in fp32
      wg_wait<0>();
      fence_acc(dp);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] * (dp[j][e] * p.scale - dlts[e >> 1]);
      uint32_t ads[NT / 2][4];
      to_a_frags<NT>(s, ads);

      wg_fence();
      fence_acc(acc);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        WgmmaRS<D>::run(acc, ads[kt], mnmajor(tK, BK, kt), 1);
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

  bf16* dqp = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh +
              g * p.dq_sg;
  store_bf16<NO>(acc, dqp, p.dq_ss, qr, p.S, t4);
}

// dk/dv pass: resident k/v rows, q/dO tiles of WG_BQ rows (with their lse
// and delta) streamed over this block's chunk of the G groups and the q
// range.  s^T = k.q^T and dp^T = v.dO^T read both operands along D; dv +=
// p^T.dO and dk += ds^T.q take p^T and ds^T from registers and read dO and
// q across their rows.  D <= 128 (SPLIT false): 128 kv rows a block, each
// consumer warpgroup 64 of them with both accumulators.  D == 256 (SPLIT):
// the two accumulators (128 registers each) do not fit one warpgroup, so
// 64 kv rows a block, warpgroup 0 computes s^T, p and dv, warpgroup 1 dp^T,
// ds and dk, and p passes from 0 to 1 in fp32 through shared memory (one
// buffer a stage; both warpgroups hold the same fragment layout, so thread
// t reads what thread t wrote).
template <int D, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ WgParams a) {
  constexpr int BQ = WG_BQ, KROWS = SPLIT ? 64 : 128;
  constexpr int NT = BQ / 8, NO = D / 8;
  constexpr uint32_t TMA_BYTES = 2 * BQ * D * 2;  // a stage's q and dO
  const Params& p = a.p;
  extern __shared__ unsigned char wg_smem[];
  bf16* sK = reinterpret_cast<bf16*>(align1024(wg_smem));  // D/64 x KROWS x 64
  bf16* sV = sK + KROWS * D;
  bf16* sQ = sV + KROWS * D;                  // WG_STAGES x D/64 x BQ x 64
  bf16* sDO = sQ + WG_STAGES * BQ * D;
  float* sL = reinterpret_cast<float*>(sDO + WG_STAGES * BQ * D);
  float* sD = sL + WG_STAGES * BQ;
  float* sP = sD + WG_STAGES * BQ;            // SPLIT: WG_STAGES x 64 x BQ
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(
      sP + (SPLIT ? WG_STAGES * 64 * BQ : 0));
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + WG_STAGES;

  const int k0 = blockIdx.x * KROWS;
  const int bh = blockIdx.y;
  const int h = bh % p.H, b = bh / p.H;
  const int g_lo = blockIdx.z * p.G / a.chunks;
  const int g_hi = (blockIdx.z + 1) * p.G / a.chunks;
  // q range that can see this kv tile.  A tile holding a prefix column is
  // seen by every query.
  int qlo = 0, qhi = p.S;
  if (!(p.prefix > 0 && k0 < p.prefix)) {
    if (p.causal) qlo = min(k0, p.S);
    if (p.window > 0) qhi = min(p.S, min(k0 + KROWS, p.Sk) - 1 + p.window);
  }
  qlo = (qlo / BQ) * BQ;
  const int n_q = qhi > qlo ? (qhi - qlo + BQ - 1) / BQ : 0;
  const int n_it = (g_hi - g_lo) * n_q;  // (group, q tile), group-major
  const int64_t rowb = static_cast<int64_t>(b * p.H + h) * p.G * p.S;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full + st, 1 + 32);  // lane 0's expect_tx, 32 lanes' copies
      mbar_init(empty + st, WG_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warpgroup index, uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer: its first warp
    regs_dec<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * KROWS * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(sK + c * KROWS * 64, &a.tk, kvbar, 64 * c, k0, h, b);
          tma_load_4d(sV + c * KROWS * 64, &a.tv, kvbar, 64 * c, k0, h, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % WG_STAGES, round = it / WG_STAGES;
        if (round > 0) mbar_wait_or_trap(empty + st, (round - 1) & 1);
        const int gg = g_lo + it / n_q, q0 = qlo + (it % n_q) * BQ;
        if (lane == 0) {
          mbar_expect_tx(full + st, TMA_BYTES);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_5d(sQ + (st * D + 64 * c) * BQ, &a.tq, full + st,
                        64 * c, q0, gg, h, b);
            tma_load_5d(sDO + (st * D + 64 * c) * BQ, &a.tdo, full + st,
                        64 * c, q0, gg, h, b);
          }
        }
        // lse and delta of the tile's rows (zeros past S): 4-byte copies,
        // which a row of any length allows (TMA needs 16-byte aligned
        // rows), each lane's landing counted by the stage's barrier
        const float* lsep = p.lse + rowb + gg * p.S;
        const float* dltp = p.delta + rowb + gg * p.S;
#pragma unroll
        for (int r = 0; r < BQ / 32; ++r) {
          const int qi = q0 + lane + 32 * r;
          const bool ok = qi < p.S;
          cp_async4(smem_addr(sL + st * BQ + lane + 32 * r),
                    ok ? lsep + qi : p.lse, ok ? 4 : 0);
          cp_async4(smem_addr(sD + st * BQ + lane + 32 * r),
                    ok ? dltp + qi : p.delta, ok ? 4 : 0);
        }
        mbar_arrive_cp_async(full + st);
      }
    }
    return;
  }

  regs_inc<240>();
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int k0w = SPLIT ? k0 : k0 + 64 * wg;
  const int kr = k0w + 16 * w + g8;  // this thread's rows: kr and kr + 8
  const float c2 = p.scale * LOG2E;
  const uint32_t aK = smem_addr(sK) + (SPLIT ? 0 : wg * 64 * 128);
  const uint32_t aV = smem_addr(sV) + (SPLIT ? 0 : wg * 64 * 128);

  // One consumer warpgroup's loop, its role fixed at compile time: both
  // accumulators, or (SPLIT) dv and p, or dk and ds.
  auto consume = [&](auto role) {
    constexpr int R = decltype(role)::value;
    constexpr bool DO_V = R != kRoleDk, DO_K = R != kRoleDv;
    float accv[DO_V ? NO : 1][4], acck[DO_K ? NO : 1][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (DO_V) accv[j][e] = 0.f;
        if constexpr (DO_K) acck[j][e] = 0.f;
      }
    mbar_wait(kvbar, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % WG_STAGES;
      const int q0 = qlo + (it % n_q) * BQ;
      mbar_wait(full + st, (it / WG_STAGES) & 1);
      if (tile_live(p, q0, q0 + BQ - 1, k0w, k0w + 63)) {
        const uint32_t tQ = smem_addr(sQ + st * BQ * D);
        const uint32_t tDO = smem_addr(sDO + st * BQ * D);
        const float* cL = sL + st * BQ;
        const float* cD = sD + st * BQ;
        float s[NT][4], dp[NT][4];  // s^T then p^T; dp^T then ds^T
        // s^T, then dp^T in a second group (BOTH), so that p^T is computed
        // while dp^T's products run
        constexpr bool TWO = DO_V && DO_K;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          if constexpr (DO_V)
            WgmmaSS<BQ>::run(s, kmajor(aK, KROWS, ks), kmajor(tQ, BQ, ks),
                             ks);
          if constexpr (DO_K && !TWO)
            WgmmaSS<BQ>::run(dp, kmajor(aV, KROWS, ks), kmajor(tDO, BQ, ks),
                             ks);
        }
        wg_commit();
        if constexpr (TWO) {
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks)
            WgmmaSS<BQ>::run(dp, kmajor(aV, KROWS, ks), kmajor(tDO, BQ, ks),
                             ks);
          wg_commit();
          wg_wait<1>();
        } else {
          wg_wait<0>();
        }
        fence_acc(s);
        float* xp = sP + st * 64 * BQ + t;
        if constexpr (DO_V) {
          // p^T = exp(s^T*scale + mask - lse) in fp32; the per-element
          // mask only where this warp's 16 x BQ patch needs it
          const bool open = all_open(p, q0, q0 + BQ - 1, k0w + 16 * w,
                                     k0w + 16 * w + 15);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * t4 + (e & 1);
              const float l2 = cL[qc] * LOG2E;
              float pv;
              if (open) {
                pv = exp2_approx(s[j][e] * c2 - l2);
              } else {
                const int ki = kr + 8 * (e >> 1), qi = q0 + qc;
                const float val = allowed(p, qi, ki) ? s[j][e] * c2 : NEG2;
                pv = (qi < p.S && ki < p.Sk) ? exp2_approx(val - l2) : 0.f;
              }
              s[j][e] = pv;
            }
        }
        if constexpr (R == kRoleDv) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) xp[(4 * j + e) * 128] = s[j][e];
          named_arrive(1 + st, 256);
        }
        if constexpr (R == kRoleDk) {
          named_sync(1 + st, 256);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = xp[(4 * j + e) * 128];
        }
        if constexpr (TWO) wg_wait<0>();
        fence_acc(dp);
        if constexpr (DO_K) {
          // ds^T = p^T * (dp^T - delta) * scale in fp32
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + 2 * t4 + (e & 1);
              dp[j][e] = s[j][e] * (dp[j][e] * p.scale - cD[qc] * p.scale);
            }
        }
        uint32_t ap[NT / 2][4], ads[NT / 2][4];
        if constexpr (DO_V) to_a_frags<NT>(s, ap);
        if constexpr (DO_K) to_a_frags<NT>(dp, ads);

        // dv += p^T.dO and dk += ds^T.q, dO and q read across their rows
        wg_fence();
        fence_acc(accv);
        fence_acc(acck);
#pragma unroll
        for (int kt = 0; kt < BQ / 16; ++kt) {
          if constexpr (DO_V)
            WgmmaRS<D>::run(accv, ap[kt], mnmajor(tDO, BQ, kt), 1);
          if constexpr (DO_K)
            WgmmaRS<D>::run(acck, ads[kt], mnmajor(tQ, BQ, kt), 1);
        }
        wg_commit();
        wg_wait<0>();
        fence_acc(accv);
        fence_acc(acck);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }

    if (a.chunks == 1) {
      if constexpr (DO_K)
        store_bf16<NO>(acck, static_cast<bf16*>(p.dk) + b * p.dk_sb +
                                 h * p.dk_sh, p.dk_ss, kr, p.Sk, t4);
      if constexpr (DO_V)
        store_bf16<NO>(accv, static_cast<bf16*>(p.dv) + b * p.dv_sb +
                                 h * p.dv_sh, p.dv_ss, kr, p.Sk, t4);
    } else {
      // partials (which, chunk, b, h, Sk, D); which 0 dk, 1 dv
      const int64_t blk = static_cast<int64_t>(p.Sk) * D;
      const int64_t bhc =
          (static_cast<int64_t>(blockIdx.z) * p.B + b) * p.H + h;
      const int64_t dv_off = static_cast<int64_t>(a.chunks) * p.B * p.H;
      if constexpr (DO_K) store_f32<NO>(acck, a.part + bhc * blk, kr, p.Sk, t4);
      if constexpr (DO_V)
        store_f32<NO>(accv, a.part + (dv_off + bhc) * blk, kr, p.Sk, t4);
    }
  };
  if constexpr (SPLIT) {
    if (wg == 0) consume(Role<kRoleDv>{});
    else consume(Role<kRoleDk>{});
  } else {
    consume(Role<kRoleBoth>{});
  }
}

// dk and dv from the fp32 partials of the dk/dv pass's group chunks: each
// value summed over the chunks in order 0, 1, ..., rounded to bf16 once.
// One thread a group of 4 columns.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_reduce_kernel(const float* part, Params p, int chunks) {
  const int64_t blk = static_cast<int64_t>(p.B) * p.H * p.Sk * D;
  const int64_t n4 = 2 * blk / 4;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = 4 * i;
    const int which = static_cast<int>(e / blk);
    const int64_t rest = e - which * blk;
    const float* src = part + which * chunks * blk + rest;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int c = 1; c < chunks; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(src + c * blk);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const int64_t row = rest / D;
    const int d = static_cast<int>(rest - row * D);
    const int ki = static_cast<int>(row % p.Sk);
    const int64_t bh = row / p.Sk;
    const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
    bf16* out = which == 0
                    ? static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh +
                          ki * p.dk_ss + d
                    : static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh +
                          ki * p.dv_ss + d;
    reinterpret_cast<__nv_bfloat162*>(out)[0] =
        __floats2bfloat162_rn(sum.x, sum.y);
    reinterpret_cast<__nv_bfloat162*>(out)[1] =
        __floats2bfloat162_rn(sum.z, sum.w);
  }
}

// The tensor maps of one pass: q and dO as 5-D (D, S, G, H, B), k and v as
// 4-D (D, Sk, H, B), boxes of 64 columns x the pass's rows.
bool make_maps(WgParams& a, int q_rows, int kv_rows) {
  const Params& p = a.p;
  return map_5d(&a.tq, p.q, p.B, p.H, p.G, p.S, p.D, p.q_sb, p.q_sh, p.q_sg,
                p.q_ss, q_rows) &&
         map_5d(&a.tdo, p.dout, p.B, p.H, p.G, p.S, p.D, p.do_sb, p.do_sh,
                p.do_sg, p.do_ss, q_rows) &&
         map_4d(&a.tk, p.k, p.B, p.H, p.Sk, p.D, p.k_sb, p.k_sh, p.k_ss,
                kv_rows) &&
         map_4d(&a.tv, p.v, p.B, p.H, p.Sk, p.D, p.v_sb, p.v_sh, p.v_ss,
                kv_rows);
}

template <typename Kernel>
cudaError_t launch_wg_kernel(Kernel kernel, dim3 grid, size_t smem,
                             cudaStream_t stream, const WgParams& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, WG_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int BK>
cudaError_t launch_dq_wg(WgParams& a, cudaStream_t stream) {
  if (!make_maps(a, 128, BK)) return cudaErrorInvalidValue;
  const size_t smem = 1024 + static_cast<size_t>(2 * 128 + 2 * WG_STAGES * BK) *
                                 D * 2 + (1 + 2 * WG_STAGES) * 8;
  const dim3 grid((a.p.S + 127) / 128, a.p.B * a.p.H * a.p.G);
  return launch_wg_kernel(flash_bwd_dq_wg_kernel<D, BK>, grid, smem, stream,
                          a);
}

template <int D, bool SPLIT>
cudaError_t launch_dkv_wg(WgParams& a, cudaStream_t stream) {
  constexpr int KROWS = SPLIT ? 64 : 128;
  if (!make_maps(a, WG_BQ, KROWS)) return cudaErrorInvalidValue;
  const size_t smem =
      1024 + static_cast<size_t>(2 * KROWS + 2 * WG_STAGES * WG_BQ) * D * 2 +
      2 * WG_STAGES * WG_BQ * 4 + (SPLIT ? WG_STAGES * 64 * WG_BQ * 4 : 0) +
      (1 + 2 * WG_STAGES) * 8;
  const dim3 grid((a.p.Sk + KROWS - 1) / KROWS, a.p.B * a.p.H, a.chunks);
  cudaError_t err = launch_wg_kernel(flash_bwd_dkv_wg_kernel<D, SPLIT>, grid,
                                     smem, stream, a);
  if (err != cudaSuccess || a.chunks == 1) return err;
  const int64_t n4 = 2LL * a.p.B * a.p.H * a.p.Sk * D / 4;
  const int64_t want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  flash_bwd_dkv_reduce_kernel<D><<<blocks, 256, 0, stream>>>(a.part, a.p,
                                                            a.chunks);
  return cudaGetLastError();
}

// D 64 and 128: k/v tiles of 64 rows in the dq pass; D 256: of 32 rows, so
// that dq's 128 accumulators, s, dp and ds fit a consumer's 240 registers
// and the stages the shared memory.
cudaError_t launch_wg_for_d(WgParams& a, bool dkv, cudaStream_t stream) {
  switch (a.p.D) {
    case 64: return dkv ? launch_dkv_wg<64, false>(a, stream)
                        : launch_dq_wg<64, 64>(a, stream);
    case 128: return dkv ? launch_dkv_wg<128, false>(a, stream)
                         : launch_dq_wg<128, 64>(a, stream);
    case 256: return dkv ? launch_dkv_wg<256, true>(a, stream)
                         : launch_dq_wg<256, 32>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Kernel>
cudaError_t launch_tc(Kernel kernel, dim3 grid, size_t smem,
                      cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TC_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KD, int DOUT, int BS, bool FULLD, int MINB>
cudaError_t launch_dq_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * TC_ROWS + 4 * BS) * (KD + 8) *
                      sizeof(bf16);
  const dim3 grid((p.S + TC_ROWS - 1) / TC_ROWS, p.B * p.H * p.G,
                  (p.D + DOUT - 1) / DOUT);
  return launch_tc(flash_bwd_dq_tc_kernel<KD, DOUT, BS, FULLD, MINB>, grid,
                   smem, stream, p);
}

template <int KD, int DOUT, int BS, bool FULLD, int MINB>
cudaError_t launch_dkv_tc(const Params& p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * TC_ROWS + 4 * BS) * (KD + 8) *
                          sizeof(bf16) + 4 * BS * sizeof(float);
  const dim3 grid((p.Sk + TC_ROWS - 1) / TC_ROWS, p.B * p.H,
                  (p.D + DOUT - 1) / DOUT);
  return launch_tc(flash_bwd_dkv_tc_kernel<KD, DOUT, BS, FULLD, MINB>, grid,
                   smem, stream, p);
}

// D == 128 (the models' head dim) takes instances without column guards:
// the dq pass streams 32-row k/v tiles at 3 blocks an SM (168 registers,
// 70 KB), the dk/dv pass 64-row q/dO tiles at 2 blocks an SM (255
// registers, 106 KB).  Other D stream 64 rows, or 32 for D > 128, whose
// output columns are split over two blocks.
cudaError_t launch_tc_for_d(const Params& p, bool dkv, cudaStream_t stream) {
  if (p.D == 128)
    return dkv ? launch_dkv_tc<128, 128, 64, true, 2>(p, stream)
               : launch_dq_tc<128, 128, 32, true, 3>(p, stream);
  if (p.D <= 64)
    return dkv ? launch_dkv_tc<64, 64, 64, false, 2>(p, stream)
               : launch_dq_tc<64, 64, 64, false, 2>(p, stream);
  if (p.D <= 128)
    return dkv ? launch_dkv_tc<128, 128, 64, false, 2>(p, stream)
               : launch_dq_tc<128, 128, 64, false, 2>(p, stream);
  return dkv ? launch_dkv_tc<256, 128, 32, false, 1>(p, stream)
             : launch_dq_tc<256, 128, 32, false, 1>(p, stream);
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

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, const int64_t* dims,
                   const int64_t* st, int causal, int window, int prefix,
                   float scale) {
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
  p.vec = p.D % 8 == 0;
  const void* operands[] = {q, k, v, dout};
  for (const void* ptr : operands)
    p.vec = p.vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (int i = 0; i < 14; ++i) p.vec = p.vec && st[i] % 8 == 0;
  return p;
}

// The wgmma route's conditions (the wrapper's _bwd_route decides the same
// from the shape): D in {64, 128, 256}, every operand pointer and stride
// 16-byte aligned (TMA), lse and delta too.
bool wg_route_ok(const Params& p) {
  return (p.D == 64 || p.D == 128 || p.D == 256) && p.vec &&
         reinterpret_cast<uintptr_t>(p.lse) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p.delta) % 16 == 0 &&
         static_cast<int64_t>(p.B) * p.H * p.G * p.S < (int64_t(1) << 31);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        const int64_t* dims, const int64_t* st, int dtype, int route,
        int chunks, void* part, int causal, int window, int prefix,
        float scale, void* stream, bool dkv) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, dims,
                               st, causal, window, prefix, scale);
  if (p.D < 1 || p.D > 256 || p.S < 1 || p.Sk < 1 ||
      static_cast<int64_t>(p.B) * p.H * p.G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0 && dtype == 0)
    return static_cast<int>(launch_for_d<float>(p, dkv, s));
  if (route == 1 && dtype == 1)
    return static_cast<int>(launch_tc_for_d(p, dkv, s));
  if (route == 2 && dtype == 1 && wg_route_ok(p) && chunks >= 1 &&
      chunks <= p.G && (chunks == 1 || part != nullptr)) {
    WgParams a;
    a.p = p;
    a.part = static_cast<float*>(part);
    a.chunks = chunks;
    return static_cast<int>(launch_wg_for_d(a, dkv, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dims: B, H (= n_kv), G, S, Sk, D.
// strides (in elements): q b,h,g,s; k b,h,s; v b,h,s; dout b,h,g,s;
// dq b,h,g,s; dk b,h,s; dv b,h,s.  The last dimension of each is
// contiguous; lse and delta are contiguous (B, H, G, S) fp32.  dtype: 0
// float32, 1 bfloat16 (all of q, k, v, dout, dq, dk, dv).  route: 0 the
// fp32 kernels, 1 the bf16 mma.sync kernels (_tc), 2 the bf16 wgmma
// kernels (_wg), which the caller chooses; a route that does not take
// these inputs returns cudaErrorInvalidValue.  chunks (route 2, dk/dv
// pass): the G groups are summed in that many chunks of blocks, each into
// fp32 partials in `part` ((2, chunks, B, H, Sk, D) fp32, unused when
// chunks == 1) that a second kernel sums in order and rounds.  Each call
// launches one kernel (two for the chunked dk/dv pass) and returns a
// cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, void* dk, void* dv,
                            const int64_t* dims, const int64_t* strides,
                            int dtype, int route, int chunks, void* part,
                            int causal, int window, int prefix, float scale,
                            void* stream) {
  return run(q, k, v, dout, lse, delta, dq, dk, dv, dims, strides, dtype,
             route, chunks, part, causal, window, prefix, scale, stream,
             false);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             const int64_t* dims, const int64_t* strides,
                             int dtype, int route, int chunks, void* part,
                             int causal, int window, int prefix, float scale,
                             void* stream) {
  return run(q, k, v, dout, lse, delta, dq, dk, dv, dims, strides, dtype,
             route, chunks, part, causal, window, prefix, scale, stream,
             true);
}

// Host microseconds a call of building one pass's four tensor maps (the
// dk/dv pass's: q, dO, k, v), the mean over `reps` builds; -1 if a map
// cannot be built for these inputs.  For measurement: each launch on the
// wgmma route builds its maps so.
extern "C" double flash_bwd_map_us(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const int64_t* dims,
                                   const int64_t* strides, int reps) {
  WgParams a;
  a.p = make_params(q, k, v, dout, lse, delta, nullptr, nullptr, nullptr,
                    dims, strides, 1, 0, 0, 1.f);
  a.chunks = 1;
  a.part = nullptr;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (!make_maps(a, WG_BQ, 128)) return -1.0;
  const std::chrono::duration<double, std::micro> us =
      std::chrono::steady_clock::now() - t0;
  return us.count() / (reps > 0 ? reps : 1);
}
