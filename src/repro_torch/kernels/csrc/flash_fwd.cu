// Flash-attention forward pass for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_fwd_pallas` (body `_fwd_kernel`) of
// src/repro/kernels/flash_attention.py.  Same function: online-softmax
// attention of q (B, n_kv, G, S, D) over k, v (B, n_kv, Sk, D) with causal,
// sliding-window and prefix-LM masks built from indices and the finite
// -1e30 sentinel, columns past Sk at -inf, returning `out` in q's dtype
// and the fp32 log-sum-exp `lse = m + log(max(l, 1e-30))`.  q head (h, g)
// reads kv head h, so GQA needs no repeated k/v.
//
// What bounds it on this card.  At the training slice's shape (B=2, 32
// heads, S=4096, D=128, causal, bf16) the two products over the causal
// triangle are 2.75e11 FLOP against ~0.27 GB of q/k/v/out: ~1000 FLOP a
// byte, far above the H100's bf16 ridge of ~295, so the kernel is bound by
// operations, and only the tensor cores (989 TFLOP/s bf16, dense) come
// near the bound.  At the serving shape (B=4, S=1024) it is ~256 FLOP a
// byte, about at the ridge: there the bytes bound it, barely.  Besides the
// products, each score costs an exp2 on the 16-a-clock MUFU unit: half the
// products' time at D = 128, so the softmax must run beside the products.
//
// Three routes, which the caller chooses (see the C interface at the end).
//
// The wgmma route (flash_fwd_wg_kernel; bf16, D in {64, 128, 256}, every
// operand 16-byte aligned: every model's serving and training shape),
// designed for Hopper's tensor cores and copy engine:
//   * Three warpgroups, 128 q rows a block: two consumers of 64 rows each
//     that run both products on wgmma, and a producer whose first thread
//     loads the q tile once and keeps a ring of 2 stages of k/v tiles in
//     flight by TMA, with full and empty mbarriers for k and for v apart,
//     so that a stage's k is refilled while its v is still read.  It gives
//     its registers to the consumers (setmaxnreg 24 / 240).
//   * Loads by TMA from a 5-D map over q (D, S, G, H, B) and 4-D maps over
//     k and v (D, Sk, H, B), built on the host at every call over the
//     wrapper's strided views: boxes of 64 columns, 128-byte swizzle, rows
//     past S or Sk filled with zeros.
//   * Products: s = q.k^T with both operands read from shared memory along
//     D (K-major); o += p.v with p from registers (the m16n8 accumulators
//     of two adjacent n8 score tiles are the m16k16 A fragment) and v read
//     across its rows (wgmma's transpose flag).  All of D in one block:
//     at D = 256 a consumer thread holds 128 fp32 O accumulators, so its
//     k/v tiles are 64 rows (128 at D = 64 and 128), which keeps O, s and
//     p in the 240 registers without a spill.
//   * Overlap, both of FA3's: each consumer issues tile i's q.k^T and tile
//     i - 1's p.v together and computes tile i's softmax while p.v runs
//     (o is rescaled by alpha only after that p.v is waited for); and the
//     two consumers take turns to issue (named barriers), each computing
//     its softmax while the other's products run.  The turns need both to
//     walk every tile of the block: the tiles hidden from one consumer's
//     rows run masked, which changes no value (see the kernel).
//   * Block order: heads in groups of 8, and in a group the q tiles
//     reversed, heads fastest: the blocks in flight share a few heads' k/v
//     in L2, and each group's longest causal tiles start first.
//   * No trap in the consumers' code (ptxas would compile it to the
//     block's entry register count and spill); only the producer's waits
//     carry a watchdog.
//
// The mma route (flash_fwd_tc_kernel: bf16 with other D, or views that are
// not 16-byte aligned):
//   * Both products run on the tensor cores as
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with fp32 accumulators:
//     S = Q.K^T with k as stored ([n][k], plain ldmatrix), O += P.V with v
//     read across its rows (ldmatrix .trans).  Each warp owns 32 q rows, two
//     m16 tiles, so that every k and v fragment it loads feeds both; their
//     Q fragments come from the q tile, resident in shared memory.
//   * k/v tiles of BS rows are staged as bf16 in a 2-stage ring of 16-byte
//     cp.async.cg copies: the next tile loads while the current one
//     multiplies, one barrier an iteration, copy addresses computed once a
//     tile, rows past Sk zero-filled by the copy itself.  Rows are padded
//     to KD + 8 elements so that the 8 rows of each ldmatrix 8x8 load hit
//     distinct banks; columns from D up to the next multiple of 16 are
//     zero, so D = 40, 80, ... take whole k-steps of 16.  A pointer or
//     stride that is not 16-byte aligned, or D not a multiple of 8, takes
//     plain 2-byte loads into the same layout.
//   * 4 warps, 128 q rows a block, 2 blocks an SM at D = 128 (255
//     registers, 102 KB of shared memory each).  The grid runs batch x
//     head fastest and the q tiles in reverse.  D > 128 splits the output
//     columns over blockIdx.z in blocks of 128, each recomputing the
//     scores, so that the O accumulators fit.  kv tiles that the causal or
//     window mask hides from the whole q tile are skipped, and a warp skips
//     the tiles that the causal mask hides from its 32 rows (a tile that
//     `prefix` opens never is).
//
// Both bf16 routes share the arithmetic:
//   * P stays in registers, rounded to bf16 once, as the A operand of P.V.
//     The row max reduces over the 4 lanes that share a row (two
//     shuffles); the row sum l is kept per lane, from the fp32 p before
//     rounding, and reduced once at the end; alpha = 2^(m_old - m_new)
//     rescales the O accumulators once a tile.  p is one FFMA and one
//     MUFU.EX2 in log2 units (the -1e30 sentinel becomes NEG2); lse is
//     converted back to natural log when stored.
//   * Rounding: s is an fp32 sum of exact products of bf16 inputs, p is
//     fp32 until it is rounded to bf16 for P.V, O is summed in fp32 and
//     rounded to bf16 once, when stored.
//   * The mask is applied per element only in the 16-row patches that a
//     causal / window / prefix boundary or the ragged edge at Sk crosses.
//     A row whose first visited tile is wholly masked accumulates values
//     computed against the sentinel max, which the next tile's alpha =
//     2^(NEG2 - m) = 0 wipes out; columns past Sk are -inf and never count.
//   * A negative scale runs as (-q).k.|scale|: the q tile is negated in
//     shared memory (exact in bf16), since the row max is taken over
//     unscaled scores and needs a positive scale.
//
// fp32 inputs (dtype 0, used by tests on the card) keep the first design,
// scalar FMA on the CUDA cores with fp32 tiles in shared memory
// (flash_fwd_kernel): TF32 tensor cores would not hold the fp32 limit of
// 3e-4.
//
// q, k, v and out are read and written through their strides (the last
// dimension must be contiguous), so the wrapper passes permuted views of
// the model's (B, S, H, D) tensors without copies.  Any D <= 256 and any
// ragged S or Sk is handled by masking.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG = -1e30f;
constexpr float NEG2 = NEG * LOG2E;  // the mask sentinel in log2 units
constexpr float LN2 = 0.6931471805599453f;

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
  int vec;   // bf16 path: every operand row 16-byte aligned, D % 8 == 0
  int negq;  // bf16 path: the caller's scale was negative (see below)
};

__device__ __forceinline__ bool allowed(const Params& p, int qi, int ki) {
  bool allow = true;
  if (p.causal) allow = ki <= qi;
  if (p.window) allow = allow && (qi - ki) < p.window;
  if (p.prefix) allow = allow || ki < p.prefix;
  return allow;
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

// ------------------------------------------------ fp32: scalar CUDA cores
// NC = output columns per thread (D <= 16 * NC).
template <int NC>
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

  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb +
                    h * p.q_sh + g * p.q_sg;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int e = tid; e < BQ * D; e += NTHREADS) {
    const int r = e / D, c = e - (e / D) * D;
    const int qi = q0 + r;
    sQ[r * ld + c] = qi < p.S ? qp[qi * p.q_ss + c] : 0.f;
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
      sK[r * ld + c] = in ? kp[ki * p.k_ss + c] : 0.f;
      sV[r * ld + c] = in ? vp[ki * p.v_ss + c] : 0.f;
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
        float val = allowed(p, qi, ki) ? s[r][c] * p.scale : NEG;
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

  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + g * p.o_sg;
  float* lp = p.lse + (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= p.S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int d = tx + 16 * cc;
      if (d < D) op[qi * p.o_ss + d] = acc[r][cc] / lc;
    }
    if (tx == 0) lp[qi] = m[r] + logf(lc);
  }
}

// ------------------------------------------------- bf16: tensor cores
// True when every (qi, ki) with qi in [qlo, qhi], ki in [klo, khi] is
// allowed and ki < Sk, so that the patch needs no per-element mask (rows
// past S are never stored; a patch opened only partly by `prefix` takes
// the masked path).
__device__ __forceinline__ bool all_open(const Params& p, int qlo, int qhi,
                                         int klo, int khi) {
  if (khi >= p.Sk) return false;
  bool open = true;
  if (p.causal) open = khi <= qlo;
  if (p.window) open = open && (qhi - klo) < p.window;
  if (p.prefix) open = open || khi < p.prefix;
  return open;
}

// NW warps of 32 q rows (two m16 tiles each); k/v tiles of BS rows; output
// columns [c0, c0 + DOUT) of D <= KD.  FULLD: D == KD == DOUT (no padded
// or split columns).  8 / NW blocks an SM leave each thread 255 registers.
template <int NW, int KD, int DOUT, int BS, bool FULLD>
__global__ void __launch_bounds__(32 * NW, 8 / NW)
    flash_fwd_tc_kernel(Params p) {
  static_assert(!FULLD || DOUT == KD, "FULLD needs one column block");
  constexpr int THREADS = 32 * NW, BQT = 32 * NW, LDS = KD + 8;
  constexpr int NT = BS / 8, NO = DOUT / 8, KS = KD / 16;
  constexpr int STAGE = 2 * BS * LDS;  // one ring stage: k then v
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(tc_smem);  // BQT x LDS
  bf16* ring = sQ + BQT * LDS;                   // 2 stages

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int n_tiles = (p.S + BQT - 1) / BQT;
  const int q0 = (n_tiles - 1 - static_cast<int>(blockIdx.y)) * BQT;
  const int bh = blockIdx.x;
  const int g = bh % p.G, h = (bh / p.G) % p.H, b = bh / (p.G * p.H);
  const int c0 = FULLD ? 0 : blockIdx.z * DOUT;
  const int D = FULLD ? KD : p.D, dpad = FULLD ? KD : (D + 15) & ~15;
  const bool vec = p.vec != 0;

  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh +
                   g * p.q_sg;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // kv range this q tile can see; wholly masked tiles are skipped.
  int hi = p.Sk;
  if (p.causal) hi = min(p.Sk, max(q0 + BQT, p.prefix));
  int lo = 0;
  if (p.window > 0 && p.prefix == 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / BS) * BS;
  const int n_kv = hi > lo ? (hi - lo + BS - 1) / BS : 0;

  auto load_kv = [&](int k0, int st) {
    load_tile_rows<THREADS, BS, KD, FULLD>(ring + st * STAGE, kp, p.k_ss, k0,
                                           p.Sk, D, dpad, vec);
    load_tile_rows<THREADS, BS, KD, FULLD>(ring + st * STAGE + BS * LDS, vp,
                                           p.v_ss, k0, p.Sk, D, dpad, vec);
  };
  load_tile_rows<THREADS, BQT, KD, FULLD>(sQ, qp, p.q_ss, q0, p.S, D, dpad,
                                          vec);
  if (n_kv > 0) load_kv(lo, 0);
  cp_async_commit();
  if (p.negq) {
    // A negative scale runs as (-q).k.|scale| = q.k.scale: the row max
    // below is taken over unscaled scores and needs a positive scale.
    // bf16 negation is exact.  The loop's first barrier publishes the
    // flipped tile before any warp reads it.
    cp_async_wait_all();
    __syncthreads();
    uint32_t* q32 = reinterpret_cast<uint32_t*>(sQ);
    for (int e = threadIdx.x; e < BQT * LDS / 2; e += THREADS)
      q32[e] ^= 0x80008000u;
  }

  // this warp's rows qw + 16 mt + g8 (+ 8); m in log2 units, l this
  // lane's part of the row sum
  const int qw = q0 + 32 * w;
  const bf16* aQ = sQ + (32 * w + a_row(lane)) * LDS + a_col(lane);
  const float c2 = p.scale * LOG2E;
  float m2[2][2], l[2][2], o[2][NO][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    m2[mt][0] = m2[mt][1] = NEG2;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
  }

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = lo + it * BS;
    const bf16* cK = ring + (it & 1) * STAGE;
    const bf16* cV = cK + BS * LDS;
    // tile `it` (and at it == 0 the q tile) has landed, and every warp is
    // done with tile it - 1, whose stage the next tile now fills while
    // this one multiplies
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_kv) load_kv(k0 + BS, (it + 1) & 1);
    cp_async_commit();
    // a tile that the causal mask hides from all 32 rows of this warp
    if (p.causal && k0 > qw + 31 && !(p.prefix > 0 && k0 < p.prefix))
      continue;

    // s = q.k^T for this warp's 2 x 16 rows x BS columns; each k fragment
    // feeds both m tiles
    float s[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (FULLD || ks * 16 < dpad) {
        uint32_t aq[2][4];
        ldsm_x4(smem_addr(aQ + 16 * ks), aq[0]);
        ldsm_x4(smem_addr(aQ + 16 * LDS + 16 * ks), aq[1]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(smem_addr(cK + (16 * np + b_row(lane)) * LDS + 16 * ks +
                            b_col(lane)), bk);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(s[mt][2 * np], aq[mt], bk[0], bk[1]);
            mma_bf16(s[mt][2 * np + 1], aq[mt], bk[2], bk[3]);
          }
        }
      }
    }

    uint32_t ap[2][NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // the row max; the per-element mask only where this 16 x BS patch
      // needs it, and there s becomes s * c2 or a sentinel, in log2 units
      // like m, so that p = 2^(s * a - m) with a = c2 or 1
      const int qm = qw + 16 * mt, qr = qm + g8;
      const bool open = all_open(p, qm, qm + 15, k0, k0 + BS - 1);
      const float a = open ? c2 : 1.f;
      if (!open) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qr + (e >> 1) * 8;
            const int ki = k0 + 8 * j + 2 * t4 + (e & 1);
            s[mt][j][e] = ki >= p.Sk ? -INFINITY
                          : allowed(p, qi, ki) ? s[mt][j][e] * c2 : NEG2;
          }
      }
      float mx[2] = {NEG2, NEG2}, alpha[2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m2[mt][r], mx[r] * a);  // a > 0
        alpha[r] = exp2_approx(m2[mt][r] - m_new);
        m2[mt][r] = m_new;
      }

      // p in fp32, one FFMA and one MUFU.EX2; l from it before rounding
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv =
              exp2_approx(fmaf(s[mt][j][e], a, -m2[mt][e >> 1]));
          s[mt][j][e] = pv;
          rs[e >> 1] += pv;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][n][e] *= alpha[e >> 1];
      to_a_frags<NT>(s[mt], ap[mt]);
    }

    // o += p.v, v read across its rows (.trans); each v fragment feeds
    // both m tiles
#pragma unroll
    for (int t = 0; t < NT / 2; ++t)
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        if (FULLD || c0 + 16 * np < D) {
          uint32_t bv[4];
          ldsm_x4_t(smem_addr(cV + (16 * t + a_row(lane)) * LDS + c0 +
                              16 * np + a_col(lane)), bv);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(o[mt][2 * np], ap[mt][t], bv[0], bv[1]);
            mma_bf16(o[mt][2 * np + 1], ap[mt][t], bv[2], bv[3]);
          }
        }
      }
  }
  cp_async_wait_all();

  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + g * p.o_sg;
  float* lp = p.lse + (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float lc = fmaxf(lr, 1e-30f), inv = 1.f / lc;
      const int qi = qw + 16 * mt + g8 + 8 * r;
      if (qi >= p.S) continue;
      bf16* orow = op + qi * p.o_ss;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = c0 + 8 * n + 2 * t4;
        const float x0 = o[mt][n][2 * r] * inv;
        const float x1 = o[mt][n][2 * r + 1] * inv;
        if (vec) {
          if (FULLD || d < D)
            *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(x0, x1);
        } else {
          if (FULLD || d < D) orow[d] = __float2bfloat16(x0);
          if (FULLD || d + 1 < D) orow[d + 1] = __float2bfloat16(x1);
        }
      }
      if (t4 == 0 && (FULLD || blockIdx.z == 0))
        lp[qi] = m2[mt][r] * LN2 + logf(lc);
    }
}

template <int NW, int KD, int DOUT, int BS, bool FULLD>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  // the q tile, then the ring's 2 stages of k and v tiles
  constexpr int BQT = 32 * NW;
  const size_t smem =
      static_cast<size_t>(BQT + 4 * BS) * (KD + 8) * sizeof(bf16);
  auto kernel = flash_fwd_tc_kernel<NW, KD, DOUT, BS, FULLD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // batch x head fastest, q tiles reversed: every head's longest causal
  // tiles start first, so the tail of the grid is short
  const dim3 grid(p.B * p.H * p.G, (p.S + BQT - 1) / BQT,
                  (p.D + DOUT - 1) / DOUT);
  kernel<<<grid, 32 * NW, smem, stream>>>(p);
  return cudaGetLastError();
}

// Every D takes 4 warps (32 q rows each).  D == 128 (the models' head dim)
// takes the instance without column guards, against 64-row kv tiles: 2
// blocks an SM (255 registers, 102 KB).  Other D take 64-row tiles, or
// 32-row tiles for D > 128, whose output columns are split over two
// blocks.
cudaError_t launch_tc_for_d(const Params& p, cudaStream_t stream) {
  if (p.D == 128) return launch_tc<4, 128, 128, 64, true>(p, stream);
  if (p.D <= 64) return launch_tc<4, 64, 64, 64, false>(p, stream);
  if (p.D <= 128) return launch_tc<4, 128, 128, 64, false>(p, stream);
  return launch_tc<4, 256, 128, 32, false>(p, stream);
}

// ------------------------------------------ bf16: wgmma + TMA route (_wg)
// Three warpgroups a block: two consumers of 64 q rows each (128 q rows a
// block) that run both products on wgmma, and a producer whose first
// thread loads the q tile once and keeps a ring of WG_STAGES k/v tiles in
// flight by TMA, and which gives its registers to the consumers
// (setmaxnreg 24 / 240).
constexpr int WG_THREADS = 384;
constexpr int WG_STAGES = 2;  // a third stage gained nothing (PERF.md)
constexpr int WG_QROWS = 128;
constexpr int WG_CONSUMER_WARPS = 8;

struct WgParams {
  CUtensorMap tq, tk, tv;
  Params p;
};

// The online softmax of one 16 x (8 NT) patch of scores (this warp's rows
// qm .. qm + 15, keys k0 ..): s (fp32 q.k sums) becomes p = 2^(s c2 - m)
// in fp32, m (log2 units) and this lane's part of the row sum l move on,
// and alpha = 2^(m_old - m_new) is what the O accumulators must be scaled
// by.  The per-element mask only where the patch needs it; there s becomes
// s c2 or the sentinel, columns past Sk -inf.  c2 > 0.
template <int NT>
__device__ __forceinline__ void softmax_patch(const Params& p,
                                              float (&s)[NT][4],
                                              float (&m2)[2], float (&l)[2],
                                              float (&alpha)[2], int qm,
                                              int k0, int g8, int t4,
                                              float c2) {
  const bool open = all_open(p, qm, qm + 15, k0, k0 + 8 * NT - 1);
  const float a = open ? c2 : 1.f;
  if (!open) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qm + g8 + (e >> 1) * 8;
        const int ki = k0 + 8 * j + 2 * t4 + (e & 1);
        s[j][e] = ki >= p.Sk ? -INFINITY
                  : allowed(p, qi, ki) ? s[j][e] * c2 : NEG2;
      }
  }
  float mx[2] = {NEG2, NEG2};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m2[r], mx[r] * a);
    alpha[r] = exp2_approx(m2[r] - m_new);
    m2[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = exp2_approx(fmaf(s[j][e], a, -m2[e >> 1]));
      s[j][e] = pv;
      rs[e >> 1] += pv;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// Heads (batch x kv head x group) a group of the block order.
constexpr int WG_HEAD_GROUP = 8;

// D: head dim (64, 128, 256); BK: k/v rows a tile.  One block: 128 q rows
// of one (batch, kv head, group).
template <int D, int BK>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_fwd_wg_kernel(const __grid_constant__ WgParams a) {
  constexpr int QROWS = WG_QROWS, STAGES = WG_STAGES, NT = BK / 8,
                NO = D / 8;
  constexpr uint32_t KV_BYTES = BK * D * 2;
  const Params& p = a.p;
  extern __shared__ unsigned char wg_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(wg_smem));  // D/64 x 128 x 64
  bf16* sK = sQ + QROWS * D;                  // STAGES x D/64 x BK x 64
  bf16* sV = sK + STAGES * BK * D;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + STAGES * BK * D);
  uint64_t* kfull = qbar + 1;   // k and v have their own barriers, so that
  uint64_t* vfull = kfull + STAGES;  // a stage's k is refilled while its v
  uint64_t* kempty = vfull + STAGES;  // is still read
  uint64_t* vempty = kempty + STAGES;

  // Block order: heads in groups of WG_HEAD_GROUP, and in a group the q
  // tiles reversed, heads fastest.  The blocks in flight then read the k/v
  // of a few heads, which stay in L2, and the longest causal tiles of each
  // group start first.
  const int n_tiles = (p.S + QROWS - 1) / QROWS;
  const int n_heads = p.B * p.H * p.G;
  const int group = blockIdx.x / (WG_HEAD_GROUP * n_tiles);
  const int in_group = blockIdx.x - group * WG_HEAD_GROUP * n_tiles;
  const int heads = min(WG_HEAD_GROUP, n_heads - group * WG_HEAD_GROUP);
  const int q0 = (n_tiles - 1 - in_group / heads) * QROWS;
  const int bh = group * WG_HEAD_GROUP + in_group % heads;
  const int g = bh % p.G, h = (bh / p.G) % p.H, b = bh / (p.G * p.H);
  // kv range this q tile can see; wholly masked tiles are not loaded
  int hi = p.Sk;
  if (p.causal) hi = min(p.Sk, max(q0 + QROWS, p.prefix));
  int lo = 0;
  if (p.window > 0 && p.prefix == 0) lo = max(0, q0 - p.window + 1);
  lo = (lo / BK) * BK;
  const int n_kv = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kfull + st, 1);
      mbar_init(vfull + st, 1);
      mbar_init(kempty + st, WG_CONSUMER_WARPS);
      mbar_init(vempty + st, WG_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warpgroup index, uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, QROWS * D * 2);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_5d(sQ + c * QROWS * 64, &a.tq, qbar, 64 * c, q0, g, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % STAGES, round = it / STAGES;
        const int k0 = lo + it * BK;
        if (round > 0) mbar_wait_or_trap(kempty + st, (round - 1) & 1);
        mbar_expect_tx(kfull + st, KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + (st * D + 64 * c) * BK, &a.tk, kfull + st, 64 * c,
                      k0, h, b);
        if (round > 0) mbar_wait_or_trap(vempty + st, (round - 1) & 1);
        mbar_expect_tx(vfull + st, KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV + (st * D + 64 * c) * BK, &a.tv, vfull + st, 64 * c,
                      k0, h, b);
      }
    }
    return;
  }

  regs_inc<240>();
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int qm = q0w + 16 * w;       // this warp's 16 rows
  const int qr = qm + g8;            // this thread's rows: qr and qr + 8
  const float c2 = p.scale * LOG2E;
  float o[NO][4], m2[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const uint32_t aQ = smem_addr(sQ) + wg * 64 * 128;
  auto phase = [](int it) { return static_cast<uint32_t>(it / STAGES) & 1; };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // The two consumers take turns to issue their products: warpgroup wg
  // issues after a sync on its named barrier and hands the turn over with
  // an arrival on the other's, so that each computes its softmax while the
  // other's products run.  Warpgroup 0 goes first.
  auto my_turn = [&]() { named_sync(3 + wg, 256); };
  auto your_turn = [&]() { named_arrive(4 - wg, 256); };
  // s = q.k^T over this warpgroup's 64 rows, k read along D (K-major)
  auto qk = [&](float (&s)[NT][4], int it) {
    const uint32_t tK = smem_addr(sK + (it % STAGES) * BK * D);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      WgmmaSS<BK>::run(s, kmajor(aQ, QROWS, ks), kmajor(tK, BK, ks), ks);
  };
  // o += p.v, p from registers, v read across its rows (MN-major)
  auto pv = [&](uint32_t (&ap)[NT / 2][4], int it) {
    const uint32_t tV = smem_addr(sV + (it % STAGES) * BK * D);
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt)
      WgmmaRS<D>::run(o, ap[kt], mnmajor(tV, BK, kt), 1);
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
  };

  mbar_wait(qbar, 0);
  if (p.negq) {
    // A negative scale runs as (-q).k.|scale| = q.k.scale: the row max is
    // taken over unscaled scores and needs a positive scale.  bf16
    // negation is exact.  Each warpgroup flips its own 64 rows; wgmma
    // reads them through the async proxy, hence the proxy fence.
    uint4* q4 = reinterpret_cast<uint4*>(sQ);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int i = t; i < 64 * 8; i += 128) {
        uint4& x = q4[(c * QROWS + wg * 64) * 8 + i];
        x.x ^= 0x80008000u;
        x.y ^= 0x80008000u;
        x.z ^= 0x80008000u;
        x.w ^= 0x80008000u;
      }
    fence_proxy_async();
    named_sync(1 + wg, 128);
  }

  // Both warpgroups walk every tile of the block, as the turns need: a
  // tile that the mask hides from a warpgroup's 64 rows runs masked.  Past
  // its last live tile a row's p is exactly 0 there; before its first, the
  // values it sums against the sentinel max are wiped by the next tile's
  // alpha = 2^(NEG2 - m) = 0; and a tile between them (only where a window
  // and a prefix leave a gap) comes after the row's prefix keys, so its p
  // is 0.  Tile 0 alone; then each step issues q.k^T of tile it and p.v of
  // tile it - 1, and computes tile it's softmax while p.v runs: o may be
  // rescaled only once p.v is done.
  if (wg == 1) your_turn();
  if (n_kv > 0) {
    uint32_t ap[NT / 2][4];
    {
      float s[NT][4], alpha[2];
      mbar_wait(kfull, 0);
      my_turn();
      wg_fence();
      qk(s, 0);
      wg_commit();
      your_turn();
      wg_wait<0>();
      fence_acc(s);
      release(kempty);
      softmax_patch<NT>(p, s, m2, l, alpha, qm, lo, g8, t4, c2);
      to_a_frags<NT>(s, ap);  // o is 0: nothing to rescale
    }
    for (int it = 1; it < n_kv; ++it) {
      float s[NT][4], alpha[2];
      mbar_wait(kfull + it % STAGES, phase(it));
      mbar_wait(vfull + (it - 1) % STAGES, phase(it - 1));
      my_turn();
      wg_fence();
      qk(s, it);
      wg_commit();
      fence_acc(o);
      pv(ap, it - 1);
      wg_commit();
      your_turn();
      wg_wait<1>();
      fence_acc(s);
      release(kempty + it % STAGES);
      softmax_patch<NT>(p, s, m2, l, alpha, qm, lo + it * BK, g8, t4, c2);
      wg_wait<0>();
      fence_acc(o);
      fence_frag(ap);
      release(vempty + (it - 1) % STAGES);
      rescale(alpha);
      to_a_frags<NT>(s, ap);
    }
    const int last = n_kv - 1;
    mbar_wait(vfull + last % STAGES, phase(last));
    my_turn();
    wg_fence();
    fence_acc(o);
    pv(ap, last);
    wg_commit();
    your_turn();
    wg_wait<0>();
    fence_acc(o);
    fence_frag(ap);
    release(vempty + last % STAGES);
  }
  if (wg == 0) my_turn();  // warpgroup 1's last hand-over

  // out = o / l, rounded to bf16 once; lse = m ln 2 + log(max(l, 1e-30))
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh + g * p.o_sg;
  float* lp = p.lse + (static_cast<int64_t>(b * p.H + h) * p.G + g) * p.S;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lc = fmaxf(lr, 1e-30f);
    inv[r] = __fdividef(1.f, lc);
    const int qi = qr + 8 * r;
    if (t4 == 0 && qi < p.S) lp[qi] = m2[r] * LN2 + __logf(lc);
  }
  rescale(inv);
  store_bf16<NO>(o, op, p.o_ss, qr, p.S, t4);
}

template <int D, int BK>
cudaError_t launch_wg(WgParams& a, cudaStream_t stream) {
  const Params& p = a.p;
  if (!map_5d(&a.tq, p.q, p.B, p.H, p.G, p.S, D, p.q_sb, p.q_sh, p.q_sg,
              p.q_ss, WG_QROWS) ||
      !map_4d(&a.tk, p.k, p.B, p.H, p.Sk, D, p.k_sb, p.k_sh, p.k_ss, BK) ||
      !map_4d(&a.tv, p.v, p.B, p.H, p.Sk, D, p.v_sb, p.v_sh, p.v_ss, BK))
    return cudaErrorInvalidValue;
  // 1024 bytes of alignment slack, the q tile, the ring, the barriers
  const size_t smem =
      1024 + static_cast<size_t>(WG_QROWS + 2 * WG_STAGES * BK) * D * 2 +
      (1 + 4 * WG_STAGES) * 8;
  auto kernel = flash_fwd_wg_kernel<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // one block a q tile of a head: fewer than 2^31 (wg_route_ok)
  const unsigned blocks = static_cast<unsigned>(
      static_cast<int64_t>(p.S + WG_QROWS - 1) / WG_QROWS * p.B * p.H * p.G);
  kernel<<<blocks, WG_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tile sizes of each D.
cudaError_t launch_wg_for_d(WgParams& a, cudaStream_t stream) {
  switch (a.p.D) {
    case 64: return launch_wg<64, 128>(a, stream);
    case 128: return launch_wg<128, 128>(a, stream);
    case 256: return launch_wg<256, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int NC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(BQ + 2 * BK) * p.ld + BQ * (BK + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H * p.G);
  flash_fwd_kernel<NC><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_for_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<4>(p, stream);
  if (p.D <= 128) return launch<8>(p, stream);
  return launch<16>(p, stream);
}

// The wgmma route's conditions (the wrapper's _fwd_route decides the same
// from the shape): D in {64, 128, 256}, every operand pointer and stride
// 16-byte aligned (TMA), the B H G S rows of lse within an int32.
bool wg_route_ok(const Params& p) {
  return (p.D == 64 || p.D == 128 || p.D == 256) && p.vec &&
         static_cast<int64_t>(p.B) * p.H * p.G * p.S < (int64_t(1) << 31);
}

}  // namespace

// dims: B, H (= n_kv), G, S, Sk, D.
// strides (in elements): q b,h,g,s; k b,h,s; v b,h,s; out b,h,g,s.  The last
// dimension of each is contiguous.  lse is a contiguous (B, H, G, S) fp32.
// dtype: 0 float32, 1 bfloat16.  route: 0 the fp32 kernel, 1 the bf16
// mma.sync kernel (_tc), 2 the bf16 wgmma kernel (_wg), which the caller
// chooses; a route that does not take these inputs returns
// cudaErrorInvalidValue.  Any nonzero scale (the bf16 routes run a
// negative one on a negated q tile with |scale|).  Launches one kernel and
// returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, const int64_t* dims,
                         const int64_t* strides, int dtype, int route,
                         int causal, int window, int prefix, float scale,
                         void* stream) {
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
  p.vec = p.D % 8 == 0;
  p.negq = 0;
  const void* operands[] = {q, k, v, out};
  for (const void* ptr : operands)
    p.vec = p.vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (int i = 0; i < 14; ++i) p.vec = p.vec && strides[i] % 8 == 0;
  if (p.D < 1 || p.D > 256 || p.S < 1 || p.Sk < 1 ||
      static_cast<int64_t>(p.B) * p.H * p.G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0 && dtype == 0) return static_cast<int>(launch_for_d(p, st));
  if (dtype != 1 || !(fabsf(scale) > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  p.negq = scale < 0.f;
  p.scale = fabsf(scale);
  if (route == 1) return static_cast<int>(launch_tc_for_d(p, st));
  if (route == 2 && wg_route_ok(p)) {
    WgParams a;
    a.p = p;
    return static_cast<int>(launch_wg_for_d(a, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
