// Decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package's `attention_decode`
// (src/repro/models/layers.py) leaves its one-token attention to XLA,
// which fuses the rope, the cache update and the softmax around its dots.
// Eager PyTorch fused none of it: the port widened the whole bf16 cache to
// fp32 and copied it into batched-GEMM layout every layer (~1.8 GB of
// traffic a deepseek-7b layer at batch 16, against the 0.27 GB the
// arithmetic needs), and rope's host-made table cost a stream
// synchronisation for q and for k.  This kernel is the work after the
// q/k/v projections, in one pass:
//   1. rope on q and on the new k at `pos` (the half-split convention over
//      the first `rot` dims; fp32 products rounded once, or with
//      `rope_bf16` each product rounded to bf16 as the plain version's
//      bf16 arithmetic does; cosf/sinf of the fp32 angle), rounded to the
//      input dtype;
//   2. the new k and v written into slot pos % S of the ring caches, in
//      place, by one designated block;
//   3. softmax(q.k / sqrt(D)) . v over the valid slots (slot j is valid iff
//      j <= pos or pos >= S; the plain version gives the others exactly 0
//      probability), read from the (B, S, Hkv, D) caches as they lie.
// No block reads the slot that is written: every block whose slots hold
// it takes the new k/v from its own shared memory.
//
// What bounds it on this card.  Each valid K and V row is read once for
// the whole GQA group: 4 D bytes of bf16 a row and kv head, against
// 4 G D FLOPs.  At G <= 16 that is <= 16 FLOP a byte, far under the
// H100's ridge (~295 bf16, ~20 fp32 on the CUDA cores): bytes bound it.
// At deepseek-7b's chat shape (B 16, 32 kv heads, D 128, ~1040 valid
// slots) a layer moves ~0.27 GB, 81 us at 3.35 TB/s.
//
// What the design does about it ("flash-decoding"):
//   * Grid: one block of 128 threads per (split of the valid slots, kv
//     head [x group chunk], row).  The caller picks the number of splits
//     from the shapes alone: enough blocks for two an SM, no split under
//     64 slots.  Where there is more than one split, each block writes its
//     unnormalised partial output with its row max and sum (fp32), and
//     `decode_attn_combine_kernel` merges them: at most 2 launches a call.
//   * The CUDA-core route (fp32, and bf16 with G <= 4): TPR threads share
//     a row, each holding one or two 16-byte vectors of it; a block works
//     on 128 / TPR rows at once and each thread keeps 8 16-byte k and v
//     loads in flight (16 KB a block).  Each row group runs its own online
//     softmax; the groups are merged through shared memory at the end.
//     Up to 4 query heads share a block's k/v loads; fp32 with G > 4 runs
//     its heads in chunks of 4, one block each (an fp32 cache is a test
//     path, and those blocks find their rows in L2).
//   * The tensor-core route (bf16 with G > 4): q is a 16-row A operand (G
//     heads, zero rows after them); k/v tiles of 64 rows stream through a
//     2-stage ring of 16-byte cp.async copies; each of the 4 warps takes
//     16 rows of a tile: s = q.k^T and o += p.v on
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulators), p rounded to bf16 as
//     the operand of p.v.  The warps' online softmaxes merge through shared
//     memory at the end.  On the CUDA cores, G = 16 would need ~53 fp32
//     TFLOP/s to keep up with the bytes, near the card's 67: on an H100
//     at 64 rows of 4096 slots (qwen3-moe's G = 16), the CUDA-core route
//     in chunks of 4 heads takes 0.60 ms a call against a byte bound of
//     0.16 ms, this route 0.25 ms.
//   * The position can lie on the card (`pos_dev`): each block reads it
//     there and takes the slot and the valid slots from it, so a launch
//     captured in a CUDA graph serves every later step whose split plan
//     (the caller's, from the host's position) is the same.
// Launches on the caller's stream; no synchronisation, no allocation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_D = 256;
constexpr int SIMT_GC = 4;     // query heads a CUDA-core block, at most
constexpr int MMA_ROWS = 16;   // query heads a tensor-core block (G padded)
constexpr int MMA_TILE = 64;   // kv rows a tensor-core tile, 16 a warp
constexpr int UNROLL = 4;      // kv rows in flight a CUDA-core row group, NV = 1
constexpr float NEG_INIT = -1e30f;

struct Params {
  const void* q;    // (B, Hq, D), head h * G + g reads kv head h
  const void* kn;   // (B, Hkv, D): the new k, before rope
  const void* vn;   // (B, Hkv, D): the new v
  void* ck;         // (B, S, Hkv, D)
  void* cv;
  void* out;        // (B, Hq, D), contiguous
  float* part;      // (B, Hq, n_split, D + 2): o, then m and l (log2 units)
  const float* inv; // rot / 2 inverse frequencies, or null
  const int* pos_dev;  // the position on the card, or null: pos as given
  int64_t q_sb, q_sh, kn_sb, kn_sh, vn_sb, vn_sh;
  int64_t ck_sb, ck_ss, ck_sh, cv_sb, cv_ss, cv_sh;
  int B, Hkv, G, D, S, pos, slot, rot, n_valid, n_split, split_rows, n_gc;
  int rope_bf16;
  float c2;         // log2(e) / sqrt(D)
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// A 16-byte vector of T as floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    f[2 * i] = __low2float(b);
    f[2 * i + 1] = __high2float(b);
  }
}

// Where the position lies on the card (a launch replayed from a CUDA graph,
// whose arguments are frozen), pos, its slot and the valid slots from it,
// by the host's arithmetic; the caller's split plan must cover them.
__device__ __forceinline__ void take_pos(Params& p) {
  if (p.pos_dev == nullptr) return;
  p.pos = *p.pos_dev;
  p.slot = p.pos % p.S;
  p.n_valid = p.pos < p.S ? p.pos + 1 : p.S;
}

// Element i of a head's rope'd row (row: D values, contiguous), rounded to
// T, with the plain version's roundings: y1 = x1 cos - x2 sin,
// y2 = x2 cos + x1 sin, each product and difference rounded to fp32 (no
// fused multiply-add), then once to T; with rope_bf16, cos and sin and
// each product and sum rounded to T.
template <typename T>
__device__ __forceinline__ T rope_elem(const T* row, int i, const Params& p) {
  const T x = row[i];
  if (i >= p.rot) return x;
  const int half = p.rot >> 1;
  const bool lo = i < half;
  const float ang = __fmul_rn(static_cast<float>(p.pos),
                              p.inv[lo ? i : i - half]);
  float c = cosf(ang), s = sinf(ang);
  const float xi = to_f(x), xo = to_f(row[lo ? i + half : i - half]);
  float a = __fmul_rn(xi, c), b = __fmul_rn(xo, s);
  if (p.rope_bf16) {
    c = to_f(from_f<T>(c));
    s = to_f(from_f<T>(s));
    a = to_f(from_f<T>(__fmul_rn(xi, c)));
    b = to_f(from_f<T>(__fmul_rn(xo, s)));
  }
  return from_f<T>(lo ? __fsub_rn(a, b) : __fadd_rn(a, b));
}

// q heads g0 .. g0 + ng - 1 of kv head h, rope'd, into rows of sq (stride
// ldq; rows ng .. q_rows - 1 and columns D .. width - 1 zero); the new k
// (rope'd) and v into skn, svn (zero past D).  Every block of a (row, kv
// head) computes the same values.
template <typename T>
__device__ __forceinline__ void prolog(const Params& p, int b, int h, int g0,
                                       int ng, T* sq, int ldq, int q_rows,
                                       int width, T* skn, T* svn) {
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb +
                (h * p.G + g0) * p.q_sh;
  for (int e = threadIdx.x; e < q_rows * width; e += THREADS) {
    const int r = e / width, i = e % width;
    sq[r * ldq + i] = (r < ng && i < p.D) ? rope_elem(qb + r * p.q_sh, i, p)
                                          : from_f<T>(0.f);
  }
  const T* kb = static_cast<const T*>(p.kn) + b * p.kn_sb + h * p.kn_sh;
  const T* vb = static_cast<const T*>(p.vn) + b * p.vn_sb + h * p.vn_sh;
  for (int i = threadIdx.x; i < width; i += THREADS) {
    skn[i] = i < p.D ? rope_elem(kb, i, p) : from_f<T>(0.f);
    svn[i] = i < p.D ? vb[i] : from_f<T>(0.f);
  }
}

// The designated block of a (row, kv head) writes the new k/v into the
// slot: the split that holds it, group chunk 0.  After prolog's barrier.
template <typename T>
__device__ __forceinline__ void write_slot(const Params& p, int b, int h,
                                           int split, int gc, const T* skn,
                                           const T* svn) {
  if (gc != 0 || p.slot / p.split_rows != split) return;
  T* kd = static_cast<T*>(p.ck) + b * p.ck_sb + p.slot * p.ck_ss +
          h * p.ck_sh;
  T* vd = static_cast<T*>(p.cv) + b * p.cv_sb + p.slot * p.cv_ss +
          h * p.cv_sh;
  for (int i = threadIdx.x; i < p.D; i += THREADS) {
    kd[i] = skn[i];
    vd[i] = svn[i];
  }
}

// Merge a block's ns online-softmax streams (shared memory: m and l at
// [s * gr + g], o at [(s * gr + g) * ld + d]) for heads g < ng; write the
// output (one split) or this split's partial.
template <typename T>
__device__ __forceinline__ void finish(const Params& p, const float* sm,
                                       const float* sl, const float* so,
                                       int ns, int gr, int ld, int b, int h,
                                       int g0, int ng, int split) {
  const int Hq = p.Hkv * p.G;
  for (int e = threadIdx.x; e < ng * p.D; e += THREADS) {
    const int g = e / p.D, d = e % p.D;
    float M = NEG_INIT;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, sm[s * gr + g]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float w = exp2_approx(sm[s * gr + g] - M);
      L += sl[s * gr + g] * w;
      O += so[(s * gr + g) * ld + d] * w;
    }
    const int64_t row = static_cast<int64_t>(b) * Hq + h * p.G + g0 + g;
    if (p.n_split == 1) {
      static_cast<T*>(p.out)[row * p.D + d] = from_f<T>(O / L);
    } else {
      float* pp = p.part + (row * p.n_split + split) * (p.D + 2);
      pp[d] = O;
      if (d == 0) {
        pp[p.D] = M;
        pp[p.D + 1] = L;
      }
    }
  }
}

// ------------------------- the CUDA-core route -------------------------
// TPR threads a row (a power of 2 <= 32), NV 16-byte vectors a thread,
// GC query heads a block.
template <typename T, int TPR, int NV, int GC>
__global__ void __launch_bounds__(THREADS)
    decode_attn_simt_kernel(Params p) {
  take_pos(p);
  constexpr int EPT = 16 / sizeof(T), RPB = THREADS / TPR;
  constexpr int DP = TPR * NV * EPT;   // >= D
  constexpr int U = UNROLL / NV;       // 2 UNROLL 16-byte loads in flight
  // q rows, the new k and v (T), then the row groups' o, m and l (fp32)
  __shared__ __align__(16) unsigned char
      smem[(GC + 2) * DP * sizeof(T) + (RPB * GC * DP + 2 * RPB * GC) * 4];
  T* sq = reinterpret_cast<T*>(smem);
  T* skn = sq + GC * DP;
  T* svn = skn + DP;
  float* so = reinterpret_cast<float*>(svn + DP);
  float* sm = so + RPB * GC * DP;
  float* sl = sm + RPB * GC;

  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / p.n_gc, gc = blockIdx.y % p.n_gc;
  const int g0 = gc * GC, ng = min(GC, p.G - g0);
  prolog<T>(p, b, h, g0, ng, sq, DP, GC, DP, skn, svn);
  __syncthreads();
  write_slot<T>(p, b, h, split, gc, skn, svn);

  const int rg = threadIdx.x / TPR, l = threadIdx.x % TPR;
  float qf[GC][NV][EPT], acc[GC][NV][EPT], m[GC], ls[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INIT;
    ls[g] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int x = 0; x < EPT; ++x) {
        qf[g][v][x] = to_f(sq[g * DP + (v * TPR + l) * EPT + x]);
        acc[g][v][x] = 0.f;
      }
  }
  const int r0 = split * p.split_rows;
  const int r1 = min(r0 + p.split_rows, p.n_valid);
  const T* kh = static_cast<const T*>(p.ck) + b * p.ck_sb + h * p.ck_sh;
  const T* vh = static_cast<const T*>(p.cv) + b * p.cv_sb + h * p.cv_sh;

  // every thread takes every iteration (the shuffles need the whole warp)
  for (int base = r0; base < r1; base += RPB * U) {
    uint4 kr[U][NV], vr[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * RPB + rg;
      const bool in = j < r1;
      const T* ks = j == p.slot ? skn : kh + j * p.ck_ss;
      const T* vs = j == p.slot ? svn : vh + j * p.cv_ss;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int e = (v * TPR + l) * EPT;
        const bool ok = in && e < p.D;
        kr[u][v] = ok ? *reinterpret_cast<const uint4*>(ks + e)
                      : make_uint4(0, 0, 0, 0);
        vr[u][v] = ok ? *reinterpret_cast<const uint4*>(vs + e)
                      : make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GC; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float kf[EPT];
        unpack(kr[u][v], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int x = 0; x < EPT; ++x) s[u][g] = fmaf(kf[x], qf[g][v][x],
                                                       s[u][g]);
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
#pragma unroll
        for (int o = TPR / 2; o > 0; o >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
        s[u][g] = base + u * RPB + rg < r1 ? s[u][g] * p.c2 : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = exp2_approx(m[g] - mx);
      m[g] = mx;
      ls[g] *= alpha;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int x = 0; x < EPT; ++x) acc[g][v][x] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) s[u][g] = exp2_approx(s[u][g] - mx);
#pragma unroll
      for (int u = 0; u < U; ++u) ls[g] += s[u][g];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float vf[EPT];
        unpack(vr[u][v], vf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int x = 0; x < EPT; ++x)
            acc[g][v][x] = fmaf(s[u][g], vf[x], acc[g][v][x]);
      }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int x = 0; x < EPT; ++x)
        so[(rg * GC + g) * DP + (v * TPR + l) * EPT + x] = acc[g][v][x];
    if (l == 0) {
      sm[rg * GC + g] = m[g];
      sl[rg * GC + g] = ls[g];
    }
  }
  __syncthreads();
  finish<T>(p, sm, sl, so, RPB, GC, DP, b, h, g0, ng, split);
}

// ------------------------ the tensor-core route ------------------------
// bf16, D <= KD (a multiple of 32), G <= 16.
template <int KD>
constexpr int mma_smem_bytes() {
  return (MMA_ROWS * (KD + 8) + 2 * KD + 2 * 2 * MMA_TILE * (KD + 8)) *
         static_cast<int>(sizeof(bf16));
}

template <int KD>
__global__ void __launch_bounds__(THREADS) decode_attn_mma_kernel(Params p) {
  take_pos(p);
  constexpr int LDS = KD + 8, CH = KD / 8, RSTEP = THREADS / CH;
  constexpr int NO = KD / 8, KS = KD / 16, STAGE = 2 * MMA_TILE * LDS;
  static_assert(MMA_TILE % RSTEP == 0, "rows per pass must divide the tile");
  extern __shared__ __align__(16) unsigned char dsmem[];
  bf16* sQ = reinterpret_cast<bf16*>(dsmem);   // MMA_ROWS x LDS
  bf16* skn = sQ + MMA_ROWS * LDS;             // KD
  bf16* svn = skn + KD;                        // KD
  bf16* ring = svn + KD;                       // 2 stages: k tile, v tile

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  prolog<bf16>(p, b, h, 0, p.G, sQ, LDS, MMA_ROWS, KD, skn, svn);
  __syncthreads();
  write_slot<bf16>(p, b, h, split, 0, skn, svn);

  const int D = p.D, dpad = (D + 15) & ~15;
  const int r0 = split * p.split_rows;
  const int r1 = min(r0 + p.split_rows, p.n_valid);
  const int n_tiles = (r1 - r0 + MMA_TILE - 1) / MMA_TILE;
  const bf16* kh = static_cast<const bf16*>(p.ck) + b * p.ck_sb +
                   h * p.ck_sh;
  const bf16* vh = static_cast<const bf16*>(p.cv) + b * p.cv_sb +
                   h * p.cv_sh;

  // Rows [k0, k0 + MMA_TILE) into stage st: each thread one 16-byte chunk
  // of every RSTEP-th row; past r1 or D zeros; the slot's row from skn/svn
  // (a plain shared store, published by the loop's barrier as the copies
  // are).
  const int lr = threadIdx.x / CH, lc = (threadIdx.x % CH) * 8;
  auto load = [&](int k0, int st) {
    bf16* dk = ring + st * STAGE;
    bf16* dv = dk + MMA_TILE * LDS;
#pragma unroll
    for (int i = 0; i < MMA_TILE / RSTEP; ++i) {
      const int rr = lr + i * RSTEP, j = k0 + rr;
      if (j == p.slot && j < r1 && lc < D) {
        *reinterpret_cast<uint4*>(dk + rr * LDS + lc) =
            *reinterpret_cast<const uint4*>(skn + lc);
        *reinterpret_cast<uint4*>(dv + rr * LDS + lc) =
            *reinterpret_cast<const uint4*>(svn + lc);
      } else {
        const bool ok = j < r1 && lc < D;
        cp_async16(smem_addr(dk + rr * LDS + lc),
                   ok ? kh + j * p.ck_ss + lc : kh, ok ? 16 : 0);
        cp_async16(smem_addr(dv + rr * LDS + lc),
                   ok ? vh + j * p.cv_ss + lc : vh, ok ? 16 : 0);
      }
    }
  };

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t4 = lane & 3, g8 = lane >> 2;
  float m2[2] = {NEG_INIT, NEG_INIT}, l[2] = {0.f, 0.f}, o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  if (n_tiles > 0) load(r0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = r0 + it * MMA_TILE;
    // tile `it` has landed and every warp is done with tile it - 1, whose
    // stage the next tile fills while this one multiplies
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) load(k0 + MMA_TILE, (it + 1) & 1);
    cp_async_commit();
    const bf16* cK = ring + (it & 1) * STAGE;
    const bf16* cV = cK + MMA_TILE * LDS;

    // s = q.k^T: 16 heads x this warp's 16 rows
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks * 16 < dpad) {
        uint32_t aq[4], bk[4];
        ldsm_x4(smem_addr(sQ + a_row(lane) * LDS + 16 * ks + a_col(lane)),
                aq);
        ldsm_x4(smem_addr(cK + (16 * w + b_row(lane)) * LDS + 16 * ks +
                          b_col(lane)), bk);
        mma_bf16(s[0], aq, bk[0], bk[1]);
        mma_bf16(s[1], aq, bk[2], bk[3]);
      }
    }
    // online softmax in log2 units; rows past r1 get p = 0
    float mx[2] = {NEG_INIT, NEG_INIT}, alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + 16 * w + 8 * j + 2 * t4 + (e & 1);
        s[j][e] = kj < r1 ? s[j][e] * p.c2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m2[r], mx[r]);
      alpha[r] = exp2_approx(m2[r] - m_new);
      m2[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(s[j][e] - m2[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    uint32_t ap[1][4];
    to_a_frags<2>(s, ap);
    // o += p.v, v read across its rows (.trans)
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      if (16 * np < D) {
        uint32_t bv[4];
        ldsm_x4_t(smem_addr(cV + (16 * w + a_row(lane)) * LDS + 16 * np +
                            a_col(lane)), bv);
        mma_bf16(o[2 * np], ap[0], bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], ap[0], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the 4 warps' streams into the ring's space, then merged
  float* so = reinterpret_cast<float*>(ring);   // 4 x 16 x KD
  float* sm = so + 4 * MMA_ROWS * KD;           // 4 x 16
  float* sl = sm + 4 * MMA_ROWS;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      so[(w * MMA_ROWS + g8 + (e >> 1) * 8) * KD + 8 * n + 2 * t4 + (e & 1)] =
          o[n][e];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t4 == 0) {
      sm[w * MMA_ROWS + g8 + 8 * r] = m2[r];
      sl[w * MMA_ROWS + g8 + 8 * r] = l[r];
    }
  }
  __syncthreads();
  finish<bf16>(p, sm, sl, so, 4, MMA_ROWS, KD, b, h, 0, p.G, split);
}

// ------------------------------ combine ------------------------------
// One block a (row, q head): the splits' partials merged and normalised.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    decode_attn_combine_kernel(Params p) {
  const int64_t row = blockIdx.x;
  const int ld = p.D + 2;
  const float* pp = p.part + row * p.n_split * ld;
  float M = NEG_INIT;
  for (int s = 0; s < p.n_split; ++s) M = fmaxf(M, pp[s * ld + p.D]);
  float L = 0.f;
  for (int s = 0; s < p.n_split; ++s)
    L += pp[s * ld + p.D + 1] * exp2_approx(pp[s * ld + p.D] - M);
  for (int d = threadIdx.x; d < p.D; d += THREADS) {
    float O = 0.f;
    for (int s = 0; s < p.n_split; ++s)
      O += pp[s * ld + d] * exp2_approx(pp[s * ld + p.D] - M);
    static_cast<T*>(p.out)[row * p.D + d] = from_f<T>(O / L);
  }
}

// ------------------------------ launches ------------------------------
__host__ __device__ constexpr int pow2_at_least(int x) {
  int y = 1;
  while (y < x) y <<= 1;
  return y;
}

template <typename T, int TPR, int NV, int GC>
cudaError_t launch_simt(const Params& p, cudaStream_t st) {
  const dim3 grid(p.n_split, p.Hkv * p.n_gc, p.B);
  decode_attn_simt_kernel<T, TPR, NV, GC><<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int TPR, int NV>
cudaError_t simt_for_g(const Params& p, cudaStream_t st) {
  const int gc = p.G >= SIMT_GC ? SIMT_GC : pow2_at_least(p.G);
  if (gc == 1) return launch_simt<T, TPR, NV, 1>(p, st);
  if (gc == 2) return launch_simt<T, TPR, NV, 2>(p, st);
  return launch_simt<T, TPR, NV, SIMT_GC>(p, st);
}

// TPR = the 16-byte vectors of a row, rounded up to a power of 2 in
// [2, 32]; a second vector a thread where 32 threads do not cover D.
template <typename T>
cudaError_t launch_simt_for_d(const Params& p, cudaStream_t st) {
  constexpr int EPT = 16 / sizeof(T);
  const int vecs = p.D / EPT;
  if constexpr (EPT == 4) {   // fp32 past D = 128: two vectors a thread
    if (vecs > 32) return simt_for_g<T, 32, 2>(p, st);
  }
  switch (vecs > 2 ? pow2_at_least(vecs) : 2) {
    case 2: return simt_for_g<T, 2, 1>(p, st);
    case 4: return simt_for_g<T, 4, 1>(p, st);
    case 8: return simt_for_g<T, 8, 1>(p, st);
    case 16: return simt_for_g<T, 16, 1>(p, st);
    default: return simt_for_g<T, 32, 1>(p, st);
  }
}

template <int KD>
cudaError_t launch_mma(const Params& p, cudaStream_t st) {
  constexpr int smem = mma_smem_bytes<KD>();
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_mma_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_split, p.Hkv, p.B);
  decode_attn_mma_kernel<KD><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma_for_d(const Params& p, cudaStream_t st) {
  if (p.D <= 32) return launch_mma<32>(p, st);
  if (p.D <= 64) return launch_mma<64>(p, st);
  if (p.D <= 128) return launch_mma<128>(p, st);
  return launch_mma<256>(p, st);
}

}  // namespace

// a (23 values): strides in elements, the last dimension of each operand
// contiguous: q b, h; k_new b, h; v_new b, h; cache_k b, s, h;
// cache_v b, s, h; then B, Hkv, G, D, S, pos, rot, n_split, split_rows,
// n_gc, rope_bf16.  q is (B, Hkv G, D), k_new / v_new (B, Hkv, D), the
// caches (B, S, Hkv, D); out a contiguous (B, Hkv G, D) in q's dtype; part
// fp32 scratch of B Hkv G n_split (D + 2) values where n_split > 1 (else
// unused); inv the rot / 2 fp32 inverse frequencies (unused where rot is
// 0); pos_dev null, or an int on the card that the kernels take the
// position from in place of a[17] (which still checks the split plan: the
// two must give the same one).  dtype: 0 float32, 1 bfloat16.  route: 0
// the CUDA cores, 1 the tensor cores (bf16, G <= 16).  Every pointer and
// stride 16-byte aligned.
// Launches one kernel, and the combine where n_split > 1; returns a
// cudaError_t (cudaErrorInvalidValue for inputs it does not take).
extern "C" int decode_attn(const void* q, const void* k_new,
                           const void* v_new, void* cache_k, void* cache_v,
                           void* out, void* part, const void* inv,
                           const void* pos_dev, const int64_t* a,
                           int dtype, int route, float c2, void* stream) {
  Params p;
  p.q = q;
  p.kn = k_new;
  p.vn = v_new;
  p.ck = cache_k;
  p.cv = cache_v;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.inv = static_cast<const float*>(inv);
  p.pos_dev = static_cast<const int*>(pos_dev);
  p.q_sb = a[0]; p.q_sh = a[1];
  p.kn_sb = a[2]; p.kn_sh = a[3];
  p.vn_sb = a[4]; p.vn_sh = a[5];
  p.ck_sb = a[6]; p.ck_ss = a[7]; p.ck_sh = a[8];
  p.cv_sb = a[9]; p.cv_ss = a[10]; p.cv_sh = a[11];
  p.B = static_cast<int>(a[12]);
  p.Hkv = static_cast<int>(a[13]);
  p.G = static_cast<int>(a[14]);
  p.D = static_cast<int>(a[15]);
  p.S = static_cast<int>(a[16]);
  p.pos = static_cast<int>(a[17]);
  p.rot = static_cast<int>(a[18]);
  p.n_split = static_cast<int>(a[19]);
  p.split_rows = static_cast<int>(a[20]);
  p.n_gc = static_cast<int>(a[21]);
  p.rope_bf16 = static_cast<int>(a[22]);
  p.c2 = c2;
  const int ept = dtype == 1 ? 8 : 4;
  if ((dtype != 0 && dtype != 1) || p.D < 1 || p.D > MAX_D ||
      p.D % ept != 0 || p.B < 1 || p.B > 65535 || p.Hkv < 1 || p.G < 1 ||
      p.S < 1 || p.pos < 0 || p.rot < 0 || p.rot > p.D ||
      (p.rot > 0 && inv == nullptr) || p.n_split < 1 ||
      p.split_rows < 1 || p.n_gc < 1 ||
      static_cast<int64_t>(p.Hkv) * p.n_gc > 65535 ||
      (p.n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.slot = p.pos % p.S;
  p.n_valid = p.pos < p.S ? p.pos + 1 : p.S;
  if (static_cast<int64_t>(p.n_split) * p.split_rows < p.n_valid ||
      static_cast<int64_t>(p.n_split - 1) * p.split_rows >= p.n_valid)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    if (dtype != 1 || p.G > MMA_ROWS || p.n_gc != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_mma_for_d(p, st);
  } else if (route == 0) {
    const int gc = p.G >= SIMT_GC ? SIMT_GC : pow2_at_least(p.G);
    if (p.n_gc != (p.G + gc - 1) / gc)
      return static_cast<int>(cudaErrorInvalidValue);
    err = dtype == 1 ? launch_simt_for_d<bf16>(p, st)
                     : launch_simt_for_d<float>(p, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || p.n_split == 1) return static_cast<int>(err);
  const dim3 rows(static_cast<unsigned>(p.B * p.Hkv * p.G));
  if (dtype == 1)
    decode_attn_combine_kernel<bf16><<<rows, THREADS, 0, st>>>(p);
  else
    decode_attn_combine_kernel<float><<<rows, THREADS, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
