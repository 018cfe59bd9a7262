// Mamba2's decode step for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package's `ssd_decode_step`
// (src/repro/models/ssm.py) leaves the one-token recurrence to XLA, which
// fuses it.  Eager PyTorch fused none of it: over the (B, H, N, P) fp32
// state it made some eleven full passes a layer (the decay, the outer
// product B (dt x)^T, their sum, a permuted copy for the readout's batched
// GEMM, the copy back into the cache): ~740 MB at granite-4.0-h-small's
// chat shape (B 16, H 128, N 128, P 64; a 67 MB state) against the
// 134 MB that reading and writing the state once takes.  This is the
// work between the two projections of `ssd_decode_step`, in two kernels:
//   1. `ssd_decode_conv_kernel`, one thread a (row, conv channel) over the
//      din + 2N channels of x, B and C: the depthwise causal conv over the
//      K - 1 cached inputs and the new one, the bias where there is one,
//      SiLU, written to a (B, din + 2N) buffer; the channel's tail shifted
//      by one in place.  Each tail element is one thread's, so the B and C
//      channels every head reads cannot race; folding the conv into the
//      state kernel would race on them.  Each product and each sum is
//      rounded to the input dtype, as the plain version's elementwise ops
//      round them, and SiLU is taken in fp32 and rounded once: the output
//      is the plain version's to the bit.
//   2. `ssd_decode_state_kernel`, one block of 128 threads a (row, head,
//      slice of P): dt = softplus(dt_raw + dt_bias) (threshold 20, as
//      F.softplus), a = exp(dt * -exp(A_log)); B and C of the row in shared
//      memory; then one pass over the slice's (N, P_slice) fp32 state,
//      s' = a s + B_n (dt x_p) stored in place, y_p += C_n s'; the block's
//      row groups summed through shared memory; y + D x written in the
//      input dtype.  The update rounds as the plain version does (each
//      product and the sum on its own, no fused multiply-add), so the new
//      state is its bits; only the readout's sum over N takes another order.
//
// What bounds it on this card: bytes.  Each state element costs 8 bytes
// (read and written) for ~5 FLOPs, far under the H100's ridge; at
// granite's chat shape one call must move ~136 MB, ~41 us at 3.35 TB/s.
// What the design does about it: the state is read once and written once,
// with 16-byte streaming loads and stores (neighbouring threads on
// neighbouring p, a row of P_slice floats shared by P_slice / 4 threads)
// and 4 rows in flight a thread; the caller picks P_slice from the shapes
// alone so that B * H * (P / P_slice) blocks keep 2 blocks an SM where the
// shape allows it (2,048 blocks at granite's B 16).
// Launches on the caller's stream; no synchronisation, no allocation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_K = 8;        // the widest conv
constexpr int MAX_N = 1024;     // the largest state size (B and C in smem)
constexpr int UNROLL = 4;       // state rows in flight a thread
constexpr int CONV_THREADS = 256;

typedef __nv_bfloat16 bf16;

struct ConvParams {
  const void* xbc;     // (B, C) rows of the input projection, row stride x_sb
  void* tail;          // (B, K - 1, C), strides tail_sb, tail_ss, 1
  const void* w;       // (K, C)
  const void* bias;    // (C,) or null
  void* out;           // (B, C)
  int64_t x_sb, tail_sb, tail_ss;
  int B, C, K;
};

struct StateParams {
  const void* conv;      // (B, C): x (H P), then B (N), then C (N)
  const void* dt_raw;    // (B, H) rows, row stride dt_sb
  const float* dt_bias;  // (H,)
  const float* a_log;    // (H,)
  const float* d_skip;   // (H,)
  float* state;          // (B, H, N, P), contiguous
  void* y;               // (B, H P)
  int64_t dt_sb;
  int B, H, N, P, C, p_slice;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: one elementwise op's result in T
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
ssd_decode_conv_kernel(ConvParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * CONV_THREADS +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(p.B) * p.C) return;
  const int b = static_cast<int>(i / p.C), c = static_cast<int>(i % p.C);
  T* tail = static_cast<T*>(p.tail) + b * p.tail_sb + c;
  const T* w = static_cast<const T*>(p.w) + c;
  T v[MAX_K];
  for (int k = 0; k < p.K - 1; ++k) v[k] = tail[k * p.tail_ss];
  v[p.K - 1] = static_cast<const T*>(p.xbc)[b * p.x_sb + c];
  // y = x_0 w_0; y = y + x_k w_k; y = y + bias; silu(y): each rounded to T
  float acc = round_to<T>(__fmul_rn(to_f<T>(v[0]), to_f<T>(w[0])));
  for (int k = 1; k < p.K; ++k) {
    const float prod = round_to<T>(
        __fmul_rn(to_f<T>(v[k]), to_f<T>(w[static_cast<int64_t>(k) * p.C])));
    acc = round_to<T>(__fadd_rn(acc, prod));
  }
  if (p.bias != nullptr)
    acc = round_to<T>(
        __fadd_rn(acc, to_f<T>(static_cast<const T*>(p.bias)[c])));
  static_cast<T*>(p.out)[static_cast<int64_t>(b) * p.C + c] =
      from_f<T>(acc / (1.0f + expf(-acc)));
  for (int k = 0; k < p.K - 1; ++k) tail[k * p.tail_ss] = v[k + 1];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_decode_state_kernel(StateParams p) {
  extern __shared__ float bc[];             // B (N), then C (N)
  __shared__ float red[THREADS * 4];        // (row groups, P_slice)
  const int n_sl = p.P / p.p_slice;
  const int blk = blockIdx.x;
  const int sl = blk % n_sl;
  const int h = (blk / n_sl) % p.H;
  const int b = blk / (n_sl * p.H);
  const int tpr = p.p_slice / 4;            // threads a state row
  const int rows = THREADS / tpr;           // row groups a block
  const int tid = threadIdx.x;
  const int cg = tid % tpr, rg = tid / tpr;
  const int din = p.H * p.P;
  const T* conv = static_cast<const T*>(p.conv) +
                  static_cast<int64_t>(b) * p.C;

  for (int n = tid; n < p.N; n += THREADS) {
    bc[n] = to_f<T>(conv[din + n]);
    bc[p.N + n] = to_f<T>(conv[din + p.N + n]);
  }
  // dt = softplus(dt_raw + dt_bias); a = exp(dt * -exp(A_log))
  float dt = __fadd_rn(
      to_f<T>(static_cast<const T*>(p.dt_raw)[b * p.dt_sb + h]),
      p.dt_bias[h]);
  dt = dt > 20.0f ? dt : log1pf(expf(dt));
  const float a = expf(__fmul_rn(dt, -expf(p.a_log[h])));
  const int p0 = h * p.P + sl * p.p_slice + cg * 4;   // this thread's x_p
  float dtx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) dtx[j] = __fmul_rn(dt, to_f<T>(conv[p0 + j]));
  __syncthreads();

  float4* st = reinterpret_cast<float4*>(
      p.state + (static_cast<int64_t>(b) * p.H + h) * p.N * p.P +
      sl * p.p_slice + cg * 4);
  const int64_t row4 = p.P / 4;             // a state row in float4s
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int n0 = rg; n0 < p.N; n0 += rows * UNROLL) {
    float4 s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = n0 + u * rows;
      if (n < p.N) s[u] = __ldcs(st + n * row4);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = n0 + u * rows;
      if (n < p.N) {
        const float bn = bc[n], cn = bc[p.N + n];
        // s * a + B_n * (dt * x_p), each product and the sum rounded
        s[u].x = __fadd_rn(__fmul_rn(s[u].x, a), __fmul_rn(bn, dtx[0]));
        s[u].y = __fadd_rn(__fmul_rn(s[u].y, a), __fmul_rn(bn, dtx[1]));
        s[u].z = __fadd_rn(__fmul_rn(s[u].z, a), __fmul_rn(bn, dtx[2]));
        s[u].w = __fadd_rn(__fmul_rn(s[u].w, a), __fmul_rn(bn, dtx[3]));
        __stcs(st + n * row4, s[u]);
        acc[0] = fmaf(cn, s[u].x, acc[0]);
        acc[1] = fmaf(cn, s[u].y, acc[1]);
        acc[2] = fmaf(cn, s[u].z, acc[2]);
        acc[3] = fmaf(cn, s[u].w, acc[3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[rg * p.p_slice + cg * 4 + j] = acc[j];
  __syncthreads();
  for (int q = tid; q < p.p_slice; q += THREADS) {
    float y = 0.0f;
    for (int r = 0; r < rows; ++r) y += red[r * p.p_slice + q];
    const int col = h * p.P + sl * p.p_slice + q;
    // y + D x, the product and the sum rounded, then y in T
    y = __fadd_rn(y, __fmul_rn(p.d_skip[h], to_f<T>(conv[col])));
    static_cast<T*>(p.y)[static_cast<int64_t>(b) * din + col] = from_f<T>(y);
  }
}

template <typename T>
cudaError_t launch(const ConvParams& cp, const StateParams& sp,
                   cudaStream_t st) {
  const int64_t n = static_cast<int64_t>(cp.B) * cp.C;
  const unsigned conv_blocks =
      static_cast<unsigned>((n + CONV_THREADS - 1) / CONV_THREADS);
  ssd_decode_conv_kernel<T><<<conv_blocks, CONV_THREADS, 0, st>>>(cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>(sp.B * sp.H * (sp.P / sp.p_slice));
  ssd_decode_state_kernel<T><<<blocks, THREADS, 2 * sp.N * sizeof(float),
                               st>>>(sp);
  return cudaGetLastError();
}

}  // namespace

// a: B, H, N, P, K, p_slice, x_sb, dt_sb, tail_sb, tail_ss (elements).
// dtype: 0 fp32, 1 bf16, for xbc, dt_raw, the tail, the conv's taps and
// bias, the conv buffer and y; dt_bias, a_log, d_skip and the state fp32.
extern "C" int ssd_decode(const void* xbc, const void* dt_raw, void* tail,
                          const void* conv_w, const void* conv_b,
                          const void* dt_bias, const void* a_log,
                          const void* d_skip, void* state, void* conv_out,
                          void* y, const int64_t* a, int dtype,
                          void* stream) {
  ConvParams cp;
  StateParams sp;
  const int B = static_cast<int>(a[0]), H = static_cast<int>(a[1]);
  const int N = static_cast<int>(a[2]), P = static_cast<int>(a[3]);
  const int K = static_cast<int>(a[4]), p_slice = static_cast<int>(a[5]);
  const int tpr = p_slice / 4;
  if ((dtype != 0 && dtype != 1) || B < 1 || H < 1 || N < 1 || N > MAX_N ||
      P < 4 || K < 2 || K > MAX_K || p_slice < 4 || p_slice % 4 != 0 ||
      P % p_slice != 0 || tpr > 32 || (tpr & (tpr - 1)) != 0 ||
      static_cast<int64_t>(B) * H * (P / p_slice) > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(state) & 15) != 0 || xbc == nullptr ||
      dt_raw == nullptr || tail == nullptr || conv_w == nullptr ||
      dt_bias == nullptr || a_log == nullptr || d_skip == nullptr ||
      conv_out == nullptr || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cp.xbc = xbc;
  cp.tail = tail;
  cp.w = conv_w;
  cp.bias = conv_b;
  cp.out = conv_out;
  cp.x_sb = a[6];
  cp.tail_sb = a[8];
  cp.tail_ss = a[9];
  cp.B = B;
  cp.C = H * P + 2 * N;
  cp.K = K;
  sp.conv = conv_out;
  sp.dt_raw = dt_raw;
  sp.dt_bias = static_cast<const float*>(dt_bias);
  sp.a_log = static_cast<const float*>(a_log);
  sp.d_skip = static_cast<const float*>(d_skip);
  sp.state = static_cast<float*>(state);
  sp.y = y;
  sp.dt_sb = a[7];
  sp.B = B;
  sp.H = H;
  sp.N = N;
  sp.P = P;
  sp.C = cp.C;
  sp.p_slice = p_slice;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? launch<bf16>(cp, sp, st)
                                     : launch<float>(cp, sp, st);
  return static_cast<int>(err);
}
