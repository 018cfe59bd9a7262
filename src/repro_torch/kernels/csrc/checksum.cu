// Weighted uint32 checksum for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `checksum_words_pallas` (body `_checksum_kernel`)
// of src/repro/kernels/checksum.py.  Same function, bit for bit:
//
//     sum_i  W^(i+1) * w_i   mod 2^32,     W = 2654435761,
//
// over the little-endian uint32 words w_i of a byte buffer, the last word
// zero-padded when the length is not a multiple of 4.  The caller XORs in
// the length mix (`splitmix64(nbytes)`) on the host, as the JAX wrapper
// does, which makes the result equal to `core.integrity.checksum`.
//
// What bounds it on this card.  Four integer multiply-adds per 16 bytes
// read: bound by bytes (each input byte read once, 4 bytes written).
//
// What the design does about it.  The TPU kernel walks (8, 128) tiles
// along a sequential grid, scaling each tile's partial sum by a host-made
// W^(t*1024) table.  Here every thread reads 16-byte vectors in a
// grid-stride loop, so neighbouring threads read neighbouring addresses,
// and the weight of a vector comes from the thread's own running power:
// W^(start+1) once by square-and-multiply with a 64-bit exponent (buffers
// above 2^31 bytes are routine: a stacked 7B-model leaf is 2.7 GB), then
// one multiply by W^(4 * threads) per step, and Horner's rule over the
// vector's 4 words.  uint32 arithmetic wraps mod 2^32 by itself, and the
// sum mod 2^32 is associative and commutative, so a warp-shuffle
// reduction and one integer atomicAdd per block give a result that does
// not depend on the order blocks run in.  Up to 3 words before the first
// 16-byte boundary, up to 3 after the last vector and the zero-padded
// partial word are read by single threads of block 0; no host copy pads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t WEIGHT = 2654435761u;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int SMS = 132;

__device__ __forceinline__ uint32_t pow_w(uint64_t e) {
  uint32_t r = 1u, b = WEIGHT;
  while (e) {
    if (e & 1u) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

// w0*W^1 + w1*W^2 + w2*W^3 + w3*W^4, divided by W: the vector's weights
// relative to its first word.
__device__ __forceinline__ uint32_t horner4(const uint4 v) {
  return v.x + WEIGHT * (v.y + WEIGHT * (v.z + WEIGHT * v.w));
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// data: 4-byte aligned.  head: words before the first 16-byte boundary;
// n_vec: 16-byte vectors after them; n_tail: whole words after the
// vectors; rem: bytes of the zero-padded last word (0..3).
__global__ void __launch_bounds__(THREADS)
checksum_kernel(const uint8_t* __restrict__ data, int64_t head, int64_t n_vec,
                int64_t n_tail, int rem, uint32_t* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * THREADS;
  uint32_t acc = 0u;
  if (tid < n_vec) {
    const uint4* vec = reinterpret_cast<const uint4*>(data + 4 * head);
    uint32_t p = pow_w(static_cast<uint64_t>(head + 4 * tid + 1));
    const uint32_t step = pow_w(static_cast<uint64_t>(4 * n_threads));
    for (int64_t v = tid; v < n_vec; v += n_threads) {
      acc += p * horner4(vec[v]);
      p *= step;
    }
  }
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    const int64_t tail0 = head + 4 * n_vec;       // first word after vectors
    if (t < head) {
      acc += pow_w(static_cast<uint64_t>(t + 1)) * load_word(data + 4 * t);
    } else if (t >= 4 && t - 4 < n_tail) {
      const int64_t i = tail0 + (t - 4);
      acc += pow_w(static_cast<uint64_t>(i + 1)) * load_word(data + 4 * i);
    } else if (t == 8 && rem > 0) {
      const int64_t i = tail0 + n_tail;
      const uint8_t* p = data + 4 * i;
      uint32_t w = 0u;
      for (int b = 0; b < rem; ++b) w |= static_cast<uint32_t>(p[b]) << (8 * b);
      acc += pow_w(static_cast<uint64_t>(i + 1)) * w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ uint32_t warp_sums[THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < THREADS / 32 ? warp_sums[threadIdx.x] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (threadIdx.x == 0) atomicAdd(out, acc);
  }
}

}  // namespace

// data: `nbytes` >= 1 bytes at a 4-byte aligned device address; out: one
// device uint32, overwritten with the weighted sum (no length mix).
// Returns a cudaError_t.
extern "C" int checksum_words(const void* data, int64_t nbytes, void* out,
                              void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  if (nbytes < 1 || (addr & 3u)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_words = nbytes / 4;
  const int rem = static_cast<int>(nbytes % 4);
  int64_t head = static_cast<int64_t>(((16u - (addr & 15u)) & 15u) / 4u);
  if (head > n_words) head = n_words;
  const int64_t n_vec = (n_words - head) / 4;
  const int64_t n_tail = n_words - head - 4 * n_vec;
  int64_t blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks > static_cast<int64_t>(SMS) * BLOCKS_PER_SM)
    blocks = static_cast<int64_t>(SMS) * BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  checksum_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(data), head, n_vec, n_tail, rem,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
