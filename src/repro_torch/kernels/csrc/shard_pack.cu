// Stripe pack / unpack for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `shard_pack_pallas` and `shard_unpack_pallas`
// (body `_pack_kernel`) of src/repro/kernels/shard_pack.py.  Same function,
// bit for bit: a buffer cut into n_cells = width * cpt equal cells is
// reordered so that cell c goes to target c % width, slot c // width
// (pack), or back (unpack), the round-robin stripe layout of
// src/repro/kernels/ref.py `shard_pack` / `shard_unpack`.
//
// Both directions are one transpose of a grid of cells: pack moves cell
// (a, b) of a (cpt x width) grid to (b, a) of a (width x cpt) grid, unpack
// the reverse.  No arithmetic: bound by bytes (each byte read once and
// written once).
//
// What the design does about it.  The TPU kernel expresses the permutation
// in BlockSpec index maps over a sequential grid of VREG-aligned cells.
// Here one block copies one source cell to its target, 256 threads moving
// 16-byte vectors, neighbouring threads on neighbouring addresses for both
// the load and the store (a cell is contiguous on both sides); cells are
// multiples of 512 bytes, so every lane of every warp has a vector.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// src: n_cells = rows * cols cells of cell_vecs 16-byte vectors, in
// row-major (rows, cols) order; dst: the same cells in (cols, rows) order.
__global__ void __launch_bounds__(THREADS)
transpose_cells(const uint4* __restrict__ src, uint4* __restrict__ dst,
                int64_t rows, int64_t cols, int64_t cell_vecs) {
  const int64_t cell = blockIdx.x;
  const int64_t r = cell / cols, c = cell % cols;
  const uint4* s = src + cell * cell_vecs;
  uint4* d = dst + (c * rows + r) * cell_vecs;
  for (int64_t i = threadIdx.x; i < cell_vecs; i += THREADS) d[i] = s[i];
}

int launch(const void* src, void* dst, int64_t rows, int64_t cols,
           int64_t cell_bytes, void* stream) {
  const int64_t n_cells = rows * cols;
  if (rows < 1 || cols < 1 || cell_bytes < 512 || cell_bytes % 512 ||
      n_cells > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(src) & 15u) ||
      (reinterpret_cast<uintptr_t>(dst) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  transpose_cells<<<static_cast<unsigned>(n_cells), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), rows, cols,
      cell_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cells: (width * cpt) cells of cell_bytes each, 16-byte aligned; packed:
// (width, cpt) cells, packed[t][c] = cells[c * width + t].  Returns a
// cudaError_t.
extern "C" int shard_pack(const void* cells, void* packed, int64_t width,
                          int64_t cpt, int64_t cell_bytes, void* stream) {
  return launch(cells, packed, cpt, width, cell_bytes, stream);
}

// The inverse: cells[c * width + t] = packed[t][c].
extern "C" int shard_unpack(const void* packed, void* cells, int64_t width,
                            int64_t cpt, int64_t cell_bytes, void* stream) {
  return launch(packed, cells, width, cpt, cell_bytes, stream);
}
