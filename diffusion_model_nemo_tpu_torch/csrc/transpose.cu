// 2-D transpose: x [rows, cols] -> y [cols, rows], elements of 2 or 4 bytes
// moved bit for bit.
//
// Replaces TPU kernel tools/microbench_attn_lanes.py:_tr_kernel (launcher
// transpose_probe), the probe of the batch-minor layout's primitive: one
// VMEM block [rows, 128] -> [128, rows].
//
// What bounds it on the H100: bytes only, each element read once and written
// once (16.8 MB at [32768, 128] in bf16: 5.0 us at 3.35 TB/s). A naive
// transpose reads or writes with a stride of a whole row; this one stages a
// 32 x 32 tile in shared memory (one padding column, so the transposed reads
// spread over the banks), so a warp reads 32 consecutive elements of one row
// of x and writes 32 consecutive elements of one row of y. Blocks of 32 x 8
// threads move four elements each. Wider loads (several elements a thread)
// are the next step; at 2 bytes an element a warp moves 64 bytes a row.

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int ROWS_PER_PASS = 8;

// blockIdx.x walks the rows of x (up to 2^31 - 1 tiles), blockIdx.y its
// columns.
template <typename E>
__global__ void __launch_bounds__(TILE * ROWS_PER_PASS)
transpose2d_kernel(const E* __restrict__ x, E* __restrict__ y, int rows, int cols) {
  __shared__ E tile[TILE][TILE + 1];
  const int r0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  for (int j = threadIdx.y; j < TILE; j += ROWS_PER_PASS) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < rows && c < cols) tile[j][threadIdx.x] = x[size_t(r) * cols + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < TILE; j += ROWS_PER_PASS) {
    const int c = c0 + j, r = r0 + threadIdx.x;  // y[c][r] = x[r][c]
    if (c < cols && r < rows) y[size_t(c) * rows + r] = tile[threadIdx.x][j];
  }
}

template <typename E>
int transpose2d(const void* x, void* y, int rows, int cols, cudaStream_t stream) {
  const dim3 grid((rows + TILE - 1) / TILE, (cols + TILE - 1) / TILE);
  transpose2d_kernel<E><<<grid, dim3(TILE, ROWS_PER_PASS), 0, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_transpose)

// x [rows, cols] -> y [cols, rows], `elem_bytes` 2 or 4; cols <= 65535 * 32.
DMN_EXPORT int dmn_transpose2d(const void* x, void* y, int rows, int cols, int elem_bytes,
                               void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (elem_bytes == 2) return transpose2d<uint16_t>(x, y, rows, cols, stream);
  if (elem_bytes == 4) return transpose2d<uint32_t>(x, y, rows, cols, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
