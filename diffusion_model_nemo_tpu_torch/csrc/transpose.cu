// 2-D transpose: x [rows, cols] -> y [cols, rows], elements of 2 or 4 bytes
// moved bit for bit.
//
// Replaces TPU kernel tools/microbench_attn_lanes.py:_tr_kernel (launcher
// transpose_probe), the probe of the batch-minor layout's primitive: one
// VMEM block [rows, 128] -> [128, rows].
//
// What bounds it on the H100: bytes only, each element read once and written
// once (16.8 MB at [32768, 128] in bf16: 5.0 us at 3.35 TB/s). So every load
// and store moves 16 bytes, and writes fill whole 32-byte sectors.
// Design: a thread moves one V x V block (V = 16 bytes / element: 8 x 8 in
// bf16, 4 x 4 for 4-byte elements): V 16-byte loads of its rows of x, a
// transpose in registers (one byte permute per 32-bit word for 2-byte
// elements, a renaming of words for 4-byte ones), V 16-byte stores of its
// rows of y. No shared memory. A warp's lanes 2k and 2k + 1 take column
// piece k of two neighbouring row blocks, so each load reads 256 contiguous
// bytes of two rows of x and each store writes 32 contiguous bytes into 16
// rows of y; a thread issues all its loads before its first store. A CTA of
// two warps moves 4 V x 16 V elements (32 x 128 in bf16), so that even
// [4096, 128] spreads over 128 CTAs, about one an SM (at eight warps a CTA
// it took 32 SMs and was slower). A block at a ragged edge, or every block
// where the rows of x or of y do not start on 16 bytes (cols or rows not a
// multiple of V), moves element by element.

#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int WARPS = THREADS / 32;
constexpr int PIECES = 16;     // column pieces of V elements a warp (lane / 2)
constexpr int ROW_BLOCKS = 2;  // row blocks of V rows a warp (lane % 2)

// blockIdx.x walks the rows of x (up to 2^31 - 1 tiles), blockIdx.y its
// columns. `vec`: x and y 16-byte aligned, rows and cols multiples of V.
template <typename E>
__global__ void __launch_bounds__(THREADS)
transpose2d_kernel(const E* __restrict__ x, E* __restrict__ y, int rows, int cols, int vec) {
  constexpr int V = 16 / sizeof(E);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = (blockIdx.y * PIECES + (lane >> 1)) * V;
  const int r0 = (blockIdx.x * WARPS * ROW_BLOCKS + ROW_BLOCKS * warp + (lane & 1)) * V;
  if (r0 >= rows || c0 >= cols) return;
  if (vec && r0 + V <= rows && c0 + V <= cols) {
    uint32_t a[V][4], o[V][4];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(x + size_t(r0 + i) * cols + c0));
      a[i][0] = u.x, a[i][1] = u.y, a[i][2] = u.z, a[i][3] = u.w;
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if constexpr (V == 8)  // word m of column j: rows 2m, 2m + 1 (low half: the even row)
          o[j][m] = __byte_perm(a[2 * m][j >> 1], a[2 * m + 1][j >> 1], (j & 1) ? 0x7632 : 0x5410);
        else
          o[j][m] = a[m][j];
      }
#pragma unroll
    for (int j = 0; j < V; ++j)
      *reinterpret_cast<uint4*>(y + size_t(c0 + j) * rows + r0) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
    return;
  }
  for (int j = 0; j < V && c0 + j < cols; ++j)
    for (int i = 0; i < V && r0 + i < rows; ++i)
      y[size_t(c0 + j) * rows + r0 + i] = x[size_t(r0 + i) * cols + c0 + j];
}

template <typename E>
int transpose2d(const void* x, void* y, int rows, int cols, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                  rows % V == 0 && cols % V == 0;
  const int tr = WARPS * ROW_BLOCKS * V, tc = PIECES * V;
  const dim3 grid((rows + tr - 1) / tr, (cols + tc - 1) / tc);
  transpose2d_kernel<E><<<grid, THREADS, 0, stream>>>(static_cast<const E*>(x), static_cast<E*>(y), rows,
                                                       cols, vec);
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
