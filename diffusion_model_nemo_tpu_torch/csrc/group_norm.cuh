// Pieces the two GroupNorm(+FiLM)+SiLU kernels share (group_norm_silu.cu,
// group_norm_bm.cu): 16-byte pieces of a channels-last row, a FiLM element,
// and the fixed-order reduction of per-thread partial sums to per-channel
// sums (the first step of the TPU kernels' _group_stats: channels over the
// pixels first, then the C/G channels of each group).
#pragma once

#include "common.cuh"

namespace dmn {

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// A FiLM scale or shift element: bf16 where `bf16`, else f32.
__device__ __forceinline__ float film_at(const void* p, int bf16, long i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// The V elements of one piece as f32 (one 16-byte load where V fills 16 bytes).
template <typename T, int V>
__device__ __forceinline__ void load_piece(const T* p, float (&e)[V]) {
  if (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = to_f32(t[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = to_f32(p[v]);
  }
}

// Per-channel sums of the partials part[2][rows][C] (sums, then sums of
// squares; row r of a channel is one thread's share) in a fixed order: S =
// max(1, nthreads / C) threads a channel each add every S-th row, then one
// adds the S. Result in chs[2][C]; red holds [2][S][C]. Ends synchronised.
__device__ __forceinline__ void channel_sums(const float* part, float* red, float* chs, int rows,
                                             int C, int nthreads) {
  const int S = max(1, nthreads / C);
  for (int i = threadIdx.x; i < S * C; i += nthreads) {
    const int c = i % C, k = i / C;
    float a = 0.f, aq = 0.f;
    for (int rr = k; rr < rows; rr += S) {
      a += part[rr * C + c];
      aq += part[(rows + rr) * C + c];
    }
    red[k * C + c] = a;
    red[(S + k) * C + c] = aq;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += nthreads) {
    float a = 0.f, aq = 0.f;
    for (int k = 0; k < S; ++k) {
      a += red[k * C + c];
      aq += red[(S + k) * C + c];
    }
    chs[c] = a;
    chs[C + c] = aq;
  }
  __syncthreads();
}

}  // namespace dmn
