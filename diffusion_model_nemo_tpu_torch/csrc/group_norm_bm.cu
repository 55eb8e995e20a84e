// Batch-minor GroupNorm (+ FiLM) + SiLU: the switched route's kernel, one
// block per sample, one read of x and one write of y.
//
// Replaces the TPU kernel diffusion_model_nemo_tpu/ops/norm.py:_kernel_bm
// (launcher _pallas_forward_bm). On the TPU, x lay batch-minor ([HW, C, B],
// 128 samples on the lanes, a bitcast of XLA's layout) and one grid step
// held a [HW, C, 128] block in VMEM: per-channel f32 sums and sums of
// squares over HW, the C/G channels of each group folded, the one-pass
// variance E[x^2] - E[x]^2 clipped at 0, a = rstd * gamma, b = beta - mean *
// a, FiLM per (sample, channel) as a * (scale + 1) and b * (scale + 1) +
// shift, y = x * a + b, SiLU, all in one HBM read and one write. The
// batch-minor layout was the TPU's way to fill its lanes; on the card it
// would be two strided copies of the tensor, so it goes, and the one read
// and one write stay.
//
// What bounds it on the H100: bytes (~12 flops per element against 4-8
// bytes). A sample's [HW, C] slab is contiguous in NHWC and, at every shape
// the gate admits (H*W*C*128*itemsize <= 12 MiB), at most 96 KiB: it comes
// into shared memory whole, by 16-byte cp.async, and x is read from device
// memory once.
//   1. Each thread owns one piece column (V consecutive channels, 16 bytes)
//      and a fixed set of pixels (rows), and sums its V channels over them.
//   2. The partials are reduced per channel in a fixed order (rows split
//      over S threads a channel, then the S sums in order), then the C/G
//      channels of each group are folded in order: the result does not
//      depend on scheduling, and the order is the TPU kernel's (channels,
//      then groups).
//   3. Per channel a and b, FiLM read in place through (sample, channel)
//      strides (f32 or x's type).
//   4. y = x * a + b, SiLU, from shared memory to y by 16-byte stores.
// Where C * itemsize is not a multiple of 16 (or x is not 16-byte aligned)
// a piece is one element and the copies are plain loads.

#include "group_norm.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 512;

struct Film {
  const void* scale;  // null: no FiLM
  const void* shift;
  long scale_sample, scale_channel;  // element strides
  long shift_sample, shift_channel;
};

using dmn::align16;
using dmn::film_at;
using dmn::load_piece;

// V: elements per piece (16 / sizeof(T), or 1).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
gn_bm_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ gamma,
             const float* __restrict__ beta, Film film, int film_bf16, int HW, int C, int groups,
             float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = C / V;                // pieces per pixel
  const int rows = THREADS / P;       // pixel rows walked in parallel
  const int S = THREADS / C;          // threads per channel in the reduction
  const int n = HW * P;               // pieces in the slab
  T* xs = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + align16(HW * C * sizeof(T)));  // [2][rows][C]
  float* red = part + 2 * rows * C;   // [2][S][C]
  float* chs = red + 2 * S * C;       // [2][C]: per-channel sums
  float* coef = chs + 2 * C;          // [2][C]: a, b
  float* gst = coef + 2 * C;          // [2][groups]: mean, rstd
  const int b = blockIdx.x;
  const T* xb = x + size_t(b) * HW * C;
  T* yb = y + size_t(b) * HW * C;
  const int tid = threadIdx.x;

  // 0. The slab into shared memory.
  if (V * sizeof(T) == 16) {
    const uint32_t dst = dmn::smem_u32(xs);
    for (int i = tid; i < n; i += THREADS) dmn::cp_async16(dst + 16 * i, xb + size_t(V) * i, true);
    dmn::cp_async_commit();
    dmn::cp_async_wait<0>();
  } else {
    for (int i = tid; i < n; i += THREADS) xs[i] = xb[i];
  }
  __syncthreads();

  // 1. Per-thread sums of its V channels over its rows.
  const int pc = tid % P, r = tid / P;
  const bool active = r < rows;
  float s[V], q[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = q[v] = 0.f;
  if (active) {
    for (int i = r * P + pc; i < n; i += rows * P) {
      float e[V];
      load_piece<T, V>(xs + i * V, e);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        s[v] += e[v];
        q[v] += e[v] * e[v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      part[r * C + pc * V + v] = s[v];
      part[(rows + r) * C + pc * V + v] = q[v];
    }
  }
  __syncthreads();
  // 2. Per channel: S threads each sum every S-th row, then one sums the S.
  dmn::channel_sums(part, red, chs, rows, C, THREADS);
  const int cg = C / groups;
  if (tid < groups) {  // fold the group's channels in order
    float a = 0.f, aq = 0.f;
    for (int c = tid * cg; c < (tid + 1) * cg; ++c) {
      a += chs[c];
      aq += chs[C + c];
    }
    const float2 st = dmn::fast_variance_stats(a, aq, static_cast<float>(HW) * cg, eps);
    gst[tid] = st.x;
    gst[groups + tid] = st.y;
  }
  __syncthreads();
  // 3. Per channel a and b, with FiLM.
  if (tid < C) {
    const int g = tid / cg;
    float a = gst[groups + g] * gamma[tid];
    float bb = beta[tid] - gst[g] * a;
    if (film.scale) {
      const float f = film_at(film.scale, film_bf16, b * film.scale_sample + tid * film.scale_channel) + 1.f;
      a *= f;
      bb = bb * f + film_at(film.shift, film_bf16, b * film.shift_sample + tid * film.shift_channel);
    }
    coef[tid] = a;
    coef[C + tid] = bb;
  }
  __syncthreads();
  // 4. y = silu(x * a + b), V channels a piece, the thread's own columns.
  if (!active) return;
  float ca[V], cb[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ca[v] = coef[pc * V + v];
    cb[v] = coef[C + pc * V + v];
  }
  for (int i = r * P + pc; i < n; i += rows * P) {
    float e[V];
    load_piece<T, V>(xs + i * V, e);
    uint4 u;
    T* o = V * sizeof(T) == 16 ? reinterpret_cast<T*>(&u) : yb + size_t(V) * i;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float h = e[v] * ca[v] + cb[v];
      o[v] = dmn::from_f32<T>(h / (1.f + __expf(-h)));
    }
    if (V * sizeof(T) == 16) *reinterpret_cast<uint4*>(yb + size_t(V) * i) = u;
  }
}

// Dynamic shared memory of a launch: the slab, the partials, the reduction,
// the coefficients and the group statistics.
template <typename T, int V>
size_t smem_bytes(int HW, int C, int groups) {
  const int rows = THREADS / (C / V), S = THREADS / C;
  return align16(HW * C * sizeof(T)) + sizeof(float) * (2 * rows * C + 2 * S * C + 4 * C + 2 * groups);
}

template <typename T, int V>
int launch(const void* x, void* y, const void* gamma, const void* beta, const Film& film,
           int film_bf16, int B, int HW, int C, int groups, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, V>(HW, C, groups);
  const cudaError_t err = dmn::set_smem((const void*)gn_bm_kernel<T, V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_bm_kernel<T, V><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), film, film_bf16, HW, C, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* y, const void* gamma, const void* beta, const Film& film,
             int film_bf16, int B, int HW, int C, int groups, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch<T, V>(x, y, gamma, beta, film, film_bf16, B, HW, C, groups, eps, stream);
  return launch<T, 1>(x, y, gamma, beta, film, film_bf16, B, HW, C, groups, eps, stream);
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_gn_bm)

// x, y: [B, HW, C] (bf16 where dtype == 1, else f32), y a new tensor; gamma,
// beta: [C] f32; scale, shift: per (sample, channel), read at element strides
// (sample, channel), f32 (film_dtype 0) or bf16 (film_dtype 1), or null.
// C <= 512 and HW * C * itemsize <= 96 KiB (the gate's bound): with the
// partials that is at most ~140 KB of shared memory.
DMN_EXPORT int dmn_group_norm_bm(const void* x, void* y, const void* gamma, const void* beta,
                                 const void* scale, const void* shift, long scale_sample,
                                 long scale_channel, long shift_sample, long shift_channel, int B,
                                 int HW, int C, int groups, float eps, int dtype, int film_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Film film{scale, shift, scale_sample, scale_channel, shift_sample, shift_channel};
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, gamma, beta, film, film_dtype, B, HW, C, groups, eps, st);
  return dispatch<float>(x, y, gamma, beta, film, film_dtype, B, HW, C, groups, eps, st);
}
