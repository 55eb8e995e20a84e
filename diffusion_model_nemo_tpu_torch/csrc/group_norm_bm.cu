// Batch-minor GroupNorm (+ FiLM) + SiLU, in place on a [HW, C, B] buffer.
//
// Replaces the TPU kernel diffusion_model_nemo_tpu/ops/norm.py:_kernel_bm
// (launcher _pallas_forward_bm). The launcher transposes x [B, H, W, C] to
// [HW, C, B] (samples on the fastest axis), runs the kernel on that buffer
// in place, and transposes back; the Python wrapper does the same two
// transposes. Statistics are per (group, sample) in f32, in the one-pass
// form E[x^2] - E[x]^2 clipped at 0; then, as the TPU kernel folds them,
// a = rstd * gamma, b = beta - mean * a, with FiLM a *= scale + 1 and
// b = b * (scale + 1) + shift (scale and shift per (channel, sample), as
// [C, B] f32), y = x * a + b, SiLU, cast to the buffer's type.
//
// What bounds it on the H100: bytes (~10 flops per element against 4-6
// bytes). The TPU kernel held a [HW, C, 128] block in VMEM and read it
// twice there. Here a (group, sample) slice is spread over many blocks, so
// the statistics are a reduction across blocks: two launches. A block owns
// 32 samples (threadIdx.x, the fastest axis, so a warp reads 32 neighbouring
// samples of one (pixel, channel)) of one group, and one of `splits` ranges
// of that group's (pixel, channel) rows; its 8 warps stride over the range.
//   1. bm_stats: partial sum / sum of squares per (split, group, sample).
//   2. bm_apply: merges the splits in a fixed order (results do not depend
//      on scheduling), normalises its range in place.
// The wrapper picks `splits` so that a call fills the 132 SMs about four
// times over; the second read of x mostly hits L2.

#include "common.cuh"

namespace {

constexpr int SAMPLES = 32;  // samples per block (threadIdx.x)
constexpr int ROWS = 8;      // warps per block (threadIdx.y)

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Row range [r0, r1) of split `sp`, over the n = HW * cg rows of a group.
__device__ __forceinline__ int2 split_range(int n, int splits, int sp) {
  const int per = ceil_div(n, splits);
  return make_int2(min(n, sp * per), min(n, (sp + 1) * per));
}

template <typename T>
__global__ void bm_stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int HW,
                                int C, int B, int groups) {
  __shared__ float2 red[ROWS][SAMPLES];
  const int s = blockIdx.x * SAMPLES + threadIdx.x;
  const int g = blockIdx.y, sp = blockIdx.z, splits = gridDim.z;
  const int cg = C / groups;
  const int2 rng = split_range(HW * cg, splits, sp);
  float a = 0.f, q = 0.f;
  for (int r = rng.x + threadIdx.y; r < rng.y; r += ROWS) {
    const int hw = r / cg, c = g * cg + r % cg;
    const float v = dmn::to_f32(x[(static_cast<size_t>(hw) * C + c) * B + s]);
    a += v;
    q += v * v;
  }
  red[threadIdx.y][threadIdx.x] = make_float2(a, q);
  __syncthreads();
  if (threadIdx.y == 0) {
    float2 t = red[0][threadIdx.x];
    for (int w = 1; w < ROWS; ++w) {  // fixed order: deterministic
      t.x += red[w][threadIdx.x].x;
      t.y += red[w][threadIdx.x].y;
    }
    part[(static_cast<size_t>(sp) * groups + g) * B + s] = t;
  }
}

template <typename T>
__global__ void bm_apply_kernel(T* __restrict__ x, const float* __restrict__ gamma,
                                const float* __restrict__ beta, const float* __restrict__ scale,
                                const float* __restrict__ shift, const float2* __restrict__ part,
                                int HW, int C, int B, int groups, float eps) {
  const int s = blockIdx.x * SAMPLES + threadIdx.x;
  const int g = blockIdx.y, sp = blockIdx.z, splits = gridDim.z;
  const int cg = C / groups;
  float sum = 0.f, sq = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float2 t = part[(static_cast<size_t>(k) * groups + g) * B + s];
    sum += t.x;
    sq += t.y;
  }
  const float2 st = dmn::fast_variance_stats(sum, sq, static_cast<float>(HW) * cg, eps);
  const int2 rng = split_range(HW * cg, splits, sp);
  for (int r = rng.x + threadIdx.y; r < rng.y; r += ROWS) {
    const int hw = r / cg, c = g * cg + r % cg;
    float a = st.y * gamma[c];
    float b = beta[c] - st.x * a;
    if (scale) {
      const float f = scale[static_cast<size_t>(c) * B + s] + 1.f;
      a *= f;
      b = b * f + shift[static_cast<size_t>(c) * B + s];
    }
    const size_t i = (static_cast<size_t>(hw) * C + c) * B + s;
    const float y = dmn::to_f32(x[i]) * a + b;
    x[i] = dmn::from_f32<T>(y / (1.f + __expf(-y)));
  }
}

template <typename T>
int launch(void* x, const void* gamma, const void* beta, const void* scale, const void* shift,
           void* part, int HW, int C, int B, int groups, int splits, float eps,
           cudaStream_t stream) {
  const dim3 grid(B / SAMPLES, groups, splits), block(SAMPLES, ROWS);
  auto* p = static_cast<float2*>(part);
  bm_stats_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), p, HW, C, B, groups);
  bm_apply_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(scale), static_cast<const float*>(shift), p, HW, C, B, groups,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_gn_bm)

// x: [HW, C, B] (bf16 where dtype == 1, else f32), normalised in place;
// gamma, beta: [C] f32; scale, shift: [C, B] f32 or null; part: splits *
// groups * B float2 of scratch. B is a multiple of 32.
DMN_EXPORT int dmn_group_norm_bm(void* x, const void* gamma, const void* beta, const void* scale,
                                 const void* shift, void* part, int HW, int C, int B, int groups,
                                 int splits, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, scale, shift, part, HW, C, B, groups, splits,
                                 eps, st);
  return launch<float>(x, gamma, beta, scale, shift, part, HW, C, B, groups, splits, eps, st);
}
