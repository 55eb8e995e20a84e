// GroupNorm + SiLU over [B, HW, C] (channels last), one block per
// (sample, group).
//
// Replaces the TPU kernel diffusion_model_nemo_tpu/ops/norm.py:_kernel
// (launcher _pallas_forward, no-FiLM branch): per (sample, group) f32 stats
// in the one-pass form E[x^2] - E[x]^2 clipped at 0, eps 1e-5, then
// (x - mean) * rstd * gamma + beta and SiLU, cast back to the input type.
//
// What bounds it on the H100: bytes. It reads x once for the statistics and
// once more to normalise, and writes the output once: ~10 flops per element
// against 4-6 bytes, far below the card's ~20 flops/byte balance point for
// f32 CUDA-core work. The TPU kernel held a whole sample in VMEM; here a
// block owns one (sample, group) slice (HW * C/G elements, at most 128 KB
// in bf16 on the U-Net's path), so the second read mostly hits L2 (50 MB),
// and B * G blocks (512 at B=64, G=8) fill the 132 SMs. Each thread walks
// the slice with a stride of the block, so one warp covers 32 consecutive
// elements of the slice; within a row of C channels a group's C/G channels
// are contiguous.

#include "common.cuh"

namespace {

template <typename T>
__global__ void gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, T* __restrict__ out, int HW,
                               int C, int groups, float eps) {
  __shared__ float scratch[64];
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / groups;
  const long n = static_cast<long>(HW) * cg;
  const T* xs = x + static_cast<long>(b) * HW * C + g * cg;
  T* os = out + static_cast<long>(b) * HW * C + g * cg;

  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < n; i += blockDim.x) {
    const long row = i / cg;
    const int c = static_cast<int>(i - row * cg);
    const float v = dmn::to_f32(xs[row * C + c]);
    s += v;
    ss += v * v;
  }
  const float2 tot = dmn::block_sum2(s, ss, scratch);
  const float2 st = dmn::fast_variance_stats(tot.x, tot.y, static_cast<float>(n), eps);

  for (long i = threadIdx.x; i < n; i += blockDim.x) {
    const long row = i / cg;
    const int c = static_cast<int>(i - row * cg);
    const float v = dmn::to_f32(xs[row * C + c]);
    const float y = (v - st.x) * st.y * gamma[g * cg + c] + beta[g * cg + c];
    os[row * C + c] = dmn::from_f32<T>(y / (1.f + __expf(-y)));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out, int B, int HW,
           int C, int groups, float eps, void* stream) {
  const dim3 grid(groups, B);
  gn_silu_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(out), HW, C, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_gn)

// dtype: 0 = float32, 1 = bfloat16.
DMN_EXPORT int dmn_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* out, int B, int HW, int C, int groups, float eps,
                                   int dtype, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, B, HW, C, groups, eps, stream);
  return launch<float>(x, gamma, beta, out, B, HW, C, groups, eps, stream);
}
