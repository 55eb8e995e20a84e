// GroupNorm (+ FiLM) + SiLU over [B, HW, C] (channels last), one block per
// (sample, group).
//
// Replaces two TPU kernels of diffusion_model_nemo_tpu/ops/norm.py (launcher
// _pallas_forward):
//   * _kernel (no FiLM): per (sample, group) f32 stats in the one-pass form
//     E[x^2] - E[x]^2 clipped at 0, then (x - mean) * rstd * gamma + beta and
//     SiLU, cast back to the input type.
//   * _kernel_film: the same, with y * (scale + 1) + shift before the SiLU.
//     The TPU launcher broadcast scale and shift to x's full shape and
//     streamed both; here they are read in place through a (sample, pixel)
//     stride pair, so a per-sample [B,1,1,C] FiLM (strides (C, 0)) costs no
//     copy and a full [B,H,W,C] map (strides (HW*C, C)) works as well. They
//     may be f32 or x's type; the arithmetic is f32 either way.
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

struct Film {
  const void* scale;  // null: no FiLM
  const void* shift;
  long scale_sample, scale_pixel;  // element strides; the channel stride is 1
  long shift_sample, shift_pixel;
};

template <typename T, typename S, bool FILM>
__global__ void gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                               const float* __restrict__ beta, Film film, T* __restrict__ out,
                               int HW, int C, int groups, float eps) {
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

  const S* sc = static_cast<const S*>(film.scale);
  const S* sh = static_cast<const S*>(film.shift);
  for (long i = threadIdx.x; i < n; i += blockDim.x) {
    const long row = i / cg;
    const int c = static_cast<int>(i - row * cg);
    const int ch = g * cg + c;
    const float v = dmn::to_f32(xs[row * C + c]);
    float y = (v - st.x) * st.y * gamma[ch] + beta[ch];
    if (FILM) {
      const float f = dmn::to_f32(sc[b * film.scale_sample + row * film.scale_pixel + ch]);
      const float h = dmn::to_f32(sh[b * film.shift_sample + row * film.shift_pixel + ch]);
      y = y * (f + 1.f) + h;
    }
    os[row * C + c] = dmn::from_f32<T>(y / (1.f + __expf(-y)));
  }
}

template <typename T, typename S, bool FILM>
int launch(const void* x, const void* gamma, const void* beta, const Film& film, void* out,
           int B, int HW, int C, int groups, float eps, void* stream) {
  const dim3 grid(groups, B);
  gn_silu_kernel<T, S, FILM><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), film, static_cast<T*>(out), HW, C, groups, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_gn)

// dtype: 0 = float32, 1 = bfloat16.
DMN_EXPORT int dmn_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   void* out, int B, int HW, int C, int groups, float eps,
                                   int dtype, void* stream) {
  const Film none{nullptr, nullptr, 0, 0, 0, 0};
  if (dtype == 1)
    return launch<__nv_bfloat16, float, false>(x, gamma, beta, none, out, B, HW, C, groups,
                                               eps, stream);
  return launch<float, float, false>(x, gamma, beta, none, out, B, HW, C, groups, eps, stream);
}

// FiLM form. scale/shift hold element (sample, pixel) strides; their type is
// float32 (film_dtype 0) or x's bf16 (film_dtype 1, only with dtype 1).
DMN_EXPORT int dmn_group_norm_silu_film(const void* x, const void* gamma, const void* beta,
                                        const void* scale, const void* shift,
                                        long scale_sample, long scale_pixel, long shift_sample,
                                        long shift_pixel, void* out, int B, int HW, int C,
                                        int groups, float eps, int dtype, int film_dtype,
                                        void* stream) {
  const Film film{scale, shift, scale_sample, scale_pixel, shift_sample, shift_pixel};
  if (dtype == 1 && film_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, true>(x, gamma, beta, film, out, B, HW, C,
                                                      groups, eps, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, float, true>(x, gamma, beta, film, out, B, HW, C, groups, eps,
                                              stream);
  return launch<float, float, true>(x, gamma, beta, film, out, B, HW, C, groups, eps, stream);
}
