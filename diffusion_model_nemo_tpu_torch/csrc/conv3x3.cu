// SAME 3x3 convolution + bias on NHWC tensors, f32 accumulation, output in
// x's dtype (float or bf16).
//
// Replaces TPU kernel diffusion_model_nemo_tpu/ops/conv.py:_tap_split_kernel
// (launcher _pallas_conv3x3). That kernel split the nine taps between the
// contraction and the output dimensions (one [M, 3C] x [3C, 3F] GEMM, then
// three shifted adds) so that a 32-channel conv would fill more of the TPU's
// 128-lane matrix unit. The split is a TPU layout device: every MAC runs once
// either way, so this kernel computes the convolution directly.
//
// What bounds it on the H100: 2 * B*H*W * 9 * C * F operations. At the
// tool's shapes that is 2.4-38.7 GFLOP against 8-34 MB of x and y, so a
// tensor-core kernel would be bound by bytes at C = F = 32 and by operations
// at C = F = 128. This simple form runs its MACs on CUDA cores in f32, so it
// is bound by CUDA-core FMA issue and by the shared-memory reads that feed
// it, far above either bound; wgmma on staged tiles is the next step.
//
// Design: one block per (band of TH output rows, tile of FT = 32 output
// channels, sample). Per chunk of CC = 32 input channels it stages the band
// with its one-row halo, zero-padded at every border, as [CC][TH+2][W+2]
// (f32), and the chunk's weights as [9][CC][FT] (f32): [3,3,128,128] in bf16
// is 295 KB, more than a block's 227 KB of shared memory, so weights come per
// chunk too. TH * W <= 128 output pixels per band; each of 256 threads owns 4
// pixels x 4 channels and reads 4 weights with one 16-byte load and 4 pixel
// values per (channel, tap) for 16 FMAs. The band covers whole rows, so no
// block reads another's halo from shared memory, and masks cover a ragged
// last band, F % 32 and C % 32.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FT = 32;                             // output channels per block
constexpr int CC = 32;                             // input channels per chunk
constexpr int PIX = 128;                           // output pixels per band, at most
constexpr int FGROUPS = FT / 4;                    // threads across the channel tile
constexpr int SLOTS = THREADS / FGROUPS;           // 32 pixel slots
constexpr int PPT = PIX / SLOTS;                   // 4 pixels per thread

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x,     // [B][H][W][C]
               const T* __restrict__ w,     // [3][3][C][F]
               const T* __restrict__ bias,  // [F] or null
               T* __restrict__ y,           // [B][H][W][F]
               int H, int W, int C, int F, int TH) {
  extern __shared__ float smem[];
  const int SW = W + 2, SR = TH + 2;
  float* xs = smem;             // [CC][SR][SW]
  float* ws = xs + CC * SR * SW;  // [9][CC][FT]; CC*SR*SW is a multiple of 4 floats
  const int r0 = blockIdx.x * TH, f0 = blockIdx.y * FT, b = blockIdx.z;
  const int fg = threadIdx.x % FGROUPS, slot = threadIdx.x / FGROUPS;

  int off[PPT], orow[PPT], ocol[PPT];
  bool valid[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = slot + SLOTS * k;
    const int r = p / W, c = p % W;
    valid[k] = p < TH * W && r0 + r < H;
    orow[k] = valid[k] ? r : 0;
    ocol[k] = valid[k] ? c : 0;
    off[k] = orow[k] * SW + ocol[k];
  }
  float acc[PPT][4];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < SR * SW * CC; i += THREADS) {
      const int c = i % CC, pix = i / CC;
      const int sc = pix % SW, sr = pix / SW;
      const int gr = r0 - 1 + sr, gc = sc - 1;
      float v = 0.f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && c0 + c < C)
        v = dmn::to_f32(x[((size_t(b) * H + gr) * W + gc) * C + c0 + c]);
      xs[(c * SR + sr) * SW + sc] = v;
    }
    for (int i = threadIdx.x; i < 9 * CC * FT; i += THREADS) {
      const int f = i % FT, c = (i / FT) % CC, tap = i / (FT * CC);
      float v = 0.f;
      if (c0 + c < C && f0 + f < F) v = dmn::to_f32(w[(size_t(tap) * C + c0 + c) * F + f0 + f]);
      ws[i] = v;
    }
    __syncthreads();
    const int cn = min(CC, C - c0);
    for (int c = 0; c < cn; ++c) {
      const float* xc = xs + c * SR * SW;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(ws + ((ky * 3 + kx) * CC + c) * FT + 4 * fg);
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const float xv = xc[off[k] + ky * SW + kx];
            acc[k][0] = fmaf(xv, wv.x, acc[k][0]);
            acc[k][1] = fmaf(xv, wv.y, acc[k][1]);
            acc[k][2] = fmaf(xv, wv.z, acc[k][2]);
            acc[k][3] = fmaf(xv, wv.w, acc[k][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (!valid[k]) continue;
    T* yp = y + ((size_t(b) * H + r0 + orow[k]) * W + ocol[k]) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + 4 * fg + j;
      if (f < F) yp[f] = dmn::from_f32<T>(acc[k][j] + (bias ? dmn::to_f32(bias[f]) : 0.f));
    }
  }
}

template <typename T>
int conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H, int W, int C,
            int F, cudaStream_t stream) {
  const int TH = max(1, PIX / W);
  const size_t smem = sizeof(float) * (size_t(CC) * (TH + 2) * (W + 2) + 9 * CC * FT);
  const cudaError_t err = dmn::set_smem((const void*)conv3x3_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_kernel<T><<<dim3(ceil_div(H, TH), ceil_div(F, FT), B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), H, W, C, F, TH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_conv)

// x [B,H,W,C], w [3,3,C,F], bias [F] (or null), y [B,H,W,F]: all f32, or all
// bf16 where `bf16`. W <= 128 (a band holds at most 128 output pixels).
DMN_EXPORT int dmn_conv3x3(const void* x, const void* w, const void* bias, void* y, int B, int H,
                           int W, int C, int F, int bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bf16) return conv3x3<__nv_bfloat16>(x, w, bias, y, B, H, W, C, F, stream);
  return conv3x3<float>(x, w, bias, y, B, H, W, C, F, stream);
}
