// Bottleneck self-attention block on [B, N, C] with small N, one block per
// sample.
//
// Replaces the TPU kernel diffusion_model_nemo_tpu/ops/attention.py:
// _attn_block_small_kernel (launcher _pallas_attn_block_small): the whole
// Residual(PreNorm(Attention)) block - GroupNorm(1) with its affine folded
// into W_qkv -> qkv -> max-subtracted softmax attention, 4 heads x 32 ->
// out projection + bias -> + x (no out-norm).
// The TPU kernel batched G samples per grid step with stacked cross-sample
// masks so its matrix unit saw large operands; that is a TPU device. Here
// each block computes one sample's attention directly.
//
// What bounds it on the H100: at the U-Net's mid level (N = 16, C = 256)
// the work per sample is ~3 MFLOP of projections and ~0.1 MFLOP of
// attention; the bytes are x, the output and W_qkv (C x 384 bf16 = 196 KB,
// read from L2 by every block). Shared memory cannot hold W_qkv beside the
// activations, so the weights are not staged: each thread streams its
// output column of W straight from L2 (consecutive threads read consecutive
// columns), and shared memory holds only the sample's activations
// (x / scores, and qkv with a padded row stride against bank conflicts).
// B blocks of 256 threads run on CUDA cores; the kernel is bound by the
// f32 FMA rate of the projections, not by memory.
//
// Seams kept from the TPU kernel: the prenorm's (x - mu) * rstd rounded to
// bf16 before the folded affine; q, k, v, the probabilities and the
// attention output rounded to bf16; f32 accumulation everywhere.

#include "common.cuh"

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;
constexpr int HD = HEADS * DH;  // 128
constexpr int QKV = 3 * HD;     // 384
constexpr int QS = QKV + 1;     // padded qkv row stride in shared memory
constexpr int THREADS = 256;

// Dynamic shared memory: A[max(N*C, HEADS*N*N)] (x, then h, then scores)
// + qkv[N*QS] (q's columns are reused for the attention output).
__global__ void attn_block_small_kernel(const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ w,  // [C][QKV]
                                        const float* __restrict__ bq,         // [QKV]
                                        const __nv_bfloat16* __restrict__ wout,  // [HD][C]
                                        const float* __restrict__ bout,          // [C]
                                        __nv_bfloat16* __restrict__ out, int N, int C,
                                        int a_floats, float scale, float eps) {
  extern __shared__ float smem[];
  __shared__ float red[64];
  float* A = smem;
  float* qkv = smem + a_floats;
  const int b = blockIdx.x;
  const __nv_bfloat16* xs = x + size_t(b) * N * C;

  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    const float v = __bfloat162float(xs[i]);
    A[i] = v;
    s += v;
    ss += v * v;
  }
  const float2 tot = dmn::block_sum2(s, ss, red);  // synchronises the block
  const float2 st = dmn::fast_variance_stats(tot.x, tot.y, float(N) * C, eps);
  for (int i = threadIdx.x; i < N * C; i += blockDim.x)
    A[i] = dmn::bf16_round((A[i] - st.x) * st.y);
  __syncthreads();

  for (int i = threadIdx.x; i < N * QKV; i += blockDim.x) {
    const int n = i / QKV, j = i % QKV;
    const float* hr = A + n * C;
    float a = bq[j];
    for (int c = 0; c < C; ++c) a += hr[c] * __bfloat162float(w[size_t(c) * QKV + j]);
    qkv[n * QS + j] = dmn::bf16_round(a);
  }
  __syncthreads();

  // scores[hh][i][j] = q_i . k_j over head hh's 32 channels, x scale
  for (int e = threadIdx.x; e < HEADS * N * N; e += blockDim.x) {
    const int hh = e / (N * N), i = (e / N) % N, j = e % N;
    const float* qi = qkv + i * QS + hh * DH;
    const float* kj = qkv + j * QS + HD + hh * DH;
    float a = 0.f;
    for (int d = 0; d < DH; ++d) a += qi[d] * kj[d];
    A[e] = a * scale;
  }
  __syncthreads();
  for (int row = threadIdx.x; row < HEADS * N; row += blockDim.x) {
    float* p = A + row * N;
    float m = -INFINITY;
    for (int j = 0; j < N; ++j) m = fmaxf(m, p[j]);
    float den = 0.f;
    for (int j = 0; j < N; ++j) {
      const float e = __expf(p[j] - m);
      p[j] = e;
      den += e;
    }
    const float inv = 1.f / den;
    for (int j = 0; j < N; ++j) p[j] = dmn::bf16_round(p[j] * inv);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * HD; e += blockDim.x) {  // P . v into q's columns
    const int i = e / HD, col = e % HD, hh = col / DH;
    const float* p = A + (hh * N + i) * N;
    float a = 0.f;
    for (int j = 0; j < N; ++j) a += p[j] * qkv[j * QS + 2 * HD + col];
    qkv[i * QS + col] = dmn::bf16_round(a);  // row i's q is no longer read
  }
  __syncthreads();
  __nv_bfloat16* os = out + size_t(b) * N * C;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    const int n = i / C, c = i % C;
    const float* ar = qkv + n * QS;
    float a = bout[c];
    for (int j = 0; j < HD; ++j) a += ar[j] * __bfloat162float(wout[size_t(j) * C + c]);
    os[i] = __float2bfloat16(a + __bfloat162float(xs[i]));
  }
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_attn_small)

// x [B,N,C] bf16 -> out [B,N,C] bf16. wqkv [C,384] bf16 holds the prenorm
// gamma folded in, bqkv [384] f32 = beta @ W_qkv; wout [128,C] bf16;
// bout [C] f32.
DMN_EXPORT int dmn_attn_block_small(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wout, const void* bout, void* out, int B,
                                    int N, int C, float scale, float eps, void* stream) {
  const int a_floats = ((N * C > HEADS * N * N ? N * C : HEADS * N * N) + 3) & ~3;
  const size_t smem = sizeof(float) * (size_t(a_floats) + size_t(N) * QS);
  cudaError_t err = dmn::set_smem((const void*)attn_block_small_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_block_small_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const __nv_bfloat16*>(wout),
      static_cast<const float*>(bout), static_cast<__nv_bfloat16*>(out), N, C, a_floats,
      scale, eps);
  return static_cast<int>(cudaGetLastError());
}
