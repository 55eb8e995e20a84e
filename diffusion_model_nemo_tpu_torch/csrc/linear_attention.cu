// Linear attention on natural [B, N, C] token rows: the whole
// Residual(PreNorm(LinearAttention)) block, the qkv-fused attention core, and
// the attention core on a raw qkv tensor.
//
// Replaces three TPU kernels of diffusion_model_nemo_tpu/ops/attention.py:
//   * _linattn_block_packed_kernel (launcher _pallas_linattn_block_packed):
//     GroupNorm(1) with its affine folded into W_qkv -> qkv -> q softmax over
//     d per head, x scale; k softmax over N -> per-head gram k^T v -> q . gram
//     -> out projection + bias -> GroupNorm(1) with affine -> + x.
//   * _linattn_qkv_fused_kernel (launcher _pallas_linattn_qkv_fused): the same
//     attention core on pre-normed tokens, without the norms, the out
//     projection or the residual.
//   * _linattn_kernel (launcher _pallas_linear_attention): the attention core
//     on a raw qkv [B, N, 384] tensor (q | k | v columns), any dtype. It is
//     the float32 U-Net's route. Its kv and apply stages load the qkv tile
//     instead of projecting it; templated on float and bf16.
//   * _linattn_block_kernel, v1 (launcher _pallas_linear_attention_block):
//     the whole block again, with the prenorm affine NOT folded into W_qkv
//     and with v1's own rounding points; see "v1" below.
//   * _linattn_block_kernel_v2 (launcher _pallas_linear_attention_block_v2):
//     the same block with every product's operands in x's dtype. In bf16 its
//     function is v1's, seam for seam; in float32 every stage stays f32. So
//     it runs v1's stages, instantiated for x's dtype. The TPU kernel took G
//     samples per grid step to batch its token GEMMs on the MXU; that was a
//     VMEM/MXU blocking with no counterpart here, where every (tile, sample)
//     is a block of its own.
//   * _v4_kernel (tools/microbench_attn_lanes.py, launcher v4_call): the
//     qkv-fused attention core on x viewed as [B, N*C/128, 128], so that the
//     TPU's (8, 128) tiles carry no lane padding. On the card the packed view
//     and [B, N, C] token rows are the same bytes, so the packing has no
//     counterpart: dmn_linattn_v4 reads the buffer as token rows and runs the
//     qkv-fused stages, instantiated for x's dtype (v4 runs in x's dtype).
// The TPU packed its tokens 128 lanes wide (J = 128/C tokens per row); that
// is a TPU layout device. Here a token is one row of C channels.
//
// What bounds it on the H100: a sample's f32 qkv is N * 384 * 4 bytes
// (1.5 MB at N = 1024). The TPU kept it in VMEM; 227 KB of shared memory
// cannot. So the kernels stream token tiles and recompute qkv where needed,
// and nothing of qkv reaches device memory:
//   1. xstats   (grid tiles x B): partial sum / sum of squares of x per
//      32-token tile (prenorm statistics; block form only).
//   2. kv       (grid chunks x B): each block projects k and v for its
//      128-token chunk, 32 tokens at a time, keeps an online column max and
//      sum for k's softmax over N, and accumulates the 4 per-head 32 x 32
//      grams in registers, rescaled whenever a column max grows.
//   3. merge    (grid heads x B): combines the chunks' (max, sum, gram) into
//      the softmax-normalised gram, rounded to bf16 like the TPU kernel.
//   4. apply    (grid tiles x B): projects q, takes its per-head softmax,
//      multiplies by the gram; the qkv-fused form writes this [N, 128]
//      output, the block form goes on through the out projection and writes
//      y (f32) with its tile's partial statistics.
//   5. outnorm  (grid tiles x B, block form): GroupNorm(1) of y + x.
// Partial sums are combined in a fixed order, so results do not depend on
// scheduling. The bytes that must move are x and the output (a few MB at
// B = 64); the streamed scratch (y and the chunk grams) adds about as much
// again, and the projections run on CUDA cores in f32 from bf16 operands,
// so this simple form is bound by CUDA-core FMA throughput, not by memory.
// Tensor cores (wgmma) and TMA are the next step.
//
// Seams kept from the TPU kernels: bf16 operands for every product with f32
// accumulation; the prenorm's (x - mu) * rstd rounded to bf16 before the
// folded affine; q softmax and gram rounded to bf16; f32 out-norm. The stages
// are templated on the token dtype T and round with dmn::round_to<T>, which
// is the identity for float: the entries of #8, #10 and #12 round only in
// their bf16 instantiations, as the JAX kernels do (x's dtype), and keep
// every stage f32 in float32. #2, #3 and #9 run the bf16 instantiations.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;            // dim_head
constexpr int HD = HEADS * DH;    // 128
constexpr int QKV = 3 * HD;       // 384
constexpr int TN = 32;            // tokens per tile
constexpr int CHUNK = 128;        // tokens per kv block
constexpr int THREADS = 256;
constexpr int GRAM = HEADS * DH * DH;  // 4096
constexpr int ACC = GRAM / THREADS;    // 16 gram entries per thread

struct Scratch {
  float2* xpart;  // [B][T]        prenorm partial sums (block form)
  float* mpart;   // [B][K][HD]    chunk column max of k
  float* spart;   // [B][K][HD]    chunk column sum of exp(k - max)
  float* gpart;   // [B][K][GRAM]  chunk grams, relative to the chunk max
  float* gram;    // [B][GRAM]     merged, softmax-normalised gram
  float* ybuf;    // [B][N][C]     out projection (block form)
  float2* ypart;  // [B][T]        partial sums of y (block form)
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Scratch layout, in floats; shared by the launcher and the Python wrapper.
inline size_t scratch_layout(int B, int N, int C, int block, Scratch* s, float* base) {
  const int T = ceil_div(N, TN), K = ceil_div(N, CHUNK);
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base ? base + off : nullptr;
    off += (n + 3) & ~size_t(3);  // keep 16-byte alignment
    return p;
  };
  float* xpart = take(size_t(B) * T * 2);
  float* mpart = take(size_t(B) * K * HD);
  float* spart = take(size_t(B) * K * HD);
  float* gpart = take(size_t(B) * K * GRAM);
  float* gram = take(size_t(B) * GRAM);
  float* ybuf = block ? take(size_t(B) * N * C) : nullptr;
  float* ypart = block ? take(size_t(B) * T * 2) : nullptr;
  if (s) {
    s->xpart = reinterpret_cast<float2*>(xpart);
    s->mpart = mpart;
    s->spart = spart;
    s->gpart = gpart;
    s->gram = gram;
    s->ybuf = ybuf;
    s->ypart = reinterpret_cast<float2*>(ypart);
  }
  return off;
}

// (mean, rstd) of one sample from its T partial sums, in a fixed order.
__device__ __forceinline__ float2 merge_stats(const float2* part, int T, float count,
                                              float eps) {
  float s = 0.f, ss = 0.f;
  for (int t = 0; t < T; ++t) {
    s += part[t].x;
    ss += part[t].y;
  }
  return dmn::fast_variance_stats(s, ss, count, eps);
}

// Load `rows` tokens of sample b from token n0 into h[rows][C] (f32): the
// prenorm output rounded to T (block form) or the input as is.
template <typename T>
__device__ __forceinline__ void load_tokens(const T* __restrict__ x, float* h, int b, int N, int C,
                                            int n0, int rows, bool prenorm, float2 st) {
  const T* xs = x + (size_t(b) * N + n0) * C;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const float v = dmn::to_f32(xs[i]);
    h[i] = prenorm ? dmn::round_to<T>((v - st.x) * st.y) : v;
  }
}

// 1. partial statistics of x per 32-token tile.
template <typename T>
__global__ void xstats_kernel(const T* __restrict__ x, float2* xpart, int N, int C) {
  __shared__ float red[64];
  const int t = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int n0 = t * TN, rows = min(TN, N - n0);
  const T* xs = x + (size_t(b) * N + n0) * C;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const float v = dmn::to_f32(xs[i]);
    s += v;
    ss += v * v;
  }
  const float2 tot = dmn::block_sum2(s, ss, red);
  if (threadIdx.x == 0) xpart[size_t(b) * nt + t] = tot;
}

// Online column max and sum of k's softmax over N, and the per-head gram
// update, for one tile of `rows` tokens in kv[rows][2*HD] (k then v, f32);
// k is replaced by exp(k - max). The caller synchronised after filling kv.
__device__ __forceinline__ void kv_tile_update(float* kv, int rows, float* rescale, float* mrun,
                                               float* srun, float (&acc)[ACC]) {
  if (threadIdx.x < HD) {  // one thread per k column: online max and sum
    const int j = threadIdx.x;
    float m = mrun[j];
    for (int r = 0; r < rows; ++r) m = fmaxf(m, kv[r * 2 * HD + j]);
    const float f = __expf(mrun[j] - m);  // 0 on the first tile
    float s = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float e = __expf(kv[r * 2 * HD + j] - m);
      kv[r * 2 * HD + j] = e;
      s += e;
    }
    srun[j] = srun[j] * f + s;
    mrun[j] = m;
    rescale[j] = f;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int idx = threadIdx.x + a * THREADS;
    const int hh = idx >> 10, i = (idx >> 5) & 31, jj = idx & 31;
    const int ck = hh * DH + i, cv = HD + hh * DH + jj;
    float g = acc[a] * rescale[ck];
    for (int r = 0; r < rows; ++r) g += kv[r * 2 * HD + ck] * kv[r * 2 * HD + cv];
    acc[a] = g;
  }
}

__device__ __forceinline__ void kv_init(float* mrun, float* srun, float (&acc)[ACC]) {
  if (threadIdx.x < HD) {
    mrun[threadIdx.x] = -INFINITY;
    srun[threadIdx.x] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
}

// Chunk k of sample b: its column max, sum and gram, for the merge.
__device__ __forceinline__ void kv_store(const Scratch& sc, int b, int k, int K,
                                         const float* mrun, const float* srun,
                                         const float (&acc)[ACC]) {
  const size_t bk = size_t(b) * K + k;
  if (threadIdx.x < HD) {
    sc.mpart[bk * HD + threadIdx.x] = mrun[threadIdx.x];
    sc.spart[bk * HD + threadIdx.x] = srun[threadIdx.x];
  }
#pragma unroll
  for (int a = 0; a < ACC; ++a) sc.gpart[bk * GRAM + threadIdx.x + a * THREADS] = acc[a];
}

// 2. k/v projection, online softmax statistics of k, chunk grams.
// Dynamic shared memory: h[TN*C] + kv[TN*2*HD] + scale[HD] + m[HD] + s[HD].
template <typename T>
__global__ void kv_kernel(const T* __restrict__ x,
                          const T* __restrict__ w,          // [C][QKV]
                          const float* __restrict__ bias,   // [QKV] or null
                          Scratch sc, int N, int C, int prenorm, float eps) {
  extern __shared__ float smem[];
  float* h = smem;
  float* kv = h + TN * C;
  float* rescale = kv + TN * 2 * HD;
  float* mrun = rescale + HD;
  float* srun = mrun + HD;

  const int k = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const int nt = ceil_div(N, TN);
  float2 st = make_float2(0.f, 1.f);
  if (prenorm) st = merge_stats(sc.xpart + size_t(b) * nt, nt, float(N) * C, eps);

  float acc[ACC];
  kv_init(mrun, srun, acc);

  const int c_end = min(N, (k + 1) * CHUNK);
  for (int n0 = k * CHUNK; n0 < c_end; n0 += TN) {
    const int rows = min(TN, c_end - n0);
    __syncthreads();  // previous tile's kv fully consumed
    load_tokens(x, h, b, N, C, n0, rows, prenorm, st);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * 2 * HD; i += blockDim.x) {
      const int r = i / (2 * HD), j = i % (2 * HD);
      const int col = HD + j;  // k and v columns of qkv
      float a = 0.f;
      const float* hr = h + r * C;
      for (int c = 0; c < C; ++c) a += hr[c] * dmn::to_f32(w[size_t(c) * QKV + col]);
      if (bias) a += bias[col];
      kv[r * 2 * HD + j] = j < HD ? a : dmn::round_to<T>(a);  // v is in T
    }
    __syncthreads();
    kv_tile_update(kv, rows, rescale, mrun, srun, acc);
  }
  __syncthreads();
  kv_store(sc, b, k, K, mrun, srun, acc);
}

// 2'. the same stage on a raw qkv tensor: k and v columns loaded, not projected.
// Dynamic shared memory: kv[TN*2*HD] + scale[HD] + m[HD] + s[HD].
template <typename T>
__global__ void qkv_kv_kernel(const T* __restrict__ qkv, Scratch sc, int N) {
  extern __shared__ float smem[];
  float* kv = smem;
  float* rescale = kv + TN * 2 * HD;
  float* mrun = rescale + HD;
  float* srun = mrun + HD;

  const int k = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  float acc[ACC];
  kv_init(mrun, srun, acc);
  const int c_end = min(N, (k + 1) * CHUNK);
  for (int n0 = k * CHUNK; n0 < c_end; n0 += TN) {
    const int rows = min(TN, c_end - n0);
    __syncthreads();  // previous tile's kv fully consumed
    const T* src = qkv + (size_t(b) * N + n0) * QKV + HD;
    for (int i = threadIdx.x; i < rows * 2 * HD; i += blockDim.x)
      kv[i] = dmn::to_f32(src[size_t(i / (2 * HD)) * QKV + i % (2 * HD)]);
    __syncthreads();
    kv_tile_update(kv, rows, rescale, mrun, srun, acc);
  }
  __syncthreads();
  kv_store(sc, b, k, K, mrun, srun, acc);
}

// 3. merge the chunks: gram = sum_k G_k e^{m_k - M} / sum_k S_k e^{m_k - M},
// rounded to bf16 where `round_bf16`.
__global__ void merge_kernel(Scratch sc, int K, int round_bf16) {
  const int hh = blockIdx.x, b = blockIdx.y;
  for (int e = threadIdx.x; e < DH * DH; e += blockDim.x) {
    const int i = e >> 5;
    const int ck = hh * DH + i;
    float M = -INFINITY;
    for (int k = 0; k < K; ++k) M = fmaxf(M, sc.mpart[(size_t(b) * K + k) * HD + ck]);
    float S = 0.f, G = 0.f;
    for (int k = 0; k < K; ++k) {
      const size_t bk = size_t(b) * K + k;
      const float f = __expf(sc.mpart[bk * HD + ck] - M);
      S += sc.spart[bk * HD + ck] * f;
      G += sc.gpart[bk * GRAM + hh * DH * DH + e] * f;
    }
    const float g = G / S;
    sc.gram[size_t(b) * GRAM + hh * DH * DH + e] = round_bf16 ? dmn::bf16_round(g) : g;
  }
}

// Per-head softmax over d of the q tile q[rows][HD], times scale, rounded to
// bf16 where `round_bf16`. The caller synchronised after filling q.
__device__ __forceinline__ void q_softmax(float* q, int rows, float scale, bool round_bf16) {
  for (int p = threadIdx.x; p < rows * HEADS; p += blockDim.x) {
    float* qh = q + (p / HEADS) * HD + (p % HEADS) * DH;
    float m = -INFINITY;
    for (int d = 0; d < DH; ++d) m = fmaxf(m, qh[d]);
    float s = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float e = __expf(qh[d] - m);
      qh[d] = e;
      s += e;
    }
    const float inv = scale / s;
    for (int d = 0; d < DH; ++d) qh[d] = round_bf16 ? dmn::bf16_round(qh[d] * inv) : qh[d] * inv;
  }
}

// Element i = r * HD + j of q_sm . gram (within j's head).
__device__ __forceinline__ float q_gram(const float* q, const float* gram, int i) {
  const int r = i / HD, j = i % HD;
  const int hh = j / DH, jj = j % DH;
  const float* qh = q + r * HD + hh * DH;
  const float* gh = gram + hh * DH * DH + jj;
  float a = 0.f;
  for (int d = 0; d < DH; ++d) a += qh[d] * gh[d * DH];
  return a;
}

// 4. q projection, per-head softmax over d, q . gram, and (block form) the
// out projection. Dynamic shared memory: h[TN*C] + q[TN*HD] + att[TN*HD]
// + gram[GRAM].
template <typename T>
__global__ void apply_kernel(const T* __restrict__ x,
                             const T* __restrict__ w,         // [C][QKV]
                             const float* __restrict__ bias,  // [QKV] or null
                             const T* __restrict__ wout,      // [HD][C] or null
                             const float* __restrict__ bout,  // [C] or null
                             T* __restrict__ att_out,         // [B][N][HD] or null
                             Scratch sc, int N, int C, int prenorm, float scale, float eps) {
  extern __shared__ float smem[];
  __shared__ float red[64];
  float* h = smem;
  float* q = h + TN * C;
  float* att = q + TN * HD;
  float* gram = att + TN * HD;

  const int t = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int n0 = t * TN, rows = min(TN, N - n0);
  float2 st = make_float2(0.f, 1.f);
  if (prenorm) st = merge_stats(sc.xpart + size_t(b) * nt, nt, float(N) * C, eps);
  load_tokens(x, h, b, N, C, n0, rows, prenorm, st);
  for (int i = threadIdx.x; i < GRAM; i += blockDim.x) gram[i] = sc.gram[size_t(b) * GRAM + i];
  __syncthreads();

  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    const int r = i / HD, j = i % HD;
    float a = 0.f;
    const float* hr = h + r * C;
    for (int c = 0; c < C; ++c) a += hr[c] * dmn::to_f32(w[size_t(c) * QKV + j]);
    if (bias) a += bias[j];
    q[i] = a;
  }
  __syncthreads();
  q_softmax(q, rows, scale, dmn::is_bf16<T>());
  __syncthreads();
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) {
    const float a = q_gram(q, gram, i);
    if (att_out)
      att_out[(size_t(b) * N + n0) * HD + i] = dmn::from_f32<T>(a);
    else
      att[i] = dmn::round_to<T>(a);
  }
  if (att_out) return;  // qkv-fused form ends here (uniform across the block)
  __syncthreads();
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const float* ar = att + r * HD;
    float a = bout[c];
    for (int j = 0; j < HD; ++j) a += ar[j] * dmn::to_f32(wout[size_t(j) * C + c]);
    sc.ybuf[(size_t(b) * N + n0) * C + i] = a;
    s += a;
    ss += a * a;
  }
  const float2 tot = dmn::block_sum2(s, ss, red);
  if (threadIdx.x == 0) sc.ypart[size_t(b) * nt + t] = tot;
}

// 4'. the apply stage on a raw qkv tensor: q columns loaded, not projected;
// out [B][N][HD] in T. Dynamic shared memory: q[TN*HD] + gram[GRAM].
template <typename T>
__global__ void qkv_apply_kernel(const T* __restrict__ qkv, T* __restrict__ out, Scratch sc,
                                 int N, float scale) {
  extern __shared__ float smem[];
  float* q = smem;
  float* gram = q + TN * HD;
  const int t = blockIdx.x, b = blockIdx.y;
  const int n0 = t * TN, rows = min(TN, N - n0);
  const T* src = qkv + (size_t(b) * N + n0) * QKV;
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x)
    q[i] = dmn::to_f32(src[size_t(i / HD) * QKV + i % HD]);
  for (int i = threadIdx.x; i < GRAM; i += blockDim.x) gram[i] = sc.gram[size_t(b) * GRAM + i];
  __syncthreads();
  q_softmax(q, rows, scale, dmn::is_bf16<T>());
  __syncthreads();
  T* dst = out + (size_t(b) * N + n0) * HD;
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x)
    dst[i] = dmn::from_f32<T>(q_gram(q, gram, i));
}

// 5. GroupNorm(1) of y with its affine, + x, cast to T.
template <typename T>
__global__ void outnorm_kernel(const T* __restrict__ x, const float* __restrict__ og,
                               const float* __restrict__ ob, T* __restrict__ out, Scratch sc,
                               int N, int C, float eps) {
  const int t = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int n0 = t * TN, rows = min(TN, N - n0);
  const float2 st = merge_stats(sc.ypart + size_t(b) * nt, nt, float(N) * C, eps);
  const size_t base = (size_t(b) * N + n0) * C;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int c = i % C;
    const float y = (sc.ybuf[base + i] - st.x) * st.y * og[c] + ob[c];
    out[base + i] = dmn::from_f32<T>(y + dmn::to_f32(x[base + i]));
  }
}

size_t kv_smem(int C) { return sizeof(float) * (TN * C + TN * 2 * HD + 3 * HD); }
size_t apply_smem(int C) { return sizeof(float) * (TN * C + 2 * TN * HD + GRAM); }
constexpr size_t QKV_KV_SMEM = sizeof(float) * (TN * 2 * HD + 3 * HD);
constexpr size_t QKV_APPLY_SMEM = sizeof(float) * (TN * HD + GRAM);

// ------------------------------------------------------------------- v1 --
// TPU kernel #9 computes the block with its own seams (ops/attention.py:
// 371-428): h = GroupNorm(1) with its affine in f32, rounded to bf16 for the
// qkv product; q, k and v stay f32; the q softmax subtracts one row max over
// all h*d columns and then divides by per-head sums; k_sm = exp(k - max) /
// sum over N in f32, rounded to bf16 with v for the gram; the masked gram,
// q_sm and attn rounded to bf16 for their products; f32 out-norm. Rounding
// k_sm before the gram needs k's column max and sum over the whole sample
// first, so the k/v stage runs twice: v1_kstats (online max and sum per
// chunk, as kv_kernel) and v1_gram (k_sm and v per tile with the merged
// statistics, plain per-chunk gram sums). A last merge adds the chunks in a
// fixed order. xstats and outnorm are shared with the packed form. The
// stages are templated on T, x's dtype: v1 runs them in bf16; v2 (#10) in
// x's dtype, where float keeps every rounding point above at f32.

// Prenorm rows of sample b with the affine applied in f32, then T.
template <typename T>
__device__ __forceinline__ void load_tokens_affine(const T* __restrict__ x,
                                                   const float* __restrict__ ng,
                                                   const float* __restrict__ nb, float* h, int b,
                                                   int N, int C, int n0, int rows, float2 st) {
  const T* xs = x + (size_t(b) * N + n0) * C;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int c = i % C;
    h[i] = dmn::round_to<T>((dmn::to_f32(xs[i]) - st.x) * st.y * ng[c] + nb[c]);
  }
}

// out[r * ncols + j] = h[r] . W[:, col0 + j] for `rows` rows, f32 accumulation.
template <typename T>
__device__ __forceinline__ void project(const float* h, const T* __restrict__ w, int rows, int C,
                                        int col0, int ncols, float* out) {
  for (int i = threadIdx.x; i < rows * ncols; i += blockDim.x) {
    const int r = i / ncols, j = i % ncols;
    const float* hr = h + r * C;
    float a = 0.f;
    for (int c = 0; c < C; ++c) a += hr[c] * dmn::to_f32(w[size_t(c) * QKV + col0 + j]);
    out[i] = a;
  }
}

// 2a. k projection and its online column max and sum over the chunk.
// Dynamic shared memory: h[TN*C] + k[TN*HD] + m[HD] + s[HD].
template <typename T>
__global__ void v1_kstats_kernel(const T* __restrict__ x, const float* __restrict__ ng,
                                 const float* __restrict__ nb, const T* __restrict__ w, Scratch sc,
                                 int N, int C, float eps) {
  extern __shared__ float smem[];
  float* h = smem;
  float* kt = h + TN * C;
  float* mrun = kt + TN * HD;
  float* srun = mrun + HD;
  const int k = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const float2 st = merge_stats(sc.xpart + size_t(b) * ceil_div(N, TN), ceil_div(N, TN),
                                float(N) * C, eps);
  if (threadIdx.x < HD) {
    mrun[threadIdx.x] = -INFINITY;
    srun[threadIdx.x] = 0.f;
  }
  const int c_end = min(N, (k + 1) * CHUNK);
  for (int n0 = k * CHUNK; n0 < c_end; n0 += TN) {
    const int rows = min(TN, c_end - n0);
    __syncthreads();  // previous tile consumed
    load_tokens_affine(x, ng, nb, h, b, N, C, n0, rows, st);
    __syncthreads();
    project(h, w, rows, C, HD, HD, kt);
    __syncthreads();
    if (threadIdx.x < HD) {
      const int j = threadIdx.x;
      float m = mrun[j];
      for (int r = 0; r < rows; ++r) m = fmaxf(m, kt[r * HD + j]);
      float s = srun[j] * __expf(mrun[j] - m);  // 0 on the first tile
      for (int r = 0; r < rows; ++r) s += __expf(kt[r * HD + j] - m);
      mrun[j] = m;
      srun[j] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < HD) {
    const size_t bk = size_t(b) * K + k;
    sc.mpart[bk * HD + threadIdx.x] = mrun[threadIdx.x];
    sc.spart[bk * HD + threadIdx.x] = srun[threadIdx.x];
  }
}

// 2b. k_sm = T(exp(k - M) / S) with the sample's column max M and sum S,
// v = T(v); per-chunk masked gram sums k_sm^T v.
// Dynamic shared memory: h[TN*C] + kv[TN*2*HD] + M[HD] + S[HD].
template <typename T>
__global__ void v1_gram_kernel(const T* __restrict__ x, const float* __restrict__ ng,
                               const float* __restrict__ nb, const T* __restrict__ w, Scratch sc,
                               int N, int C, float eps) {
  extern __shared__ float smem[];
  float* h = smem;
  float* kv = h + TN * C;
  float* colm = kv + TN * 2 * HD;
  float* cols = colm + HD;
  const int k = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const float2 st = merge_stats(sc.xpart + size_t(b) * ceil_div(N, TN), ceil_div(N, TN),
                                float(N) * C, eps);
  if (threadIdx.x < HD) {  // merge the chunks' column statistics, fixed order
    const int j = threadIdx.x;
    float M = -INFINITY;
    for (int kk = 0; kk < K; ++kk) M = fmaxf(M, sc.mpart[(size_t(b) * K + kk) * HD + j]);
    float S = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const size_t bk = size_t(b) * K + kk;
      S += sc.spart[bk * HD + j] * __expf(sc.mpart[bk * HD + j] - M);
    }
    colm[j] = M;
    cols[j] = S;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  const int c_end = min(N, (k + 1) * CHUNK);
  for (int n0 = k * CHUNK; n0 < c_end; n0 += TN) {
    const int rows = min(TN, c_end - n0);
    __syncthreads();  // previous tile consumed
    load_tokens_affine(x, ng, nb, h, b, N, C, n0, rows, st);
    __syncthreads();
    project(h, w, rows, C, HD, 2 * HD, kv);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * 2 * HD; i += blockDim.x) {
      const int j = i % (2 * HD);
      kv[i] = j < HD ? dmn::round_to<T>(__expf(kv[i] - colm[j]) / cols[j]) : dmn::round_to<T>(kv[i]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int idx = threadIdx.x + a * THREADS;
      const int hh = idx >> 10, i = (idx >> 5) & 31, jj = idx & 31;
      const int ck = hh * DH + i, cv = HD + hh * DH + jj;
      float g = acc[a];
      for (int r = 0; r < rows; ++r) g += kv[r * 2 * HD + ck] * kv[r * 2 * HD + cv];
      acc[a] = g;
    }
  }
  const size_t bk = size_t(b) * K + k;
#pragma unroll
  for (int a = 0; a < ACC; ++a) sc.gpart[bk * GRAM + threadIdx.x + a * THREADS] = acc[a];
}

// 3'. gram = T(sum of the chunk grams), fixed order.
template <typename T>
__global__ void v1_merge_kernel(Scratch sc, int K) {
  const int b = blockIdx.x;
  for (int e = threadIdx.x; e < GRAM; e += blockDim.x) {
    float G = 0.f;
    for (int k = 0; k < K; ++k) G += sc.gpart[(size_t(b) * K + k) * GRAM + e];
    sc.gram[size_t(b) * GRAM + e] = dmn::round_to<T>(G);
  }
}

// 4'. q projection; softmax over d with one row max over all h*d columns and
// per-head sums, x scale, T; q_sm . gram -> T; out projection + bias -> y
// (f32) with the tile's partial statistics.
// Dynamic shared memory: h[TN*C] + q[TN*HD] + att[TN*HD] + gram[GRAM].
template <typename T>
__global__ void v1_apply_kernel(const T* __restrict__ x, const float* __restrict__ ng,
                                const float* __restrict__ nb, const T* __restrict__ w,
                                const T* __restrict__ wout, const float* __restrict__ bout,
                                Scratch sc, int N, int C, float scale, float eps) {
  extern __shared__ float smem[];
  __shared__ float red[64];
  float* h = smem;
  float* q = h + TN * C;
  float* att = q + TN * HD;
  float* gram = att + TN * HD;
  const int t = blockIdx.x, b = blockIdx.y, nt = gridDim.x;
  const int n0 = t * TN, rows = min(TN, N - n0);
  const float2 st = merge_stats(sc.xpart + size_t(b) * nt, nt, float(N) * C, eps);
  load_tokens_affine(x, ng, nb, h, b, N, C, n0, rows, st);
  for (int i = threadIdx.x; i < GRAM; i += blockDim.x) gram[i] = sc.gram[size_t(b) * GRAM + i];
  __syncthreads();
  project(h, w, rows, C, 0, HD, q);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float* qr = q + r * HD;
    float m = -INFINITY;
    for (int j = 0; j < HD; ++j) m = fmaxf(m, qr[j]);
    for (int hh = 0; hh < HEADS; ++hh) {
      float* qh = qr + hh * DH;
      float s = 0.f;
      for (int d = 0; d < DH; ++d) {
        qh[d] = __expf(qh[d] - m);
        s += qh[d];
      }
      for (int d = 0; d < DH; ++d) qh[d] = dmn::round_to<T>(qh[d] / s * scale);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * HD; i += blockDim.x) att[i] = dmn::round_to<T>(q_gram(q, gram, i));
  __syncthreads();
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const float* ar = att + r * HD;
    float a = 0.f;
    for (int j = 0; j < HD; ++j) a += ar[j] * dmn::to_f32(wout[size_t(j) * C + c]);
    a += bout[c];
    sc.ybuf[(size_t(b) * N + n0) * C + i] = a;
    s += a;
    ss += a * a;
  }
  const float2 tot = dmn::block_sum2(s, ss, red);
  if (threadIdx.x == 0) sc.ypart[size_t(b) * nt + t] = tot;
}

size_t v1_kstats_smem(int C) { return sizeof(float) * (TN * C + TN * HD + 2 * HD); }
size_t v1_gram_smem(int C) { return sizeof(float) * (TN * C + TN * 2 * HD + 2 * HD); }

template <typename T>
int linattn_qkv(const void* qkv, void* out, void* scratch, int B, int N, float scale,
                cudaStream_t stream) {
  Scratch sc;
  scratch_layout(B, N, 0, 0, &sc, static_cast<float*>(scratch));
  const int nt = ceil_div(N, TN), K = ceil_div(N, CHUNK);
  const auto* src = static_cast<const T*>(qkv);
  cudaError_t err = dmn::set_smem((const void*)qkv_kv_kernel<T>, QKV_KV_SMEM);
  if (err == cudaSuccess) err = dmn::set_smem((const void*)qkv_apply_kernel<T>, QKV_APPLY_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_kv_kernel<T><<<dim3(K, B), THREADS, QKV_KV_SMEM, stream>>>(src, sc, N);
  merge_kernel<<<dim3(HEADS, B), THREADS, 0, stream>>>(sc, K, dmn::is_bf16<T>());
  qkv_apply_kernel<T><<<dim3(nt, B), THREADS, QKV_APPLY_SMEM, stream>>>(
      src, static_cast<T*>(out), sc, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// The qkv-fused attention core (#3 in bf16, #12 in x's dtype).
template <typename T>
int linattn_tokens(const void* h, const void* wqkv, void* out, void* scratch, int B, int N, int C,
                   float scale, cudaStream_t stream) {
  Scratch sc;
  scratch_layout(B, N, C, 0, &sc, static_cast<float*>(scratch));
  const int nt = ceil_div(N, TN), K = ceil_div(N, CHUNK);
  const auto* hb = static_cast<const T*>(h);
  const auto* wb = static_cast<const T*>(wqkv);
  cudaError_t err = dmn::set_smem((const void*)kv_kernel<T>, kv_smem(C));
  if (err == cudaSuccess) err = dmn::set_smem((const void*)apply_kernel<T>, apply_smem(C));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<T><<<dim3(K, B), THREADS, kv_smem(C), stream>>>(hb, wb, nullptr, sc, N, C, 0, 0.f);
  merge_kernel<<<dim3(HEADS, B), THREADS, 0, stream>>>(sc, K, dmn::is_bf16<T>());
  apply_kernel<T><<<dim3(nt, B), THREADS, apply_smem(C), stream>>>(
      hb, wb, nullptr, nullptr, nullptr, static_cast<T*>(out), sc, N, C, 0, scale, 0.f);
  return static_cast<int>(cudaGetLastError());
}

// The whole block with the prenorm affine unfolded (#9 in bf16, #10 in x's
// dtype).
template <typename T>
int linattn_block_unfolded(const void* x, const void* ng, const void* nb, const void* wqkv,
                           const void* wout, const void* bout, const void* og, const void* ob,
                           void* out, void* scratch, int B, int N, int C, float scale, float eps,
                           cudaStream_t stream) {
  Scratch sc;
  scratch_layout(B, N, C, 1, &sc, static_cast<float*>(scratch));
  const int nt = ceil_div(N, TN), K = ceil_div(N, CHUNK);
  const auto* xt = static_cast<const T*>(x);
  const auto* g = static_cast<const float*>(ng);
  const auto* be = static_cast<const float*>(nb);
  const auto* wt = static_cast<const T*>(wqkv);
  cudaError_t err = dmn::set_smem((const void*)v1_kstats_kernel<T>, v1_kstats_smem(C));
  if (err == cudaSuccess) err = dmn::set_smem((const void*)v1_gram_kernel<T>, v1_gram_smem(C));
  if (err == cudaSuccess) err = dmn::set_smem((const void*)v1_apply_kernel<T>, apply_smem(C));
  if (err != cudaSuccess) return static_cast<int>(err);
  xstats_kernel<T><<<dim3(nt, B), THREADS, 0, stream>>>(xt, sc.xpart, N, C);
  v1_kstats_kernel<T><<<dim3(K, B), THREADS, v1_kstats_smem(C), stream>>>(xt, g, be, wt, sc, N,
                                                                           C, eps);
  v1_gram_kernel<T><<<dim3(K, B), THREADS, v1_gram_smem(C), stream>>>(xt, g, be, wt, sc, N, C,
                                                                       eps);
  v1_merge_kernel<T><<<B, THREADS, 0, stream>>>(sc, K);
  v1_apply_kernel<T><<<dim3(nt, B), THREADS, apply_smem(C), stream>>>(
      xt, g, be, wt, static_cast<const T*>(wout), static_cast<const float*>(bout), sc, N, C, scale,
      eps);
  outnorm_kernel<T><<<dim3(nt, B), THREADS, 0, stream>>>(
      xt, static_cast<const float*>(og), static_cast<const float*>(ob), static_cast<T*>(out), sc,
      N, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_linattn)

// Floats of scratch the launchers below need.
DMN_EXPORT long dmn_linattn_scratch_floats(int B, int N, int C, int block) {
  return static_cast<long>(scratch_layout(B, N, C, block, nullptr, nullptr));
}

// Whole block: x [B,N,C] bf16 -> out [B,N,C] bf16. wqkv [C,384] bf16 holds
// the prenorm gamma folded in, bqkv [384] f32 = beta @ W_qkv; wout [128,C]
// bf16; bout, og, ob [C] f32.
DMN_EXPORT int dmn_linattn_block(const void* x, const void* wqkv, const void* bqkv,
                                 const void* wout, const void* bout, const void* og,
                                 const void* ob, void* out, void* scratch, int B, int N,
                                 int C, float scale, float eps, void* stream_) {
  using BF = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  Scratch sc;
  scratch_layout(B, N, C, 1, &sc, static_cast<float*>(scratch));
  const int nt = ceil_div(N, TN), K = ceil_div(N, CHUNK);
  const auto* xb = static_cast<const BF*>(x);
  const auto* wb = static_cast<const BF*>(wqkv);
  const auto* bq = static_cast<const float*>(bqkv);
  cudaError_t err = dmn::set_smem((const void*)kv_kernel<BF>, kv_smem(C));
  if (err == cudaSuccess) err = dmn::set_smem((const void*)apply_kernel<BF>, apply_smem(C));
  if (err != cudaSuccess) return static_cast<int>(err);
  xstats_kernel<BF><<<dim3(nt, B), THREADS, 0, stream>>>(xb, sc.xpart, N, C);
  kv_kernel<BF><<<dim3(K, B), THREADS, kv_smem(C), stream>>>(xb, wb, bq, sc, N, C, 1, eps);
  merge_kernel<<<dim3(HEADS, B), THREADS, 0, stream>>>(sc, K, 1);
  apply_kernel<BF><<<dim3(nt, B), THREADS, apply_smem(C), stream>>>(
      xb, wb, bq, static_cast<const BF*>(wout), static_cast<const float*>(bout), nullptr, sc, N,
      C, 1, scale, eps);
  outnorm_kernel<BF><<<dim3(nt, B), THREADS, 0, stream>>>(
      xb, static_cast<const float*>(og), static_cast<const float*>(ob), static_cast<BF*>(out), sc,
      N, C, eps);
  return static_cast<int>(cudaGetLastError());
}

// Whole block, v1 (TPU kernel #9): x [B,N,C] bf16 -> out [B,N,C] bf16.
// ng, nb [C] f32 (the prenorm affine, not folded); wqkv [C,384] bf16;
// wout [128,C] bf16; bout, og, ob [C] f32.
DMN_EXPORT int dmn_linattn_block_v1(const void* x, const void* ng, const void* nb,
                                    const void* wqkv, const void* wout, const void* bout,
                                    const void* og, const void* ob, void* out, void* scratch,
                                    int B, int N, int C, float scale, float eps, void* stream_) {
  return linattn_block_unfolded<__nv_bfloat16>(x, ng, nb, wqkv, wout, bout, og, ob, out, scratch,
                                               B, N, C, scale, eps,
                                               static_cast<cudaStream_t>(stream_));
}

// Whole block, v2 (TPU kernel #10): x [B,N,C] f32, or bf16 where `bf16` ->
// out [B,N,C] in x's dtype. ng, nb [C] f32; wqkv [C,384] and wout [128,C] in
// x's dtype; bout, og, ob [C] f32.
DMN_EXPORT int dmn_linattn_block_v2(const void* x, const void* ng, const void* nb,
                                    const void* wqkv, const void* wout, const void* bout,
                                    const void* og, const void* ob, void* out, void* scratch,
                                    int B, int N, int C, int bf16, float scale, float eps,
                                    void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bf16)
    return linattn_block_unfolded<__nv_bfloat16>(x, ng, nb, wqkv, wout, bout, og, ob, out,
                                                 scratch, B, N, C, scale, eps, stream);
  return linattn_block_unfolded<float>(x, ng, nb, wqkv, wout, bout, og, ob, out, scratch, B, N,
                                       C, scale, eps, stream);
}

// Attention core on pre-normed tokens: h [B,N,C] bf16, wqkv [C,384] bf16 ->
// out [B,N,128] bf16.
DMN_EXPORT int dmn_linattn_tokens(const void* h, const void* wqkv, void* out, void* scratch,
                                  int B, int N, int C, float scale, void* stream_) {
  return linattn_tokens<__nv_bfloat16>(h, wqkv, out, scratch, B, N, C, scale,
                                       static_cast<cudaStream_t>(stream_));
}

// The same core on the lane-packed view (TPU kernel #12): x [B, N*C/128, 128]
// is [B,N,C] token rows, byte for byte. x and wqkv [C,384] f32, or bf16 where
// `bf16` -> out [B,N,128] in x's dtype.
DMN_EXPORT int dmn_linattn_v4(const void* x, const void* wqkv, void* out, void* scratch, int B,
                              int N, int C, int bf16, float scale, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bf16)
    return linattn_tokens<__nv_bfloat16>(x, wqkv, out, scratch, B, N, C, scale, stream);
  return linattn_tokens<float>(x, wqkv, out, scratch, B, N, C, scale, stream);
}

// Attention core on a raw qkv tensor: qkv [B,N,384] (f32, or bf16 where
// `bf16`) -> out [B,N,128] in the same dtype.
DMN_EXPORT int dmn_linattn_qkv(const void* qkv, void* out, void* scratch, int B, int N, int bf16,
                               float scale, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bf16) return linattn_qkv<__nv_bfloat16>(qkv, out, scratch, B, N, scale, stream);
  return linattn_qkv<float>(qkv, out, scratch, B, N, scale, stream);
}
