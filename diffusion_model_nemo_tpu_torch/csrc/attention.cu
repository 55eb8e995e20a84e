// Softmax attention over [B, N, h, d] tensors, read in place with strides.
//
// Replaces TPU kernel _attn_kernel (launcher _pallas_attention) of
// diffusion_model_nemo_tpu/ops/attention.py: per (sample, head),
// softmax(q k^T - rowmax) v with q pre-scaled, f32 scores, probabilities and
// accumulation, the output in the input dtype. The TPU launcher transposed
// q, k and v to [B*h, N, d] and held a whole [N, N] score block in VMEM per
// grid step. Neither carries over: the transposes would be three extra
// passes through device memory (k and v are strided slices of the DiT's qkv
// tensor), and an [N, N] f32 block (4 MB at N = 1024) does not fit 227 KB of
// shared memory.
//
// Design: one block per (64-query tile, sample * head). The block keeps its
// q tile (transposed) in shared memory and loops over 64-token k/v tiles
// staged in shared memory, with an online softmax: a running row max and
// row sum in f32, the output accumulator in registers, rescaled when the max
// grows. No N x N tensor exists. 256 threads as 16 x 16: thread (ty, tx)
// owns queries 4ty..4ty+3, scores for keys tx + 16j of each tile, and
// output columns tx*D/16 .. of its queries; a row's max and sum are reduced
// over the 16 lanes that share ty (one half-warp). The probabilities pass
// through shared memory (transposed) from the score layout to the p.v layout.
//
// What bounds it: 4 B h N^2 d operations against 4 B N h d elements moved;
// at N = 1024, d = 64 that is ~1000 operations per element, so the card's
// operation rate bounds it (tensor cores: 989 TFLOP/s in bf16). This first
// form runs f32 FMAs on CUDA cores (67 TFLOP/s peak) from shared memory;
// mma.sync / wgmma with TMA-fed tiles is the redesign that closes the gap.

#include "common.cuh"

namespace {

constexpr int BM = 64;         // queries per block
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int QP = BM + 4;     // padded row of the transposed q and p tiles
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, n, h;  // elements; the d stride is 1
};

template <int D>
constexpr size_t smem_floats() {
  return size_t(D) * QP + size_t(BN) * (D + 1) + size_t(BN) * D + size_t(BN) * QP;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, Strides sq, Strides sk, Strides sv, int N, int H) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KP = D + 1;   // padded k row: lanes tx read distinct banks
  constexpr int DP = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [D][QP]  q tile, transposed
  float* ks = qt + D * QP;     // [BN][KP] k tile
  float* vs = ks + BN * KP;    // [BN][D]  v tile
  float* pt = vs + BN * D;     // [BN][QP] probabilities, transposed

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * BM;
  const int b = blockIdx.y / H, hh = blockIdx.y % H;
  const T* qb = q + b * sq.b + hh * sq.h;
  const T* kb = k + b * sk.b + hh * sk.h;
  const T* vb = v + b * sv.b + hh * sv.h;

  // q tile, scaled by log2(e) so the softmax runs on exp2.
  for (int i = threadIdx.x; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D, n = m0 + r;
    qt[d * QP + r] = n < N ? dmn::to_f32(qb[n * sq.n + d]) * LOG2E : 0.f;
  }

  float m[4], l[4], o[4][DP];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; ++c) o[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int i = threadIdx.x; i < BN * D; i += THREADS) {
      const int r = i / D, d = i % D, n = n0 + r;
      const bool in = n < N;
      ks[r * KP + d] = in ? dmn::to_f32(kb[n * sk.n + d]) : 0.f;
      vs[r * D + d] = in ? dmn::to_f32(vb[n * sv.n + d]) : 0.f;
    }
    __syncthreads();

    // s[i][j] = q[4ty + i] . k[tx + 16j] (base-2 logits)
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + d * QP + 4 * ty);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = ks[(tx + 16 * j) * KP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qa[i], kv, s[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tx + 16 * j >= N)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // online softmax per query row, over the 16 lanes that share ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile has a valid key
      const float f = exp2f(m[i] - m_new);  // 0 on the first tile
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * f + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DP; ++c) o[i][c] *= f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * QP + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // o[i][c] += sum_key p[4ty + i][key] * v[key][tx*DP + c]
#pragma unroll 4
    for (int key = 0; key < BN; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + key * QP + 4 * ty);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float vv[DP];
      const float* vrow = vs + key * D + tx * DP;
      if constexpr (DP % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DP; c += 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = w.x;
          vv[c + 1] = w.y;
          vv[c + 2] = w.z;
          vv[c + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DP; c += 2) {
          const float2 w = *reinterpret_cast<const float2*>(vrow + c);
          vv[c] = w.x;
          vv[c + 1] = w.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DP; ++c) o[i][c] = fmaf(pa[i], vv[c], o[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = m0 + 4 * ty + i;
    if (n >= N) continue;
    const float inv = 1.f / l[i];
    T* orow = out + ((size_t(b) * N + n) * H + hh) * D + tx * DP;
#pragma unroll
    for (int c = 0; c < DP; ++c) orow[c] = dmn::from_f32<T>(o[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
           Strides sv, int B, int N, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = attn_fwd_kernel<T, D>;
  const cudaError_t err = dmn::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + BM - 1) / BM, B * H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, sv, N, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
             Strides sv, int B, int N, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, sq, sk, sv, B, N, H, stream);
    case 64: return launch<T, 64>(q, k, v, out, sq, sk, sv, B, N, H, stream);
    case 128: return launch<T, 128>(q, k, v, out, sq, sk, sv, B, N, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_attn)

// q, k, v [B, N, H, D] (f32 or bf16 by `bf16`, unit stride along D, the
// other strides in elements) -> out [B, N, H, D] contiguous, same dtype.
// D is 32, 64 or 128; B * H <= 65535.
DMN_EXPORT int dmn_attention(const void* q, const void* k, const void* v, void* out,
                             long long qsb, long long qsn, long long qsh, long long ksb,
                             long long ksn, long long ksh, long long vsb, long long vsn,
                             long long vsh, int B, int N, int H, int D, int bf16,
                             void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh};
  if (bf16) return launch_d<__nv_bfloat16>(q, k, v, out, sq, sk, sv, B, N, H, D, stream);
  return launch_d<float>(q, k, v, out, sq, sk, sv, B, N, H, D, stream);
}
