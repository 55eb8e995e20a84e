// Bottleneck self-attention block on [B, N, C] with small N, one block per
// sample, every product on the tensor cores.
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
// What bounds it on the H100: at the U-Net's mid level (N = 16, C = 256) a
// sample is ~3 MFLOP of projections and ~0.1 MFLOP of attention, and the
// bytes are x, the output and the weights (W_qkv: C x 384 bf16 = 196 KB,
// W_out: 64 KB). At 64 samples the table's bound (bytes over 3.35 TB/s) is
// under half a microsecond, less than a launch costs: what the kernel can
// reach is set by latency - a chain of four dependent stages, each fed from
// L2 or shared memory - not by the memory or the operation rate. The design
// therefore shortens the chain's stages:
//  - N <= 64 tokens are one to four m16 tiles. All four products run on
//    mma.sync.m16n8k16 (bf16 in, f32 out): qkv = h W (K = C, the 48 n8 tiles
//    of 384 columns split six to a warp), per head S = q k^T (K = 32) and
//    O = P v, out = att W_out (K = 128, the C / 8 n8 tiles dealt to the
//    warps). wgmma is not used: its 64-row tile would be mostly padding.
//  - h, qkv and att live in shared memory as bf16, rows padded by 16 bytes
//    so the eight rows of an ldmatrix fall in eight different bank groups.
//    The softmax of a head's 16 x N tile stays in registers (row max and sum
//    over the four lanes that share a row); P goes to the next mma as its A
//    fragment without touching shared memory.
//  - Each weight element is read once per block, as the B fragment, straight
//    from L2, and no weight is staged in shared memory. The wrapper lays the
//    weights out in fragment order ([k / 32][n / 8][lane][8 values]: the B
//    fragments of two k16 steps of one n8 tile, lane by lane), so a thread's
//    share is one 16-byte load and a warp's load instruction reads 512
//    contiguous bytes. (K-contiguous rows, two 4-byte loads a fragment, had a
//    warp touch eight cache lines per instruction: the load unit, not L2,
//    set the time.)
//  - Tokens are padded to a multiple of 16 with zero rows; padded keys are
//    set to -inf before the row max, padded query rows are not stored.
//
// Seams kept from the TPU kernel: the prenorm's (x - mu) * rstd rounded to
// bf16 before the folded affine; q, k, v, the probabilities and the
// attention output rounded to bf16; f32 accumulation everywhere; the
// residual added in f32 from the bf16 x.

#include "mma.cuh"

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;
constexpr int HD = HEADS * DH;  // 128
constexpr int QKV = 3 * HD;     // 384
constexpr int PAD = 8;          // bf16 of row padding in shared memory (16 bytes)
constexpr int QS = QKV + PAD;   // qkv row
constexpr int AS = HD + PAD;    // attention-output row
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int QKV_NT = QKV / 8 / WARPS;  // n8 tiles of qkv per warp: 6
constexpr int PF = 2;                    // pairs of k16 steps of W_qkv fragments in flight per warp

// The B fragments of k16 steps 2 kp and 2 kp + 1 of n8 tile nt, for this
// lane, from a weight in fragment order with `ntiles` n8 tiles: (b0, b1) of
// the first step in x, y, of the second in z, w.
__device__ __forceinline__ uint4 ldg_fragments(const __nv_bfloat16* w, int kp, int nt, int ntiles,
                                               int lane) {
  return __ldg(reinterpret_cast<const uint4*>(w) + (size_t(kp) * ntiles + nt) * 32 + lane);
}

// Dynamic shared memory: h [NP][Cp + PAD], qkv [NP][QS], att [NP][AS], bf16,
// NP = 16 * MT tokens, Cp = C rounded up to 32.
template <int MT>
__global__ void __launch_bounds__(THREADS)
attn_block_small_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wt,   // [Cp/32][QKV/8][32][8]
                        const float* __restrict__ bq,           // [QKV]
                        const __nv_bfloat16* __restrict__ wot,  // [HD/32][C/8][32][8]
                        const float* __restrict__ bout,         // [C]
                        __nv_bfloat16* __restrict__ out, int N, int C, float scale, float eps) {
  constexpr int NP = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[64];
  const int Cp = (C + 31) & ~31;  // the qkv product walks k in pairs of k16 steps
  const int HS = Cp + PAD;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qkv = hs + NP * HS;
  __nv_bfloat16* att = qkv + NP * QS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t sample = size_t(blockIdx.x) * N * C;
  const __nv_bfloat16* xs = x + sample;

  // W_qkv fragments of warp w's columns 48w .. 48w + 47: they come from L2
  // with hundreds of cycles of latency while a k16 step is a few dozen cycles
  // of mma, so PF pairs of steps are kept in flight in a register ring, and
  // the first PF are asked for before the statistics, which do not depend on
  // them.
  const int j0 = warp * (QKV_NT * 8);
  uint4 bw[PF][QKV_NT];
  const int kpairs = Cp / 32;
  auto fetch_qkv = [&](uint4 (&dst)[QKV_NT], int kp) {
#pragma unroll
    for (int nt = 0; nt < QKV_NT; ++nt) dst[nt] = ldg_fragments(wt, kp, warp * QKV_NT + nt, QKV / 8, lane);
  };
#pragma unroll
  for (int p = 0; p < PF; ++p)
    if (p < kpairs) fetch_qkv(bw[p], p);

  // 1. x -> shared memory (16 bytes a thread), GroupNorm(1) statistics in
  // f32, h = bf16((x - mu) * rstd) in place. Each thread normalises the
  // chunks it loaded itself. Rows N .. NP - 1 and columns C .. Cp - 1 stay
  // zero (their weight rows are zero too).
  const int cpr = C / 8, cpr_p = Cp / 8;  // 16-byte chunks per row: of x, of h
  float sum = 0.f, sumsq = 0.f;
  for (int i = threadIdx.x; i < NP * cpr_p; i += THREADS) {
    const int r = i / cpr_p, c = i % cpr_p;
    uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
    if (r < N && c < cpr) {
      chunk = __ldg(reinterpret_cast<const uint4*>(xs + size_t(r) * C) + c);
      const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&chunk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pairs[e]);
        sum += f.x + f.y;
        sumsq += f.x * f.x + f.y * f.y;
      }
    }
    *reinterpret_cast<uint4*>(hs + r * HS + c * 8) = chunk;
  }
  const float2 tot = dmn::block_sum2(sum, sumsq, red);  // synchronises the block
  const float2 st = dmn::fast_variance_stats(tot.x, tot.y, float(N) * C, eps);
  for (int i = threadIdx.x; i < N * cpr_p; i += THREADS) {
    const int r = i / cpr_p, c = i % cpr_p;
    if (c >= cpr) continue;
    uint4* slot = reinterpret_cast<uint4*>(hs + r * HS + c * 8);
    uint4 chunk = *slot;
    __nv_bfloat162* pairs = reinterpret_cast<__nv_bfloat162*>(&chunk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pairs[e]);
      pairs[e] = __floats2bfloat162_rn((f.x - st.x) * st.y, (f.y - st.x) * st.y);
    }
    *slot = chunk;
  }
  __syncthreads();

  // 2. qkv = h W + b: warp w owns columns 48w .. 48w + 47 for every token.
  {
    float acc[MT][QKV_NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < QKV_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const uint32_t a_base = dmn::smem_u32(hs + (lane & 15) * HS + (lane >> 4) * 8);
    for (int kp0 = 0; kp0 < kpairs; kp0 += PF) {
#pragma unroll
      for (int p = 0; p < PF; ++p) {
        const int kp = kp0 + p;
        if (kp < kpairs) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            dmn::ldmatrix_x4(a, a_base + (mt * 16 * HS + kp * 32) * 2);
#pragma unroll
            for (int nt = 0; nt < QKV_NT; ++nt) dmn::mma_bf16(acc[mt][nt], a, bw[p][nt].x, bw[p][nt].y);
            dmn::ldmatrix_x4(a, a_base + (mt * 16 * HS + kp * 32 + 16) * 2);
#pragma unroll
            for (int nt = 0; nt < QKV_NT; ++nt) dmn::mma_bf16(acc[mt][nt], a, bw[p][nt].z, bw[p][nt].w);
          }
          if (kp + PF < kpairs) fetch_qkv(bw[p], kp + PF);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < QKV_NT; ++nt) {
      const int col = j0 + nt * 8 + 2 * t;
      const float b0 = bq[col], b1 = bq[col + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        __nv_bfloat16* dst = qkv + (mt * 16 + g) * QS + col;
        *reinterpret_cast<uint32_t*>(dst) = dmn::pack_bf16(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
        *reinterpret_cast<uint32_t*>(dst + 8 * QS) =
            dmn::pack_bf16(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
      }
    }
  }
  __syncthreads();

  // W_out fragments of this warp's first n8 tile, asked for before the
  // attention they do not depend on; then one tile ahead.
  uint4 bo[2][HD / 32];
  const int ntiles = C / 8;
  auto fetch_out = [&](uint4 (&dst)[HD / 32], int nt) {
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp) dst[kp] = ldg_fragments(wot, kp, nt, ntiles, lane);
  };
  if (warp < ntiles) fetch_out(bo[0], warp);

  // 3. Attention: one warp per (head, m16 tile of queries) over all keys.
  for (int u = warp; u < HEADS * MT; u += WARPS) {
    const int hh = u / MT, mt = u % MT;
    const __nv_bfloat16* qh = qkv + hh * DH;
    const __nv_bfloat16* kh = qkv + HD + hh * DH;
    const __nv_bfloat16* vh = qkv + 2 * HD + hh * DH;
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      dmn::ldmatrix_x4(qa[kk], dmn::smem_u32(qh + (mt * 16 + (lane & 15)) * QS + kk * 16 +
                                             (lane >> 4) * 8));
    float s[2 * MT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < MT; ++np)
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t bk[4];  // keys np*16 .. +15: (b0, b1) of tile 2np, then of 2np + 1
        dmn::ldmatrix_x4(bk, dmn::smem_u32(kh + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * QS +
                                           kk * 16 + ((lane >> 3) & 1) * 8));
        dmn::mma_bf16(s[2 * np], qa[kk], bk[0], bk[1]);
        dmn::mma_bf16(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    // softmax over the keys of rows g (r = 0) and g + 8 (r = 1); probabilities
    // normalised in f32, then rounded to bf16 by the packing below
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = nt * 8 + 2 * t + e < N;
          s[nt][2 * r + e] = in ? s[nt][2 * r + e] * scale : -INFINITY;
          m = fmaxf(m, s[nt][2 * r + e]);
        }
      m = dmn::quad_max(m);  // finite: key 0 is valid
      float den = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][2 * r + e] = __expf(s[nt][2 * r + e] - m);
          den += s[nt][2 * r + e];
        }
      const float inv = 1.f / dmn::quad_sum(den);
#pragma unroll
      for (int nt = 0; nt < 2 * MT; ++nt) {
        s[nt][2 * r] *= inv;
        s[nt][2 * r + 1] *= inv;
      }
    }
    float o[DH / 8][4];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      const uint32_t pa[4] = {dmn::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              dmn::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              dmn::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              dmn::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t bv[4];  // keys kk*16 .. +15: (b0, b1) of d tile 2dp, then of 2dp + 1
        dmn::ldmatrix_x4_trans(bv, dmn::smem_u32(vh + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * QS +
                                                 dp * 16 + (lane >> 4) * 8));
        dmn::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        dmn::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      __nv_bfloat16* dst = att + (mt * 16 + g) * AS + hh * DH + dt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dst) = dmn::pack_bf16(o[dt][0], o[dt][1]);
      *reinterpret_cast<uint32_t*>(dst + 8 * AS) = dmn::pack_bf16(o[dt][2], o[dt][3]);
    }
  }
  __syncthreads();

  // 4. out = att W_out + b_out + x: the C / 8 n8 tiles dealt round-robin.
  __nv_bfloat16* os = out + sample;
  const uint32_t att_base = dmn::smem_u32(att + (lane & 15) * AS + (lane >> 4) * 8);
  auto project = [&](const uint4 (&w)[HD / 32], int nt) {
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < HD / 32; ++kp)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        dmn::ldmatrix_x4(a, att_base + (mt * 16 * AS + kp * 32) * 2);
        dmn::mma_bf16(acc[mt], a, w[kp].x, w[kp].y);
        dmn::ldmatrix_x4(a, att_base + (mt * 16 * AS + kp * 32 + 16) * 2);
        dmn::mma_bf16(acc[mt], a, w[kp].z, w[kp].w);
      }
    const int col = nt * 8 + 2 * t;
    const float b0 = bout[col], b1 = bout[col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = mt * 16 + g + 8 * r;
        if (n >= N) continue;
        const float2 res = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + size_t(n) * C + col));
        *reinterpret_cast<uint32_t*>(os + size_t(n) * C + col) =
            dmn::pack_bf16(acc[mt][2 * r] + b0 + res.x, acc[mt][2 * r + 1] + b1 + res.y);
      }
  };
  for (int nt = warp; nt < ntiles; nt += 2 * WARPS) {
    const bool second = nt + WARPS < ntiles;
    if (second) fetch_out(bo[1], nt + WARPS);
    project(bo[0], nt);
    if (second) {
      if (nt + 2 * WARPS < ntiles) fetch_out(bo[0], nt + 2 * WARPS);
      project(bo[1], nt + WARPS);
    }
  }
}

template <int MT>
int launch(const void* x, const void* wt, const void* bq, const void* wot, const void* bout,
           void* out, int B, int N, int C, float scale, float eps, cudaStream_t stream) {
  const size_t smem = size_t(16 * MT) * (((C + 31) & ~31) + PAD + QS + AS) * sizeof(__nv_bfloat16);
  auto kernel = attn_block_small_kernel<MT>;
  const cudaError_t err = dmn::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bq), static_cast<const __nv_bfloat16*>(wot),
      static_cast<const float*>(bout), static_cast<__nv_bfloat16*>(out), N, C, scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_attn_small)

// x [B,N,C] bf16 -> out [B,N,C] bf16, 8 <= N <= 64 a multiple of 8, C a
// multiple of 8, x 16-byte aligned. wqkv_f is gamma * W_qkv ([C,384], the
// prenorm's gamma folded in, zero rows up to the next multiple of 32) and
// wout_f is W_out ([128,C]), both bf16 in fragment order [K/32][J/8][32][8]
// (see ldg_fragments); bqkv [384] f32 = beta @ W_qkv; bout [C] f32.
DMN_EXPORT int dmn_attn_block_small(const void* x, const void* wqkv_f, const void* bqkv,
                                    const void* wout_f, const void* bout, void* out, int B,
                                    int N, int C, float scale, float eps, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (N < 8 || N > 64 || N % 8 || C % 8) return static_cast<int>(cudaErrorInvalidValue);
  switch ((N + 15) / 16) {
    case 1: return launch<1>(x, wqkv_f, bqkv, wout_f, bout, out, B, N, C, scale, eps, stream);
    case 2: return launch<2>(x, wqkv_f, bqkv, wout_f, bout, out, B, N, C, scale, eps, stream);
    case 3: return launch<3>(x, wqkv_f, bqkv, wout_f, bout, out, B, N, C, scale, eps, stream);
    default: return launch<4>(x, wqkv_f, bqkv, wout_f, bout, out, B, N, C, scale, eps, stream);
  }
}
