// Linear attention on natural [B, N, C] token rows: the whole
// Residual(PreNorm(LinearAttention)) block, the qkv-fused attention core, and
// the attention core on a raw qkv tensor.
//
// Replaces these TPU kernels of diffusion_model_nemo_tpu/ops/attention.py:
//   * _linattn_block_packed_kernel (launcher _pallas_linattn_block_packed):
//     GroupNorm(1) with its affine folded into W_qkv -> qkv -> q softmax over
//     d per head, x scale; k softmax over N -> per-head gram k^T v -> q . gram
//     -> out projection + bias -> GroupNorm(1) with affine -> + x.
//   * _linattn_block_kernel, v1 (launcher _pallas_linear_attention_block) and
//     _linattn_block_kernel_v2 (launcher _pallas_linear_attention_block_v2):
//     the same block with the prenorm affine applied in f32 before the qkv
//     product (not folded) and no qkv bias. v2 gives every product operands
//     in x's dtype; in bf16 its function is v1's, seam for seam, so both run
//     one kernel, instantiated for x's dtype.
//   * _linattn_qkv_fused_kernel (launcher _pallas_linattn_qkv_fused): the
//     attention core on pre-normed tokens, without the norms, the out
//     projection or the residual.
//   * _v4_kernel (tools/microbench_attn_lanes.py, launcher v4_call): the
//     qkv-fused core on x viewed as [B, N*C/128, 128], so that the TPU's
//     (8, 128) tiles carry no lane padding. On the card the packed view and
//     [B, N, C] token rows are the same bytes: the wrapper hands the buffer
//     to the qkv-fused core as token rows, in x's dtype.
//   * _linattn_kernel (launcher _pallas_linear_attention): the attention core
//     on a raw qkv [B, N, 384] tensor (q | k | v columns), any dtype; the
//     float32 U-Net's route.
// The TPU packed its tokens 128 lanes wide and took G samples per grid step
// so that its matrix unit saw tall operands: both are VMEM/MXU blockings with
// no counterpart here. On the card a sample is spread over a thread-block
// cluster instead, and the token GEMMs run on the tensor cores.
//
// The whole block (#2, #9, #10) and the qkv-fused core (#3, #12): one launch,
// one cluster per sample (linattn_block_kernel; the core is its CORE mode).
//   What bounds it on the H100: at unet_small's four #2 calls (B = 64) the
//   block moves ~17 MB (x in, out back: ~5 us at 3.35 TB/s) and does ~6
//   GFLOP (~6 us at the bf16 peak). A sample's intermediates fit in the
//   shared memory of a few SMs, so nothing but x and the output has to touch
//   device memory; what is left to bound the kernel is the latency of a chain
//   of dependent stages, three of which need the whole sample (the prenorm's
//   statistics, k's softmax over N and its gram, the out-norm's statistics).
//   Design:
//   - A cluster of min(8, ceil(N / 128)) CTAs holds one sample; CTA r owns
//     the token slab [r * slab, (r + 1) * slab). The sample-wide reductions
//     go through distributed shared memory: each CTA publishes its partial,
//     cluster.sync(), and the partials are added in rank order, so every CTA
//     (and every run) gets the same bits. The 4 x 32 x 32 gram is
//     reduce-scattered (rank r adds up rows r, r + cluster, ..., 16 bytes a
//     load) and then gathered, rounded: a CTA reads each remote byte once.
//   - Each CTA walks its slab in 64-token tiles (four m16 tiles); every
//     product is mma.sync.m16n8k16 with f32 accumulation: qkv = h W (the
//     weights' B fragments straight from L2 in fragment order, one 16-byte
//     load a lane, as csrc/attention_block_small.cu, all k steps of a
//     product asked for at once), the per-head gram k_sm^T v (both operands
//     by ldmatrix.trans from the tile), q_sm . gram and att W_out.
//   - Stages: (1) x statistics; (2) k's column max and sum over the slab,
//     online, merged over the cluster; (3) k_sm and v recomputed per tile
//     (a projection on the tensor cores costs less than holding an f32 k),
//     rounded, and the slab's gram; the cluster's grams added in rank order
//     and rounded; (4) q, its softmax (one max over the 128 columns, per-head
//     sums), att = q_sm . gram, y = att W_out + b_out with y's statistics;
//     (5) out = GroupNorm(y) + x, 16 bytes a thread.
//   - CORE (#3, #12): h is already normed, so there is no stage 1 and no
//     bias; stages 2-4 as above, and stage 4 writes att [B, N, 128] in h's
//     dtype from the att tile, 16 bytes a thread, instead of projecting it.
//   - "Resident": where the slab's h (and, but for CORE, f32 y) fit in
//     shared memory (with the tile buffers, at most 227 KB), x is read once
//     into it (cp.async) and y is kept for stage 5. Otherwise ("recompute",
//     e.g. [4096, 128]) each stage reloads its x tile from device memory (L2)
//     and normalises it again, and stage 4 runs twice: for y's statistics,
//     then to write the output. The launch plan (cluster, slab, bytes, mode)
//     is the wrapper's (ops/attention.py:linattn_block_plan); block_layout()
//     below is its mirror and the entries refuse a plan that disagrees.
//   - What is left is latency: a CTA's stages are a chain of L2 round trips
//     and barriers, whatever the batch (on the H100 a one-wave call takes
//     ~33 us with one 64-token tile a CTA, [64, 64, 128], and ~45 us with two,
//     [64, 256, 64]: tools/check_linattn.py). So the
//     kernel is held to 128 registers and, on the main path, ~115 KB of
//     shared memory (the f32 partial gram takes the k_sm|v tile's place), two
//     CTAs an SM: at [64, 1024, 32] its 512 CTAs run in two waves, not four.
//   - float32 (#10 and #12 in float32): the same kernel and stages, with each
//     product's 16 x 8 output tile computed by f32 FMAs on the CUDA cores in
//     the mma fragment layout (no TF32: the 1e-4 gate), weights row major.
//   Seams kept from the TPU kernels: the prenorm's (x - mu) * rstd rounded to
//   bf16 before the folded affine (#2), or the affine applied in f32 before
//   the rounding (#9, #10); qkv (+ the folded bias) in f32; q_sm = exp(q -
//   rowmax) * (scale / headsum), k_sm = exp(k - M) * (1 / S) and v rounded to
//   x's dtype (a reciprocal where the TPU kernel divides: one f32 rounding
//   apart, before a bf16 one); the gram, masked to its diagonal blocks,
//   rounded; att rounded (#3 and #12: att is the output, q_sm . gram in f32
//   cast once);
//   y = att W_out + b_out, the out-norm and the residual in f32, cast once.
//   Padded tokens (N not a multiple of 16) enter no max, sum or gram.
//
// The attention core on a raw qkv tensor (#8): the RAW mode of the same
// kernel, one launch, one cluster a sample: ceil(N / 128) CTAs up to N =
// 256, else min(16, ceil(N / 64)) (above 8 a non-portable cluster size,
// which the H100 takes).
//   What bounds it on the H100: bytes. At the float32 U-Net's five calls (B =
//   64; N = 1024, 256, 256, 64, 64) it reads qkv and writes the output, ~0.22
//   GB (~65 us at 3.35 TB/s), against ~1.7 GFLOP of f32 FMAs (~26 us at 67
//   TFLOP/s). Its old form took three launches and a global scratch round trip
//   (~9x the bound).
//   Design: stages 2-4 of the core mode with q, k and v loaded, not
//   projected. CTA r loads its slab's k, v and q rows (16-byte cp.async
//   pieces, each row padded by 16 bytes, three commit groups in that order),
//   so that the statistics start when k has landed while v and q are still
//   in flight, and qkv is read from device memory once ("resident": up to
//   128 tokens a CTA, ~206 KB in float32, a CTA an SM; a 64-token slab is
//   ~105 KB and two CTAs share an SM, one loading while the other computes:
//   faster where the sample is large enough for clusters of 8-16).
//   Otherwise each stage reloads its 64-token tiles (k twice: statistics,
//   then the gram; the second read comes from L2).
//   Stages: (2) k's column max and sum over the slab, merged over the
//   cluster in rank order; (3) k_sm = exp(k - M) / S computed once per
//   element into an f32 buffer, then the slab's per-head gram k_sm^T v,
//   reduce-scattered over the cluster in rank order and gathered; (4) q's
//   softmax over each head (one max over the token's 128 columns, as the TPU
//   kernel takes it) into an f32 buffer, transposed, then q_sm . gram. Both
//   products keep a register block a thread (4 x 8 of the gram, 4 tokens x 8
//   channels of the output), so that each 16-byte shared-memory load feeds
//   16 to 32 FMAs: with a value a load, as a thread-per-(token, head) form
//   has it, the products were bound by shared-memory loads and instruction
//   issue, not by the FMAs, and more warps a CTA did not help.
//   Arithmetic is f32 in both dtypes, on f32 FMAs: the TPU kernel converts q,
//   k and v to f32, keeps q_sm, k_sm and the masked gram in f32 and casts the
//   output once (a bf16 mma would round q_sm and k_sm where it does not). bf16
//   changes how tokens are loaded and stored, and adds an f32 buffer for k_sm
//   and q_sm (float32 writes them over k's own rows).

#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HEADS = 4;
constexpr int DH = 32;            // dim_head
constexpr int HD = HEADS * DH;    // 128
constexpr int QKV = 3 * HD;       // 384
constexpr int THREADS = 256;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------ the whole block (#2, #9, #10) --
constexpr int TILE = 64;          // tokens per tile
constexpr int MT = TILE / 16;     // m16 tiles per tile
constexpr int PAD = 8;            // elements of row padding: 16 bytes in bf16
constexpr int KVS = 2 * HD + PAD;  // k_sm | v row (stage 3); q row (stage 4)
constexpr int AS = HD + PAD;      // attention-output row
constexpr int GS = DH + PAD;      // gram row
constexpr int WARPS = THREADS / 32;
constexpr int MISC_BYTES = 512;   // block_sum2 scratch and the two cluster slots
constexpr int MAX_CLUSTER = 8;    // the portable cluster size
constexpr size_t SMEM_LIMIT = 232448;

// Byte offsets of the block kernel's shared memory; ops/attention.py:
// _linattn_block_smem is its mirror. `core`: the CORE mode keeps no y.
struct Layout {
  size_t misc, colst, gram, a, b, h, y, total;  // the f32 partial gram lives in region a
  int hs, c8, rows_h;
};

__host__ __device__ inline Layout block_layout(int C, int slab, int resident, int esize, int core) {
  Layout L;
  L.hs = ((C + 31) & ~31) + PAD;  // the qkv product walks k in pairs of k16 steps
  L.c8 = (C + 7) & ~7;            // the out projection's n8 tiles
  L.rows_h = resident ? ceil_div(slab, TILE) * TILE : TILE;
  const int rows_y = resident && !core ? slab : 0;
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off += (n + 15) & ~size_t(15);
    return at;
  };
  L.misc = take(MISC_BYTES);
  L.colst = take(sizeof(float) * 4 * HD);
  L.gram = take(size_t(HEADS) * DH * GS * esize);
  L.a = take(size_t(TILE) * KVS * esize);
  L.b = take(size_t(TILE) * AS * esize);
  L.h = take(size_t(L.rows_h) * L.hs * esize);
  L.y = take(sizeof(float) * rows_y * L.c8);
  L.total = off;
  return L;
}

struct BlockArgs {
  const void* x;
  const void* wqkv;    // bf16: fragment order [Cp/32][48][32][8]; float: [C][384]
  const float* bqkv;   // [384] (folded prenorm) or null (unfolded, CORE)
  const float* ng;     // [C] prenorm affine applied before the product, or null (folded)
  const float* nb;
  const void* wout;    // bf16: fragment order [4][C8/8][32][8]; float: [128][C8]; CORE: null
  const float* bout;   // [C]
  const float* og;     // [C]
  const float* ob;     // [C]
  void* out;           // [B, N, C]; CORE: att [B, N, 128]
  int N, C, cluster, slab, resident;
  float scale, eps;
};

// The B fragments of k16 steps 2 kp and 2 kp + 1 of n8 tile nt, for this
// lane, from a weight in fragment order with `ntiles` n8 tiles.
__device__ __forceinline__ uint4 ldg_fragments(const __nv_bfloat16* w, int kp, int nt, int ntiles,
                                               int lane) {
  return __ldg(reinterpret_cast<const uint4*>(w) + (size_t(kp) * ntiles + nt) * 32 + lane);
}

// A fragment (16 x 16) of rows m0.., columns k0.. of a bf16 tile with row stride s.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* base, int s, int m0,
                                       int k0, int lane) {
  dmn::ldmatrix_x4(a, dmn::smem_u32(base + (m0 + (lane & 15)) * s + k0 + (lane >> 4) * 8));
}

// A fragment of a transposed tile: A[m][k] = base[(k0 + k) * s + m0 + m].
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const __nv_bfloat16* base, int s, int m0,
                                         int k0, int lane) {
  dmn::ldmatrix_x4_trans(a, dmn::smem_u32(base + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * s + m0 +
                                          ((lane >> 3) & 1) * 8));
}

// B fragments at k16 step k0 of B[k][n] = base[k * s + n], n8 tiles n0 and
// n0 + 8: (b[0], b[1]) of the first, (b[2], b[3]) of the second.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const __nv_bfloat16* base, int s, int k0,
                                       int n0, int lane) {
  dmn::ldmatrix_x4_trans(b, dmn::smem_u32(base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * s + n0 +
                                          (lane >> 4) * 8));
}

// float32: the 16 x 8 output tile (m0.., n0..) of A . B by f32 FMAs, each
// lane owning the four elements of its mma C fragment.
template <class FA, class FB>
__device__ __forceinline__ void fma_tile(float (&d)[4], int K, FA fa, FB fb, int m0, int n0,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = fa(m0 + g, k), a1 = fa(m0 + g + 8, k);
    const float b0 = fb(k, n0 + 2 * t), b1 = fb(k, n0 + 2 * t + 1);
    d[0] += a0 * b0;
    d[1] += a0 * b1;
    d[2] += a1 * b0;
    d[3] += a1 * b1;
  }
}

// acc[mt][j] += A . W over the tile's MT m16 tiles and the NT n8 tiles from
// nt0: A [TILE][K] in shared memory (row stride as; bf16: zero columns up
// to K rounded to 32), W a weight of `ntiles` n8 tiles (see BlockArgs).
template <typename T, int NT>
__device__ __forceinline__ void tile_product(float (&acc)[MT][NT][4], const T* a, int as, int K,
                                             const T* w, int ntiles, int nt0, int lane) {
  if constexpr (dmn::is_bf16<T>()) {
    // The B fragments of KG pairs of k16 steps are asked for at once, so that
    // a product with K <= 128 waits for L2 once, not once a step.
    constexpr int KG = 4;
    const int kpairs = ceil_div(K, 32);
    for (int kp0 = 0; kp0 < kpairs; kp0 += KG) {
      uint4 bw[KG][NT];
#pragma unroll
      for (int i = 0; i < KG; ++i)
        if (kp0 + i < kpairs) {
#pragma unroll
          for (int j = 0; j < NT; ++j) bw[i][j] = ldg_fragments(w, kp0 + i, nt0 + j, ntiles, lane);
        }
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        if (kp0 + i >= kpairs) break;
        const int k0 = (kp0 + i) * 32;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t f[4];
          load_a(f, a, as, mt * 16, k0, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j) dmn::mma_bf16(acc[mt][j], f, bw[i][j].x, bw[i][j].y);
          load_a(f, a, as, mt * 16, k0 + 16, lane);
#pragma unroll
          for (int j = 0; j < NT; ++j) dmn::mma_bf16(acc[mt][j], f, bw[i][j].z, bw[i][j].w);
        }
      }
    }
  } else {
    const int ld = 8 * ntiles;
    for (int mt = 0; mt < MT; ++mt)
      for (int j = 0; j < NT; ++j)
        fma_tile(acc[mt][j], K, [&](int m, int k) { return a[m * as + k]; },
                 [&](int k, int n) { return w[size_t(k) * ld + n]; }, mt * 16, (nt0 + j) * 8, lane);
  }
}

template <int M, int NT>
__device__ __forceinline__ void zero(float (&acc)[M][NT][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Two neighbouring elements of a tile row, rounded to T.
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  if constexpr (dmn::is_bf16<T>())
    *reinterpret_cast<uint32_t*>(dst) = dmn::pack_bf16(a, b);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Columns c0 .. c0 + V - 1 (16 bytes) of row r of the slab [rows][C] of x,
// as f32; zeros outside it. `vec`: C is a multiple of V, 16-byte loads.
template <typename T, int V = 16 / sizeof(T)>
__device__ __forceinline__ void load_x(float (&f)[V], const T* xs, int r, int c0, int rows, int C,
                                       bool vec) {
  if (vec && r < rows && c0 < C) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(xs + size_t(r) * C + c0));
    const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = dmn::to_f32(v[e]);
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    f[e] = (r < rows && c0 + e < C) ? dmn::to_f32(xs[size_t(r) * C + c0 + e]) : 0.f;
}

template <typename T, int V = 16 / sizeof(T)>
__device__ __forceinline__ void store_chunk(T* dst, const float (&f)[V]) {
  T v[V];
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = dmn::from_f32<T>(f[e]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// The block's sum of (a, b) added over the cluster in rank order; every
// thread of every CTA gets the same bits. `slot` is this CTA's published
// partial, read by the others after the cluster barrier and not written again.
__device__ __forceinline__ float2 cluster_sum2(float a, float b, float* red, float2* slot,
                                               cg::cluster_group& cluster, int cs) {
  const float2 tot = dmn::block_sum2(a, b, red);
  if (threadIdx.x == 0) *slot = tot;
  cluster.sync();
  float2 o[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < cs) o[q] = *cluster.map_shared_rank(slot, q);
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    if (q < cs) {
      r.x += o[q].x;
      r.y += o[q].y;
    }
  return r;
}

// The stages of the block and the core modes: see the note at the top. FOLD:
// the prenorm affine is folded into W_qkv and bqkv (#2); CORE: no prenorm,
// no bias, att is the output (#3, #12); neither: the affine applied (#9, #10).
template <typename T, bool FOLD, bool CORE>
__device__ __forceinline__ void block_stages(const BlockArgs& p) {
  static_assert(!(FOLD && CORE), "the core has no prenorm to fold");
  extern __shared__ float4 block_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(block_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cluster, rank = int(cluster.block_rank());
  const int b = blockIdx.x / cs, N = p.N, C = p.C;
  const int n0 = rank * p.slab, rows = min(p.slab, N - n0);
  const Layout L = block_layout(C, p.slab, p.resident, sizeof(T), CORE);
  float* red = reinterpret_cast<float*>(smem + L.misc);
  float2* slots = reinterpret_cast<float2*>(red + 64);  // x's sums, y's sums
  float* colm = reinterpret_cast<float*>(smem + L.colst);  // this slab's k column max
  float* cols = colm + HD;                                 // ... and sum of exp(k - max)
  float* colM = cols + HD;                                 // the sample's
  float* colR = colM + HD;                                 // 1 / the sample's sum
  T* gram = reinterpret_cast<T*>(smem + L.gram);  // [HEADS][DH][GS]
  T* abuf = reinterpret_cast<T*>(smem + L.a);     // [TILE][KVS]: k_sm | v, then q_sm
  float* gpart = reinterpret_cast<float*>(smem + L.a);  // between them, the slab's f32 gram
  float* qraw = reinterpret_cast<float*>(smem + L.a);  // f32 q, rows at the same bytes as abuf's
  const int QR = KVS * int(sizeof(T)) / 4;
  T* att = reinterpret_cast<T*>(smem + L.b);   // [TILE][AS]
  T* hbuf = reinterpret_cast<T*>(smem + L.h);  // [rows_h][hs]: the slab's h, or one tile's
  float* ybuf = reinterpret_cast<float*>(smem + L.y);  // [slab][c8] (resident)
  const int HS = L.hs, C8 = L.c8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const T* __restrict__ xs = static_cast<const T*>(p.x) + (size_t(b) * N + n0) * C;
  T* __restrict__ os = static_cast<T*>(p.out) + (size_t(b) * N + n0) * C;
  const T* __restrict__ wq = static_cast<const T*>(p.wqkv);
  const T* __restrict__ wo = static_cast<const T*>(p.wout);
  const float* __restrict__ bq = p.bqkv;
  const int ntile = ceil_div(rows, TILE);
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0;
  const float count = float(N) * C;

  // 1. x's statistics over the sample (not in CORE); resident: x into shared
  // memory, its padding (rows past the slab, columns past C) zero.
  float2 st = make_float2(0.f, 1.f);
  {
    float s = 0.f, ss = 0.f;
    auto add = [&](const float (&f)[V]) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += f[e];
        ss += f[e] * f[e];
      }
    };
    if (p.resident && vec) {  // every 16-byte piece in flight at once (cp.async), zeros as padding
      const int cpr = HS / V;
      for (int i = threadIdx.x; i < L.rows_h * cpr; i += THREADS) {
        const int r = i / cpr, c0 = (i % cpr) * V;
        const bool in = r < rows && c0 < C;
        dmn::cp_async16(dmn::smem_u32(hbuf + r * HS + c0), in ? xs + size_t(r) * C + c0 : xs, in);
      }
      dmn::cp_async_commit();
      dmn::cp_async_wait<0>();
      __syncthreads();
      for (int i = threadIdx.x; i < (CORE ? 0 : rows * (C / V)); i += THREADS) {
        const uint4 u = *reinterpret_cast<const uint4*>(hbuf + (i / (C / V)) * HS + (i % (C / V)) * V);
        const T* v = reinterpret_cast<const T*>(&u);
        float f[V];
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = dmn::to_f32(v[e]);
        add(f);
      }
    } else if (!CORE || p.resident) {
      const int cpr = p.resident ? HS / V : ceil_div(C, V);
      const int rr = p.resident ? L.rows_h : rows;
#pragma unroll 4
      for (int i = threadIdx.x; i < rr * cpr; i += THREADS) {
        const int r = i / cpr, c0 = (i % cpr) * V;
        float f[V];
        load_x<T>(f, xs, r, c0, rows, C, vec);
        add(f);
        if (p.resident) store_chunk<T>(hbuf + r * HS + c0, f);
      }
    }
    if constexpr (!CORE) {
      const float2 tot = cluster_sum2(s, ss, red, slots, cluster, cs);
      st = dmn::fast_variance_stats(tot.x, tot.y, count, p.eps);
    }
  }
  auto prenorm = [&](float v, int c) {
    if constexpr (CORE) return v;
    float h = (v - st.x) * st.y;
    if constexpr (!FOLD) h = h * p.ng[c] + p.nb[c];
    return h;
  };
  if constexpr (!CORE) {  // the resident slab normalised in place (CORE: h is the input)
    if (p.resident && vec) {
      for (int i = threadIdx.x; i < rows * (C / V); i += THREADS) {
        const int c0 = (i % (C / V)) * V;
        uint4* piece = reinterpret_cast<uint4*>(hbuf + (i / (C / V)) * HS + c0);
        uint4 u = *piece;
        T* v = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = dmn::from_f32<T>(prenorm(dmn::to_f32(v[e]), c0 + e));
        *piece = u;
      }
    } else if (p.resident) {
      for (int i = threadIdx.x; i < rows * C; i += THREADS) {
        T* e = hbuf + (i / C) * HS + i % C;
        *e = dmn::from_f32<T>(prenorm(dmn::to_f32(*e), i % C));
      }
    }
  }
  // The h rows of tile ti. Recompute: loaded again and normalised. Callers
  // synchronise before (the tile buffers' last readers are done).
  auto h_tile = [&](int ti) -> const T* {
    if (p.resident) return hbuf + ti * TILE * HS;
    const int cpr = HS / V;
#pragma unroll 4
    for (int i = threadIdx.x; i < TILE * cpr; i += THREADS) {
      const int r = i / cpr, c0 = (i % cpr) * V, row = ti * TILE + r;
      float f[V];
      load_x<T>(f, xs, row, c0, rows, C, vec);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = (row < rows && c0 + e < C) ? prenorm(f[e], c0 + e) : 0.f;
      store_chunk<T>(hbuf + r * HS + c0, f);
    }
    __syncthreads();
    return hbuf;
  };

  // 2. k's column max and sum of exp(k - max) over the slab, online; warp w
  // owns k columns 16w .. 16w + 15 (lane: 16w + 8j + 2t + e).
  {
    float mrun[2][2], srun[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mrun[j][e] = -INFINITY;
        srun[j][e] = 0.f;
      }
    for (int ti = 0; ti < ntile; ++ti) {
      __syncthreads();
      const T* h = h_tile(ti);
      float bias[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) bias[j][e] = FOLD ? __ldg(bq + HD + 16 * warp + 8 * j + 2 * t + e) : 0.f;
      float acc[MT][2][4];
      zero(acc);
      tile_product<T, 2>(acc, h, HS, C, wq, QKV / 8, HD / 8 + 2 * warp, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b_ = bias[j][e];
          float m = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              acc[mt][j][2 * r + e] += b_;
              if (ti * TILE + mt * 16 + g + 8 * r < rows) m = fmaxf(m, acc[mt][j][2 * r + e]);
            }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          const float mn = fmaxf(mrun[j][e], m);  // finite: the tile has a token
          float s = 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (ti * TILE + mt * 16 + g + 8 * r < rows) s += __expf(acc[mt][j][2 * r + e] - mn);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          srun[j][e] = srun[j][e] * __expf(mrun[j][e] - mn) + s;
          mrun[j][e] = mn;
        }
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * warp + 8 * j + 2 * t + e;
          colm[col] = mrun[j][e];
          cols[col] = srun[j][e];
        }
    }
    cluster.sync();
    if (threadIdx.x < HD) {  // the sample's M and S, ranks in order
      const int j = threadIdx.x;
      float m[MAX_CLUSTER], sr[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs) {
          m[q] = cluster.map_shared_rank(colm, q)[j];
          sr[q] = cluster.map_shared_rank(cols, q)[j];
        }
      float M = -INFINITY, S = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs) M = fmaxf(M, m[q]);
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs) S += sr[q] * __expf(m[q] - M);
      colM[j] = M;
      colR[j] = 1.f / S;
    }
  }

  // 3. k_sm = T(exp(k - M) / S) and v = T(v) per tile (warp w: columns 32w ..
  // 32w + 31 of k | v, in two halves), zero on padded tokens; the slab's per-head gram, warp
  // w owning head w / 2, k rows 16 (w % 2) .. + 15, all 32 v columns.
  {
    const int hh = warp >> 1, mh = warp & 1;
    float gacc[1][4][4];
    zero(gacc);
    for (int ti = 0; ti < ntile; ++ti) {
      __syncthreads();
      const T* h = h_tile(ti);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // 16 columns at a time: registers for two CTAs an SM
      float bias[2][2], cm[2][2], cr[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 32 * warp + 16 * half + 8 * j + 2 * t + e;
          bias[j][e] = FOLD ? __ldg(bq + HD + c) : 0.f;
          cm[j][e] = c < HD ? colM[c] : 0.f;
          cr[j][e] = c < HD ? colR[c] : 0.f;
        }
      float acc[MT][2][4];
      zero(acc);
      tile_product<T, 2>(acc, h, HS, C, wq, QKV / 8, HD / 8 + 4 * warp + 2 * half, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = mt * 16 + g + 8 * r, c = 32 * warp + 16 * half + 8 * j + 2 * t;
            const bool in = ti * TILE + row < rows;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = acc[mt][j][2 * r + e] + bias[j][e];
              v[e] = !in ? 0.f
                         : c < HD ? dmn::round_to<T>(__expf(a - cm[j][e]) * cr[j][e])
                                  : dmn::round_to<T>(a);
            }
            store2(abuf + row * KVS + c, v[0], v[1]);
          }
      }
      __syncthreads();
      if constexpr (dmn::is_bf16<T>()) {
#pragma unroll
        for (int ks = 0; ks < TILE / 16; ++ks) {
          uint32_t a[4];
          load_a_t(a, abuf, KVS, hh * DH + mh * 16, ks * 16, lane);
#pragma unroll
          for (int dp = 0; dp < 2; ++dp) {
            uint32_t bv[4];
            load_b(bv, abuf, KVS, ks * 16, HD + hh * DH + dp * 16, lane);
            dmn::mma_bf16(gacc[0][2 * dp], a, bv[0], bv[1]);
            dmn::mma_bf16(gacc[0][2 * dp + 1], a, bv[2], bv[3]);
          }
        }
      } else {
        for (int j = 0; j < 4; ++j)
          fma_tile(gacc[0][j], TILE, [&](int m, int k) { return abuf[k * KVS + hh * DH + m]; },
                   [&](int k, int n) { return abuf[k * KVS + HD + hh * DH + n]; }, mh * 16, 8 * j, lane);
      }
    }
    __syncthreads();  // the last tile's k_sm and v are read: gpart takes their place
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gpart[hh * DH * DH + (mh * 16 + g + 8 * r) * DH + 8 * j + 2 * t + e] = gacc[0][j][2 * r + e];
    cluster.sync();
    // Gram row rho (head rho / 32, k channel rho % 32) is added up by rank
    // rho % cs, four columns a thread, the ranks' partials in rank order; the
    // others then copy the rounded row from it.
    const int owned = ceil_div(HEADS * DH - rank, cs);
    for (int i = threadIdx.x; i < owned * (DH / 4); i += THREADS) {
      const int rho = rank + (i >> 3) * cs, c4 = (i & 7) * 4;
      float4 part[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs)
          part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(gpart, q) + rho * DH + c4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < cs) {
          v.x += part[q].x;
          v.y += part[q].y;
          v.z += part[q].z;
          v.w += part[q].w;
        }
      store2(gram + rho * GS + c4, dmn::round_to<T>(v.x), dmn::round_to<T>(v.y));
      store2(gram + rho * GS + c4 + 2, dmn::round_to<T>(v.z), dmn::round_to<T>(v.w));
    }
    cluster.sync();
    constexpr int RV = DH * int(sizeof(T)) / 16;  // 16-byte pieces of a gram row
    for (int i = threadIdx.x; i < HEADS * DH * RV; i += THREADS) {
      const int rho = i / RV, owner = rho % cs;
      if (owner == rank) continue;
      uint4* dst = reinterpret_cast<uint4*>(gram + rho * GS) + i % RV;
      *dst = *cluster.map_shared_rank(dst, owner);
    }
  }

  // 4. q, its softmax, att = q_sm . gram, y = att W_out + b_out. mode 0:
  // keep y (resident) and sum it; 1: sum it; 2: write the output with y's
  // statistics yst. Returns this thread's (sum, sum of squares) of y.
  auto attention_pass = [&](int mode, float2 yst) {
    float s = 0.f, ss = 0.f;
    for (int ti = 0; ti < ntile; ++ti) {
      __syncthreads();
      const T* h = h_tile(ti);
      {  // q columns 16w .. 16w + 15, f32
        float2 bias[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bias[j] = FOLD ? __ldg(reinterpret_cast<const float2*>(bq + 16 * warp + 8 * j + 2 * t))
                         : make_float2(0.f, 0.f);
        float acc[MT][2][4];
        zero(acc);
        tile_product<T, 2>(acc, h, HS, C, wq, QKV / 8, 2 * warp, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<float2*>(qraw + (mt * 16 + g + 8 * r) * QR + 16 * warp + 8 * j + 2 * t) =
                  make_float2(acc[mt][j][2 * r] + bias[j].x, acc[mt][j][2 * r + 1] + bias[j].y);
      }
      __syncthreads();
      // one max over the token's 128 columns, per-head sums (lanes 8h .. 8h + 7
      // hold head h); q_sm written over the row's own bytes
      {
        constexpr int RW = TILE / WARPS;  // rows of a warp, taken together
        float e[RW][4];
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          const float4 q = *reinterpret_cast<const float4*>(qraw + (warp + k * WARPS) * QR + 4 * lane);
          e[k][0] = q.x, e[k][1] = q.y, e[k][2] = q.z, e[k][3] = q.w;
        }
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          const float m = dmn::warp_max(fmaxf(fmaxf(e[k][0], e[k][1]), fmaxf(e[k][2], e[k][3])));
          float hs = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) hs += (e[k][c] = __expf(e[k][c] - m));
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) hs += __shfl_xor_sync(0xffffffffu, hs, o);
          const float inv = p.scale / hs;
#pragma unroll
          for (int c = 0; c < 4; ++c) e[k][c] = dmn::round_to<T>(e[k][c] * inv);
        }
        __syncwarp();  // every lane has read its rows before they are written over
#pragma unroll
        for (int k = 0; k < RW; ++k)
#pragma unroll
          for (int c = 0; c < 4; c += 2)
            store2(abuf + (warp + k * WARPS) * KVS + 4 * lane + c, e[k][c], e[k][c + 1]);
      }
      __syncthreads();
      {  // att of head w / 2, columns 16 (w % 2) .. + 15 of the head
        const int hh = warp >> 1, nh = warp & 1;
        float acc[MT][2][4];
        zero(acc);
        if constexpr (dmn::is_bf16<T>()) {
#pragma unroll
          for (int ks = 0; ks < DH / 16; ++ks) {
            uint32_t bg[4];
            load_b(bg, gram + hh * DH * GS, GS, ks * 16, nh * 16, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              uint32_t a[4];
              load_a(a, abuf, KVS, mt * 16, hh * DH + ks * 16, lane);
              dmn::mma_bf16(acc[mt][0], a, bg[0], bg[1]);
              dmn::mma_bf16(acc[mt][1], a, bg[2], bg[3]);
            }
          }
        } else {
          for (int mt = 0; mt < MT; ++mt)
            for (int j = 0; j < 2; ++j)
              fma_tile(acc[mt][j], DH, [&](int m, int k) { return abuf[m * KVS + hh * DH + k]; },
                       [&](int k, int n) { return gram[(hh * DH + k) * GS + n]; }, mt * 16,
                       nh * 16 + 8 * j, lane);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              store2(att + (mt * 16 + g + 8 * r) * AS + hh * DH + nh * 16 + 8 * j + 2 * t,
                     dmn::round_to<T>(acc[mt][j][2 * r]), dmn::round_to<T>(acc[mt][j][2 * r + 1]));
      }
      __syncthreads();
      if constexpr (CORE) {  // att is the output: its tile rows, 16 bytes a thread
        constexpr int PR = HD / V;
        T* __restrict__ ob = static_cast<T*>(p.out) + (size_t(b) * N + n0 + ti * TILE) * HD;
        for (int i = threadIdx.x; i < TILE * PR; i += THREADS) {
          const int r = i / PR, c0 = (i % PR) * V;
          if (ti * TILE + r < rows)
            *reinterpret_cast<uint4*>(ob + size_t(r) * HD + c0) = *reinterpret_cast<const uint4*>(att + r * AS + c0);
        }
        continue;
      }
      // y: n8 tiles nt0 .. nt0 + NY - 1 of the C8 / 8 (std::integral_constant NY)
      auto project_out = [&](auto ny, int nt0) {
        constexpr int NY = decltype(ny)::value;
        float bo[NY][2];
#pragma unroll
        for (int j = 0; j < NY; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = (nt0 + j) * 8 + 2 * t + e;
            bo[j][e] = col < C ? __ldg(p.bout + col) : 0.f;
          }
        float acc[MT][NY][4];
        zero(acc);
        tile_product<T, NY>(acc, att, AS, HD, wo, C8 / 8, nt0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NY; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = ti * TILE + mt * 16 + g + 8 * r, col = (nt0 + j) * 8 + 2 * t + e;
                if (row >= rows || col >= C) continue;
                const float y = acc[mt][j][2 * r + e] + bo[j][e];
                if (mode == 2) {
                  const float o = ((y - yst.x) * yst.y) * p.og[col] + p.ob[col] +
                                  dmn::to_f32(xs[size_t(row) * C + col]);
                  os[size_t(row) * C + col] = dmn::from_f32<T>(o);
                  continue;
                }
                s += y;
                ss += y * y;
                if (mode == 0) ybuf[row * C8 + col] = y;
              }
      };
      const int nty = C8 / 8, pairs = nty / 2;
      if (pairs >= WARPS) {  // wide C: two n8 tiles a warp, one wait for their fragments
        for (int pi = warp; pi < pairs; pi += WARPS) project_out(std::integral_constant<int, 2>{}, 2 * pi);
        if (nty % 2 && warp == pairs % WARPS) project_out(std::integral_constant<int, 1>{}, nty - 1);
      } else {
        for (int nt = warp; nt < nty; nt += WARPS) project_out(std::integral_constant<int, 1>{}, nt);
      }
    }
    return make_float2(s, ss);
  };

  // 5. y's statistics over the sample, then out = GroupNorm(y) + x.
  if (CORE) {
    attention_pass(1, make_float2(0.f, 0.f));
  } else if (p.resident) {
    const float2 part = attention_pass(0, make_float2(0.f, 0.f));
    const float2 tot = cluster_sum2(part.x, part.y, red, slots + 1, cluster, cs);
    const float2 yst = dmn::fast_variance_stats(tot.x, tot.y, count, p.eps);
    const int cpr = ceil_div(C, V);
    int cl = -1;  // the columns whose affine is in og_, ob_ (a thread's columns change only if cpr
                  // does not divide THREADS)
    float og_[V], ob_[V];
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c0 = (i % cpr) * V;
      if (c0 != cl) {
        cl = c0;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          og_[e] = __ldg(p.og + min(c0 + e, C - 1));
          ob_[e] = __ldg(p.ob + min(c0 + e, C - 1));
        }
      }
      float f[V];
      load_x<T>(f, xs, r, c0, rows, C, vec);
#pragma unroll
      for (int e = 0; e < V; ++e)
        f[e] += ((ybuf[r * C8 + min(c0 + e, C - 1)] - yst.x) * yst.y) * og_[e] + ob_[e];
      if (vec) {
        store_chunk<T>(os + size_t(r) * C + c0, f);
      } else {
        for (int e = 0; e < V && c0 + e < C; ++e) os[size_t(r) * C + c0 + e] = dmn::from_f32<T>(f[e]);
      }
    }
  } else {
    const float2 part = attention_pass(1, make_float2(0.f, 0.f));
    const float2 tot = cluster_sum2(part.x, part.y, red, slots + 1, cluster, cs);
    attention_pass(2, dmn::fast_variance_stats(tot.x, tot.y, count, p.eps));
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// ------------------------------------------------ the raw-qkv core (#8) --
constexpr int RAW_TILE = 64;                  // tokens of a reloaded tile
constexpr int RAW_MAX_CLUSTER = 16;           // the H100's largest (non-portable) cluster
constexpr int ROW_GROUPS = THREADS / HD;      // stage 2: a k column's rows split two ways
constexpr int FRS = HD + 4;                   // f32 k_sm row (floats)
// The raw mode's f32 grams: a head's 32 rows of DH + 4 floats, the heads
// GHS floats apart, so that the rows' 16-byte pieces spread over the bank
// groups.
constexpr int GRS = DH + 4;
constexpr int GHS = DH * GRS + 4;
constexpr int RAW_GRAM_BYTES = HEADS * GHS * 4;

// Byte offsets of the raw mode's shared memory; ops/attention.py:
// _linattn_raw_smem is its mirror. k, v and q rows of `rows` tokens (the
// slab rounded up to 64, or one 64-token tile), padded by 16 bytes; f32
// k_sm [rows][FRS] and then q_sm transposed [HD][rows + 4] live in k's
// region in float32 and in region f in bf16; the slab's partial gram takes
// k's place, the sample's gram v's.
struct RawLayout {
  size_t colst, groups, k, v, q, f, total;
  int rs, rows;
};

__host__ __device__ inline RawLayout raw_layout(int slab, int resident, int esize) {
  auto most = [](size_t a, size_t b) { return a > b ? a : b; };
  RawLayout L;
  L.rs = HD + 16 / esize;
  L.rows = resident ? ceil_div(slab, TILE) * TILE : RAW_TILE;
  const size_t tokens = size_t(L.rows) * L.rs * esize;
  const size_t f32 = most(size_t(L.rows) * FRS * 4, size_t(HD) * (L.rows + 4) * 4);
  size_t off = 0;
  auto take = [&](size_t n) {
    const size_t at = off;
    off += (n + 15) & ~size_t(15);
    return at;
  };
  L.colst = take(sizeof(float) * 4 * HD);
  L.groups = take(sizeof(float) * (ROW_GROUPS - 1) * 2 * HD);
  L.k = take(most(most(tokens, RAW_GRAM_BYTES), esize == 4 ? f32 : 0));
  L.v = take(most(tokens, RAW_GRAM_BYTES));
  L.q = take(tokens);
  L.f = take(esize == 4 ? 0 : f32);
  L.total = off;
  return L;
}

// M consecutive elements from shared memory as f32, 16 bytes a load.
template <typename T, int M>
__device__ __forceinline__ void load_row(float (&f)[M], const T* s) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < M / V; ++u) {
    const uint4 w = *reinterpret_cast<const uint4*>(s + u * V);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) f[u * V + j] = dmn::to_f32(e[j]);
  }
}

// M consecutive elements stored in T, 16 bytes a store.
template <typename T, int M>
__device__ __forceinline__ void store_row(T* d, const float (&f)[M]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < M / V; ++u) {
    T v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = dmn::from_f32<T>(f[u * V + j]);
    *reinterpret_cast<uint4*>(d + u * V) = *reinterpret_cast<const uint4*>(v);
  }
}

// The RAW mode (#8): stages 2-4 on q, k and v loaded from qkv [B, N, 384]
// rows, f32 arithmetic, the output cast once; see the note at the top.
template <typename T>
__device__ __forceinline__ void raw_stages(const BlockArgs& p) {
  extern __shared__ float4 block_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(block_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cluster, rank = int(cluster.block_rank());
  const int b = blockIdx.x / cs, N = p.N;
  const int n0 = rank * p.slab, rows = min(p.slab, N - n0);
  const RawLayout L = raw_layout(p.slab, p.resident, sizeof(T));
  float* colm = reinterpret_cast<float*>(smem + L.colst);  // this slab's k column max
  float* cols = colm + HD;                                 // ... and sum of exp(k - max)
  float* colM = cols + HD;                                 // the sample's
  float* colR = colM + HD;                                 // 1 / the sample's sum
  float* groups = reinterpret_cast<float*>(smem + L.groups);  // row group 1's max and sum; stage 4's head maxes
  T* kb = reinterpret_cast<T*>(smem + L.k);
  T* vb = reinterpret_cast<T*>(smem + L.v);
  T* qb = reinterpret_cast<T*>(smem + L.q);
  float* fb = reinterpret_cast<float*>(smem + (dmn::is_bf16<T>() ? L.f : L.k));  // k_sm, then q_sm^T
  float* gpart = reinterpret_cast<float*>(smem + L.k);  // the slab's gram, once k is read
  float* gram = reinterpret_cast<float*>(smem + L.v);   // the sample's, once v is read
  const int RS = L.rs, TS = L.rows + 4, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* __restrict__ src = static_cast<const T*>(p.x) + (size_t(b) * N + n0) * QKV;
  T* __restrict__ dst = static_cast<T*>(p.out) + (size_t(b) * N + n0) * HD;
  constexpr int V = 16 / sizeof(T), PR = HD / V;  // 16-byte pieces of a row's q, k or v

  // Slab rows t0 .. t0 + nr - 1 of columns [col, col + HD) into buf; one commit group.
  auto fetch = [&](T* buf, int col, int t0, int nr) {
    for (int i = threadIdx.x; i < nr * PR; i += THREADS) {
      const int r = i / PR, c = (i % PR) * V;
      dmn::cp_async16(dmn::smem_u32(buf + r * RS + c), src + size_t(t0 + r) * QKV + col + c, true);
    }
    dmn::cp_async_commit();
  };

  // 2. k's column max and sum of exp(k - max) over the slab, online over
  // tiles: column c2, the rows of parity grp.
  const int c2 = threadIdx.x & (HD - 1), grp = threadIdx.x >> 7;
  float m = -INFINITY, s = 0.f;
  auto stats = [&](const T* kt, int nr) {
    float tm = -INFINITY;
#pragma unroll 8
    for (int r = grp; r < nr; r += ROW_GROUPS) tm = fmaxf(tm, dmn::to_f32(kt[r * RS + c2]));
    if (tm > m) {  // exp(-inf) = 0 on the first tile
      s *= __expf(m - tm);
      m = tm;
    }
#pragma unroll 8
    for (int r = grp; r < nr; r += ROW_GROUPS) s += __expf(dmn::to_f32(kt[r * RS + c2]) - m);
  };
  if (p.resident) {  // every piece in flight at once: k, then v, then q
    fetch(kb, HD, 0, rows);
    fetch(vb, 2 * HD, 0, rows);
    fetch(qb, 0, 0, rows);
    dmn::cp_async_wait<2>();
    __syncthreads();
    stats(kb, rows);
  } else {
    for (int t0 = 0; t0 < rows; t0 += RAW_TILE) {
      const int nr = min(RAW_TILE, rows - t0);
      __syncthreads();
      fetch(kb, HD, t0, nr);
      dmn::cp_async_wait<0>();
      __syncthreads();
      stats(kb, nr);
    }
  }
  if (grp) {
    groups[c2] = m;
    groups[HD + c2] = s;
  }
  __syncthreads();
  if (!grp) {  // row 0 is even: m is finite; m1 is -inf only for a one-token slab
    const float m1 = groups[c2], s1 = groups[HD + c2], M = fmaxf(m, m1);
    colm[c2] = M;
    cols[c2] = s * __expf(m - M) + s1 * __expf(m1 - M);
  }
  if (cs == 1) {  // the slab is the sample: the merge below would give these bits
    __syncthreads();
    if (threadIdx.x < HD) {
      colM[threadIdx.x] = colm[threadIdx.x];
      colR[threadIdx.x] = 1.f / cols[threadIdx.x];
    }
  } else {
    cluster.sync();
    if (threadIdx.x < HD) {  // the sample's M and 1 / S, ranks in order
      const int j = threadIdx.x;
      float mq[RAW_MAX_CLUSTER], sq[RAW_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < RAW_MAX_CLUSTER; ++q)
        if (q < cs) {
          mq[q] = cluster.map_shared_rank(colm, q)[j];
          sq[q] = cluster.map_shared_rank(cols, q)[j];
        }
      float M = -INFINITY, S = 0.f;
#pragma unroll
      for (int q = 0; q < RAW_MAX_CLUSTER; ++q)
        if (q < cs) M = fmaxf(M, mq[q]);
#pragma unroll
      for (int q = 0; q < RAW_MAX_CLUSTER; ++q)
        if (q < cs) S += sq[q] * __expf(mq[q] - M);
      colM[j] = M;
      colR[j] = 1.f / S;
    }
  }
  __syncthreads();

  // 3. k_sm = exp(k - M) / S in f32 (a reciprocal where the TPU kernel
  // divides: one f32 rounding apart), each element once, into fb; then the
  // slab's gram k_sm^T v: warp w takes head w % 4 and the rows of parity
  // w / 4, lane (ib, jb) k channels 4 ib .. 4 ib + 3 against v channels 8 jb
  // .. 8 jb + 7 (32 FMAs a 16-byte k piece and two v pieces); the two row
  // halves added after (into the sample's gram itself on a one-CTA cluster).
  {
    const float Mc = colM[c2], Rc = colR[c2];
    auto k_softmax = [&](const T* kt, int nr) {
#pragma unroll 4
      for (int r = grp; r < nr; r += ROW_GROUPS) fb[r * FRS + c2] = __expf(dmn::to_f32(kt[r * RS + c2]) - Mc) * Rc;
    };
    const int hr = warp >> 2, hh = warp & (HEADS - 1), ib = lane >> 2, jb = lane & 3;
    float g[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) g[a][j] = 0.f;
    auto gram_rows = [&](const T* vt, int nr) {
#pragma unroll 2
      for (int r = hr; r < nr; r += 2) {
        const float4 k4 = *reinterpret_cast<const float4*>(fb + r * FRS + hh * DH + 4 * ib);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        float vv[8];
        load_row<T, 8>(vv, vt + r * RS + hh * DH + 8 * jb);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) g[a][j] += kk[a] * vv[j];
      }
    };
    if (p.resident) {
      dmn::cp_async_wait<1>();
      __syncthreads();
      k_softmax(kb, rows);
      __syncthreads();
      gram_rows(vb, rows);
    } else {
      for (int t0 = 0; t0 < rows; t0 += RAW_TILE) {
        const int nr = min(RAW_TILE, rows - t0);
        __syncthreads();
        fetch(kb, HD, t0, nr);
        fetch(vb, 2 * HD, t0, nr);
        dmn::cp_async_wait<0>();
        __syncthreads();
        k_softmax(kb, nr);
        __syncthreads();
        gram_rows(vb, nr);
      }
    }
    __syncthreads();  // every k_sm and v read: the grams take their place
    float* part = (cs == 1 ? gram : gpart) + hh * GHS + 4 * ib * GRS + 8 * jb;
    if (hr) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          *reinterpret_cast<float4*>(part + a * GRS + 4 * u) =
              make_float4(g[a][4 * u], g[a][4 * u + 1], g[a][4 * u + 2], g[a][4 * u + 3]);
    }
    __syncthreads();
    if (!hr) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float4* e = reinterpret_cast<float4*>(part + a * GRS + 4 * u);
          const float4 o = *e;
          *e = make_float4(g[a][4 * u] + o.x, g[a][4 * u + 1] + o.y, g[a][4 * u + 2] + o.z, g[a][4 * u + 3] + o.w);
        }
    }
  }
  if (cs > 1) {
    // Gram row rho (head rho / 32, k channel rho % 32) is added up by rank
    // rho % cs, four columns a thread, the ranks' partials in rank order;
    // the others then copy the row from it.
    auto grow = [](int rho) { return (rho >> 5) * GHS + (rho & (DH - 1)) * GRS; };
    cluster.sync();
    const int owned = ceil_div(HEADS * DH - rank, cs);
    for (int i = threadIdx.x; i < owned * (DH / 4); i += THREADS) {
      const int rho = rank + (i >> 3) * cs, at = grow(rho) + (i & 7) * 4;
      float4 part[RAW_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < RAW_MAX_CLUSTER; ++q)
        if (q < cs) part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(gpart, q) + at);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < RAW_MAX_CLUSTER; ++q)
        if (q < cs) {
          v.x += part[q].x;
          v.y += part[q].y;
          v.z += part[q].z;
          v.w += part[q].w;
        }
      *reinterpret_cast<float4*>(gram + at) = v;
    }
    cluster.sync();  // every partial read: k's region is free again
    for (int i = threadIdx.x; i < HEADS * DH * (DH / 4); i += THREADS) {
      const int rho = i >> 3, owner = rho % cs;
      if (owner == rank) continue;
      float4* d = reinterpret_cast<float4*>(gram + grow(rho) + (i & 7) * 4);
      *d = *cluster.map_shared_rank(d, owner);
    }
  }

  // 4. q's softmax over each head, with one max over the token's 128
  // columns as the TPU kernel takes it, times scale, written transposed
  // (q_sm^T [HD][TS] in fb; warp w: head w % 4, a token a lane); then
  // att = q_sm . gram, f32, cast once: lane (tb, jb) of warp w, head w / 2,
  // takes tokens 4 tb .. 4 tb + 3 against v channels 8 jb .. 8 jb + 7 (32
  // FMAs a 16-byte q piece and two gram pieces), 64 tokens a pass. The
  // rows are staged in q's region and written whole, 16 bytes a thread:
  // written from the register blocks, each store would fill half a sector
  // of eight rows, and the stores took longer than the FMAs.
  auto q_softmax = [&](const T* qt, int nr) {
    const int hq = warp & (HEADS - 1);
    for (int p0 = 0; p0 < nr; p0 += 64) {
      const int tl = (warp >> 2) * 32 + lane, t = p0 + tl;
      float q[DH];
      if (t < nr) {
        load_row<T, DH>(q, qt + t * RS + hq * DH);
      } else {
#pragma unroll
        for (int d = 0; d < DH; ++d) q[d] = 0.f;
      }
      float mx = q[0];
#pragma unroll
      for (int d = 1; d < DH; ++d) mx = fmaxf(mx, q[d]);
      __syncthreads();  // the last pass's head maxes are read
      groups[tl * HEADS + hq] = mx;
      __syncthreads();
      const float4 m4 = *reinterpret_cast<const float4*>(groups + tl * HEADS);
      mx = fmaxf(fmaxf(m4.x, m4.y), fmaxf(m4.z, m4.w));
      float hs = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) hs += (q[d] = __expf(q[d] - mx));
      const float inv = p.scale / hs;
      if (t < nr) {
#pragma unroll
        for (int d = 0; d < DH; ++d) fb[(hq * DH + d) * TS + t] = q[d] * inv;
      }
    }
  };
  auto attend = [&](int t0, int nr) {
    const int hp = warp >> 1, jb = lane & 3;
    const float* gh = gram + hp * GHS + 8 * jb;
    for (int tb = ((warp & 1) << 3) + (lane >> 2); 4 * tb < nr; tb += 16) {
      float acc[4][8];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
#pragma unroll 4
      for (int i = 0; i < DH; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(fb + (hp * DH + i) * TS + 4 * tb);
        const float4 ga = *reinterpret_cast<const float4*>(gh + i * GRS);
        const float4 gc = *reinterpret_cast<const float4*>(gh + i * GRS + 4);
        const float qq[4] = {qa.x, qa.y, qa.z, qa.w};
        const float gg[8] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[t][j] += qq[t] * gg[j];
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) store_row<T, 8>(qb + (4 * tb + t) * RS + hp * DH + 8 * jb, acc[t]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * PR; i += THREADS) {
      const int r = i / PR, c = (i % PR) * V;
      *reinterpret_cast<uint4*>(dst + size_t(t0 + r) * HD + c) = *reinterpret_cast<const uint4*>(qb + r * RS + c);
    }
  };
  if (p.resident) {
    dmn::cp_async_wait<0>();
    __syncthreads();
    q_softmax(qb, rows);
    __syncthreads();
    attend(0, rows);
  } else {
    for (int t0 = 0; t0 < rows; t0 += RAW_TILE) {
      const int nr = min(RAW_TILE, rows - t0);
      __syncthreads();
      fetch(qb, 0, t0, nr);
      dmn::cp_async_wait<0>();
      __syncthreads();
      q_softmax(qb, nr);
      __syncthreads();
      attend(t0, nr);
    }
  }
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

// One cluster of `cluster` CTAs per sample (see the note at the top); RAW:
// the attention core on a raw qkv tensor (#8).
template <typename T, bool FOLD, bool CORE, bool RAW = false>
__global__ void __launch_bounds__(THREADS, 2) linattn_block_kernel(const BlockArgs p) {
  if constexpr (RAW)
    raw_stages<T>(p);
  else
    block_stages<T, FOLD, CORE>(p);
}

// The launch plan the wrapper computed, checked against this file's layout.
// mode: 0 the block, 1 the core, 2 the raw-qkv core (C = 384).
bool plan_ok(int B, int N, int C, int cluster, int slab, int resident, int smem, int esize, int mode) {
  if (B < 1 || N < 1 || C < 1 || cluster < 1 || cluster > (mode == 2 ? RAW_MAX_CLUSTER : MAX_CLUSTER) || slab < 1)
    return false;
  if (size_t(cluster) * slab < size_t(N) || size_t(cluster - 1) * slab >= size_t(N)) return false;
  if (size_t(B) * cluster > 0x7fffffff) return false;
  if (mode == 2 && C != QKV) return false;
  const size_t total = mode == 2 ? raw_layout(slab, resident, esize).total
                                 : block_layout(C, slab, resident, esize, mode).total;
  return total == size_t(smem) && total <= SMEM_LIMIT;
}

template <typename T, bool FOLD, bool CORE = false, bool RAW = false>
int launch_block(const BlockArgs& p, int B, int smem, cudaStream_t stream) {
  if (!plan_ok(B, p.N, p.C, p.cluster, p.slab, p.resident, smem, sizeof(T), RAW ? 2 : int(CORE)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = linattn_block_kernel<T, FOLD, CORE, RAW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && p.cluster > MAX_CLUSTER)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(B) * p.cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int block_unfolded(const void* x, const void* ng, const void* nb, const void* wqkv, const void* wout,
                   const void* bout, const void* og, const void* ob, void* out, int B, int N, int C,
                   int bf16, int cluster, int slab, int resident, int smem, float scale, float eps,
                   void* stream) {
  const BlockArgs p{x, wqkv, nullptr, static_cast<const float*>(ng), static_cast<const float*>(nb),
                    wout, static_cast<const float*>(bout), static_cast<const float*>(og),
                    static_cast<const float*>(ob), out, N, C, cluster, slab, resident, scale, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_block<__nv_bfloat16, false>(p, B, smem, s);
  return launch_block<float, false>(p, B, smem, s);
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_linattn)

// Shared-memory bytes of the whole-block kernel for a plan (the wrapper's
// linattn_block_plan computes the same; element size 2 for bf16, 4 for f32;
// mode 0 the block, 1 the core, 2 the raw-qkv core).
DMN_EXPORT long dmn_linattn_block_smem(int C, int slab, int resident, int esize, int mode) {
  if (mode == 2) return static_cast<long>(raw_layout(slab, resident, esize).total);
  return static_cast<long>(block_layout(C, slab, resident, esize, mode).total);
}

// Whole block (#2), one launch: x [B,N,C] bf16 (16-byte aligned) -> out
// [B,N,C] bf16. wqkv: gamma * W_qkv in bf16, fragment order (zero rows up to
// C rounded to 32); bqkv [384] f32 = beta @ W_qkv; wout: W_out [128, C8] in
// bf16 (zero columns past C), fragment order; bout, og, ob [C] f32. The plan
// (cluster, slab, resident, smem) is linattn_block_plan's.
DMN_EXPORT int dmn_linattn_block(const void* x, const void* wqkv, const void* bqkv,
                                 const void* wout, const void* bout, const void* og,
                                 const void* ob, void* out, int B, int N, int C, int cluster,
                                 int slab, int resident, int smem, float scale, float eps,
                                 void* stream) {
  const BlockArgs p{x, wqkv, static_cast<const float*>(bqkv), nullptr, nullptr, wout,
                    static_cast<const float*>(bout), static_cast<const float*>(og),
                    static_cast<const float*>(ob), out, N, C, cluster, slab, resident, scale, eps};
  return launch_block<__nv_bfloat16, true>(p, B, smem, static_cast<cudaStream_t>(stream));
}

// Whole block, v1 (#9): x [B,N,C] bf16 -> out bf16; ng, nb [C] f32 (the
// prenorm affine, not folded); wqkv, wout as for #2 without the fold.
DMN_EXPORT int dmn_linattn_block_v1(const void* x, const void* ng, const void* nb,
                                    const void* wqkv, const void* wout, const void* bout,
                                    const void* og, const void* ob, void* out, int B, int N, int C,
                                    int cluster, int slab, int resident, int smem, float scale,
                                    float eps, void* stream) {
  return block_unfolded(x, ng, nb, wqkv, wout, bout, og, ob, out, B, N, C, 1, cluster, slab,
                        resident, smem, scale, eps, stream);
}

// Whole block, v2 (#10): x [B,N,C] f32, or bf16 where `bf16` -> out in x's
// dtype. bf16: as v1. float32: wqkv [C,384] and wout [128,C8] f32 row major.
DMN_EXPORT int dmn_linattn_block_v2(const void* x, const void* ng, const void* nb,
                                    const void* wqkv, const void* wout, const void* bout,
                                    const void* og, const void* ob, void* out, int B, int N, int C,
                                    int bf16, int cluster, int slab, int resident, int smem,
                                    float scale, float eps, void* stream) {
  return block_unfolded(x, ng, nb, wqkv, wout, bout, og, ob, out, B, N, C, bf16, cluster, slab,
                        resident, smem, scale, eps, stream);
}

// Attention core on pre-normed tokens (#3 in bf16; #12, the same bytes as
// token rows, in x's dtype), one launch: h [B,N,C] f32, or bf16 where `bf16`
// (16-byte aligned) -> out [B,N,128] in h's dtype. wqkv: bf16 W_qkv [C,384]
// in fragment order (zero rows up to C rounded to 32); float32: [C,384] row
// major. The plan (cluster, slab, resident, smem) is linattn_block_plan's in
// its core mode.
DMN_EXPORT int dmn_linattn_tokens(const void* h, const void* wqkv, void* out, int B, int N, int C,
                                  int bf16, int cluster, int slab, int resident, int smem,
                                  float scale, void* stream_) {
  const BlockArgs p{h, wqkv, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    out, N, C, cluster, slab, resident, scale, 0.f};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bf16) return launch_block<__nv_bfloat16, false, true>(p, B, smem, stream);
  return launch_block<float, false, true>(p, B, smem, stream);
}

// Attention core on a raw qkv tensor (#8), one launch: qkv [B,N,384] (f32,
// or bf16 where `bf16`; 16-byte aligned) -> out [B,N,128] in the same dtype.
// The plan (cluster, slab, resident, smem) is linattn_block_plan's in its
// raw mode.
DMN_EXPORT int dmn_linattn_qkv(const void* qkv, void* out, int B, int N, int bf16, int cluster,
                               int slab, int resident, int smem, float scale, void* stream_) {
  const BlockArgs p{qkv, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    out, N, QKV, cluster, slab, resident, scale, 0.f};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bf16) return launch_block<__nv_bfloat16, false, false, true>(p, B, smem, stream);
  return launch_block<float, false, false, true>(p, B, smem, stream);
}
