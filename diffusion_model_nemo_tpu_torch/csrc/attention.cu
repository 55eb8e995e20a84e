// Softmax attention over [B, N, h, d] tensors, read in place with strides.
//
// Replaces TPU kernel _attn_kernel (launcher _pallas_attention) of
// diffusion_model_nemo_tpu/ops/attention.py: per (sample, head),
// softmax(q k^T - rowmax) v with q pre-scaled, f32 scores and accumulation,
// the output in the input dtype. The TPU launcher transposed q, k and v to
// [B*h, N, d] and held a whole [N, N] score block in VMEM per grid step.
// Neither carries over: the transposes would be three extra passes through
// device memory (k and v are strided slices of the DiT's qkv tensor), and an
// [N, N] f32 block (4 MB at N = 1024) does not fit 227 KB of shared memory.
//
// What bounds it: 4 B h N^2 d operations against 4 B N h d elements moved; at
// N = 1024, d = 64 that is ~1000 operations per element, so the operation
// rate bounds it: 989 TFLOP/s on the bf16 tensor cores. A second limit sits
// close behind: the softmax needs B h N^2 exp2, and an SM's special-function
// units give 16 a clock, which at d = 64 is about as long as the products
// take at the tensor cores' peak. Neither is what a simple kernel meets
// first: a key tile's arithmetic is short against the round trips it waits
// for (a group of matrix instructions started, run and waited for; a barrier)
// and against the instructions it spends around them, so the design keeps
// the loop's instruction count down and the tensor cores' work in flight
// while the softmax runs.
//
// bf16 design, FlashAttention form on the tensor cores (both kernels):
//  - One block per (query tile, sample * head) walks the keys in tiles of 64
//    with an online softmax; no N x N tensor exists.
//  - q, k and v stay bf16 in shared memory, rows of d values with their
//    16-byte chunks XOR-swizzled by the row (for d = 64 this is the 128-byte
//    swizzle the warpgroup instructions read), so that the eight rows of one
//    ldmatrix fall in eight different bank groups. S = q k^T and O += P v
//    accumulate in f32 registers. A bf16 x bf16 product is exact in f32, so
//    S differs from an f32 kernel's only by the order of its sums.
//  - The softmax runs on the S accumulators: row max and row sum over the
//    four lanes that share a row, exp2 (one ex2.approx) on logits scaled by
//    log2(e) in the same FMA that subtracts the max. P is rounded to bf16 in
//    registers and is the A operand of the second product as it stands (the
//    accumulator layout is the A layout), so it never crosses shared memory.
//    The row sum is taken of the f32 values and divides O at the end. The
//    plain version rounds the *normalised* probabilities to bf16; this seam
//    differs from it by one bf16 rounding per term and stays inside
//    rtol = atol = 2e-2.
//  - Rows past N arrive as zeros; keys past N are set to -inf before the max
//    (only a ragged last tile runs that code), query rows past N are not
//    stored. k and v are read through their strides (16-byte aligned rows),
//    so the DiT's qkv slices need no copy.
//  - d = 64, the DiT's head (attn_wgmma_kernel): two warpgroups of 64 query
//    rows share a ring of four k/v stages. One thread asks the TMA unit for
//    each tile two steps ahead (4-D tensor maps over (d, h, n, b), encoded on
//    the host per launch, take the strided k/v as they are); the copies land
//    on mbarriers, and a stage is given back on another mbarrier when both
//    warpgroups are done with it, so no block-wide barrier and no thread's
//    own copy instructions sit in the loop. Both products are
//    wgmma.m64n64k16 with the A operand (q, P) in registers and the k tile
//    (K-major) or the v tile (MN-major, transpose flag) read from shared
//    memory through a descriptor. Within a warpgroup, step j starts S_{j+1}
//    and O += P_j v_j and runs the softmax of S_{j+1} while O's product is
//    still in flight.
//  - d = 32 and 128 (attn_mma_kernel): 4 warps, mma.sync.m16n8k16 with
//    k fragments from ldmatrix, v fragments from ldmatrix.trans, q fragments
//    kept in registers; a warp owns 32 query rows at d = 32, 16 at d = 128.
//    Tiles arrive by 16-byte cp.async through a ring of 3-4 stages, each
//    thread's addresses worked out once (TileCopy).
//  - Tried at d = 64 and dropped: four warpgroups a block (slower: more
//    consumers wait on one copying thread), a second warpgroup trailing the
//    first by half a step (no change). Not done: a producer warp of its own
//    with setmaxnreg; the copying thread's work is a few dozen cycles a step,
//    and a third warpgroup would cost the consumers registers they use.
//
// float32 inputs keep the CUDA-core kernel (attn_f32_kernel): it is held to
// 1e-4 against the plain version, which neither bf16 nor TF32 tensor cores
// give, and no network sends float32 at N >= 1024 on its main path.

#include <cuda.h>  // CUtensorMap and its enums; no function of libcuda is linked

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, n, h;  // elements; the d stride is 1
};

// ------------------------------------------------------- bf16, tensor cores --
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int BN = 64;  // keys per tile

// Byte offset of 16-byte chunk `c` of row `r` in a [rows][D] bf16 tile. The
// chunk index is XORed with the row so that eight consecutive rows put one
// logical chunk into eight different 16-byte bank groups: rows of 128 B or
// more use the row's low three bits, rows of 64 B (two to a 128-byte line)
// the next two.
template <int D>
__device__ __forceinline__ int tile_offset(int r, int c) {
  const int x = D >= 64 ? (r & 7) : ((r >> 1) & 3);
  return (r * D + ((c ^ x) << 3)) * 2;
}

// One thread's share of the 16-byte copies that fill swizzled [ROWS][D]
// tiles from successive blocks of ROWS rows of one (sample, head): the block
// covers PASS_ROWS rows a pass, a thread the same chunk of one row in every
// pass, so its tile offset is worked out once and its source address only
// steps: a tile costs it one compare, one add and one copy per pass. Rows
// >= N become zeros.
template <int D, int ROWS, int NTHREADS>
struct TileCopy {
  static constexpr int CH = D / 8;                 // 16-byte chunks per row
  static constexpr int PASS_ROWS = NTHREADS / CH;  // a multiple of 8: the swizzle repeats
  static constexpr int PASSES = ROWS / PASS_ROWS;
  static_assert(ROWS % PASS_ROWS == 0 && PASS_ROWS % 8 == 0, "tile rows must split into passes");
  const __nv_bfloat16* base;  // row 0 of this (sample, head): the address of a copy of zeros
  const __nv_bfloat16* src;   // this thread's chunk of its pass-0 row of the next tile
  long long pass_step;        // elements between the rows of two passes
  int row;                    // its pass-0 row in the next tile, counted from row 0
  uint32_t offset;            // of the pass-0 chunk in a tile

  __device__ __forceinline__ TileCopy(const __nv_bfloat16* base_, long long stride_n, int n0)
      : base(base_), pass_step(PASS_ROWS * stride_n) {
    const int r = threadIdx.x / CH, c = threadIdx.x % CH;
    row = n0 + r;
    src = base_ + row * stride_n + c * 8;
    offset = tile_offset<D>(r, c);
  }

  // Copy the next tile and step to the one after it.
  __device__ __forceinline__ void next(uint32_t tile, int N) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const bool in = row + p * PASS_ROWS < N;
      dmn::cp_async16(tile + offset + p * PASS_ROWS * D * 2, in ? src + p * pass_step : base, in);
    }
    row += ROWS;
    src += PASSES * pass_step;
  }
};

// Keys >= N of the ragged last tile leave the softmax: -inf before the max.
// Thread (g, t) holds columns 2t, 2t + 1 of every n8 tile, for two rows.
template <int MT, int NT>
__device__ __forceinline__ void mask_keys(float (&s)[MT][NT][4], int first_key, int N, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (first_key + nt * 8 + 2 * t + e >= N)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) s[mt][nt][e] = s[mt][nt][2 + e] = -INFINITY;
}

// One step of the online softmax on the S accumulators of a key tile, in
// place: s becomes the unnormalised probabilities 2^((s - max) log2 e) under
// the new running row max, l the running row sum of their f32 values (this
// lane's share: the four lanes of a row are summed once, at the end), and f
// the factor 2^((old max - new max) log2 e) that brings earlier sums to the
// new max. Thread (g, t) holds rows g (elements 0, 1) and g + 8 (elements
// 2, 3) of each m16 tile.
template <int MT, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[MT][NT][4], float (&mx)[MT][2],
                                             float (&l)[MT][2], float (&f)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) m = fmaxf(m, fmaxf(s[mt][nt][2 * r], s[mt][nt][2 * r + 1]));
      m = fmaxf(mx[mt][r], dmn::quad_max(m));  // finite: every tile has a valid key
      f[mt][r] = dmn::fast_exp2((mx[mt][r] - m) * LOG2E);  // 0 on the first tile
      const float ms = m * LOG2E;
      mx[mt][r] = m;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = dmn::fast_exp2(fmaf(s[mt][nt][2 * r + e], LOG2E, -ms));
          s[mt][nt][2 * r + e] = p;
          rs += p;
        }
      l[mt][r] = l[mt][r] * f[mt][r] + rs;
    }
}

// The output accumulator brought to the new running max.
template <int MT, int DT>
__device__ __forceinline__ void rescale(float (&o)[MT][DT][4], const float (&f)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] *= f[mt][e >> 1];
}

// The probabilities of keys 16 kk .. 16 kk + 15 rounded to bf16: two
// neighbouring C tiles are the A fragment of the next product.
template <int NT>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4], const float (&s)[NT][4], int kk) {
  pa[0] = dmn::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pa[1] = dmn::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pa[2] = dmn::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pa[3] = dmn::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// O / l for rows g and g + 8 of one m16 tile starting at query `row0`,
// written as bf16 pairs; rows >= N are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&o)[D / 8][4],
                                           const float (&l)[2], int row0, int b, int hh, int N,
                                           int H, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = row0 + g + 8 * r;
    const float inv = 1.f / dmn::quad_sum(l[r]);
    if (n >= N) continue;
    __nv_bfloat16* orow = out + ((size_t(b) * N + n) * H + hh) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          dmn::pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

using Masked = std::true_type;
using Whole = std::false_type;

// ------------------------------------------- d = 32 and 128: mma.sync form --
template <int D, int MT, int STAGES>
constexpr size_t mma_smem_bytes() {
  return size_t(MMA_WARPS * 16 * MT + STAGES * 2 * BN) * D * 2;  // q tile + stages of (k, v)
}

template <int D, int MT, int STAGES>
__global__ void __launch_bounds__(MMA_THREADS, 2)
attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                Strides sq, Strides sk, Strides sv, int N, int H) {
  constexpr int BM = MMA_WARPS * 16 * MT;  // queries per block
  constexpr int KT = D / 16;               // k16 steps of q k^T
  constexpr int NT = BN / 8;               // n8 tiles of S
  constexpr int DT = D / 8;                // n8 tiles of O
  constexpr int TILE = BN * D * 2;         // bytes of one k or v tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = dmn::smem_u32(smem);
  const uint32_t ring = qs + BM * D * 2;  // stage i: k tile at ring + 2 i TILE, v tile after it

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int b = blockIdx.y / H, hh = blockIdx.y % H;

  // Copies are committed in groups: q, then one group per k/v tile, STAGES - 1
  // tiles ahead of the one being multiplied (an empty group past the last
  // tile keeps the count uniform).
  const int tiles = (N + BN - 1) / BN;
  TileCopy<D, BN, MMA_THREADS> kcopy(k + b * sk.b + hh * sk.h, sk.n, 0);
  TileCopy<D, BN, MMA_THREADS> vcopy(v + b * sv.b + hh * sv.h, sv.n, 0);
  auto load_kv = [&](int j, int stage) {
    if (j < tiles) {
      kcopy.next(ring + stage * 2 * TILE, N);
      vcopy.next(ring + stage * 2 * TILE + TILE, N);
    }
    dmn::cp_async_commit();
  };
  TileCopy<D, BM, MMA_THREADS>(q + b * sq.b + hh * sq.h, sq.n, m0).next(qs, N);
  dmn::cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) load_kv(j, j);

  uint32_t qf[MT][KT][4];
  float o[MT][DT][4], mx[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mx[mt][0] = mx[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;
  }

  // The q tile has landed (the k/v tiles may still be in flight): this
  // warp's q fragments go to registers for the whole walk over the keys.
  dmn::cp_async_wait<STAGES - 1>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      dmn::ldmatrix_x4(qf[mt][kk], qs + tile_offset<D>((warp * MT + mt) * 16 + (lane & 15),
                                                       kk * 2 + (lane >> 4)));

  int stage = 0;  // of tile j; tile j + STAGES - 1 goes into the stage before it
  auto tile_step = [&](int j, auto masked) {
    // Tile j has landed for every thread, and every thread is done with
    // tile j - 1, whose stage the next copy overwrites.
    dmn::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_kv(j + STAGES - 1, stage == 0 ? STAGES - 1 : stage - 1);
    const uint32_t kt = ring + stage * 2 * TILE, vt = kt + TILE;
    stage = stage == STAGES - 1 ? 0 : stage + 1;

    // S = q k^T for this warp's rows and the tile's 64 keys.
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];  // keys np*16 .. +15: (b0, b1) of tile 2np, then of 2np + 1
        dmn::ldmatrix_x4(bk, kt + tile_offset<D>(np * 16 + (lane >> 4) * 8 + (lane & 7),
                                                 kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dmn::mma_bf16(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
          dmn::mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
        }
      }
    if constexpr (decltype(masked)::value) mask_keys(s, j * BN, N, t);
    float f[MT][2];
    softmax_step(s, mx, l, f);
    rescale(o, f);

    // O += P v, P rounded to bf16 in registers as the A fragments.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pack_p(pa[mt], s[mt], kk);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];  // keys kk*16 .. +15: (b0, b1) of d tile 2dp, then of 2dp + 1
        dmn::ldmatrix_x4_trans(bv, vt + tile_offset<D>(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                       dp * 2 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dmn::mma_bf16(o[mt][2 * dp], pa[mt], bv[0], bv[1]);
          dmn::mma_bf16(o[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  };
  const int whole = N / BN;  // only a ragged last tile pays for the mask
  for (int j = 0; j < whole; ++j) tile_step(j, Whole{});
  if (whole < tiles) tile_step(whole, Masked{});

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<D>(out, o[mt], l[mt], m0 + (warp * MT + mt) * 16, b, hh, N, H, g, t);
}

template <int D, int MT, int STAGES>
int launch_mma(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
               Strides sv, int B, int N, int H, cudaStream_t stream) {
  constexpr int BM = MMA_WARPS * 16 * MT;
  constexpr size_t smem = mma_smem_bytes<D, MT, STAGES>();
  auto kernel = attn_mma_kernel<D, MT, STAGES>;
  const cudaError_t err = dmn::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + BM - 1) / BM, B * H), MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, sv, N, H);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- d = 64: warpgroup form (wgmma), fed by TMA --
constexpr int WG_THREADS = 256;  // two warpgroups
constexpr int WG_BM = 128;       // of 64 query rows each
constexpr int WG_STAGES = 4;
constexpr int WG_TILE = BN * 64 * 2;  // bytes of one k or v tile
// q tile, stages of (k, v), then the barriers: full[4], empty[4], q.
constexpr size_t WG_SMEM = size_t(WG_BM) * 64 * 2 + WG_STAGES * 2 * WG_TILE + 8 * (2 * WG_STAGES + 1);

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: its address is asked of the
// runtime once, so the library links no stub of it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [B, N, H, 64] bf16 tensor read through its strides as the 4-D map
// (d, h, n, b): boxes of `rows` tokens of one head, written to shared memory
// in the 128-byte swizzle, rows past N as zeros. Encoded on the host at every
// launch (the addresses change); it is a few hundred nanoseconds.
int make_map(CUtensorMap* map, const void* base, Strides s, int B, int N, int H, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {64, cuuint64_t(H), cuuint64_t(N), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(s.h) * 2, cuuint64_t(s.n) * 2, cuuint64_t(s.b) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

__global__ void __launch_bounds__(WG_THREADS, 2)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, int N,
                  int H) {
  constexpr int D = 64;
  constexpr int KT = D / 16;
  constexpr int NT = BN / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(1024) unsigned char smem_wg[];  // the swizzle repeats every 1024 B
  const uint32_t qs = dmn::smem_u32(smem_wg);
  const uint32_t ring = qs + WG_BM * D * 2;  // stage i: k tile at ring + 2 i WG_TILE, v tile after it
  const uint32_t bars = ring + WG_STAGES * 2 * WG_TILE;
  auto full = [&](int i) { return bars + 8 * i; };                // the stage's copies have landed
  auto empty = [&](int i) { return bars + 8 * (WG_STAGES + i); };  // both warpgroups are done with it
  const uint32_t qbar = bars + 8 * 2 * WG_STAGES;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;  // warps 0-3 and 4-7: the warpgroups
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * WG_BM;
  const int b = blockIdx.y / H, hh = blockIdx.y % H;
  const int tiles = (N + BN - 1) / BN;
  const bool copier = threadIdx.x == 0;  // the one thread that asks for copies

  if (copier) {
    for (int i = 0; i < WG_STAGES; ++i) {
      dmn::mbar_init(full(i), 1);
      dmn::mbar_init(empty(i), WG_THREADS / 128);
    }
    dmn::mbar_init(qbar, 1);
    dmn::mbar_init_fence();
  }
  __syncthreads();
  // Tile j lives in stage j % 4; j / 4, the stage's use number, gives the
  // parity its barriers are waited with. A copy into a used stage first
  // waits until both warpgroups have released the tile it held.
  auto load_kv = [&](int j) {
    if (j >= tiles) return;
    const int st = j % WG_STAGES, use = j / WG_STAGES;
    if (use > 0) dmn::mbar_wait(empty(st), (use - 1) & 1);
    dmn::mbar_arrive_expect(full(st), 2 * WG_TILE);
    dmn::tma_load_4d(ring + st * 2 * WG_TILE, &kmap, full(st), 0, hh, j * BN, b);
    dmn::tma_load_4d(ring + st * 2 * WG_TILE + WG_TILE, &vmap, full(st), 0, hh, j * BN, b);
  };
  auto wait_tile = [&](int j) { dmn::mbar_wait(full(j % WG_STAGES), (j / WG_STAGES) & 1); };
  if (copier) {
    dmn::mbar_arrive_expect(qbar, WG_BM * D * 2);
    dmn::tma_load_4d(qs, &qmap, qbar, 0, hh, m0, b);
    load_kv(0);
    load_kv(1);
  }
  __syncwarp();

  float s[1][NT][4], o[1][DT][4], mx[1][2], l[1][2], f[1][2];
  uint32_t pa[BN / 16][4];
  mx[0][0] = mx[0][1] = -INFINITY;
  l[0][0] = l[0][1] = 0.f;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[0][dt][e] = 0.f;
  // This warp's rows of q, as ldmatrix addresses: the fragments are loaded
  // anew for every key tile. Held in registers across the loop they are
  // lost: ptxas (CUDA 12.8) gives the A registers of the P v product the same
  // registers, as if an A operand's life ended at its first wgmma.
  uint32_t qaddr[KT];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    qaddr[kk] = qs + tile_offset<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4));

  // Start S = q k_j^T (this warpgroup's 64 rows by tile j's 64 keys) as one
  // wgmma group; it completes asynchronously.
  auto start_scores = [&](int j) {
    const uint64_t kdesc = dmn::wgmma_desc_sw128(ring + (j % WG_STAGES) * 2 * WG_TILE);
    uint32_t qa[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) dmn::ldmatrix_x4(qa[kk], qaddr[kk]);
    dmn::wgmma_fence_regs(s[0]);
    dmn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)  // a k16 step is 32 bytes along the row: 2 in the descriptor
      dmn::wgmma_m64n64k16<0>(s[0], qa[kk], kdesc + kk * 2, kk > 0);
    dmn::wgmma_commit();
  };
  // Start O += P v_j as one wgmma group: P from registers, the v tile as the
  // MN-major B operand.
  auto start_values = [&](int j) {
    const uint64_t vdesc = dmn::wgmma_desc_sw128(ring + (j % WG_STAGES) * 2 * WG_TILE + WG_TILE);
    dmn::wgmma_fence_regs(o[0]);
    dmn::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // a k16 step is 16 rows of 128 bytes: 128 in the descriptor
      dmn::wgmma_m64n64k16<1>(o[0], pa[kk], vdesc + kk * 128, 1);
    dmn::wgmma_commit();
  };
  auto pack_probabilities = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pack_p(pa[kk], s[0], kk);
  };

  // A wgmma group's round trip (the start, the tensor cores, the wait) is long
  // against the arithmetic of one tile, so the two products of a step are in
  // flight while the softmax of the next tile runs: step j starts
  // S_{j+1} = q k_{j+1}^T and O += P_j v_j, takes the softmax of S_{j+1} as
  // soon as that group is done (the running max, P_{j+1}, the row sum), and
  // only then waits for O, releases tile j's stage and brings O to the new max.
  dmn::mbar_wait(qbar, 0);
  wait_tile(0);
  start_scores(0);
  dmn::wgmma_wait<0>();
  dmn::wgmma_fence_regs(s[0]);
  if (tiles == 1 && N % BN) mask_keys(s, 0, N, t);
  softmax_step(s, mx, l, f);  // o is zero: nothing to rescale
  pack_probabilities();
  auto tile_step = [&](int j, auto masked) {  // v of tile j, k of tile j + 1
    if (copier) load_kv(j + 2);  // into the stage of tile j - 2
    __syncwarp();
    wait_tile(j + 1);
    start_scores(j + 1);
    start_values(j);
    dmn::wgmma_wait<1>();  // S_{j+1}
    dmn::wgmma_fence_regs(s[0]);
    if constexpr (decltype(masked)::value) mask_keys(s, (j + 1) * BN, N, t);
    softmax_step(s, mx, l, f);
    dmn::wgmma_wait<0>();  // O, and P_j's registers are free again
    dmn::wgmma_fence_regs(o[0]);
    if ((warp & 3) == 0 && lane == 0) dmn::mbar_arrive(empty(j % WG_STAGES));
    rescale(o, f);
    pack_probabilities();
  };
  const int whole = N / BN;  // only a ragged last tile pays for the mask
  for (int j = 0; j + 1 < whole; ++j) tile_step(j, Whole{});
  if (whole < tiles && tiles > 1) tile_step(tiles - 2, Masked{});
  start_values(tiles - 1);
  dmn::wgmma_wait<0>();
  dmn::wgmma_fence_regs(o[0]);

  store_rows<D>(out, o[0], l[0], m0 + warp * 16, b, hh, N, H, g, t);
}

int launch_wgmma(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
                 Strides sv, int B, int N, int H, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int rc = make_map(&qmap, q, sq, B, N, H, WG_BM);
  if (!rc) rc = make_map(&kmap, k, sk, B, N, H, BN);
  if (!rc) rc = make_map(&vmap, v, sv, B, N, H, BN);
  if (rc) return rc;
  const cudaError_t err = dmn::set_smem((const void*)attn_wgmma_kernel, WG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_wgmma_kernel<<<dim3((N + WG_BM - 1) / WG_BM, B * H), WG_THREADS, WG_SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), N, H);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ float32, CUDA cores --
// One block per (64-query tile, sample * head): the q tile (transposed) and
// 64-token k/v tiles in shared memory as f32, an online softmax, the output
// accumulator in registers. 256 threads as 16 x 16: thread (ty, tx) owns
// queries 4ty..4ty+3, scores for keys tx + 16j of each tile, and output
// columns tx*D/16 .. of its queries; the probabilities pass through shared
// memory (transposed) from the score layout to the p.v layout.
constexpr int BM = 64;        // queries per block
constexpr int THREADS = 256;  // 16 x 16
constexpr int QP = BM + 4;    // padded row of the transposed q and p tiles

template <int D>
constexpr size_t smem_floats() {
  return size_t(D) * QP + size_t(BN) * (D + 1) + size_t(BN) * D + size_t(BN) * QP;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, Strides sq, Strides sk,
                Strides sv, int N, int H) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KP = D + 1;   // padded k row: lanes tx read distinct banks
  constexpr int DP = D / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem_f[];
  float* qt = smem_f;          // [D][QP]  q tile, transposed
  float* ks = qt + D * QP;     // [BN][KP] k tile
  float* vs = ks + BN * KP;    // [BN][D]  v tile
  float* pt = vs + BN * D;     // [BN][QP] probabilities, transposed

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.x * BM;
  const int b = blockIdx.y / H, hh = blockIdx.y % H;
  const float* qb = q + b * sq.b + hh * sq.h;
  const float* kb = k + b * sk.b + hh * sk.h;
  const float* vb = v + b * sv.b + hh * sv.h;

  // q tile, scaled by log2(e) so the softmax runs on exp2.
  for (int i = threadIdx.x; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D, n = m0 + r;
    qt[d * QP + r] = n < N ? qb[n * sq.n + d] * LOG2E : 0.f;
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
      ks[r * KP + d] = in ? kb[n * sk.n + d] : 0.f;
      vs[r * D + d] = in ? vb[n * sv.n + d] : 0.f;
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
    float* orow = out + ((size_t(b) * N + n) * H + hh) * D + tx * DP;
#pragma unroll
    for (int c = 0; c < DP; ++c) orow[c] = o[i][c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
               Strides sv, int B, int N, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = attn_f32_kernel<D>;
  const cudaError_t err = dmn::set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((N + BM - 1) / BM, B * H), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, sv, N, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_attn)

// q, k, v [B, N, H, D] (f32 or bf16 by `bf16`, unit stride along D, the
// other strides in elements) -> out [B, N, H, D] contiguous, same dtype.
// D is 32, 64 or 128; B * H <= 65535. In bf16 every base pointer and every
// row (the strides times two bytes) is 16-byte aligned.
DMN_EXPORT int dmn_attention(const void* q, const void* k, const void* v, void* out,
                             long long qsb, long long qsn, long long qsh, long long ksb,
                             long long ksn, long long ksh, long long vsb, long long vsn,
                             long long vsh, int B, int N, int H, int D, int bf16,
                             void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh};
  if (bf16) {
    switch (D) {
      case 32: return launch_mma<32, 2, 4>(q, k, v, out, sq, sk, sv, B, N, H, stream);
      case 64: return launch_wgmma(q, k, v, out, sq, sk, sv, B, N, H, stream);
      case 128: return launch_mma<128, 1, 3>(q, k, v, out, sq, sk, sv, B, N, H, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    case 32: return launch_f32<32>(q, k, v, out, sq, sk, sv, B, N, H, stream);
    case 64: return launch_f32<64>(q, k, v, out, sq, sk, sv, B, N, H, stream);
    case 128: return launch_f32<128>(q, k, v, out, sq, sk, sv, B, N, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
