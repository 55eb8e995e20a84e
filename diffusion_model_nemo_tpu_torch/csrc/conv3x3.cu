// SAME 3x3 convolution + bias on NHWC tensors, f32 accumulation, output in
// x's dtype (float or bf16).
//
// Replaces TPU kernel diffusion_model_nemo_tpu/ops/conv.py:_tap_split_kernel
// (launcher _pallas_conv3x3). That kernel split the nine taps between the
// contraction and the output dimensions (one [M, 3C] x [3C, 3F] GEMM, then
// three shifted adds) so that a 32-channel conv would fill more of the TPU's
// 128-lane matrix unit. The split is a TPU layout device and is not carried
// over: every MAC runs once either way.
//
// What bounds it on the H100: 2 * B*H*W * 9 * C * F operations against x, w
// and y read or written once. At the microbenchmark's shapes that is bytes
// at C, F <= 64 and operations (bf16 tensor cores) at C = F = 128.
//
// bf16: an implicit GEMM on the tensor cores,
//   Y[m, f] = sum over (tap, c) of X[pixel(m) + offset(tap), c] * W[tap, c, f],
// with M = B*H*W output pixels and K = 9*C, in the K order (chunk of 32 input
// channels, tap, channel). One block owns 128 output pixels as whole image
// rows (TH = 128 / W rows of one sample) and NT output channels (32 in the
// mma.sync form; 64 or 128 in the wgmma form, so there a band of x is staged
// once per block, not F/32 times).
//   * Per chunk of 32 input channels the (TH+2) x (W+2) band, halo included,
//     comes into shared memory by 16-byte cp.async; a pixel outside the image
//     or a channel past C is zero-filled by the copy itself (SAME padding and
//     C % 32 with no branch in the MMA loop). A staged pixel takes 80 bytes
//     (32 bf16 + 16 bytes of padding), so the eight rows of an ldmatrix phase
//     fall on distinct banks.
//   * The A operand comes by ldmatrix.x4 with each lane pointing at its own
//     output pixel shifted by the tap: a tap is an address offset, with no
//     im2col buffer.
//   * The B operand is the weight, repacked once per parameter version by
//     the wrapper into the layout its instruction reads.
//   * Band and weights of the next chunk are in flight (two-stage cp.async
//     ring) while the tensor cores work on this one.
//   * The epilogue adds the bias in f32, rounds to bf16, stages the tile in
//     shared memory and writes NHWC with 16-byte stores: the band's pixels
//     are contiguous in y.
// Two forms of the product (ops/conv.py:conv3x3_route picks one by F):
//   conv3x3_wgmma_kernel, F >= 64: two warpgroups of 64 pixels x NT = 64 or
//     128 channels, one wgmma.m64nNTk16 a k16 step, A from registers, B
//     K-major in the 128-byte swizzle from shared memory
//     (ops/conv.py:pack_conv3x3_weights_wgmma).
//   conv3x3_mma_kernel, F < 64: 8 warps of mma.sync.m16n8k16, each 16 pixels
//     x all NT = 32 channels of the block's tile, B in mma.m16n8k16 fragment
//     order (ops/conv.py:pack_conv3x3_weights, [chunk * 9 + tap][F'/8][32
//     lanes][8]: a lane's B fragments for two k16 steps of one n8 tile are
//     one 16-byte load).
// float32: conv3x3_f32_kernel, the direct form on CUDA cores (f32 FMAs; the
//   tensor cores' float32 input is TF32, which would not hold the 1e-4
//   float32 tolerance). One block per (band of <= 128 output pixels, 32
//   output channels, sample); per chunk of 32 input channels it stages the
//   band as [CC][TH+2][W+2] f32 and the chunk's weights as [9][CC][FT].

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CC = 32;    // input channels per chunk: one k32 slice per tap
constexpr int PIX = 128;  // output pixels per block, at most

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------------ bf16 --
constexpr int PIX_BYTES = CC * 2 + 16;  // one staged pixel: 32 bf16 + 16 bytes of padding
constexpr int KSTEPS = 9 * CC / 16;     // k16 steps a chunk: (tap, half of the 32 channels)

__host__ __device__ inline int band_bytes(int TH, int W) {
  return (((TH + 2) * (W + 2) * PIX_BYTES) + 127) / 128 * 128;
}

// Chunk c0 .. c0 + 31 of the (TH+2) x (W+2) band of sample b that starts at
// image row r0 - 1, into shared memory at `band` (PIX_BYTES a pixel); pixels
// outside the image and channels past C are zeros.
__device__ __forceinline__ void stage_band(const __nv_bfloat16* __restrict__ x, uint32_t band,
                                           unsigned char* band_ptr, int b, int r0, int c0, int H,
                                           int W, int C, int TH, int vec) {
  const int SW = W + 2, npix = (TH + 2) * SW;
  const __nv_bfloat16* xb = x + size_t(b) * H * W * C;
  if (vec) {  // C % 8 == 0 and x 16-byte aligned: 16-byte copies, zero-filled outside
    for (int i = threadIdx.x; i < npix * 4; i += THREADS) {
      const int piece = i & 3, pix = i >> 2;
      const int sr = pix / SW, sc = pix - sr * SW;
      const int gr = r0 - 1 + sr, gc = sc - 1, c = c0 + piece * 8;
      const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W && c < C;
      const __nv_bfloat16* src = ok ? xb + (size_t(gr) * W + gc) * C + c : x;
      dmn::cp_async16(band + pix * PIX_BYTES + piece * 16, src, ok);
    }
  } else {  // any C: element by element, synchronously
    for (int i = threadIdx.x; i < npix * CC; i += THREADS) {
      const int c = i % CC, pix = i / CC;
      const int sr = pix / SW, sc = pix - sr * SW;
      const int gr = r0 - 1 + sr, gc = sc - 1;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && c0 + c < C)
        v = xb[(size_t(gr) * W + gc) * C + c0 + c];
      reinterpret_cast<__nv_bfloat16*>(band_ptr + pix * PIX_BYTES)[c] = v;
    }
  }
}

// This lane's ldmatrix row address, relative to the band, for the m16 tile
// `tile` of the block's pixels: pixel tile * 16 + (lane / 8 % 2) * 8 + lane % 8,
// channels (lane / 16) * 8 .. + 7 of a k16 step.
__device__ __forceinline__ uint32_t a_row(int tile, int lane, int TH, int W) {
  const int p = tile * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const bool in = p < TH * W;
  const int r = in ? p / W : 0, c = in ? p % W : 0;
  return (r * (W + 2) + c) * PIX_BYTES + (lane >> 4) * 16;
}

// The band offset of k16 step `step` (tap step / 2, channels 16 (step % 2) ..).
__device__ __forceinline__ uint32_t a_step(int step, int W) {
  const int tap = step >> 1;
  return ((tap / 3) * (W + 2) + tap % 3) * PIX_BYTES + (step & 1) * 32;
}

// The epilogue of both bf16 kernels: the block's [PIX][NT] tile, + bias,
// staged as bf16 in shared memory `out` ([PIX][NT + 8], rows 16 bytes apart
// mod 128), to NHWC y with 16-byte stores (the band's pixels are contiguous
// in y). The caller has written `out` and synchronised.
template <int NT>
__device__ __forceinline__ void store_tile(const __nv_bfloat16* out, __nv_bfloat16* __restrict__ y,
                                           int b, int r0, int ft, int H, int W, int F, int TH) {
  constexpr int OS = NT + 8, N8 = NT / 8;
  const int npix = min(TH, H - r0) * W;
  __nv_bfloat16* yb = y + (size_t(b) * H + r0) * W * F + ft * NT;
  const int fn = min(NT, F - ft * NT);
  if ((F & 7) == 0) {
    for (int i = threadIdx.x; i < npix * N8; i += THREADS) {
      const int p = i / N8, q = i % N8;
      if (q * 8 < fn)
        *reinterpret_cast<uint4*>(yb + size_t(p) * F + q * 8) =
            *reinterpret_cast<const uint4*>(out + p * OS + q * 8);
    }
  } else {
    for (int i = threadIdx.x; i < npix * NT; i += THREADS) {
      const int p = i / NT, f = i % NT;
      if (f < fn) yb[size_t(p) * F + f] = out[p * OS + f];
    }
  }
}

// One C fragment pair (rows g, g + 8 of m16 tile `tile`, columns f, f + 1 of
// the block's tile) + bias into the staged output tile.
__device__ __forceinline__ void put_c(__nv_bfloat16* out, int OS, int tile, int g, int f,
                                      const float (&c)[4], float b0, float b1) {
  const int p = tile * 16 + g;
  *reinterpret_cast<__nv_bfloat162*>(out + p * OS + f) = __floats2bfloat162_rn(c[0] + b0, c[1] + b1);
  *reinterpret_cast<__nv_bfloat162*>(out + (p + 8) * OS + f) =
      __floats2bfloat162_rn(c[2] + b0, c[3] + b1);
}

__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* bias, int fg, int F) {
  return make_float2(bias && fg < F ? __bfloat162float(bias[fg]) : 0.f,
                     bias && fg + 1 < F ? __bfloat162float(bias[fg + 1]) : 0.f);
}

// --- mma.sync form (F < 64) ---
constexpr int MMA_NT = 32;                          // output channels per block
constexpr int MMA_N8 = MMA_NT / 8;                  // n8 tiles per block
constexpr int MMA_W_BYTES = 9 * MMA_NT * CC * 2;  // a chunk's weights for MMA_NT channels

__device__ __forceinline__ void lds128(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__global__ void __launch_bounds__(THREADS)
conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x,  // [B][H][W][C]
                   const uint4* __restrict__ wp,          // [C'/32 * 9][F'/8][32][8] bf16
                   const __nv_bfloat16* __restrict__ bias,  // [F] or null
                   __nv_bfloat16* __restrict__ y,           // [B][H][W][F]
                   int H, int W, int C, int F, int TH, int stages, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bbytes = band_bytes(TH, W);
  const int sbytes = bbytes + MMA_W_BYTES;
  const int ft = blockIdx.x, r0 = blockIdx.y * TH, b = blockIdx.z;
  const int f8 = gridDim.x * MMA_N8;  // n8 tiles of the padded F'
  const int nchunks = ceil_div(C, CC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;  // warp: m16 tile of the pixels
  const uint32_t smem0 = dmn::smem_u32(smem);

  // Chunk `chunk` of band and weights into stage `s`.
  auto stage = [&](int chunk, int s) {
    const uint32_t band = smem0 + s * sbytes;
    stage_band(x, band, smem + s * sbytes, b, r0, chunk * CC, H, W, C, TH, vec);
    const uint32_t wsm = band + bbytes;
    for (int i = threadIdx.x; i < 9 * MMA_N8 * 32; i += THREADS) {
      const int ln = i & 31, j = (i >> 5) % MMA_N8, tap = (i >> 5) / MMA_N8;
      const uint4* src = wp + (size_t(chunk * 9 + tap) * f8 + ft * MMA_N8 + j) * 32 + ln;
      dmn::cp_async16(wsm + i * 16, src, true);
    }
  };

  const uint32_t a_off = a_row(warp, lane, TH, W);
  float acc[MMA_N8][4];
#pragma unroll
  for (int j = 0; j < MMA_N8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  stage(0, 0);
  dmn::cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(k + 1, (k + 1) % stages);
    dmn::cp_async_commit();
    dmn::cp_async_wait<1>();
    __syncthreads();  // chunk k has landed for every thread
    const uint32_t band = smem0 + (k % stages) * sbytes;
    const uint32_t wsm = band + bbytes + lane * 16;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t bf[MMA_N8][4];  // per n8 tile: b0, b1 of k16 step 0, then of step 1
#pragma unroll
      for (int j = 0; j < MMA_N8; ++j) lds128(bf[j], wsm + (tap * MMA_N8 + j) * 512);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
        dmn::ldmatrix_x4(a, band + a_off + a_step(2 * tap + ks, W));
#pragma unroll
        for (int j = 0; j < MMA_N8; ++j) dmn::mma_bf16(acc[j], a, bf[j][2 * ks], bf[j][2 * ks + 1]);
      }
    }
    __syncthreads();  // stage k % stages may be refilled
  }

  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MMA_N8; ++j) {
    const int f = j * 8 + 2 * t;
    const float2 bb = bias_pair(bias, ft * MMA_NT + f, F);
    put_c(out, MMA_NT + 8, warp, g, f, acc[j], bb.x, bb.y);
  }
  __syncthreads();
  store_tile<MMA_NT>(out, y, b, r0, ft, H, W, F, TH);
}

int conv3x3_mma(const void* x, const void* wp, const void* bias, void* y, int B, int H, int W,
                int C, int F, cudaStream_t stream) {
  const int TH = max(1, PIX / W);
  const int stages = C > CC ? 2 : 1;
  const size_t smem = max(size_t(stages) * (band_bytes(TH, W) + MMA_W_BYTES),
                          size_t(PIX) * (MMA_NT + 8) * 2);
  const cudaError_t err = dmn::set_smem((const void*)conv3x3_mma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  conv3x3_mma_kernel<<<dim3(ceil_div(F, MMA_NT), ceil_div(H, TH), B), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wp),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), H, W, C, F, TH,
      stages, vec);
  return static_cast<int>(cudaGetLastError());
}

// --- wgmma form (F >= 64) ---
// Two warpgroups of 64 output pixels each (warp w owns m16 tile w, as in the
// mma form) x all NT = 64 or 128 channels of the block's tile: per k16 step
// one wgmma.m64nNTk16 per warpgroup, A (the band, shifted by the tap) from
// registers by ldmatrix, B from shared memory through a descriptor. The B
// operand of a chunk is K-major in the 128-byte swizzle, repacked once per
// parameter version (ops/conv.py:pack_conv3x3_weights_wgmma): 5 atoms of 64
// k (taps 2a and 2a + 1; the last atom's second half is zeros and never
// read) x NT rows (output channels) x 128 bytes, 16-byte pieces XOR row % 8.
// A stage holds that (1024-byte aligned) and then the band.
constexpr int KATOMS = 5;

template <int NT>
__device__ __forceinline__ void wgmma_step(float (&d)[NT / 8][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (NT == 128) dmn::wgmma_m64n128k16<0>(d, a, desc, 1);
  else dmn::wgmma_m64n64k16<0>(d, a, desc, 1);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, NT == 64 ? 2 : 1)
conv3x3_wgmma_kernel(const __nv_bfloat16* __restrict__ x,    // [B][H][W][C]
                     const uint4* __restrict__ wp,            // [C'/32][F'/NT][5][NT][64] bf16, swizzled
                     const __nv_bfloat16* __restrict__ bias,  // [F] or null
                     __nv_bfloat16* __restrict__ y,           // [B][H][W][F]
                     int H, int W, int C, int F, int TH, int vec) {
  constexpr int W_BYTES = KATOMS * NT * 128;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int sbytes = (W_BYTES + band_bytes(TH, W) + 1023) / 1024 * 1024;
  const int ft = blockIdx.x, r0 = blockIdx.y * TH, b = blockIdx.z;
  const int nchunks = ceil_div(C, CC);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t smem0 = dmn::smem_u32(smem);

  // Chunk `chunk` of weights and band into stage `s`.
  auto stage = [&](int chunk, int s) {
    const uint32_t wsm = smem0 + s * sbytes;
    const uint4* src = wp + (size_t(chunk) * gridDim.x + ft) * (W_BYTES / 16);
    for (int i = threadIdx.x; i < W_BYTES / 16; i += THREADS) dmn::cp_async16(wsm + i * 16, src + i, true);
    stage_band(x, wsm + W_BYTES, smem + s * sbytes + W_BYTES, b, r0, chunk * CC, H, W, C, TH, vec);
  };

  const uint32_t a_off = a_row(warp, lane, TH, W);
  float acc[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  stage(0, 0);
  dmn::cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(k + 1, (k + 1) & 1);
    dmn::cp_async_commit();
    dmn::cp_async_wait<1>();
    dmn::fence_proxy_async();  // the copies are read by wgmma
    __syncthreads();           // chunk k has landed for every thread
    const uint32_t wsm = smem0 + (k & 1) * sbytes, band = wsm + W_BYTES + a_off;
    // Two wgmma groups of 9 k16 steps; the second group's A fragments are
    // loaded while the first runs. Each fragment feeds one instruction.
    uint32_t af[KSTEPS][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int s = 9 * half; s < 9 * half + 9; ++s) dmn::ldmatrix_x4(af[s], band + a_step(s, W));
      dmn::wgmma_fence_regs(acc);
      dmn::wgmma_fence();
#pragma unroll
      for (int s = 9 * half; s < 9 * half + 9; ++s)  // atom s / 4, k offset 32 bytes a step in it
        wgmma_step<NT>(acc, af[s], dmn::wgmma_desc_sw128(wsm + (s >> 2) * NT * 128) + (s & 3) * 2);
      dmn::wgmma_commit();
    }
    dmn::wgmma_wait<0>();
    dmn::wgmma_fence_regs(acc);
    __syncthreads();  // stage k & 1 may be refilled
  }

  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int f = j * 8 + 2 * t;
    const float2 bb = bias_pair(bias, ft * NT + f, F);
    put_c(out, NT + 8, warp, g, f, acc[j], bb.x, bb.y);
  }
  __syncthreads();
  store_tile<NT>(out, y, b, r0, ft, H, W, F, TH);
}

template <int NT>
int conv3x3_wgmma(const void* x, const void* wp, const void* bias, void* y, int B, int H, int W,
                  int C, int F, cudaStream_t stream) {
  const int TH = max(1, PIX / W);
  const size_t sbytes = (size_t(KATOMS) * NT * 128 + band_bytes(TH, W) + 1023) / 1024 * 1024;
  const size_t smem = max(2 * sbytes, size_t(PIX) * (NT + 8) * 2);
  const cudaError_t err = dmn::set_smem((const void*)conv3x3_wgmma_kernel<NT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  conv3x3_wgmma_kernel<NT><<<dim3(ceil_div(F, NT), ceil_div(H, TH), B), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wp),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), H, W, C, F, TH, vec);
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------- float32 --
constexpr int FT = 32;                    // output channels per block
constexpr int FGROUPS = FT / 4;           // threads across the channel tile
constexpr int SLOTS = THREADS / FGROUPS;  // 32 pixel slots
constexpr int PPT = PIX / SLOTS;          // 4 pixels per thread

__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ x,     // [B][H][W][C]
                   const float* __restrict__ w,     // [3][3][C][F]
                   const float* __restrict__ bias,  // [F] or null
                   float* __restrict__ y,           // [B][H][W][F]
                   int H, int W, int C, int F, int TH) {
  extern __shared__ float fsmem[];
  const int SW = W + 2, SR = TH + 2;
  float* xs = fsmem;                // [CC][SR][SW]
  float* ws = xs + CC * SR * SW;    // [9][CC][FT]; CC*SR*SW is a multiple of 4 floats
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
        v = x[((size_t(b) * H + gr) * W + gc) * C + c0 + c];
      xs[(c * SR + sr) * SW + sc] = v;
    }
    for (int i = threadIdx.x; i < 9 * CC * FT; i += THREADS) {
      const int f = i % FT, c = (i / FT) % CC, tap = i / (FT * CC);
      float v = 0.f;
      if (c0 + c < C && f0 + f < F) v = w[(size_t(tap) * C + c0 + c) * F + f0 + f];
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
    float* yp = y + ((size_t(b) * H + r0 + orow[k]) * W + ocol[k]) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + 4 * fg + j;
      if (f < F) yp[f] = acc[k][j] + (bias ? bias[f] : 0.f);
    }
  }
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_conv)

// bf16: x [B,H,W,C], wp = the weights as ops/conv.py:conv3x3_route picks
// them (route 1: pack_conv3x3_weights_wgmma for an output tile of nt = 64 or
// 128 channels, F >= 64; route 0: pack_conv3x3_weights, fragment order, nt =
// 32), bias [F] (or null), y [B,H,W,F]. W <= 128 (a block holds at most 128
// output pixels as whole rows).
DMN_EXPORT int dmn_conv3x3_bf16(const void* x, const void* wp, const void* bias, void* y, int B,
                                int H, int W, int C, int F, int route, int nt, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (route == 1 && nt == 64) return conv3x3_wgmma<64>(x, wp, bias, y, B, H, W, C, F, stream);
  if (route == 1 && nt == 128) return conv3x3_wgmma<128>(x, wp, bias, y, B, H, W, C, F, stream);
  if (route == 0 && nt == MMA_NT) return conv3x3_mma(x, wp, bias, y, B, H, W, C, F, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// float32: x [B,H,W,C], w [3,3,C,F], bias [F] (or null), y [B,H,W,F]; W <= 128.
DMN_EXPORT int dmn_conv3x3_f32(const void* x, const void* w, const void* bias, void* y, int B,
                               int H, int W, int C, int F, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int TH = max(1, PIX / W);
  const size_t smem = sizeof(float) * (size_t(CC) * (TH + 2) * (W + 2) + 9 * CC * FT);
  const cudaError_t err = dmn::set_smem((const void*)conv3x3_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_f32_kernel<<<dim3(ceil_div(H, TH), ceil_div(F, FT), B), THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(y), H, W, C, F, TH);
  return static_cast<int>(cudaGetLastError());
}
