// GroupNorm (+ FiLM) + SiLU over [B, HW, C] (channels last): one read of a
// sample, one launch a call.
//
// Replaces two TPU kernels of diffusion_model_nemo_tpu/ops/norm.py (launcher
// _pallas_forward):
//   * _kernel (no FiLM): per (sample, group) f32 statistics in the one-pass
//     form E[x^2] - E[x]^2 clipped at 0 (_group_stats: per-channel sums over
//     the pixels, then the C/G channels of each group), then (x - mean) *
//     rstd * gamma + beta and SiLU, cast back to the input type.
//   * _kernel_film: the same, with y * (scale + 1) + shift before the SiLU.
//     The TPU launcher broadcast scale and shift to x's full shape and
//     streamed both; here they are read in place through a (sample, pixel)
//     stride pair, so a per-sample [B,1,1,C] FiLM (pixel strides 0) costs no
//     copy and is folded into the per-channel coefficients, and a full
//     [B,H,W,C] map (strides (HW*C, C)) is read per element. They may be f32
//     or x's type; the arithmetic is f32 either way.
// The TPU kernel held one sample's [HW, C] block in VMEM: one read of x, one
// write of y.
//
// What bounds it on the H100: bytes (~11 flops per element against 4-8
// bytes). A sample's [HW, C] slab is contiguous in NHWC. Design:
//   - A cluster of `cluster` CTAs holds one sample, CTA r owning the pixels
//     [r * pixels, (r + 1) * pixels). The plan (ops/norm.py:group_norm_plan)
//     splits only slabs above 32 KB: on the H100 a cluster launch costs more
//     than the SMs it fills beyond two CTAs (tools/check_conv_norm.py times
//     the [64, 32, 32, 32] site with a sample over 1, 2, 4 and 8 CTAs).
//   - Form: the CTA's share is read from device memory once, into
//     registers where a thread
//     holds at most KREG pieces (all but unet_small's two largest sites;
//     more pieces, or 512 threads a CTA, spill past 128 registers), else into
//     shared memory by cp.async, all in flight at once. Where it
//     fits neither (e.g. bf16 [1, 128, 128, 128], 4 MB a sample) the
//     statistics pass streams the share from device memory and the output
//     pass reads it again (from L2).
//   - Each thread owns one piece column (V consecutive channels, 16 bytes)
//     and a fixed set of pixels, and sums its V channels over them; the
//     partials go to per-channel sums in a fixed order (group_norm.cuh).
//   - The cluster's per-channel sums are added through distributed shared
//     memory in rank order, then the C/G channels of each group by a fixed
//     shuffle tree, a warp a group: every CTA, and every run, gets the same
//     bits.
//   - y = x * a + b (a = rstd * gamma, b = beta - mean * a, per channel; a
//     per-sample FiLM folded in), SiLU, 16-byte stores.
//   - What is left at the small sites (a few KB a sample) is a chain of
//     latencies, not bytes: gamma, beta and the FiLM are fetched while the
//     share is in flight, each reduction is one step, and the last cluster
//     barrier is split (arrive after the remote reads, wait at the end).
// Where C * itemsize is not a multiple of 16 (or x or y is not 16-byte
// aligned) a piece is one element and the copies are plain loads.

#include <cooperative_groups.h>

#include "group_norm.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr size_t SMEM_LIMIT = 232448;

struct Film {
  const void* scale;  // null: no FiLM
  const void* shift;
  long scale_sample, scale_pixel;  // element strides; the channel stride is 1
  long shift_sample, shift_pixel;
  int bf16;  // scale and shift are bf16, else f32
};

// Where a CTA's share of x lives between the two passes.
enum Form : int {
  TWICE = 0,      // nowhere: read from device memory twice (the second time from L2)
  SHARED = 1,     // shared memory, by cp.async
  REGISTERS = 2,  // registers: at most KREG 16-byte pieces a thread
};
constexpr int KREG = 4;

struct Args {
  const void* x;
  const float* gamma;  // [C]
  const float* beta;
  Film film;
  void* out;
  int HW, C, groups, cluster, pixels, form;
  float eps;
};

// The V elements of one piece from device memory, read-only path.
template <typename T, int V>
__device__ __forceinline__ void ldg_piece(const T* p, float (&e)[V]) {
  if (V * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = dmn::to_f32(t[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) e[v] = dmn::to_f32(__ldg(p + v));
  }
}

// V f32 values rounded to T, stored as one piece (16 bytes where V fills them).
template <typename T, int V>
__device__ __forceinline__ void store_piece(T* p, const float (&e)[V]) {
  if (V * sizeof(T) == 16) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = dmn::from_f32<T>(e[v]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = dmn::from_f32<T>(e[v]);
  }
}

// x * sigmoid(x) for an output of type T. The special-function unit (16
// operations a clock an SM) bounds an output pass that holds a whole
// sample on one SM, so bf16 takes one: sigmoid(h) = (1 + tanh(h / 2)) / 2
// with tanh.approx (relative error ~2^-11, under half a bf16 step); float32
// keeps exp and the fast reciprocal (the 1e-4 gate). Where exp(-h)
// overflows the quotient is 0, as silu(h) is in f32.
template <typename T>
__device__ __forceinline__ float silu(float h) {
  if constexpr (dmn::is_bf16<T>()) {
    const float half = 0.5f * h;
    float t;
    asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(half));
    return fmaf(half, t, half);
  } else {
    return __fdividef(h, 1.f + __expf(-h));
  }
}

// Byte offsets of a CTA's shared memory; ops/norm.py:_group_norm_smem is its
// mirror. Regions: the share of x (resident), then f32 partials [2][rows][C],
// the reduction [2][S][C], this CTA's per-channel sums [2][C] (read by the
// cluster), gamma, beta and a per-sample FiLM's scale and shift [4][C], and
// the coefficients [2][C].
struct Layout {
  size_t part, red, chs, par, coef, total;
  int rows, S;
};

__host__ __device__ inline Layout gn_layout(int C, int pixels, int form, int esize, int V) {
  Layout L;
  const int P = C / V;
  L.rows = P >= THREADS ? 1 : THREADS / P;
  L.S = C >= THREADS ? 1 : THREADS / C;
  size_t off = form == SHARED ? dmn::align16(pixels * C * esize) : 0;
  L.part = off;
  off += sizeof(float) * 2 * size_t(L.rows) * C;
  L.red = off;
  off += sizeof(float) * 2 * size_t(L.S) * C;
  L.chs = off;
  off += sizeof(float) * 2 * C;
  L.par = off;
  off += sizeof(float) * 4 * C;
  L.coef = off;
  off += sizeof(float) * 2 * C;
  L.total = (off + 15) / 16 * 16;
  return L;
}

// Split cluster barrier: arrive once this CTA's reads of the others' shared
// memory are done, wait before leaving (a CTA's shared memory must outlive
// the others' reads of it). A one-CTA cluster needs neither.
__device__ __forceinline__ void cluster_arrive(int cs) {
  if (cs > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait(int cs) {
  if (cs > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cluster of `cluster` CTAs per sample; V: elements per piece (16 /
// sizeof(T), or 1).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) gn_silu_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool WIDE = V * sizeof(T) == 16;  // 16-byte pieces
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = p.cluster, rank = int(cluster.block_rank());
  const int b = blockIdx.x / cs, C = p.C, HW = p.HW;
  const int p0 = rank * p.pixels, np = min(p.pixels, HW - p0);
  const Layout L = gn_layout(C, p.pixels, p.form, sizeof(T), V);
  T* xs = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* chs = reinterpret_cast<float*>(smem + L.chs);
  float* par = reinterpret_cast<float*>(smem + L.par);  // gamma, beta, FiLM scale + 1, shift
  float* coef = reinterpret_cast<float*>(smem + L.coef);
  const T* __restrict__ xb = static_cast<const T*>(p.x) + (size_t(b) * HW + p0) * C;
  T* __restrict__ yb = static_cast<T*>(p.out) + (size_t(b) * HW + p0) * C;
  const int P = C / V, n = np * P, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = L.rows;
  // Thread (r, pc): piece columns pc0, pc0 + THREADS, ... (one where P <=
  // THREADS), pixels r, r + rows, ...; in the register form its k-th piece
  // is pixel r + k * rows of column pc0.
  const int r = tid / P, pc0 = tid % P;
  const bool active = r < rows;
  const bool regs = WIDE && p.form == REGISTERS;
  const Film& f = p.film;
  const bool film_px = f.scale && (f.scale_pixel != 0 || f.shift_pixel != 0);
  const bool film_ps = f.scale && !film_px;
  auto piece = [&](int i, float (&e)[V]) {  // piece i of the share, as f32
    if (p.form == SHARED)
      dmn::load_piece<T, V>(xs + size_t(V) * i, e);
    else
      ldg_piece<T, V>(xb + size_t(V) * i, e);
  };
  uint4 xr[KREG];  // the register form's pieces

  // 0. The share into registers or shared memory, and the per-channel
  // parameters while it is in flight.
  if constexpr (WIDE) {
    if (regs) {
#pragma unroll
      for (int k = 0; k < KREG; ++k) {
        const int i = r + k * rows;
        if (active && i < np) xr[k] = __ldg(reinterpret_cast<const uint4*>(xb) + i * P + pc0);
      }
    } else if (p.form == SHARED) {
      const uint32_t dst = dmn::smem_u32(xs);
      for (int i = tid; i < n; i += THREADS) dmn::cp_async16(dst + 16 * i, xb + size_t(V) * i, true);
      dmn::cp_async_commit();
    }
  }
  for (int c = tid; c < C; c += THREADS) {
    par[c] = __ldg(p.gamma + c);
    par[C + c] = __ldg(p.beta + c);
    if (film_ps) {
      par[2 * C + c] = dmn::film_at(f.scale, f.bf16, b * f.scale_sample + c) + 1.f;
      par[3 * C + c] = dmn::film_at(f.shift, f.bf16, b * f.shift_sample + c);
    }
  }
  if (p.form == SHARED) {
    if (WIDE)
      dmn::cp_async_wait<0>();
    else
      for (int i = tid; i < n * V; i += THREADS) xs[i] = xb[i];
    __syncthreads();
  }

  // 1. Per-thread sums of its V channels over its pixels, then this CTA's
  // per-channel sums in a fixed order. Where a warp's 32 lanes cover 32 / P
  // rows of the same P piece columns (P a power of two), the lanes of a
  // column are added by shuffles, leaving one partial a warp; otherwise the
  // partials go through dmn::channel_sums.
  const bool shfl = P <= 32 && (P & (P - 1)) == 0;
  if (active) {
    for (int pc = pc0; pc < P; pc += THREADS) {
      float s[V], q[V];
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = q[v] = 0.f;
      auto add = [&](const float (&e)[V]) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s[v] += e[v];
          q[v] += e[v] * e[v];
        }
      };
      if (regs) {
#pragma unroll
        for (int k = 0; k < KREG; ++k)
          if (r + k * rows < np) {
            float e[V];
            dmn::load_piece<T, V>(reinterpret_cast<const T*>(&xr[k]), e);
            add(e);
          }
      } else {
        for (int i = r; i < np; i += rows) {
          float e[V];
          piece(i * P + pc, e);
          add(e);
        }
      }
      if (shfl) {
        for (int o = P; o < 32; o <<= 1)
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s[v] += __shfl_xor_sync(0xffffffffu, s[v], o);
            q[v] += __shfl_xor_sync(0xffffffffu, q[v], o);
          }
        if (lane >= P) continue;
      }
      const int row = shfl ? warp : r, nrows = shfl ? WARPS : rows;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        part[row * C + pc * V + v] = s[v];
        part[(nrows + row) * C + pc * V + v] = q[v];
      }
    }
  }
  __syncthreads();
  // One CTA a sample with warp partials: the group step reads them itself.
  // Otherwise this CTA's per-channel sums go to chs, for the cluster.
  const bool direct = shfl && cs == 1;
  if (!direct) {
    if (shfl) {
      for (int c = tid; c < C; c += THREADS) {
        float a = 0.f, aq = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          a += part[w * C + c];
          aq += part[(WARPS + w) * C + c];
        }
        chs[c] = a;
        chs[C + c] = aq;
      }
    } else {
      dmn::channel_sums(part, reinterpret_cast<float*>(smem + L.red), chs, rows, C, THREADS);
    }
    if (cs > 1)
      cluster.sync();
    else
      __syncthreads();
  }

  // 2. The sample's statistics, a warp a group: each lane adds up its
  // channels (the warps' partials in order, or the cluster's per-channel
  // sums in rank order), the group's channels are added by a fixed shuffle
  // tree and lane 0's result is every lane's; then the group's coefficients
  // a = rstd * gamma, b = beta - mean * a (a per-sample FiLM folded in).
  const int cpg = C / p.groups;
  const float count = static_cast<float>(HW) * cpg;
  for (int g = warp; g < p.groups; g += WARPS) {
    float a = 0.f, aq = 0.f;
    for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
      float t = 0.f, tq = 0.f;
      if (direct) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          t += part[w * C + c];
          tq += part[(WARPS + w) * C + c];
        }
      } else {
        float o[MAX_CLUSTER], oq[MAX_CLUSTER];
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k)
          if (k < cs) {
            const float* src = cs == 1 ? chs : cluster.map_shared_rank(chs, k);
            o[k] = src[c];
            oq[k] = src[C + c];
          }
#pragma unroll
        for (int k = 0; k < MAX_CLUSTER; ++k)
          if (k < cs) {
            t += o[k];
            tq += oq[k];
          }
      }
      a += t;
      aq += tq;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      aq += __shfl_xor_sync(0xffffffffu, aq, o);
    }
    const float2 st = dmn::fast_variance_stats(__shfl_sync(0xffffffffu, a, 0),
                                               __shfl_sync(0xffffffffu, aq, 0), count, p.eps);
    for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
      float ca = st.y * par[c];
      float cb = par[C + c] - st.x * ca;
      if (film_ps) {
        ca *= par[2 * C + c];
        cb = cb * par[2 * C + c] + par[3 * C + c];
      }
      coef[c] = ca;
      coef[C + c] = cb;
    }
  }
  cluster_arrive(cs);  // the others' sums are read
  __syncthreads();

  // 3. y = silu(x * a + b) (per-pixel FiLM between the two), V channels a
  // piece, the thread's own columns.
  if (active) {
    for (int pc = pc0; pc < P; pc += THREADS) {
      float ca[V], cb[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ca[v] = coef[pc * V + v];
        cb[v] = coef[C + pc * V + v];
      }
      auto emit = [&](int i, float (&e)[V]) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float h = e[v] * ca[v] + cb[v];
          if (film_px) {
            const long px = p0 + i, c = pc * V + v;
            h = h * (dmn::film_at(f.scale, f.bf16, b * f.scale_sample + px * f.scale_pixel + c) + 1.f) +
                dmn::film_at(f.shift, f.bf16, b * f.shift_sample + px * f.shift_pixel + c);
          }
          e[v] = silu<T>(h);
        }
        store_piece<T, V>(yb + size_t(V) * (i * P + pc), e);
      };
      if (regs) {
#pragma unroll
        for (int k = 0; k < KREG; ++k)
          if (r + k * rows < np) {
            float e[V];
            dmn::load_piece<T, V>(reinterpret_cast<const T*>(&xr[k]), e);
            emit(r + k * rows, e);
          }
      } else {
        for (int i = r; i < np; i += rows) {
          float e[V];
          piece(i * P + pc, e);
          emit(i, e);
        }
      }
    }
  }
  cluster_wait(cs);  // no CTA leaves while another may still read its sums
}

// The launch plan the wrapper computed, checked against this file's layout.
bool plan_ok(const Args& p, int B, int smem, int esize, int V) {
  if (B < 1 || p.HW < 1 || p.C < 1 || p.groups < 1 || p.C % p.groups || p.C % V) return false;
  if (p.cluster < 1 || p.cluster > MAX_CLUSTER || p.pixels < 1) return false;
  if (size_t(p.cluster) * p.pixels < size_t(p.HW) || size_t(p.cluster - 1) * p.pixels >= size_t(p.HW))
    return false;
  if (size_t(B) * p.cluster > 0x7fffffff || size_t(p.pixels) * p.C * esize > 0x7fffffff) return false;
  if (p.form < TWICE || p.form > REGISTERS) return false;
  if (p.form == REGISTERS) {  // 16-byte pieces, one column a thread, KREG pieces at most
    const int P = p.C / V, rows = THREADS / P;
    if (V * esize != 16 || P > THREADS || (p.pixels + rows - 1) / rows > KREG) return false;
  }
  const size_t total = gn_layout(p.C, p.pixels, p.form, esize, V).total;
  return total == size_t(smem) && total <= SMEM_LIMIT;
}

template <typename T, int V>
int launch(const Args& p, int B, int smem, cudaStream_t stream) {
  if (!plan_ok(p, B, smem, sizeof(T), V)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gn_silu_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

template <typename T>
int dispatch(const Args& p, int B, int vec, int smem, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    if (reinterpret_cast<uintptr_t>(p.x) % 16 || reinterpret_cast<uintptr_t>(p.out) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    return launch<T, V>(p, B, smem, stream);
  }
  return launch<T, 1>(p, B, smem, stream);
}

}  // namespace

DMN_DEFINE_ERROR_STRING(dmn_gn)

// Shared-memory bytes of one CTA for a plan (ops/norm.py:group_norm_plan
// computes the same); esize 2 for bf16, 4 for f32; vec: 16-byte pieces.
DMN_EXPORT long dmn_group_norm_silu_smem(int C, int pixels, int form, int esize, int vec) {
  return static_cast<long>(gn_layout(C, pixels, form, esize, vec ? 16 / esize : 1).total);
}

// x, out: [B, HW, C] (bf16 where dtype == 1, else f32), out a new tensor;
// gamma, beta: [C] f32; scale, shift: null (#1) or FiLM (#5) read at element
// strides (sample, pixel) with unit channel stride, f32 (film_dtype 0) or
// bf16 (film_dtype 1). The plan (vec, cluster, pixels, form, smem) is
// group_norm_plan's (form: 0 read twice, 1 shared memory, 2 registers); a
// plan that disagrees with this file's layout is refused.
DMN_EXPORT int dmn_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                   const void* scale, const void* shift, long scale_sample,
                                   long scale_pixel, long shift_sample, long shift_pixel,
                                   void* out, int B, int HW, int C, int groups, float eps,
                                   int dtype, int film_dtype, int vec, int cluster, int pixels,
                                   int form, int smem, void* stream) {
  const Film film{scale, shift, scale_sample, scale_pixel, shift_sample, shift_pixel, film_dtype};
  const Args p{x, static_cast<const float*>(gamma), static_cast<const float*>(beta), film, out,
               HW, C, groups, cluster, pixels, form, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, vec, smem, st);
  return dispatch<float>(p, B, vec, smem, st);
}
