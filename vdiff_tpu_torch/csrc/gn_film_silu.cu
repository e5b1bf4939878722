// GroupNorm (+FiLM) (+SiLU) of an NHWC activation: one launch that reads x
// from device memory once and writes y once.
//
// Replaces vdiff_tpu/ops/groupnorm.py::_gn_kernel (B10, through
// gn_film_silu_pallas): per sample and group, f32 sums of x and x*x, the
// single-pass var = sum(x*x)/n - mean^2 (JAX's formula), the normalisation,
// affine and FiLM folded into one f32 pair per channel
//   A = gamma * rsqrt(var + eps) * (1 + scale)
//   B = (beta - mean * gamma * rsqrt(var + eps)) * (1 + scale) + shift,
// then y = x*A + B and the optional SiLU in f32, one cast to x's type.
//
// Bound on the H100: bytes (x read and y written once; ~10 operations per
// element). The TPU kernel holds one whole sample in VMEM; here a sample is
// cut into slabs of (pixels, run), a run being whole groups whose channels
// make a multiple of 16 bytes per pixel (ops/groupnorm.py::gn_plan picks it,
// 64 bytes or more where the groups allow, and the cluster and the warps
// below, from measurements on the card). A block:
//   1. copies its slab into shared memory with 16-byte cp.async, all in
//      flight at once, and never reads x again; meanwhile it fetches the
//      channels' gamma, beta and FiLM values (the FiLM rows read as scalars:
//      the two strided halves of one (B, 2C) projection, f32 or x's type);
//   2. forms f32 per-channel sums over its pixels (each lane owns one
//      16-byte column of the run), folds them over the lanes of a warp that
//      share a column (shuffles in a fixed tree), then over the warps and
//      each group's channels, always in the same order;
//   3. where one block cannot hold the slab (celeba's 64x64 images), the
//      slab is split over a thread-block cluster of `ranks` blocks along the
//      pixels: each publishes its per-group (sum x, sum x*x) in shared
//      memory, and after a cluster barrier every block reads all ranks' sums
//      in rank order through distributed shared memory. No atomics: two
//      calls give the same bits;
//   4. computes A and B per channel;
//   5. writes y from the shared-memory copy with 16-byte stores.
// What is left between this and the bound (PERF.md §6): a block loads, then
// folds, then stores, and the blocks of a wave do so in step, so reads and
// writes overlap little; at 8x8 the launch (~2 us) and the chain of
// barriers; with SiLU, two SFU operations an element.
// SiLU takes the SFU's exp and reciprocal (__fdividef returns 0 for the
// huge denominators of very negative inputs, SiLU's limit there).
//
// Layout: x and out (B, HW, C) contiguous and 16-byte aligned, f32 or bf16;
// gamma/beta (C,) f32; shift/scale rows of C values, `film_stride` elements
// apart, or both null.

#include <cooperative_groups.h>

#include "attn_tc.cuh"
#include "gn_common.cuh"

namespace vdiff {
namespace {

namespace cg = cooperative_groups;

constexpr int kGnThreads = 256;  // a block's most threads
constexpr int kMaxRanks = 16;    // above 8 the cluster is non-portable

// 16 bytes of E as f32 values: 4 f32 or 8 bf16 (low half first).
template <typename E>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(uint4 r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Dynamic shared memory of a block, in this order: the slab (pixels x V
// 16-byte vectors), the warps' per-channel sums (2 x warps x run_ch f32), the
// channels' gamma, beta, FiLM scale and shift, then A and B in the first two
// rows (4 x run_ch), and the block's per-group sums (2 x groups), which the
// cluster reads.
__host__ __device__ constexpr long smem_bytes(int pixels, int vecs, int threads, int run_ch,
                                              int groups) {
  return 16L * pixels * vecs + 4L * (2L * (threads / 32) * run_ch + 4L * run_ch + 2L * groups);
}

// grid (runs * ranks, B), cluster (ranks, 1, 1), 32 x warps threads. A
// warp holds 32 / V pixels of the run: lane l takes the 16-byte column
// v = l % V of pixel lane warp * (32 / V) + l / V, then every P-th pixel
// (P pixel lanes a block); lanes past V * (32 / V) hold none.
template <typename E, bool kSilu>
__global__ void __launch_bounds__(kGnThreads)
    gn_film_silu_kernel(const E* __restrict__ x, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const void* __restrict__ shift,
                        const void* __restrict__ scale, int film_stride, int film_f32,
                        E* __restrict__ out, int HW, int C, int cg_, int groups, int pixels,
                        int ranks, float eps) {
  constexpr int kN = Vec16<E>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int run_ch = groups * cg_;
  const int V = run_ch / kN, lanes = 32 / V * V;  // lanes of a warp that hold pixels
  const int warps = blockDim.x / 32, P = warps * (32 / V);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, v = lane % V;
  const int rank = blockIdx.x % ranks, c0 = (blockIdx.x / ranks) * run_ch;
  const int p0 = rank * pixels, np = min(pixels, HW - p0);
  const int pl = lane < lanes ? warp * (32 / V) + lane / V : np;  // np: no pixels
  cg::cluster_group cluster = cg::this_cluster();

  uint4* slab = reinterpret_cast<uint4*>(smem);
  float* part = reinterpret_cast<float*>(slab + (long)pixels * V);  // [2][warps][run_ch]
  float* prm = part + 2 * warps * run_ch;                           // [4][run_ch]
  float* grp = prm + 4 * run_ch;                                    // [2][groups]

  const E* xb = x + ((long)blockIdx.y * HW + p0) * C + c0 + v * kN;
  E* ob = out + ((long)blockIdx.y * HW + p0) * C + c0 + v * kN;

  // 1. the slab, every copy in flight at once; the channels' parameters
  // fetched meanwhile
  for (int p = pl; p < np; p += P) tc::cp_async16(slab + p * V + v, xb + (long)p * C, true);
  tc::cp_async_commit();
  const long fb = (long)blockIdx.y * film_stride + c0;
  for (int c = t; c < run_ch; c += blockDim.x) {
    prm[c] = gamma[c0 + c];
    prm[run_ch + c] = beta[c0 + c];
    prm[2 * run_ch + c] = shift != nullptr ? 1.f + gn::film_at(scale, fb + c, film_f32) : 1.f;
    prm[3 * run_ch + c] = shift != nullptr ? gn::film_at(shift, fb + c, film_f32) : 0.f;
  }
  // a thread reads back only the vectors it copied itself
  tc::cp_async_wait<0>();

  // 2. this thread's per-channel sums; then, in a fixed tree, over the
  // lanes of its warp that share its column (l, l + V, l + 2V, ...), which
  // leaves the warp's sums in lanes l < V; then, one thread a group, over
  // the warps and the group's channels, in order
  float s1[kN], s2[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) s1[j] = s2[j] = 0.f;
  for (int p = pl; p < np; p += P) {
    float f[kN];
    Vec16<E>::unpack(slab[p * V + v], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      s1[j] += f[j];
      s2[j] = fmaf(f[j], f[j], s2[j]);
    }
  }
  for (int off = V; off < lanes; off *= 2) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float o1 = __shfl_down_sync(0xffffffffu, s1[j], off);
      const float o2 = __shfl_down_sync(0xffffffffu, s2[j], off);
      if (lane + off < lanes) {
        s1[j] += o1;
        s2[j] += o2;
      }
    }
  }
  if (lane < V) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      part[warp * run_ch + v * kN + j] = s1[j];
      part[(warps + warp) * run_ch + v * kN + j] = s2[j];
    }
  }
  __syncthreads();
  for (int g = t; g < 2 * groups; g += blockDim.x) {  // g < groups: sum x, else sum x*x
    const float* src = part + (g < groups ? g * cg_ : warps * run_ch + (g - groups) * cg_);
    float s = 0.f;
    for (int w = 0; w < warps; ++w)
      for (int j = 0; j < cg_; ++j) s += src[w * run_ch + j];
    grp[g] = s;
  }

  // 3. the group sums of all ranks, in rank order (the local ones when the
  // block holds the whole slab)
  if (ranks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  const float n = (float)HW * (float)cg_;
  for (int c = t; c < run_ch; c += blockDim.x) {
    const int g = c / cg_;
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < ranks; ++r) {
      const float* src = ranks > 1 ? cluster.map_shared_rank(grp, r) : grp;
      t1 += src[g];
      t2 += src[groups + g];
    }
    // 4. A and B of channel c0 + c, over its gamma and beta
    const float mean = t1 / n;
    const float inv = rsqrtf(t2 / n - mean * mean + eps);
    float a = prm[c] * inv;
    float o = prm[run_ch + c] - mean * a;
    if (shift != nullptr) {
      const float fs = prm[2 * run_ch + c];
      a = a * fs;
      o = o * fs + prm[3 * run_ch + c];
    }
    prm[c] = a;
    prm[run_ch + c] = o;
  }
  if (ranks > 1) cluster_arrive();  // this block is done reading the other ranks
  __syncthreads();

  // 5. y from the slab
  float a[kN], o[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    a[j] = prm[v * kN + j];
    o[j] = prm[run_ch + v * kN + j];
  }
  for (int p = pl; p < np; p += P) {
    float f[kN];
    Vec16<E>::unpack(slab[p * V + v], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float y = fmaf(f[j], a[j], o[j]);
      f[j] = kSilu ? __fdividef(y, 1.f + __expf(-y)) : y;
    }
    *reinterpret_cast<uint4*>(ob + (long)p * C) = Vec16<E>::pack(f);
  }
  if (ranks > 1) cluster_wait();  // no block leaves while another reads its sums
}

template <typename E, bool kSilu>
int launch(const void* x, const void* gamma, const void* beta, const void* shift,
           const void* scale, int film_stride, int film_f32, void* out, int B, int HW, int C,
           int G, float eps, int groups, int ranks, int pixels, int threads,
           cudaStream_t stream) {
  constexpr int kN = Vec16<E>::kN;
  const int cg_ = G > 0 ? C / G : 0;
  const int run_ch = groups * cg_;
  const int V = run_ch / kN;
  // the plan (ops/groupnorm.py::gn_plan) must cover the sample exactly
  const bool ok = B > 0 && B <= 65535 && HW > 0 && G > 0 && C % G == 0 && groups > 0 &&
                  G % groups == 0 && run_ch % kN == 0 && V > 0 && V <= 32 && threads > 0 &&
                  threads % 32 == 0 && threads <= kGnThreads && ranks >= 1 &&
                  ranks <= kMaxRanks && pixels > 0 &&
                  (long)pixels * ranks >= HW && (long)pixels * (ranks - 1) < HW &&
                  (shift == nullptr) == (scale == nullptr) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long smem = smem_bytes(pixels, V, threads, run_ch, groups);
  if (!ok || smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = gn_film_silu_kernel<E, kSilu>;
  cudaError_t err = tc::allow_smem(kernel, static_cast<int>(smem));
  if (err == cudaSuccess && ranks > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((G / groups) * ranks, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const E*>(x),
                           static_cast<const float*>(gamma), static_cast<const float*>(beta),
                           shift, scale, film_stride, film_f32, static_cast<E*>(out), HW, C, cg_,
                           groups, pixels, ranks, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vdiff

// groups: whole groups per run; ranks: blocks per cluster along the pixels;
// pixels: pixels per block; threads: 32 x warps (ops/groupnorm.py::gn_plan).
// Returns the cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_gn_film_silu(const void* x, const void* gamma, const void* beta,
                                  const void* shift, const void* scale, int film_stride,
                                  int film_f32, void* out, int B, int HW, int C, int G, float eps,
                                  int apply_silu, int is_bf16, int groups, int ranks, int pixels,
                                  int threads, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  auto run = is_bf16 ? (apply_silu ? vdiff::launch<bf16, true> : vdiff::launch<bf16, false>)
                     : (apply_silu ? vdiff::launch<float, true> : vdiff::launch<float, false>);
  return run(x, gamma, beta, shift, scale, film_stride, film_f32, out, B, HW, C, G, eps, groups,
             ranks, pixels, threads, s);
}
