// GroupNorm statistics and the folded per-channel coefficients: the
// statistics pass of B11 (gn_silu_conv3x3.cu and gn_silu_conv3x3_tc.cu),
// which leaves A and B for the conv pass, and the FiLM and SiLU helpers.
// The kApply form (statistics, then y = x*A + B and SiLU from a second read
// of x) was B10's kernel until gn_film_silu.cu took it over with one read;
// nothing instantiates it now, and it stays only so that the statistics
// pass, the same template, keeps its instructions.
//
// Per sample and group, in f32: mean = sum(x)/n and var = sum(x*x)/n - mean^2
// over the group's H*W*cg values (one pass, the formula of both JAX paths),
// then per channel
//   A = gamma * rsqrt(var + eps) * (1 + scale)
//   B = (beta - mean * gamma * rsqrt(var + eps)) * (1 + scale) + shift
// with shift/scale the FiLM rows of the sample, or absent.
//
// The Pallas kernels fold channels to groups and back with one-hot (C, G)
// matmuls because Mosaic cannot reshape lanes; here a group's channels are a
// plain index range. One block takes one sample and a run of `gpb` whole
// groups (channels c0 .. c0 + gpb*cg): lane l of every warp owns channel
// c0 + l (+32, +64, ... when one group is wider than a warp), the 8 warps
// stride over the pixels, so a warp reads gpb*cg neighbouring channels of one
// pixel per load. The launcher picks gpb = max(1, 32 / cg), so that either
// every lane owns one channel, or the block holds a single group; in both
// cases a thread's partial sums belong to one group. The sums are folded in a
// fixed order (warps, then the group's lanes): no atomics, the same bits on
// every run.
#pragma once

#include "attn_common.cuh"

namespace vdiff {
namespace {  // internal linkage: each translation unit gets its own copies
namespace gn {

// One FiLM value: rows are `stride` elements apart, f32 or bf16.
__device__ __forceinline__ float film_at(const void* p, long i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// kApply: write out = [silu](x*A + B) in x's type (B10). Otherwise write the
// coefficients to coef_a / coef_b, f32 (B, C) (the statistics pass of B11).
// grid (ceil(G / gpb), B), kThreads threads.
template <typename E, bool kApply>
__global__ void __launch_bounds__(kThreads)
    kernel(const E* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, const void* __restrict__ shift,
           const void* __restrict__ scale, int film_stride, int film_f32, E* __restrict__ out,
           float* __restrict__ coef_a, float* __restrict__ coef_b, int HW, int C, int cg, int gpb,
           float eps, int apply_silu) {
  __shared__ float part1[kWarps][32], part2[kWarps][32];
  __shared__ float mean_s[32], inv_s[32];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * gpb * cg;
  const int wc = min(gpb * cg, C - c0);  // channels of this block
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const E* xb = x + (long)b * HW * C + c0;

  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < wc; c += 32) {
#pragma unroll 8
    for (int p = warp; p < HW; p += kWarps) {
      const float v = to_f32(xb[(long)p * C + c]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  part1[warp][lane] = s1;
  part2[warp][lane] = s2;
  __syncthreads();
  if (warp == 0) {
    float t1 = 0.f, t2 = 0.f;  // this lane's channel(s) over all pixels
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t1 += part1[w][lane];
      t2 += part2[w][lane];
    }
    const float n = (float)HW * (float)cg;
    if (gpb == 1) {  // one group: every lane's sums belong to it
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      if (lane == 0) {
        const float mean = t1 / n;
        mean_s[0] = mean;
        inv_s[0] = rsqrtf(t2 / n - mean * mean + eps);
      }
    } else {  // lane g folds the cg lanes of group g
      part1[0][lane] = t1;
      part2[0][lane] = t2;
      __syncwarp();
      if (lane * cg < wc) {
        float g1 = 0.f, g2 = 0.f;
        for (int j = 0; j < cg; ++j) {
          g1 += part1[0][lane * cg + j];
          g2 += part2[0][lane * cg + j];
        }
        const float mean = g1 / n;
        mean_s[lane] = mean;
        inv_s[lane] = rsqrtf(g2 / n - mean * mean + eps);
      }
    }
  }
  __syncthreads();

  for (int c = lane; c < wc; c += 32) {
    const int g = gpb == 1 ? 0 : c / cg;
    const int ch = c0 + c;
    float a = gamma[ch] * inv_s[g];
    float o = beta[ch] - mean_s[g] * a;
    if (shift != nullptr) {
      const long fi = (long)b * film_stride + ch;
      const float fs = 1.f + film_at(scale, fi, film_f32);
      a = a * fs;
      o = o * fs + film_at(shift, fi, film_f32);
    }
    if constexpr (kApply) {
      E* ob = out + (long)b * HW * C + c0;
#pragma unroll 8
      for (int p = warp; p < HW; p += kWarps) {
        float y = fmaf(to_f32(xb[(long)p * C + c]), a, o);
        if (apply_silu) y = silu(y);
        ob[(long)p * C + c] = from_f32<E>(y);
      }
    } else if (warp == 0) {
      coef_a[(long)b * C + ch] = a;
      coef_b[(long)b * C + ch] = o;
    }
  }
}

// x (B, HW, C) contiguous, C = G * cg. Returns the launch's cudaError_t.
template <typename E, bool kApply>
int launch(const void* x, const void* gamma, const void* beta, const void* shift,
           const void* scale, int film_stride, int film_f32, void* out, float* coef_a,
           float* coef_b, int B, int HW, int C, int G, float eps, int apply_silu,
           cudaStream_t stream) {
  if (B <= 0 || HW <= 0 || G <= 0 || C % G || B > 65535 || (shift == nullptr) != (scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cg = C / G;
  const int gpb = cg >= 32 ? 1 : 32 / cg;
  const dim3 grid((G + gpb - 1) / gpb, B);
  kernel<E, kApply><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), shift, scale, film_stride, film_f32,
      static_cast<E*>(out), coef_a, coef_b, HW, C, cg, gpb, eps, apply_silu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn
}  // namespace
}  // namespace vdiff
