// Direct-softmax attention forward over whole token rows, straight off the
// fused qkv projection. Shared by attn_fwd_qblk.cu (B2, the sampler's and the
// training forward at T > 512) and attn_fwd_train.cu (B3, the training
// forward at T <= 512); each keeps its own entry point.
//
// Per (batch, head, 16-row q tile) the block keeps the whole (16, T) f32 score
// row in dynamic shared memory (64 KiB at T = 1024), so the softmax is exact
// and needs no running rescale:
//   pass 1: s = (q/sqrt(C)).k^T over all key tiles, tracking the row max;
//   then    e = exp(s - max) in place and l = sum(e);
//           kNormaliseP: p = e / l in place (the Pallas kernels' softmax form);
//   pass 2: out = (e . v) / l, or p . v when kNormaliseP.
//
// Bound on the H100: at the UNet's shapes (T = 64..1024, C = 256) each
// (batch, head) does 4*T*T*C FLOPs on 4*T*C elements, so the kernel is compute
// bound. This first version runs both products as f32 FMAs from shared memory
// (no tensor cores); its ceiling is the SM's shared-memory bandwidth. What
// the design does about it: the score row never goes to device memory, k and
// v tiles share one padded buffer so the lanes of a warp (one key each) read
// distinct banks, and each thread owns one output column and reads e as a
// broadcast. The 115 KB footprint at T = 1024 allows one block (8 warps) per
// SM, which caps latency hiding; tensor cores and a smaller score row come
// later.
//
// Layout: qkv (B, T, 3*N*C), head n's q/k/v at columns n*C, (N+n)*C and
// (2N+n)*C; out (B, T, N*C). f32 or bf16 in and out, f32 math, q scaled by
// 1/sqrt(C) on load.
#pragma once

#include "attn_common.cuh"

namespace vdiff {
namespace {  // internal linkage: each translation unit gets its own copies
namespace direct_fwd {

constexpr int kBq = 16;  // q rows per block
constexpr int kBk = 32;  // keys per tile: one per lane
constexpr int kRowsPerWarp = kBq / kWarps;

template <int C>
int smem_floats(int T) {
  return kBq * C          // q tile
         + kBk * (C + 1)  // k tile, then v tile (padded pitch)
         + kBq * T        // score row, then e = exp(s - max) (or p)
         + kBq;           // row sums
}

// Largest token count the score row allows at head dim C; 0 for an
// unsupported head dim.
inline int max_t(int C) {
  if (C != 32 && C != 64 && C != 128 && C != 256) return 0;
  const int free_floats =
      kMaxSmemBytes / static_cast<int>(sizeof(float)) - kBq * C - kBk * (C + 1) - kBq;
  return (free_floats / kBq) / kBk * kBk;
}

template <typename E, int C, bool kNormaliseP>
__global__ void __launch_bounds__(kThreads)
    kernel(const E* __restrict__ qkv, E* __restrict__ out, int T, int N, float scale) {
  constexpr int kKp = C + 1;
  constexpr int kRpt = kBq * C / kThreads;  // output rows owned by each thread
  static_assert(kThreads % C == 0, "each thread owns one output column");

  extern __shared__ float smem[];
  float* q_s = smem;
  float* kv_s = q_s + kBq * C;
  float* s_s = kv_s + kBk * kKp;
  float* l_s = s_s + kBq * T;

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kBq;
  const long row_stride = 3L * N * C;
  const E* base = qkv + (long)b * T * row_stride;
  load_rows<E, C>(q_s, C, base + (long)q0 * row_stride + n * C, row_stride, kBq, scale);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // pass 1: scores and row max. Warp w owns rows w, w+8; lane j owns key k0+j.
  float mx[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) mx[i] = -INFINITY;
  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();
    load_rows<E, C>(kv_s, kKp, base + (long)k0 * row_stride + (N + n) * C, row_stride, kBk, 1.f);
    __syncthreads();
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* k_row = kv_s + lane * kKp;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float kv = k_row[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(q_s[(warp + kWarps * i) * C + c], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      s_s[(warp + kWarps * i) * T + k0 + lane] = s[i];
      mx[i] = fmaxf(mx[i], s[i]);
    }
  }

  // exact softmax numerator (or probabilities) in place; each warp touches
  // only its own rows
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const float m = warp_max(mx[i]);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(s_s[r * T + j] - m);
      s_s[r * T + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (kNormaliseP) {
      for (int j = lane; j < T; j += 32) s_s[r * T + j] /= sum;
    }
    if (lane == 0) l_s[r] = sum;
  }

  // pass 2: acc = e . v (or p . v) for this thread's column
  const int col = threadIdx.x % C;
  const int r0 = (threadIdx.x / C) * kRpt;
  float acc[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();  // e rows written (first tile) / previous v tile consumed
    load_rows<E, C>(kv_s, kKp, base + (long)k0 * row_stride + (2 * N + n) * C, row_stride, kBk,
                    1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      const float vv = kv_s[j * kKp + col];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(s_s[(r0 + i) * T + k0 + j], vv, acc[i]);
    }
  }

  const long out_stride = (long)N * C;
  E* o = out + ((long)b * T + q0) * out_stride + n * C + col;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    o[(r0 + i) * out_stride] = from_f32<E>(kNormaliseP ? acc[i] : acc[i] / l_s[r0 + i]);
  }
}

template <typename E, int C, bool kNormaliseP>
int launch(const void* qkv, void* out, int B, int T, int N, cudaStream_t stream) {
  if (T % kBq || T % kBk) return static_cast<int>(cudaErrorInvalidValue);
  const long bytes = static_cast<long>(smem_floats<C>(T)) * sizeof(float);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto k = kernel<E, C, kNormaliseP>;
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T / kBq, N, B);
  k<<<grid, kThreads, bytes, stream>>>(static_cast<const E*>(qkv), static_cast<E*>(out), T, N,
                                       1.0f / sqrtf(static_cast<float>(C)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace direct_fwd
}  // namespace
}  // namespace vdiff
