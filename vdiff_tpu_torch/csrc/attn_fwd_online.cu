// Online-softmax attention forward straight off the fused qkv projection, at
// any token count that is a multiple of 32; with a second entry point that
// also writes each row's logsumexp.
//
// Replaces, for f32 inputs, three Pallas kernels of
// vdiff_tpu/ops/attention.py that compute out = softmax((q/sqrt(C)).k^T).v
// with f32 products and the output divided by the row sums:
//   _flash_kernel (B1, through flash_attention_qkv for T <= 512: the CIFAR
//     and celeba samplers' T = 256 and T = 64 calls) and
//     _attn_fwd_kernel_pack1 (B6, through _pack1_fwd_call: the celeba
//     sampler's and pack1 training forward at head dim 64, T = 256, 1024,
//     4096) through vdiff_attn_fwd_online;
//   _attn_fwd_kernel_pack1_lse (B7, through _pack1_fwd_lse_call: the forward
//     of pack1_attention_trainable_kv at T = 4096, which saves lse for the
//     kv-streamed backward) through vdiff_attn_fwd_pack1_lse.
// bf16 calls of all three run the tensor-core forward, attn_fwd_tc.cu, and
// its lse entry; chip_smoke.py times this kernel beside it on the same bf16
// inputs.
// Per (batch, head, 32-row q tile) the block walks the keys in tiles of 32 and
// keeps a running row max m and denominator l, rescaling the f32 output
// accumulator by exp(m_old - m_new) per tile, as the Pallas kernel's fori_loop
// does. The pack1 kernels hold a whole (bq, T) score tile in VMEM with 128/C
// heads packed into a 128-lane block (TPU lane layout, not carried over); at
// T = 4096 a (16, T) f32 score row alone is 256 KB, over the 227 KB a block
// may use, so here the softmax streams: nothing in shared memory grows with T
// (29 KB at C = 64, 91 KB at C = 256). The running max moves f32 roundings
// only. With kLse the block also writes lse = m + log(l) per row as f32
// (B, N, T), the layout attn_bwd_cols reads; the TPU kernel broadcasts it
// over each head's C lanes of a (B, T, N*C) array.
//
// Bound on the H100: each (batch, head) does 4*T*T*C FLOPs on 4*T*C elements,
// so at the UNets' shapes the kernel is compute bound. This first version runs
// the two products as f32 FMAs out of shared memory (no tensor cores), so its
// ceiling is the SM's shared-memory bandwidth, not the 67 TFLOP/s f32 peak.
// What the design does about it: the q tile stays resident in shared memory
// across all key tiles, k rows use a padded pitch so the 32 lanes of a warp
// (one key column each) read 32 distinct banks, and in the P.V product each
// thread owns one output column and reads p as a broadcast. Tensor cores
// (mma/wgmma) come later.
//
// Layout: qkv (B, T, 3*N*C) row-major, head n's q/k/v at columns n*C,
// (N+n)*C and (2N+n)*C. out (B, T, N*C). f32 or bf16 in and out; all math f32.
// q is scaled by 1/sqrt(C) as it is loaded, before the q.k product.

#include "attn_common.cuh"

namespace vdiff {
namespace {

constexpr int kBq = 32;  // q rows per block
constexpr int kBk = 32;  // keys per tile: one per lane
constexpr int kRowsPerWarp = kBq / kWarps;

template <int C>
constexpr int online_smem_floats() {
  return kBq * C            // q tile
         + kBk * (C + 1)    // k tile, padded pitch
         + kBk * C          // v tile
         + kBq * kBk        // p tile
         + 2 * kBq;         // per-row rescale factor and final denominator
}

template <typename E, int C, bool kLse>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_online_kernel(const E* __restrict__ qkv, E* __restrict__ out,
                           float* __restrict__ lse, int T, int N, float scale) {
  constexpr int kKp = C + 1;
  constexpr int kRpt = kBq * C / kThreads;  // output rows owned by each thread
  static_assert(kThreads % C == 0, "each thread owns one output column");

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBq * C;
  float* v_s = k_s + kBk * kKp;
  float* p_s = v_s + kBk * C;
  float* alpha_s = p_s + kBq * kBk;
  float* l_s = alpha_s + kBq;

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kBq;
  const long row_stride = 3L * N * C;
  const E* base = qkv + (long)b * T * row_stride;
  load_rows<E, C>(q_s, C, base + (long)q0 * row_stride + n * C, row_stride, kBq, scale);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = threadIdx.x % C;
  const int r0 = (threadIdx.x / C) * kRpt;

  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float acc[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();  // the previous k/v/p tiles are fully consumed
    load_rows<E, C>(k_s, kKp, base + (long)k0 * row_stride + (N + n) * C, row_stride, kBk, 1.f);
    load_rows<E, C>(v_s, C, base + (long)k0 * row_stride + (2 * N + n) * C, row_stride, kBk, 1.f);
    __syncthreads();

    // scores: warp w owns rows w, w+8, ...; lane j owns key k0+j
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* k_row = k_s + lane * kKp;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float kv = k_row[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(q_s[(warp + kWarps * i) * C + c], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const float m_new = fmaxf(m[i], warp_max(s[i]));
      const float p = expf(s[i] - m_new);
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      l[i] = alpha * l[i] + warp_sum(p);
      m[i] = m_new;
      p_s[r * kBk + lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p . v for this thread's column
#pragma unroll
    for (int i = 0; i < kRpt; ++i) acc[i] *= alpha_s[r0 + i];
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      const float vv = v_s[j * C + col];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(p_s[(r0 + i) * kBk + j], vv, acc[i]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      l_s[r] = l[i];
      if constexpr (kLse) lse[((long)b * N + n) * T + q0 + r] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();

  const long out_stride = (long)N * C;
  E* o = out + ((long)b * T + q0) * out_stride + n * C + col;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) o[(r0 + i) * out_stride] = from_f32<E>(acc[i] / l_s[r0 + i]);
}

template <typename E, int C, bool kLse>
int launch_online(const void* qkv, void* out, float* lse, int B, int T, int N,
                  cudaStream_t stream) {
  if (T % kBq || T % kBk) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = online_smem_floats<C>() * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attn_fwd_online_kernel<E, C, kLse>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T / kBq, N, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const E*>(qkv), static_cast<E*>(out), lse,
                                            T, N, 1.0f / sqrtf(static_cast<float>(C)));
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int C>
struct OnlineLauncher {
  static int run(const void* qkv, void* out, int B, int T, int N, cudaStream_t stream) {
    return launch_online<E, C, false>(qkv, out, nullptr, B, T, N, stream);
  }
};

template <typename E, int C>
struct OnlineLseLauncher {
  static int run(const void* qkv, void* out, float* lse, int B, int T, int N,
                 cudaStream_t stream) {
    return launch_online<E, C, true>(qkv, out, lse, B, T, N, stream);
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C) in, out (B, T, N*C). Returns the cudaError_t of the
// launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_fwd_online(const void* qkv, void* out, int B, int T, int N, int C,
                                     int is_bf16, void* stream) {
  return vdiff::dispatch<vdiff::OnlineLauncher>(is_bf16, C, qkv, out, B, T, N,
                                                static_cast<cudaStream_t>(stream));
}

// As vdiff_attn_fwd_online, and lse (B, N, T) f32 out.
extern "C" int vdiff_attn_fwd_pack1_lse(const void* qkv, void* out, void* lse, int B, int T,
                                        int N, int C, int is_bf16, void* stream) {
  return vdiff::dispatch<vdiff::OnlineLseLauncher>(is_bf16, C, qkv, out, static_cast<float*>(lse),
                                                   B, T, N, static_cast<cudaStream_t>(stream));
}

extern "C" const char* vdiff_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
