// Attention backward, second pass (per key tile): dK and dV, from the row
// statistics that attn_bwd_rows.cu wrote (lse and delta, f32 (B, N, T)).
// Writes them into the k and v columns of the (B, T, 3*N*C) d(qkv) buffer
// whose q columns the first pass filled.
//
// Replaces, with attn_bwd_rows.cu, vdiff_tpu/ops/attention.py::_attn_bwd_kernel
// (T <= 512) and ::_attn_bwd_kernel_qblk (T > 512); the math is set out in
// attn_bwd_rows.cu. _attn_bwd_kernel_qblk carries its f32 dK/dV accumulator in
// VMEM across the sequential q-block grid of one (batch, head). CUDA blocks run
// in no order and carry nothing between them, so here one block owns a
// 32-key tile of one (batch, head) and loops over all q rows in chunks of 16,
// keeping dK and dV for its keys in f32 registers:
//   per chunk: S = q.k^T / sqrt(C) and dP = dO.v^T (lane j = key j),
//              P = exp(S - lse), dS = P o (dP - delta), both rounded to the
//              input dtype (the Pallas kernels' matmul operands);
//              dV += P^T.dO, dK += dS^T.q (each thread one column, a few keys);
//   at the end dK is scaled by 1/sqrt(C), both are cast to the input dtype and
//   written once. No atomics: the sums run in a fixed order.
//
// Bound on the H100: compute, 8*T*T*C FLOPs per (batch, head) here (S and dP
// again, dK, dV). This first version runs f32 FMAs from shared memory (no
// tensor cores). What the design does about it: the k/v tile stays resident
// for the whole q loop, with a padded pitch so the 32 lanes read distinct
// banks; q/dO/P/dS are read as broadcasts or by neighbouring columns; the
// (32, C) dK/dV accumulators live in registers (64 floats a thread at
// C = 256). The 103 KB footprint at C = 256 allows two blocks per SM.

#include "attn_common.cuh"

namespace vdiff {
namespace {

constexpr int kBk = 32;  // keys per block: one per lane
constexpr int kBq = 16;  // q rows per chunk of the loop
constexpr int kRowsPerWarp = kBq / kWarps;

template <int C>
constexpr int cols_smem_floats() {
  return 2 * kBk * (C + 1)  // k tile, v tile (padded pitch)
         + 2 * kBq * C      // q chunk, dO chunk
         + 2 * kBq * kBk    // P chunk, dS chunk
         + 2 * kBq;         // lse, delta of the chunk's rows
}

template <typename E, int C>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_cols_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         E* __restrict__ dqkv, int T, int N, float scale) {
  constexpr int kKp = C + 1;
  constexpr int kKpt = kBk * C / kThreads;  // keys owned by each thread
  static_assert(kThreads % C == 0, "each thread owns one dK/dV column");

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kBk * kKp;
  float* q_s = v_s + kBk * kKp;
  float* do_s = q_s + kBq * C;
  float* p_s = do_s + kBq * C;
  float* ds_s = p_s + kBq * kBk;
  float* lse_s = ds_s + kBq * kBk;
  float* dlt_s = lse_s + kBq;

  const int b = blockIdx.z, n = blockIdx.y, k0 = blockIdx.x * kBk;
  const long row_stride = 3L * N * C;
  const long out_stride = static_cast<long>(N) * C;
  const E* base = qkv + (long)b * T * row_stride;
  const E* dbase = dout + (long)b * T * out_stride + n * C;
  const long stat0 = ((long)b * N + n) * T;
  load_rows<E, C>(k_s, kKp, base + (long)k0 * row_stride + (N + n) * C, row_stride, kBk, 1.f);
  load_rows<E, C>(v_s, kKp, base + (long)k0 * row_stride + (2 * N + n) * C, row_stride, kBk, 1.f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = threadIdx.x % C;
  const int j0 = (threadIdx.x / C) * kKpt;
  float dk[kKpt], dv[kKpt];
#pragma unroll
  for (int i = 0; i < kKpt; ++i) dk[i] = dv[i] = 0.f;

  const float* key_row = k_s + lane * kKp;
  const float* val_row = v_s + lane * kKp;
  for (int q0 = 0; q0 < T; q0 += kBq) {
    __syncthreads();  // the previous chunk is fully consumed
    load_rows<E, C>(q_s, C, base + (long)q0 * row_stride + n * C, row_stride, kBq, 1.f);
    load_rows<E, C>(do_s, C, dbase + (long)q0 * out_stride, out_stride, kBq, 1.f);
    if (threadIdx.x < kBq) {
      lse_s[threadIdx.x] = lse[stat0 + q0 + threadIdx.x];
      dlt_s[threadIdx.x] = delta[stat0 + q0 + threadIdx.x];
    }
    __syncthreads();

    // S and dP for (row, key lane); warp w owns rows w, w+8
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float kv = key_row[c];
      const float vv = val_row[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        s[i] = fmaf(q_s[r * C + c], kv, s[i]);
        dp[i] = fmaf(do_s[r * C + c], vv, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const float p = expf(s[i] * scale - lse_s[r]);
      p_s[r * kBk + lane] = round_to<E>(p);
      ds_s[r * kBk + lane] = round_to<E>(p * (dp[i] - dlt_s[r]));
    }
    __syncthreads();

    // dV += P^T . dO, dK += dS^T . q for this thread's column and keys
#pragma unroll 4
    for (int r = 0; r < kBq; ++r) {
      const float qv = q_s[r * C + col];
      const float dov = do_s[r * C + col];
#pragma unroll
      for (int i = 0; i < kKpt; ++i) {
        dv[i] = fmaf(p_s[r * kBk + j0 + i], dov, dv[i]);
        dk[i] = fmaf(ds_s[r * kBk + j0 + i], qv, dk[i]);
      }
    }
  }

  E* out_k = dqkv + ((long)b * T + k0 + j0) * row_stride + (N + n) * C + col;
  E* out_v = dqkv + ((long)b * T + k0 + j0) * row_stride + (2 * N + n) * C + col;
#pragma unroll
  for (int i = 0; i < kKpt; ++i) {
    out_k[i * row_stride] = from_f32<E>(dk[i] * scale);
    out_v[i * row_stride] = from_f32<E>(dv[i]);
  }
}

template <typename E, int C>
struct ColsLauncher {
  static int run(const void* qkv, const void* dout, const float* lse, const float* delta,
                 void* dqkv, int B, int T, int N, cudaStream_t stream) {
    if (T % kBq || T % kBk) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = cols_smem_floats<C>() * static_cast<int>(sizeof(float));
    if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = attn_bwd_cols_kernel<E, C>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(T / kBk, N, B);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const E*>(qkv), static_cast<const E*>(dout), lse, delta,
        static_cast<E*>(dqkv), T, N, 1.0f / sqrtf(static_cast<float>(C)));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C), dout (B, T, N*C), lse and delta (B, N, T) f32 in; dK and
// dV into the k and v columns of dqkv (B, T, 3*N*C). Returns the cudaError_t
// of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_cols(const void* qkv, const void* dout, const void* lse,
                                   const void* delta, void* dqkv, int B, int T, int N, int C,
                                   int is_bf16, void* stream) {
  return vdiff::dispatch<vdiff::ColsLauncher>(
      is_bf16, C, qkv, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
      dqkv, B, T, N, static_cast<cudaStream_t>(stream));
}
