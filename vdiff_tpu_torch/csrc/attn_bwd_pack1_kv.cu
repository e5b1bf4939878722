// kv-streamed attention backward for head dims 32 and 64 at any token count,
// from the forward's saved output and logsumexp.
//
// Replaces vdiff_tpu/ops/attention.py::_attn_bwd_kernel_pack1_kv (B9, through
// _pack1_bwd_kv_call inside pack1_attention_trainable_kv: the celeba train
// step's backward at T = 4096, in up_1_us). Its math, per head:
//   delta = sum_C dO o O, from the SAVED output O in its own dtype (not
//           rowsum(P o dP), which differs from it by O's rounding in bf16);
//   per kv chunk: S = q.k^T / sqrt(C) (products on input-dtype operands,
//           scaled after), P = exp(S - lse) with lse from the forward (B7),
//           dP = dO.v^T, dS = P o (dP - delta),
//           dQ += dS.k / sqrt(C), dK = dS^T.q / sqrt(C), dV = P^T.dO,
// with P and dS rounded to the input dtype as matmul operands and every
// product accumulated in f32.
//
// No (rows, T) buffer fits at T = 4096 (a (16, T) f32 row is 256 KB, and the
// full-row backward keeps two), so both passes stream key tiles:
//   pass 1 (this file): one block per (batch, head, 32-row q tile) computes
//     delta for its rows from O and dO and writes it (f32, (B, N, T)), then
//     walks the keys in tiles of 32: S and dP (lane j = key j), P and dS in
//     f32, dS rounded and staged in shared memory, dQ += dS.k with each
//     thread one column of the (32, C) f32 accumulator; dQ is written once;
//   pass 2: attn_bwd_cols.cu, one block per 32-key tile, loops over all q
//     rows with (lse, delta), recomputes P and dS exactly as above and keeps
//     dK/dV in registers until one write.
// The TPU kernel accumulates dK/dV into VMEM blocks across its sequential
// (q-block, head) grid; CUDA blocks run in no order, so the column pass owns
// its keys instead: no atomics, and the result does not depend on block order.
// dQ, dK and dV land in their column slots of one (B, T, 3*N*C) d(qkv) buffer.
//
// Bound on the H100: compute, 6*T*T*C FLOPs per (batch, head) in this pass
// (S, dP, dQ) on 5*T*C elements. This first version runs f32 FMAs from shared
// memory (no tensor cores). What the design does about it: 32 q rows per
// block halve the k/v re-reads of a 16-row tile, k and v rows use a padded
// pitch so the 32 lanes (one key each) read distinct banks, q/dO rows and dS
// are read as broadcasts; shared memory is 37 KB at C = 64, independent of T,
// so several blocks share an SM.

#include "attn_common.cuh"

extern "C" int vdiff_attn_bwd_cols(const void* qkv, const void* dout, const void* lse,
                                   const void* delta, void* dqkv, int B, int T, int N, int C,
                                   int is_bf16, void* stream);

namespace vdiff {
namespace {

constexpr int kBq = 32;  // q rows per block
constexpr int kBk = 32;  // keys per tile: one per lane
constexpr int kRowsPerWarp = kBq / kWarps;

template <int C>
constexpr int kv_dq_smem_floats() {
  return 2 * kBq * C         // q tile, dO tile
         + 2 * kBk * (C + 1)  // k tile, v tile (padded pitch)
         + kBq * kBk          // dS tile
         + 2 * kBq;           // lse, delta of the tile's rows
}

template <typename E, int C>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_kv_dq_kernel(const E* __restrict__ qkv, const E* __restrict__ out,
                          const float* __restrict__ lse, const E* __restrict__ dout,
                          E* __restrict__ dqkv, float* __restrict__ delta, int T, int N,
                          float scale) {
  constexpr int kKp = C + 1;
  constexpr int kRpt = kBq * C / kThreads;  // dQ rows owned by each thread
  static_assert(kThreads % C == 0, "each thread owns one dQ column");

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBq * C;
  float* k_s = do_s + kBq * C;
  float* v_s = k_s + kBk * kKp;
  float* ds_s = v_s + kBk * kKp;
  float* lse_s = ds_s + kBq * kBk;
  float* dlt_s = lse_s + kBq;

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kBq;
  const long row_stride = 3L * N * C;
  const long out_stride = static_cast<long>(N) * C;
  const E* base = qkv + (long)b * T * row_stride;
  load_rows<E, C>(q_s, C, base + (long)q0 * row_stride + n * C, row_stride, kBq, 1.f);
  load_rows<E, C>(do_s, C, dout + ((long)b * T + q0) * out_stride + n * C, out_stride, kBq, 1.f);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long stat0 = ((long)b * N + n) * T + q0;
  // delta = sum_C dO o O per row: warp w owns rows w, w+8, ...; lane c reads
  // columns c, c+32 of the saved output
  const E* o_tile = out + ((long)b * T + q0) * out_stride + n * C;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    float part = 0.f;
    for (int c = lane; c < C; c += 32) part = fmaf(do_s[r * C + c], to_f32(o_tile[r * out_stride + c]), part);
    const float dlt = warp_sum(part);
    if (lane == 0) {
      dlt_s[r] = dlt;
      lse_s[r] = lse[stat0 + r];
      delta[stat0 + r] = dlt;
    }
  }

  const int col = threadIdx.x % C;
  const int r0 = (threadIdx.x / C) * kRpt;
  float acc[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;
  const float* key_row = k_s + lane * kKp;
  const float* val_row = v_s + lane * kKp;

  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();  // the previous k/v/dS tiles are fully consumed (and delta/lse written)
    load_rows<E, C>(k_s, kKp, base + (long)k0 * row_stride + (N + n) * C, row_stride, kBk, 1.f);
    load_rows<E, C>(v_s, kKp, base + (long)k0 * row_stride + (2 * N + n) * C, row_stride, kBk,
                    1.f);
    __syncthreads();

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
      ds_s[r * kBk + lane] = round_to<E>(p * (dp[i] - dlt_s[r]));
    }
    __syncthreads();

    // dQ += dS . k for this thread's column
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      const float kv = k_s[j * kKp + col];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(ds_s[(r0 + i) * kBk + j], kv, acc[i]);
    }
  }

  E* dq = dqkv + ((long)b * T + q0) * row_stride + n * C + col;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) dq[(r0 + i) * row_stride] = from_f32<E>(acc[i] * scale);
}

template <typename E, int C>
struct KvDqLauncher {
  static int run(const void* qkv, const void* out, const float* lse, const void* dout,
                 void* dqkv, float* delta, int B, int T, int N, cudaStream_t stream) {
    if (T % kBq || T % kBk) return static_cast<int>(cudaErrorInvalidValue);
    const int bytes = kv_dq_smem_floats<C>() * static_cast<int>(sizeof(float));
    if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = attn_bwd_kv_dq_kernel<E, C>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(T / kBq, N, B);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const E*>(qkv), static_cast<const E*>(out), lse, static_cast<const E*>(dout),
        static_cast<E*>(dqkv), delta, T, N, 1.0f / sqrtf(static_cast<float>(C)));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C), the forward's out (B, T, N*C) and lse (B, N, T) f32,
// dout (B, T, N*C) in; d(qkv) (B, T, 3*N*C) out; delta (B, N, T) f32 scratch
// (written by the first pass, read by the second). C = 32, 64, 128 or 256
// (the wrapper takes JAX's pack1 widths, 32 and 64), T a multiple of 32. Launches two kernels on the stream and returns the first
// cudaError_t (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_pack1_kv(const void* qkv, const void* out, const void* lse,
                                       const void* dout, void* dqkv, void* delta, int B, int T,
                                       int N, int C, int is_bf16, void* stream) {
  const int err = vdiff::dispatch<vdiff::KvDqLauncher>(
      is_bf16, C, qkv, out, static_cast<const float*>(lse), dout, dqkv,
      static_cast<float*>(delta), B, T, N, static_cast<cudaStream_t>(stream));
  if (err) return err;
  return vdiff_attn_bwd_cols(qkv, dout, lse, delta, dqkv, B, T, N, C, is_bf16, stream);
}
