// Attention backward, first pass (per q row): dQ, plus the row statistics the
// second pass (attn_bwd_cols.cu) needs. Works straight off the fused qkv and
// writes dQ into the q columns of one (B, T, 3*N*C) d(qkv) buffer, which the
// second pass completes with dK and dV: no split or concat copies.
//
// Replaces, together with attn_bwd_cols.cu, both Pallas backward kernels of
// flash_attention_trainable: vdiff_tpu/ops/attention.py::_attn_bwd_kernel
// (T <= 512, a whole (T, T) tile per program) and ::_attn_bwd_kernel_qblk
// (T > 512, per q block, with dK/dV carried in f32 across the sequential
// q-block grid). Both compute the same backward:
//   S = q.k^T / sqrt(C), P = softmax(S) (f32), dP = dO.v^T,
//   dS = P o (dP - rowsum(P o dP)),
//   dQ = dS.k / sqrt(C), dK = dS^T.q / sqrt(C), dV = P^T.dO,
// with P and dS rounded to the input dtype only as matmul operands and every
// product accumulated in f32.
//
// This pass: one block per (batch, head, 16-row q tile). The block keeps the
// whole (16, T) S row and dP row in shared memory (2 x 64 KiB at T = 1024):
//   pass 1: S and dP over all key tiles (k tile, then v tile, one padded
//           buffer), tracking the row max;
//   rows:   P = exp(S - max) / sum in place, delta = rowsum(P o dP),
//           dS = P o (dP - delta) in place of dP (rounded to the input dtype);
//           lse = max + log(sum) and delta go to device memory (f32, (B, N, T));
//   pass 2: dQ = dS.k / sqrt(C), each thread one column of the (16, C) tile.
// CUDA blocks cannot carry dK/dV across q tiles the way the TPU grid carries
// its VMEM accumulator, so dK/dV are left to the second pass, which owns a
// key tile and loops over all q rows: no atomics, and the result does not
// depend on the order the blocks run in.
//
// Bound on the H100: compute, 6*T*T*C FLOPs per (batch, head) here (S, dP,
// dQ) on 4*T*C elements. This first version runs f32 FMAs from shared memory
// (no tensor cores), so its ceiling is shared-memory bandwidth. What the design
// does about it: the S/dP rows never go to device memory, key rows use a
// padded pitch so the 32 lanes (one key each) read distinct banks, and q/dO
// rows are read as broadcasts. At T = 1024, C = 256 the block takes 197 KB,
// one block per SM; T is capped by the 227 KB a block may use (1280 at
// C = 256; the wrapper asks vdiff_attn_bwd_rows_max_t).

#include "attn_common.cuh"

namespace vdiff {
namespace {

constexpr int kBq = 16;  // q rows per block
constexpr int kBk = 32;  // keys per tile: one per lane
constexpr int kRowsPerWarp = kBq / kWarps;

template <int C>
int rows_smem_floats(int T) {
  return 2 * kBq * C      // q tile, dO tile
         + kBk * (C + 1)  // k tile / v tile (padded pitch)
         + 2 * kBq * T;   // S row -> P, dP row -> dS
}

int rows_max_t(int C) {
  if (C != 32 && C != 64 && C != 128 && C != 256) return 0;
  const int free_floats =
      kMaxSmemBytes / static_cast<int>(sizeof(float)) - 2 * kBq * C - kBk * (C + 1);
  return (free_floats / (2 * kBq)) / kBk * kBk;
}

template <typename E, int C>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rows_kernel(const E* __restrict__ qkv, const E* __restrict__ dout,
                         E* __restrict__ dqkv, float* __restrict__ lse,
                         float* __restrict__ delta, int T, int N, float scale) {
  constexpr int kKp = C + 1;
  constexpr int kRpt = kBq * C / kThreads;  // dQ rows owned by each thread
  static_assert(kThreads % C == 0, "each thread owns one dQ column");

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kBq * C;
  float* kv_s = do_s + kBq * C;
  float* p_s = kv_s + kBk * kKp;  // S, then P
  float* ds_s = p_s + kBq * T;    // dP, then dS

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kBq;
  const long row_stride = 3L * N * C;
  const long out_stride = static_cast<long>(N) * C;
  const E* base = qkv + (long)b * T * row_stride;
  load_rows<E, C>(q_s, C, base + (long)q0 * row_stride + n * C, row_stride, kBq, 1.f);
  load_rows<E, C>(do_s, C, dout + ((long)b * T + q0) * out_stride + n * C, out_stride, kBq, 1.f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // pass 1: S and dP; warp w owns rows w, w+8; lane j owns key k0+j
  float mx[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) mx[i] = -INFINITY;
  const float* key_row = kv_s + lane * kKp;
  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();
    load_rows<E, C>(kv_s, kKp, base + (long)k0 * row_stride + (N + n) * C, row_stride, kBk, 1.f);
    __syncthreads();
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float kv = key_row[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = fmaf(q_s[(warp + kWarps * i) * C + c], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      s[i] *= scale;
      p_s[(warp + kWarps * i) * T + k0 + lane] = s[i];
      mx[i] = fmaxf(mx[i], s[i]);
    }
    __syncthreads();
    load_rows<E, C>(kv_s, kKp, base + (long)k0 * row_stride + (2 * N + n) * C, row_stride, kBk,
                    1.f);
    __syncthreads();
    float dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dp[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float vv = key_row[c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) dp[i] = fmaf(do_s[(warp + kWarps * i) * C + c], vv, dp[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) ds_s[(warp + kWarps * i) * T + k0 + lane] = dp[i];
  }

  // per row, in f32: P, delta, dS. Lane j touches only entries j mod 32, the
  // ones it wrote itself in pass 1.
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    float* p_row = p_s + r * T;
    float* ds_row = ds_s + r * T;
    const float m = warp_max(mx[i]);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(p_row[j] - m);
      p_row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float pdp = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float p = p_row[j] / sum;
      p_row[j] = p;
      pdp = fmaf(p, ds_row[j], pdp);
    }
    const float dlt = warp_sum(pdp);
    for (int j = lane; j < T; j += 32) ds_row[j] = round_to<E>(p_row[j] * (ds_row[j] - dlt));
    if (lane == 0) {
      const long stat = ((long)b * N + n) * T + q0 + r;
      lse[stat] = m + logf(sum);
      delta[stat] = dlt;
    }
  }

  // pass 2: dQ = dS . k / sqrt(C) for this thread's column
  const int col = threadIdx.x % C;
  const int r0 = (threadIdx.x / C) * kRpt;
  float acc[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < T; k0 += kBk) {
    __syncthreads();  // dS rows written (first tile) / previous k tile consumed
    load_rows<E, C>(kv_s, kKp, base + (long)k0 * row_stride + (N + n) * C, row_stride, kBk, 1.f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      const float kv = kv_s[j * kKp + col];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) acc[i] = fmaf(ds_s[(r0 + i) * T + k0 + j], kv, acc[i]);
    }
  }
  E* dq = dqkv + ((long)b * T + q0) * row_stride + n * C + col;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) dq[(r0 + i) * row_stride] = from_f32<E>(acc[i] * scale);
}

template <typename E, int C>
struct RowsLauncher {
  static int run(const void* qkv, const void* dout, void* dqkv, float* lse, float* delta, int B,
                 int T, int N, cudaStream_t stream) {
    if (T % kBq || T % kBk) return static_cast<int>(cudaErrorInvalidValue);
    const long bytes = static_cast<long>(rows_smem_floats<C>(T)) * sizeof(float);
    if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = attn_bwd_rows_kernel<E, C>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(T / kBq, N, B);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const E*>(qkv), static_cast<const E*>(dout), static_cast<E*>(dqkv), lse,
        delta, T, N, 1.0f / sqrtf(static_cast<float>(C)));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C) and dout (B, T, N*C) in; dQ into the q columns of dqkv
// (B, T, 3*N*C); lse and delta (B, N, T) f32 out. Returns the cudaError_t of
// the launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_rows(const void* qkv, const void* dout, void* dqkv, void* lse,
                                   void* delta, int B, int T, int N, int C, int is_bf16,
                                   void* stream) {
  return vdiff::dispatch<vdiff::RowsLauncher>(
      is_bf16, C, qkv, dout, dqkv, static_cast<float*>(lse), static_cast<float*>(delta), B, T, N,
      static_cast<cudaStream_t>(stream));
}

// Largest token count the row pass takes at head dim C (its S and dP rows
// live in shared memory); 0 for an unsupported head dim.
extern "C" int vdiff_attn_bwd_rows_max_t(int C) { return vdiff::rows_max_t(C); }
