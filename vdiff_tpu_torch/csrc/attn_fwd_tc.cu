// bf16 attention forward on the tensor cores, straight off the fused qkv
// projection: out = (e . v) / l with e = exp(s - max), s = q.k^T / sqrt(C).
//
// Replaces vdiff_tpu/ops/attention.py::_attn_fwd_kernel_qblk (B2: reached
// through flash_attention_qkv for T > 512 when sampling, through
// _qblk_fwd_call for the training forward at T > 512 and for head dims 32/64
// with unaligned N*C) and _attn_fwd_kernel_pack1 (B6: the head-dim 32/64
// forward off the fused qkv at any T, celeba's sampling and its training
// forward at T <= 1024), both through entry vdiff_attn_fwd_tc, for bf16
// inputs; f32 inputs stay on attn_fwd_qblk.cu (B2) and attn_fwd_online.cu
// (B6). Its lse instantiation (entry vdiff_attn_fwd_tc_lse) replaces
// _attn_fwd_kernel_pack1_lse (B7: the forward of pack1_attention_trainable_kv,
// head dim 32/64 at T = 4096) for bf16; f32 stays on attn_fwd_online.cu.
//
// Bound on the H100: per (batch, head) 4*T*T*C operations on 4*T*C bf16
// elements, T/2 operations per byte against the card's ~295 for bf16 on the
// tensor cores: compute at T = 1024, bytes at T = 256. B7 at (B, T, N, C) =
// (48, 4096, 6, 64) does 1.24 TFLOP, 1.25 ms at the bf16 peak; its lse adds
// 4.7 MB of f32 to the 0.6 GB read and written. The f32-FMA kernel it replaces
// ran at ~11 TFLOP/s, bound by shared-memory reads, with a (16, T) f32 score
// row in shared memory (one block per SM, T capped). What this design does:
//   * both products run on the tensor cores (mma.sync.m16n8k16, bf16
//     operands from ldmatrix, f32 accumulators);
//   * one block per (64-row q tile, head, batch), four warps of 16 rows; the
//     q tile stays in shared memory as bf16 and each warp re-reads its
//     fragments per k-step (at C = 256 the (16, C) f32 output alone takes 128
//     registers a thread, so q cannot also live in registers);
//   * key tiles (64 keys, 32 at C = 256) of k and v are double-buffered with
//     cp.async, 16 bytes a thread, straight from the (B, T, 3*N*C) rows;
//   * the softmax is online in f32 registers (running max and sum per row),
//     so nothing of the score row is kept and T is not capped: any T that is
//     a multiple of 32 runs, the ragged last key tile masked to -inf and the
//     rows past T read as zeros;
//   * 99 KB of shared memory at C = 256 (two blocks per SM), 85 KB at 128.
//
// Numerics: the scale 1/sqrt(C) (times log2(e), the softmax then using exp2)
// is applied to S in f32 after the product, never to the bf16 q operand; max,
// sums and the rescales are f32. The one departure from the Pallas kernel,
// which takes e . v in f32: e is rounded to bf16 as the A operand of e . v,
// which moves each output by at most 2^-9 * sum_j p_j |v_j|. The output is
// divided by the f32 row sum once and cast to bf16 once. lse (kLse) is the
// natural-log logsumexp of the scaled scores, (m + log2 l) * ln2 from the f32
// running max m and sum l of the log2 domain, written as f32 (B, N, T): the
// convention of attn_bwd_tc.cu's row kernel and attn_bwd_pack1_kv.cu. Against
// the Pallas kernel's max + log(sum) in f32 it moves f32 roundings only.

#include "attn_tc.cuh"

namespace vdiff {
namespace {

using namespace tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;  // q rows per block

template <int C>
struct FwdShape {
  static constexpr int kBk = C == 256 ? 32 : 64;  // keys per tile
  static constexpr int kTile = kBk * pitch<C>();  // elements of one k or v tile
  // q tile + two stages of (k tile, v tile), bf16
  static constexpr int kSmemBytes = (kBq * pitch<C>() + 4 * kTile) * 2;
};

template <int C, bool kLse>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                       float* __restrict__ lse, int T, int N, float scale_log2) {
  constexpr int kBk = FwdShape<C>::kBk;
  constexpr int kTile = FwdShape<C>::kTile;
  constexpr int kNc = C / 8;    // n8 tiles of a warp's output rows
  constexpr int kNk = kBk / 8;  // n8 tiles of a warp's score rows

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBq * pitch<C>();  // [2][kBk][pitch]
  bf16* v_s = k_s + 2 * kTile;         // [2][kBk][pitch]

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long stride = 3L * N * C;
  const bf16* base = qkv + (long)b * T * stride;
  const bf16* k_base = base + (long)(N + n) * C;
  const bf16* v_base = base + (long)(2 * N + n) * C;
  const int tiles = (T + kBk - 1) / kBk;
  auto fetch = [&](int j) {
    const int st = j % 2;
    load_tile<kBk, C, kThreads>(k_s + st * kTile, k_base + (long)j * kBk * stride, stride,
                                T - j * kBk);
    load_tile<kBk, C, kThreads>(v_s + st * kTile, v_base + (long)j * kBk * stride, stride,
                                T - j * kBk);
  };
  load_tile<kBq, C, kThreads>(q_s, base + (long)q0 * stride + n * C, stride, T - q0);
  fetch(0);
  cp_async_commit();

  const bf16* q_w = q_s + warp * 16 * pitch<C>();
  const int t4 = lane % 4;
  float o[kNc][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (log2 units)
  for (int j = 0; j < tiles; ++j) {
    if (j + 1 < tiles) {
      fetch(j + 1);  // into the stage the previous iteration finished with
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_t = k_s + (j % 2) * kTile;
    const bf16* v_t = v_s + (j % 2) * kTile;

    float s[kNk][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      load_a<C>(a, q_w, kk, lane);
#pragma unroll
      for (int nn = 0; nn < kBk; nn += 16) {
        uint32_t bb[4];
        load_b_nk<C>(bb, k_t, nn, kk, lane);
        mma(s[nn / 8], a, bb[0], bb[1]);
        mma(s[nn / 8 + 1], a, bb[2], bb[3]);
      }
    }

    // scale in f32, mask the keys past T, online softmax per row
    const int valid = T - j * kBk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kNk; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = i * 8 + 2 * t4 + (e & 1) < valid ? s[i][e] * scale_log2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[i][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < kNk; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = exp2f(s[i][e] - m[e / 2]);
        l[e / 2] += s[i][e];
      }
    }
#pragma unroll
    for (int i = 0; i < kNc; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // o += e . v, e rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      uint32_t a[4];
      pack_a(a, s[kk / 8], s[kk / 8 + 1]);
#pragma unroll
      for (int nn = 0; nn < C; nn += 16) {
        uint32_t bb[4];
        load_b_kn<C>(bb, v_t, kk, nn, lane);
        mma(o[nn / 8], a, bb[0], bb[1]);
        mma(o[nn / 8 + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is read by all warps before it is refilled
  }

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
#pragma unroll
  for (int i = 0; i < kNc; ++i) {
    o[i][0] /= l0;
    o[i][1] /= l0;
    o[i][2] /= l1;
    o[i][3] /= l1;
  }
  const int r0 = q0 + warp * 16;
  if constexpr (kLse) {
    const int r = r0 + lane / 4;  // rows r and r + 8; m is the same in all four lanes
    float* row = lse + ((long)b * N + n) * T;
    if (t4 == 0 && r < T) row[r] = (m[0] + log2f(l0)) * kLn2;
    if (t4 == 0 && r + 8 < T) row[r + 8] = (m[1] + log2f(l1)) * kLn2;
  }
  store_rows<kNc>(out + ((long)b * T + r0) * N * C + n * C, (long)N * C, o, T - r0, lane);
}

// lse == nullptr launches the instantiation without the lse output.
template <int C>
struct FwdLauncher {
  static int run(const void* qkv, void* out, float* lse, int B, int T, int N,
                 cudaStream_t stream) {
    if (T <= 0 || T % 32) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int bytes = FwdShape<C>::kSmemBytes;
    auto kernel = attn_fwd_tc_kernel<C, false>;
    if (lse) kernel = attn_fwd_tc_kernel<C, true>;
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + kBq - 1) / kBq, N, B);
    kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
                                              lse, T, N, kLog2e / sqrtf(static_cast<float>(C)));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C) bf16 in, out (B, T, N*C) bf16; T a multiple of 32, C in
// {32, 64, 128, 256}, both pointers 16-byte aligned. Returns the cudaError_t
// of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_fwd_tc(const void* qkv, void* out, int B, int T, int N, int C,
                                 void* stream) {
  return vdiff::tc::dispatch_head_dim<vdiff::FwdLauncher>(C, qkv, out, nullptr, B, T, N,
                                                          static_cast<cudaStream_t>(stream));
}

// The same, and each row's logsumexp of the scaled scores into lse, f32
// (B, N, T).
extern "C" int vdiff_attn_fwd_tc_lse(const void* qkv, void* out, void* lse, int B, int T, int N,
                                     int C, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return vdiff::tc::dispatch_head_dim<vdiff::FwdLauncher>(C, qkv, out, static_cast<float*>(lse),
                                                          B, T, N,
                                                          static_cast<cudaStream_t>(stream));
}
