// bf16 attention backward on the tensor cores: d(qkv) straight off the fused
// (B, T, 3*N*C) projection, into one buffer. Two entries:
//
// vdiff_attn_bwd_tc, from qkv and d(out) alone: replaces
// vdiff_tpu/ops/attention.py::_attn_bwd_kernel_qblk (B5: the backward of
// flash_attention_trainable at T > 512) and _attn_bwd_kernel_pack1 (B8: the
// full-row backward of pack1_attention_trainable, head dim 32/64) for bf16
// inputs; f32 inputs, and B4 (T <= 512), stay on attn_bwd_rows.cu +
// attn_bwd_cols.cu. The function kept is the Pallas kernels':
//   S = q.k^T / sqrt(C), P = softmax(S) (f32), dP = dO.v^T,
//   delta = rowsum(P o dP) over the whole row in f32,
//   dS = P o (dP - delta),
//   dQ = dS.k / sqrt(C), dK = dS^T.q / sqrt(C), dV = P^T.dO,
// with P and dS rounded to bf16 only as matmul operands and every product
// accumulated in f32.
//
// vdiff_attn_bwd_tc_kv, from qkv, d(out) and the forward's saved output O and
// lse: replaces _attn_bwd_kernel_pack1_kv (B9: the backward of
// pack1_attention_trainable_kv, head dim 32/64, the celeba train step's
// T = 4096) for bf16 inputs; f32 inputs stay on attn_bwd_pack1_kv.cu. Its
// function differs from the above in the row statistics only: lse is the
// forward's (natural log, f32 (B, N, T), as attn_fwd_tc.cu's lse entry
// writes it) and delta = sum_C dO o O from the saved bf16 O, summed in f32
// (not rowsum(P o dP), which differs from it by O's rounding).
//
// Bound on the H100: compute, 10*T*T*C operations per (batch, head) on 7*T*C
// bf16 elements. The f32-FMA kernels they replace ran at ~6 TFLOP/s, bound by
// shared-memory reads (the full-row pair kept two whole (16, T) f32 rows, S
// and dP, in shared memory: one block per SM, T capped at 1280). What this
// design does: every product runs on the tensor cores (mma.sync.m16n8k16,
// bf16 operands from ldmatrix, f32 accumulators in registers), tiles arrive
// by cp.async, and no score row is kept, so T is not capped (any multiple of
// 32; head dims 32, 64, 128, 256, and 32, 64 for the kv entry). Two kernels,
// no atomics, so the result does not depend on the order in which blocks
// run:
//   rows: per 64-row q tile (four warps of 16 rows), sweeps over the key
//         tiles (64 keys, 32 at C = 256). Full-row (kSaved = false), two:
//         1. S and dP, keeping per row the running max m, the sum l of
//            exp(S - m) and the sum d of exp(S - m) * dP, rescaled as m
//            grows (an online softmax); then lse = m + log l and
//            delta = d / l, the full-row rowsum(P o dP) in f32, both written
//            as f32 (B, N, T);
//         2. S and dP again, P = exp(S - lse), dS = P o (dP - delta) rounded
//            to bf16 in registers, dQ += dS.k; dQ is scaled and written once.
//         Saved statistics (kSaved = true), one: lse read for the block's
//         rows, delta = sum_C dO o O from the dO tile in shared memory and O
//         read once, written as f32 (B, N, T); then sweep 2 alone.
//   cols: per 64-key tile (four warps of 16 keys), one sweep over the q tiles
//         (64 rows, 32 at C >= 128): S^T and dP^T, P^T = exp(S^T - lse),
//         dS^T = P^T o (dP^T - delta), dV += P^T.dO and dK += dS^T.q in f32
//         registers, written once. At C = 256 the two (16, C) accumulators
//         would take 256 registers a thread, so each key tile has two blocks,
//         one for dK and one for dV (the dV block skips dP).
// That is 18*T*T*C operations (20 at C = 256) for the full-row entry and
// 14*T*T*C for the kv entry, against the 10 of the bound, all on the tensor
// cores. A block takes at most 102 KB of shared memory (the row kernel at
// C = 128), so two or more blocks share an SM.

#include "attn_tc.cuh"

namespace vdiff {
namespace {

using namespace tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // q rows of a row block, keys of a column block

template <int C>
struct RowShape {
  static constexpr int kBk = C == 256 ? 32 : 64;     // keys per tile
  static constexpr int kStages = C == 256 ? 1 : 2;   // k/v tiles in flight
  static constexpr int kTile = kBk * pitch<C>();
  // q tile, dO tile, kStages x (k tile, v tile), bf16
  static constexpr int kSmemBytes = (2 * kRows * pitch<C>() + 2 * kStages * kTile) * 2;
};

template <int C>
struct ColShape {
  static constexpr int kBq = C >= 128 ? 32 : 64;     // q rows per step of the sweep
  static constexpr int kStages = C == 256 ? 1 : 2;
  static constexpr int kRoles = C == 256 ? 2 : 1;    // dK and dV in separate blocks
  static constexpr int kTile = kBq * pitch<C>();
  // k tile, v tile, kStages x (q tile, dO tile, lse, delta)
  static constexpr int kSmemBytes =
      (2 * kRows * pitch<C>() + 2 * kStages * kTile) * 2 + 2 * kStages * kBq * 4;
};

// kSaved: lse is the forward's, read; delta is taken from the saved output
// `out` (B, T, N*C) and written. Otherwise both come from the first sweep and
// are written, and `out` is not read.
template <int C, bool kSaved>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_tc_rows(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, float* __restrict__ lse, float* __restrict__ delta,
                     int T, int N, float scale, const bf16* __restrict__ out) {
  using Sh = RowShape<C>;
  constexpr int kBk = Sh::kBk, kStages = Sh::kStages, kTile = Sh::kTile;
  constexpr int kNc = C / 8, kNk = kBk / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kRows * pitch<C>();
  bf16* k_s = do_s + kRows * pitch<C>();  // [kStages][kBk][pitch]
  bf16* v_s = k_s + kStages * kTile;      // [kStages][kBk][pitch]

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const long stride = 3L * N * C, out_stride = static_cast<long>(N) * C;
  const bf16* base = qkv + (long)b * T * stride;
  const bf16* k_base = base + (long)(N + n) * C;
  const bf16* v_base = base + (long)(2 * N + n) * C;
  const float scale_log2 = scale * kLog2e;
  const int tiles = (T + kBk - 1) / kBk;
  constexpr int kSweeps = kSaved ? 1 : 2;
  // step `it` of the sweeps reads key tile it % tiles from stage it % kStages
  auto fetch = [&](int it) {
    const int j = it % tiles, st = it % kStages;
    load_tile<kBk, C, kThreads>(k_s + st * kTile, k_base + (long)j * kBk * stride, stride,
                                T - j * kBk);
    load_tile<kBk, C, kThreads>(v_s + st * kTile, v_base + (long)j * kBk * stride, stride,
                                T - j * kBk);
    cp_async_commit();
  };
  load_tile<kRows, C, kThreads>(q_s, base + (long)q0 * stride + n * C, stride, T - q0);
  load_tile<kRows, C, kThreads>(do_s, dout + ((long)b * T + q0) * out_stride + n * C, out_stride,
                                T - q0);
  fetch(0);

  const bf16* q_w = q_s + warp * 16 * pitch<C>();
  const bf16* do_w = do_s + warp * 16 * pitch<C>();
  const int r0 = q0 + warp * 16;
  // per row g, g + 8: running max, sum of exp, sum of exp * dP (log2 units),
  // then lse (log2 units) and delta
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  float dq[kNc][4] = {};
  for (int it = 0; it < kSweeps * tiles; ++it) {
    if (kStages == 2 && it + 1 < kSweeps * tiles) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kSaved) {
      if (it == 0) {  // the q and dO tiles have arrived: the saved row statistics
        constexpr int kPart = C / 4;  // columns of a row per lane of its quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + lane / 4 + 8 * h;
          float part = 0.f;
          if (r < T) {
            const bf16* o_row = out + ((long)b * T + r) * out_stride + n * C + t4 * kPart;
            const bf16* do_row = do_w + (lane / 4 + 8 * h) * pitch<C>() + t4 * kPart;
#pragma unroll
            for (int c = 0; c < kPart; c += 8) {
              const uint4 o8 = *reinterpret_cast<const uint4*>(o_row + c);
              const uint4 d8 = *reinterpret_cast<const uint4*>(do_row + c);
              const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o8);
              const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d8);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float2 of = __bfloat1622float2(o2[u]), df = __bfloat1622float2(d2[u]);
                part = fmaf(df.x, of.x, part);
                part = fmaf(df.y, of.y, part);
              }
            }
          }
          dlt[h] = quad_sum(part);
          const long stat = ((long)b * N + n) * T + r;
          lse2[h] = r < T ? lse[stat] * kLog2e : 0.f;
          if (t4 == 0 && r < T) delta[stat] = dlt[h];
        }
      }
    }
    const int j = it % tiles;
    const bf16* k_t = k_s + (it % kStages) * kTile;
    const bf16* v_t = v_s + (it % kStages) * kTile;

    float s[kNk][4] = {}, dp[kNk][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4], a2[4];
      load_a<C>(a, q_w, kk, lane);
      load_a<C>(a2, do_w, kk, lane);
#pragma unroll
      for (int nn = 0; nn < kBk; nn += 16) {
        uint32_t bb[4];
        load_b_nk<C>(bb, k_t, nn, kk, lane);
        mma(s[nn / 8], a, bb[0], bb[1]);
        mma(s[nn / 8 + 1], a, bb[2], bb[3]);
        load_b_nk<C>(bb, v_t, nn, kk, lane);
        mma(dp[nn / 8], a2, bb[0], bb[1]);
        mma(dp[nn / 8 + 1], a2, bb[2], bb[3]);
      }
    }
    const int valid = T - j * kBk;
#pragma unroll
    for (int i = 0; i < kNk; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = i * 8 + 2 * t4 + (e & 1) < valid ? s[i][e] * scale_log2 : -INFINITY;
      }
    }

    if (!kSaved && it < tiles) {  // sweep 1: the row statistics
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kNk; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[i][e]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        const float alpha = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha;
        d[h] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < kNk; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[i][e] - m[e / 2]);
          l[e / 2] += p;
          d[e / 2] = fmaf(p, dp[i][e], d[e / 2]);
        }
      }
      if (it == tiles - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float lt = quad_sum(l[h]);
          lse2[h] = m[h] + log2f(lt);
          dlt[h] = quad_sum(d[h]) / lt;
          const int r = r0 + lane / 4 + 8 * h;
          if (t4 == 0 && r < T) {
            const long stat = ((long)b * N + n) * T + r;
            lse[stat] = lse2[h] * kLn2;
            delta[stat] = dlt[h];
          }
        }
      }
    } else {  // sweep 2: dS, dQ += dS . k
#pragma unroll
      for (int kk = 0; kk < kBk; kk += 16) {
        float ds[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = kk / 8 + u;
            ds[u][e] = exp2f(s[i][e] - lse2[e / 2]) * (dp[i][e] - dlt[e / 2]);
          }
        }
        uint32_t a[4];
        pack_a(a, ds[0], ds[1]);
#pragma unroll
        for (int nn = 0; nn < C; nn += 16) {
          uint32_t bb[4];
          load_b_kn<C>(bb, k_t, kk, nn, lane);
          mma(dq[nn / 8], a, bb[0], bb[1]);
          mma(dq[nn / 8 + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is read by all warps before it is refilled
    if (kStages == 1 && it + 1 < kSweeps * tiles) fetch(it + 1);
  }

#pragma unroll
  for (int i = 0; i < kNc; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] *= scale;
  }
  store_rows<kNc>(dqkv + ((long)b * T + r0) * stride + n * C, stride, dq, T - r0, lane);
}

// One column block: dK (kDoK) and/or dV (kDoV) of 64 keys of one head.
template <int C, bool kDoK, bool kDoV>
__device__ __forceinline__ void cols_block(const bf16* __restrict__ qkv,
                                           const bf16* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           bf16* __restrict__ dqkv, int T, int N, int n,
                                           float scale, unsigned char* smem) {
  using Sh = ColShape<C>;
  constexpr int kBq = Sh::kBq, kStages = Sh::kStages, kTile = Sh::kTile;
  constexpr int kNc = C / 8, kNq = kBq / 8;

  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kRows * pitch<C>();
  bf16* q_s = v_s + kRows * pitch<C>();  // [kStages][kBq][pitch]
  bf16* do_s = q_s + kStages * kTile;    // [kStages][kBq][pitch]
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * kTile);  // [kStages][kBq]
  float* dlt_s = lse_s + kStages * kBq;                            // [kStages][kBq]

  const int b = blockIdx.z, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const long stride = 3L * N * C, out_stride = static_cast<long>(N) * C;
  const bf16* base = qkv + (long)b * T * stride;
  const bf16* q_base = base + (long)n * C;
  const bf16* do_base = dout + (long)b * T * out_stride + (long)n * C;
  const long stat0 = ((long)b * N + n) * T;
  const float scale_log2 = scale * kLog2e;
  const int tiles = (T + kBq - 1) / kBq;
  auto fetch = [&](int i) {
    const int st = i % kStages, valid = T - i * kBq;
    load_tile<kBq, C, kThreads>(q_s + st * kTile, q_base + (long)i * kBq * stride, stride, valid);
    load_tile<kBq, C, kThreads>(do_s + st * kTile, do_base + (long)i * kBq * out_stride,
                                out_stride, valid);
    load_floats<kThreads>(lse_s + st * kBq, lse + stat0 + i * kBq, kBq, valid);
    load_floats<kThreads>(dlt_s + st * kBq, delta + stat0 + i * kBq, kBq, valid);
    cp_async_commit();
  };
  load_tile<kRows, C, kThreads>(k_s, base + (long)k0 * stride + (long)(N + n) * C, stride,
                                T - k0);
  if constexpr (kDoK) {
    load_tile<kRows, C, kThreads>(v_s, base + (long)k0 * stride + (long)(2 * N + n) * C, stride,
                                  T - k0);
  }
  fetch(0);

  const bf16* k_w = k_s + warp * 16 * pitch<C>();
  const bf16* v_w = v_s + warp * 16 * pitch<C>();
  float dk[kDoK ? kNc : 1][4] = {}, dv[kDoV ? kNc : 1][4] = {};
  for (int i = 0; i < tiles; ++i) {
    if (kStages == 2 && i + 1 < tiles) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = i % kStages;
    const bf16* q_t = q_s + st * kTile;
    const bf16* do_t = do_s + st * kTile;
    const float* lse_t = lse_s + st * kBq;
    const float* dlt_t = dlt_s + st * kBq;

    // S^T (keys x q rows) and dP^T on the tensor cores
    float s[kNq][4] = {}, dp[kDoK ? kNq : 1][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4], a2[4];
      load_a<C>(a, k_w, kk, lane);
      if constexpr (kDoK) load_a<C>(a2, v_w, kk, lane);
#pragma unroll
      for (int nn = 0; nn < kBq; nn += 16) {
        uint32_t bb[4];
        load_b_nk<C>(bb, q_t, nn, kk, lane);
        mma(s[nn / 8], a, bb[0], bb[1]);
        mma(s[nn / 8 + 1], a, bb[2], bb[3]);
        if constexpr (kDoK) {
          load_b_nk<C>(bb, do_t, nn, kk, lane);
          mma(dp[nn / 8], a2, bb[0], bb[1]);
          mma(dp[nn / 8 + 1], a2, bb[2], bb[3]);
        }
      }
    }
    // P^T = exp(S^T - lse) and dS^T = P^T o (dP^T - delta), per q column;
    // rows past T were read as zeros (q, dO, lse, delta), so they add nothing
#pragma unroll
    for (int j = 0; j < kNq; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -lse_t[col] * kLog2e));
        if constexpr (kDoK) dp[j][e] = s[j][e] * (dp[j][e] - dlt_t[col]);
      }
    }
    // dV += P^T . dO, dK += dS^T . q, with P and dS rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kBq; kk += 16) {
      uint32_t ap[4], ads[4];
      if constexpr (kDoV) pack_a(ap, s[kk / 8], s[kk / 8 + 1]);
      if constexpr (kDoK) pack_a(ads, dp[kk / 8], dp[kk / 8 + 1]);
#pragma unroll
      for (int nn = 0; nn < C; nn += 16) {
        uint32_t bb[4];
        if constexpr (kDoV) {
          load_b_kn<C>(bb, do_t, kk, nn, lane);
          mma(dv[nn / 8], ap, bb[0], bb[1]);
          mma(dv[nn / 8 + 1], ap, bb[2], bb[3]);
        }
        if constexpr (kDoK) {
          load_b_kn<C>(bb, q_t, kk, nn, lane);
          mma(dk[nn / 8], ads, bb[0], bb[1]);
          mma(dk[nn / 8 + 1], ads, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is read by all warps before it is refilled
    if (kStages == 1 && i + 1 < tiles) fetch(i + 1);
  }

  const int r0 = k0 + warp * 16;
  bf16* dst = dqkv + ((long)b * T + r0) * stride;
  if constexpr (kDoK) {
#pragma unroll
    for (int i = 0; i < kNc; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][e] *= scale;
    }
    store_rows<kNc>(dst + (long)(N + n) * C, stride, dk, T - r0, lane);
  }
  if constexpr (kDoV) store_rows<kNc>(dst + (long)(2 * N + n) * C, stride, dv, T - r0, lane);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_tc_cols(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dqkv, int T, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRoles = ColShape<C>::kRoles;
  const int n = blockIdx.y / kRoles;
  if constexpr (kRoles == 1) {
    cols_block<C, true, true>(qkv, dout, lse, delta, dqkv, T, N, n, scale, smem);
  } else if (blockIdx.y % kRoles == 0) {
    cols_block<C, true, false>(qkv, dout, lse, delta, dqkv, T, N, n, scale, smem);
  } else {
    cols_block<C, false, true>(qkv, dout, lse, delta, dqkv, T, N, n, scale, smem);
  }
}

// The row kernel (full-row, or from the saved statistics and `out`), then
// the column kernel on the (lse, delta) it leaves.
template <int C, bool kSaved>
int launch_bwd(const void* qkv, const void* out, const void* dout, void* dqkv, float* lse,
               float* delta, int B, int T, int N, cudaStream_t stream) {
  if (T <= 0 || T % 32) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(C));
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(out);
  const bf16* g = static_cast<const bf16*>(dout);
  bf16* dx = static_cast<bf16*>(dqkv);
  const dim3 grid_rows((T + kRows - 1) / kRows, N, B);
  const dim3 grid_cols((T + kRows - 1) / kRows, N * ColShape<C>::kRoles, B);

  auto rows = attn_bwd_tc_rows<C, kSaved>;
  cudaError_t err = allow_smem(rows, RowShape<C>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rows<<<grid_rows, kThreads, RowShape<C>::kSmemBytes, stream>>>(x, g, dx, lse, delta, T, N,
                                                                 scale, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto cols = attn_bwd_tc_cols<C>;
  err = allow_smem(cols, ColShape<C>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cols<<<grid_cols, kThreads, ColShape<C>::kSmemBytes, stream>>>(x, g, lse, delta, dx, T, N,
                                                                 scale);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
struct BwdLauncher {
  static int run(const void* qkv, const void* dout, void* dqkv, float* lse, float* delta, int B,
                 int T, int N, cudaStream_t stream) {
    return launch_bwd<C, false>(qkv, nullptr, dout, dqkv, lse, delta, B, T, N, stream);
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C) and dout (B, T, N*C) bf16 in; d(qkv) (B, T, 3*N*C) bf16
// out; lse and delta (B, N, T) f32 scratch, written by the row kernel and read
// by the column kernel. T a multiple of 32, C in {32, 64, 128, 256}, every
// pointer 16-byte aligned. Returns the first cudaError_t of the two launches
// (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_tc(const void* qkv, const void* dout, void* dqkv, void* lse,
                                 void* delta, int B, int T, int N, int C, void* stream) {
  return vdiff::tc::dispatch_head_dim<vdiff::BwdLauncher>(
      C, qkv, dout, dqkv, static_cast<float*>(lse), static_cast<float*>(delta), B, T, N,
      static_cast<cudaStream_t>(stream));
}

// qkv (B, T, 3*N*C), the forward's out (B, T, N*C) and dout (B, T, N*C) bf16
// and its lse (B, N, T) f32 (natural log) in; d(qkv) (B, T, 3*N*C) bf16 out;
// delta (B, N, T) f32 scratch, written by the row kernel and read by the
// column kernel. T a multiple of 32, C 32 or 64 (JAX's pack1 head dims),
// every pointer 16-byte aligned. Returns the first cudaError_t of the two
// launches (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_tc_kv(const void* qkv, const void* out, const void* lse,
                                    const void* dout, void* dqkv, void* delta, int B, int T,
                                    int N, int C, void* stream) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(const_cast<void*>(lse));
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return vdiff::launch_bwd<32, true>(qkv, out, dout, dqkv, l, d, B, T, N, s);
    case 64: return vdiff::launch_bwd<64, true>(qkv, out, dout, dqkv, l, d, B, T, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
