// f32 attention backward on the tensor cores (3xTF32): d(qkv) straight off
// the fused (B, T, 3*N*C) projection, into one buffer. It serves the f32
// calls of four Pallas kernels of vdiff_tpu/ops/attention.py:
//   _attn_bwd_kernel (B4: the backward of flash_attention_trainable at
//     T <= 512), _attn_bwd_kernel_qblk (B5: the same at T > 512) and
//     _attn_bwd_kernel_pack1 (B8: the full-row backward of
//     pack1_attention_trainable, head dim 32/64) through the full-row row
//     kernel (entry vdiff_attn_bwd_tf32_rows) and the column kernel (entry
//     vdiff_attn_bwd_tf32_cols), two launches;
//   _attn_bwd_kernel_pack1_kv (B9: the backward of
//     pack1_attention_trainable_kv, head dim 32/64, the celeba train step's
//     T = 4096) through the saved-statistics row kernel and the same column
//     kernel (entry vdiff_attn_bwd_tf32_kv).
// The function is attn_bwd_tc.cu's: S = q.k^T / sqrt(C), P = softmax(S),
// dP = dO.v^T, delta = rowsum(P o dP) (the saved form: lse from B7's
// forward, delta = sum_C dO o O from its saved output), dS = P o (dP - delta),
// dQ = dS.k / sqrt(C), dK = dS^T.q / sqrt(C), dV = P^T.dO, every product
// f32-accurate and nothing rounded to a narrower type. It replaces the
// f32-FMA kernels attn_bwd_rows.cu + attn_bwd_cols.cu (B4, B5, B8) and
// attn_bwd_pack1_kv.cu (B9), which stay built as yardsticks.
//
// Bound on the H100: compute, 10*T*T*C operations per (batch, head) on 7*T*C
// f32 elements; at 165 TFLOP/s of f32-accurate work on the tensor cores
// (three TF32 products at the dense 495) that is the bound above T ~ 100. The
// FMA kernels ran at ~6 TFLOP/s, bound by shared-memory reads of two whole
// (16, T) f32 rows (T capped at 1280 at C = 256). What this design does:
//   * every product runs mma.sync.m16n8k8 on tf32 operands, three per f32
//     product (attn_tf32.cuh); hi.hi of q.k^T and dO.v^T restarts every 64
//     columns (32 at C <= 64) into an f32 total, the cross terms accumulate
//     apart, and each tile's share of dQ, dK and dV starts from zero and is
//     added to its f32 accumulator once, so no long sum runs on the tensor
//     cores' truncating adders (attn_fwd_tf32.cu's measure);
//   * fragments load as float2 pairs from f32 tiles in shared memory
//     (ldmatrix moves b16 only). The k-index of every product is permuted so
//     that one product's accumulators are the next one's A fragments with no
//     shuffle: S and dP (and S^T, dP^T) come out as the A fragments of dS.k
//     (P^T.dO, dS^T.q). A tile is read two ways: row g at columns 2t,
//     2t + 1 (the operands of q.k^T-like products) and rows 2t, 2t + 1 at
//     column 2g (the B operand of dS.k-like products). A row pitch of
//     C + 8 floats and 32-byte halves of each 64-byte column group swapped
//     in rows with bit 2 set (at<C>) put the 16 lanes of each half warp on
//     32 different banks both ways;
//   * no score row is kept, so T is not capped: any T that is a multiple of
//     32 runs, the ragged last key tile masked to -inf and rows past T read
//     as zeros. Two kernels, no atomics, so the result does not depend on
//     the order in which blocks run:
//   rows: per 64-row q tile (four warps of 16 rows), sweeps over the key
//         tiles (32 keys at C = 128, 64 at C <= 64). Full-row, two sweeps:
//         1. dP and S, keeping per row the running max m, the sum l of
//            exp(S - m) and the sum d of exp(S - m) * dP, rescaled as m grows;
//            then lse = m + log l and delta = d / l, written as f32 (B, N, T);
//         2. dP and S again, P = exp(S - lse), dS = P o (dP - delta),
//            dQ += dS.k; dQ is scaled and written once.
//         Saved statistics (B9, head dims 32/64): lse read, delta = sum_C
//         dO o O from the dO tile and the saved O (f32), written; sweep 2.
//   cols: per 64-key tile (four warps of 16 keys), one sweep over the q
//         tiles (32 rows at C = 128, 64 at C <= 64): dP^T = v.dO^T and
//         S^T = k.q^T, P^T = exp(S^T - lse), dS^T = P^T o (dP^T - delta),
//         dV += P^T.dO and dK += dS^T.q in f32 registers, written once.
//   Each block holds its own tile (q and dO, or k and v) and one tile of the
//   other side, each refilled by cp.async as soon as every warp is done with
//   it: the row kernel reads v for dP first, then k for S and dS.k, so v
//   tile j + 1 arrives during S and dS.k of tile j and k tile j + 1 during
//   dP of tile j + 1; the column kernel does the same with dO and q. 104 KB
//   of shared memory a block at C = 128, 74 KB at C = 64.
//   C = 256 (CIFAR's head): a 64-row block's own tiles alone take 135 KB, so
//         an SM holds one block; four warps of 16 rows, each with a (16, 256)
//         f32 accumulator beside 32-wide score tiles, spilled registers and
//         left one warp a scheduler (B4 2.971 ms, 7.2 TFLOP/s, no faster
//         than the FMA pair). So each 16 rows (keys) get two warps, eight a
//         block (B4 1.226 ms; scripts/probe_torch_bwd_tf32.py): in the
//         row kernel one takes S and the row statistics, the other dP, and
//         each accumulates dQ for half of the columns; in the column kernel
//         one takes S^T and dV, the other dP^T and dK. The pair swaps one
//         (16, 16) tile through shared memory (dP, then dS; P^T), and the
//         other side's tiles are 16 rows, two stages deep: 211 KB (rows) and
//         207 KB (cols) a block.
// That is 18*T*T*C operations of f32 work per (batch, head) for the
// full-row pair and 14 for the saved form, against the 10 of the bound, each
// f32 product three TF32 products on the tensor cores. Warp pairs at C <= 128
// and 32-wide tiles at C <= 64 measured 1-35% slower at the train paths'
// shapes (scripts/ablate_torch_bwd_tf32.py).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, device time
// in ms; before = the f32-FMA kernels on the same inputs, SDPA f32 forward +
// backward beside):
//   B4 (128, 256, 1, 256): rows 0.6995 + cols 0.5129 (before 1.4054 +
//      1.5803; SDPA 0.9461)
//   B5 (128, 1024, 1, 256): 10.660 + 7.737 (before 31.722 + 21.108; SDPA
//      13.407)
//   B8 (48, 1024, 6, 64): 8.124 (before 28.335; SDPA 7.952)
//   B9 (48, 4096, 6, 64): 97.60 (before 240.31; SDPA 123.41)
// Against an f64 twin the largest error is 0.34-1.46 of the FMA kernels' on
// the same inputs.
//
// Numerics: max, sums and rescales are f32 (log2 domain, the scale
// 1/sqrt(C) applied to f32 S); lse is written in natural-log units, the
// convention of attn_bwd_tc.cu, and the column kernel takes
// P^T = exp2(S^T * log2e / sqrt(C) - lse * log2e).

#include "attn_tf32.cuh"

namespace vdiff {
namespace {

using namespace tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // q rows of a row block, keys of a column block

// f32 tiles: row pitch C + 8 floats; element (r, c) at at<C>(r, c), columns
// c and c ^ 8 swapped in rows with bit 2 set (a 16-byte chunk stays whole).
template <int C>
__host__ __device__ constexpr int f32_pitch() {
  return C + 8;
}
template <int C>
__device__ __forceinline__ int at(int r, int c) {
  return r * f32_pitch<C>() + (c ^ ((r & 4) << 1));
}

// Start copying rows [0, ROWS) of a (rows, C) f32 block with row stride
// `stride` elements into a tile, NT threads; rows at or past `valid` read as
// zero.
template <int ROWS, int C, int NT = kThreads>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              long stride, int valid) {
  constexpr int kChunks = C / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const bool ok = r < valid;
    cp_async16(dst + at<C>(r, c), src + (ok ? r * stride : 0) + c, ok);
  }
}

// A lane's reads of rows g and g + 8 of a 16-row block at row0 (a multiple
// of 8) at columns kk + 2t, kk + 2t + 1: through `e` for even 8-column steps
// kk / 8, `o` for odd ones (the swizzle's column flip folded into the base).
struct RowPtr {
  const float* e;
  const float* o;
};
template <int C>
__device__ __forceinline__ RowPtr row_ptr(const float* tile, int row0, int lane) {
  const int g = lane / 4, m = (g & 4) << 1;
  const float* p = tile + (row0 + g) * f32_pitch<C>() + 2 * (lane % 4);
  return {p + m, p - m};
}
// A lane's reads of rows 2t and 2t + 1 (of each 8-row group) at columns
// 16c + 2g, 16c + 2g + 1.
template <int C>
__device__ __forceinline__ const float* col_ptr(const float* tile, int lane) {
  const int g = lane / 4, t = lane % 4;
  return tile + 2 * t * f32_pitch<C>() + ((2 * g) ^ ((t & 2) << 2));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// out[i] = a . b_i^T over the C columns, in 3xTF32: a is a warp's 16 rows,
// b_i rows 8i .. 8i + 7 of the other tile (n8 tile i), both read under the
// k-index permutation t <-> column kk + 2t, t + 4 <-> kk + 2t + 1. hi.hi
// accumulates from zero on the tensor cores (which truncate as they add) and
// is added to the f32 total every kChunk columns; the cross terms, 2^-11 of
// it, accumulate apart over all C.
template <int C, int NT>
__device__ __forceinline__ void dot_rows(float (&out)[NT][4], RowPtr a, RowPtr b) {
  constexpr int P = f32_pitch<C>(), kChunk = C <= 64 ? 32 : 64;
  float hh[NT][4] = {}, xx[NT][4] = {};
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[i][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < C; kk += 8) {
    const float* pa = ((kk / 8) % 2 ? a.o : a.e) + kk;
    const float* pb = ((kk / 8) % 2 ? b.o : b.e) + kk;
    const float2 x0 = ld2(pa), x1 = ld2(pa + 8 * P);
    uint32_t ah[4], al[4];
    split(x0.x, ah[0], al[0]);
    split(x1.x, ah[1], al[1]);
    split(x0.y, ah[2], al[2]);
    split(x1.y, ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float2 y = ld2(pb + i * 8 * P);
      mma3(hh[i], xx[i], ah, al, y.x, y.y);
    }
    if (kk % kChunk == kChunk - 8 || kk + 8 == C) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[i][e] += hh[i][e];
          hh[i][e] = 0.f;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[i][e] += xx[i][e];
  }
}

// The accumulators of NT n8 tiles, (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1) each, split into A fragments of the next product under the
// k-index permutation t <-> 2t, t + 4 <-> 2t + 1.
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&h)[NT][4], uint32_t (&l)[NT][4],
                                     const float (&x)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    split(x[i][0], h[i][0], l[i][0]);
    split(x[i][2], h[i][1], l[i][1]);
    split(x[i][1], h[i][2], l[i][2]);
    split(x[i][3], h[i][3], l[i][3]);
  }
}

// o += a . y in 3xTF32: a (16 x 8*NT) the A fragments (h, l), y the 8*NT
// rows of a tile from `pb` (col_ptr, plus the first column), NG groups of 16
// columns. The even n8 tile of column group c takes columns 16c + 2g, the
// odd one 16c + 2g + 1, so a lane's o[c] is rows g (0..3) and g + 8 (4..7)
// at columns 16c + 4t .. + 3. hi.hi and the cross terms of the tile
// accumulate apart from zero and are added to o once.
template <int C, int NG, int NT>
__device__ __forceinline__ void acc_cols(float (&o)[NG][8], const uint32_t (&h)[NT][4],
                                         const uint32_t (&l)[NT][4], const float* pb) {
  constexpr int P = f32_pitch<C>();
#pragma unroll
  for (int c = 0; c < NG; ++c) {
    float ev[4] = {}, od[4] = {}, evx[4] = {}, odx[4] = {};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float2 y0 = ld2(pb + i * 8 * P + 16 * c);
      const float2 y1 = ld2(pb + (i * 8 + 1) * P + 16 * c);
      mma3(ev, evx, h[i], l[i], y0.x, y1.x);
      mma3(od, odx, h[i], l[i], y0.y, y1.y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      o[c][4 * r + 0] += ev[2 * r] + evx[2 * r];
      o[c][4 * r + 1] += od[2 * r] + odx[2 * r];
      o[c][4 * r + 2] += ev[2 * r + 1] + evx[2 * r + 1];
      o[c][4 * r + 3] += od[2 * r + 1] + odx[2 * r + 1];
    }
  }
}

// Store o * scale (rows g, g + 8 of a warp's 16 at dst, NG groups of 16
// columns) into a (rows, stride) f32 array; rows at or past `valid` are
// skipped.
template <int NG>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst, long stride,
                                               const float (&o)[NG][8], float scale, int valid,
                                               int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + 8 * r >= valid) continue;
    float* row = dst + (g + 8 * r) * stride + 4 * t;
#pragma unroll
    for (int c = 0; c < NG; ++c) {
      *reinterpret_cast<float4*>(row + 16 * c) =
          make_float4(o[c][4 * r] * scale, o[c][4 * r + 1] * scale, o[c][4 * r + 2] * scale,
                      o[c][4 * r + 3] * scale);
    }
  }
}

// Scores of n8 tiles in the log2 domain: s * scale_log2 for keys below
// `valid` (columns 2t, 2t + 1 of tile i), -inf for the keys past T.
template <int NK>
__device__ __forceinline__ void scale_mask(float (&s)[NK][4], float scale_log2, int valid,
                                           int t4) {
#pragma unroll
  for (int i = 0; i < NK; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[i][e] = i * 8 + 2 * t4 + (e & 1) < valid ? s[i][e] * scale_log2 : -INFINITY;
    }
  }
}

// The row statistics of a lane's rows g and g + 8 (log2 units).
struct RowStats {
  // sweep 1: the running max m, the sum l of exp2(s - m) and the sum d of
  // exp2(s - m) * dP, l and d rescaled as m grows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  // then lse2 = m + log2 l and delta = d / l (or read, in the saved form)
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};

  template <int NK>
  __device__ __forceinline__ void step(const float (&s)[NK][4], const float (&dp)[NK][4]) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NK; ++i) {
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
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[i][e] - m[e / 2]);
        l[e / 2] += p;
        d[e / 2] = fmaf(p, dp[i][e], d[e / 2]);
      }
    }
  }

  // After the last key tile: lse2 and delta over the quad, written as lse
  // (natural log) and delta at stat[r] for the rows r = r0 + g (+ 8) < T.
  __device__ __forceinline__ void finish(float* __restrict__ lse, float* __restrict__ delta,
                                         long stat, int r0, int T, int lane) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = quad_sum(l[h]);
      lse2[h] = m[h] + log2f(lt);
      dlt[h] = quad_sum(d[h]) / lt;
      const int r = r0 + lane / 4 + 8 * h;
      if (lane % 4 == 0 && r < T) {
        lse[stat + r] = lse2[h] * kLn2;
        delta[stat + r] = dlt[h];
      }
    }
  }

  // s (scaled scores) becomes dS = exp2(s - lse2) * (dP - delta).
  template <int NK>
  __device__ __forceinline__ void ds(float (&s)[NK][4], const float (&dp)[NK][4]) const {
#pragma unroll
    for (int i = 0; i < NK; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = exp2f(s[i][e] - lse2[e / 2]) * (dp[i][e] - dlt[e / 2]);
    }
  }
};

template <int C>
struct RowShape {
  static constexpr int kBk = C >= 128 ? 32 : 64;  // keys per tile
  // q tile, dO tile, one k tile, one v tile
  static constexpr int kSmemBytes = (2 * kRows + 2 * kBk) * f32_pitch<C>() * 4;
};

template <int C>
struct ColShape {
  static constexpr int kBq = C >= 128 ? 32 : 64;  // q rows per step of the sweep
  // k tile, v tile, one q tile, one dO tile, lse and delta of the q tile
  static constexpr int kSmemBytes = (2 * kRows + 2 * kBq) * f32_pitch<C>() * 4 + 2 * kBq * 4;
};

// kSaved: lse is the forward's, read; delta is taken from the saved output
// `out` (B, T, N*C) and written. Otherwise both come from the first sweep and
// are written, and `out` is not read.
template <int C, bool kSaved>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_tf32_rows(const float* __restrict__ qkv, const float* __restrict__ dout,
                       float* __restrict__ dqkv, float* __restrict__ lse,
                       float* __restrict__ delta, int T, int N, float scale,
                       const float* __restrict__ out) {
  constexpr int kBk = RowShape<C>::kBk, P = f32_pitch<C>(), kNk = kBk / 8;
  constexpr int kSweeps = kSaved ? 1 : 2;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kRows * P;
  float* k_s = do_s + kRows * P;  // [kBk][P]
  float* v_s = k_s + kBk * P;     // [kBk][P]

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const long stride = 3L * N * C, out_stride = static_cast<long>(N) * C;
  const float* base = qkv + (long)b * T * stride;
  const float* k_base = base + (long)(N + n) * C;
  const float* v_base = base + (long)(2 * N + n) * C;
  const float scale_log2 = scale * kLog2e;
  const int tiles = (T + kBk - 1) / kBk, steps = kSweeps * tiles;
  // step `it` of the sweeps reads key tile it % tiles; a fetch past the last
  // step commits an empty group, which keeps the count
  auto fetch = [&](float* dst, const float* src, int it) {
    if (it < steps) {
      const int j = it % tiles;
      load_tile_f32<kBk, C>(dst, src + (long)j * kBk * stride, stride, T - j * kBk);
    }
    cp_async_commit();
  };
  load_tile_f32<kRows, C>(q_s, base + (long)q0 * stride + n * C, stride, T - q0);
  load_tile_f32<kRows, C>(do_s, dout + ((long)b * T + q0) * out_stride + n * C, out_stride,
                          T - q0);
  fetch(v_s, v_base, 0);  // one group with q and dO
  fetch(k_s, k_base, 0);

  const RowPtr q_w = row_ptr<C>(q_s, warp * 16, lane), do_w = row_ptr<C>(do_s, warp * 16, lane);
  const RowPtr k_r = row_ptr<C>(k_s, 0, lane), v_r = row_ptr<C>(v_s, 0, lane);
  const float* k_c = col_ptr<C>(k_s, lane);
  const int r0 = q0 + warp * 16;
  const long stat0 = ((long)b * N + n) * T;
  RowStats st;
  float dq[C / 16][8] = {};
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<1>();  // v tile (at it = 0 with q and dO; the k tile may be in flight)
    __syncthreads();
    if constexpr (kSaved) {
      if (it == 0) {  // the saved row statistics
        constexpr int kPart = C / 4;  // columns of a row per lane of its quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rl = warp * 16 + g + 8 * h, r = q0 + rl;
          float part = 0.f;
          if (r < T) {
            const float* o_row = out + ((long)b * T + r) * out_stride + n * C + t4 * kPart;
#pragma unroll
            for (int c = 0; c < kPart; c += 4) {
              const float4 o4 = *reinterpret_cast<const float4*>(o_row + c);
              const float4 d4 = *reinterpret_cast<const float4*>(do_s + at<C>(rl, t4 * kPart + c));
              part = fmaf(d4.x, o4.x, part);
              part = fmaf(d4.y, o4.y, part);
              part = fmaf(d4.z, o4.z, part);
              part = fmaf(d4.w, o4.w, part);
            }
          }
          st.dlt[h] = quad_sum(part);
          st.lse2[h] = r < T ? lse[stat0 + r] * kLog2e : 0.f;
          if (t4 == 0 && r < T) delta[stat0 + r] = st.dlt[h];
        }
      }
    }
    float dp[kNk][4];
    dot_rows<C, kNk>(dp, do_w, v_r);
    __syncthreads();  // every warp is done with this v tile
    fetch(v_s, v_base, it + 1);

    cp_async_wait<1>();  // k tile (the next v tile may be in flight)
    __syncthreads();
    float s[kNk][4];
    dot_rows<C, kNk>(s, q_w, k_r);
    scale_mask(s, scale_log2, T - (it % tiles) * kBk, t4);
    if (!kSaved && it < tiles) {  // sweep 1: the row statistics
      st.step(s, dp);
      if (it == tiles - 1) st.finish(lse, delta, stat0, r0, T, lane);
    } else {  // sweep 2: dS, dQ += dS . k
      st.ds(s, dp);
      uint32_t sh[kNk][4], sl[kNk][4];
      to_a(sh, sl, s);
      acc_cols<C, C / 16, kNk>(dq, sh, sl, k_c);
    }
    __syncthreads();  // every warp is done with this k tile
    fetch(k_s, k_base, it + 1);
  }
  store_rows_f32<C / 16>(dqkv + ((long)b * T + r0) * stride + n * C, stride, dq, scale, T - r0,
                        lane);
}

// One column block: dK and dV of 64 keys of one head (C <= 128).
template <int C>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_tf32_cols(const float* __restrict__ qkv, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dqkv, int T, int N, float scale) {
  constexpr int kBq = ColShape<C>::kBq, P = f32_pitch<C>(), kNq = kBq / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kRows * P;
  float* q_s = v_s + kRows * P;   // [kBq][P]
  float* do_s = q_s + kBq * P;    // [kBq][P]
  float* lse_s = do_s + kBq * P;  // [kBq]
  float* dlt_s = lse_s + kBq;     // [kBq]

  const int b = blockIdx.z, n = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const long stride = 3L * N * C, out_stride = static_cast<long>(N) * C;
  const float* base = qkv + (long)b * T * stride;
  const float* q_base = base + (long)n * C;
  const float* do_base = dout + (long)b * T * out_stride + (long)n * C;
  const long stat0 = ((long)b * N + n) * T;
  const float scale_log2 = scale * kLog2e;
  const int tiles = (T + kBq - 1) / kBq;
  auto fetch_q = [&](int i) {  // q tile i with its rows' lse and delta
    if (i < tiles) {
      const int valid = T - i * kBq;
      load_tile_f32<kBq, C>(q_s, q_base + (long)i * kBq * stride, stride, valid);
      load_floats<kThreads>(lse_s, lse + stat0 + i * kBq, kBq, valid);
      load_floats<kThreads>(dlt_s, delta + stat0 + i * kBq, kBq, valid);
    }
    cp_async_commit();
  };
  auto fetch_do = [&](int i) {
    if (i < tiles)
      load_tile_f32<kBq, C>(do_s, do_base + (long)i * kBq * out_stride, out_stride, T - i * kBq);
    cp_async_commit();
  };
  load_tile_f32<kRows, C>(k_s, base + (long)k0 * stride + (long)(N + n) * C, stride, T - k0);
  load_tile_f32<kRows, C>(v_s, base + (long)k0 * stride + (long)(2 * N + n) * C, stride, T - k0);
  fetch_do(0);  // one group with k and v
  fetch_q(0);

  const RowPtr k_w = row_ptr<C>(k_s, warp * 16, lane), v_w = row_ptr<C>(v_s, warp * 16, lane);
  const RowPtr q_r = row_ptr<C>(q_s, 0, lane), do_r = row_ptr<C>(do_s, 0, lane);
  const float* q_c = col_ptr<C>(q_s, lane);
  const float* do_c = col_ptr<C>(do_s, lane);
  float dk[C / 16][8] = {}, dv[C / 16][8] = {};
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<1>();  // the dO tile (the q tile may be in flight)
    __syncthreads();
    float dp[kNq][4], s[kNq][4];
    dot_rows<C, kNq>(dp, v_w, do_r);  // dP^T (keys x q rows)
    cp_async_wait<0>();  // the q tile
    __syncthreads();
    dot_rows<C, kNq>(s, k_w, q_r);  // S^T
    // P^T = exp(S^T - lse) and dS^T = P^T o (dP^T - delta), per q column;
    // rows past T were read as zeros (q, dO, lse, delta), so they add nothing
#pragma unroll
    for (int j = 0; j < kNq; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -lse_s[col] * kLog2e));
        dp[j][e] = s[j][e] * (dp[j][e] - dlt_s[col]);
      }
    }
    uint32_t h[kNq][4], lo[kNq][4];
    to_a(h, lo, s);
    acc_cols<C, C / 16, kNq>(dv, h, lo, do_c);  // dV += P^T . dO
    __syncthreads();  // every warp is done with this dO tile
    fetch_do(i + 1);
    to_a(h, lo, dp);
    acc_cols<C, C / 16, kNq>(dk, h, lo, q_c);  // dK += dS^T . q
    __syncthreads();  // ... and with this q tile
    fetch_q(i + 1);
  }

  const int r0 = k0 + warp * 16;
  float* dst = dqkv + ((long)b * T + r0) * stride;
  store_rows_f32<C / 16>(dst + (long)(N + n) * C, stride, dk, scale, T - r0, lane);
  store_rows_f32<C / 16>(dst + (long)(2 * N + n) * C, stride, dv, 1.f, T - r0, lane);
}

// C = 256: two warps to each 16 rows (row kernel) or 16 keys (column
// kernel) of a 64-row block, eight warps, so that no thread holds two (16, C)
// accumulators or one beside a 32-wide tile's sums, and an SM runs eight
// warps where 64-row blocks of four left it one warp a scheduler. The other
// side's tiles are 16 rows, two stages deep (the next one arrives while this
// one is used). The pair swaps a (16, 16) f32 tile through shared memory,
// in the lanes' fragment order (lane L of one warp reads what lane L of the
// other wrote). Row kernel: warp 0 of the pair takes S and the row
// statistics, warp 1 dP; dS goes to both, and each accumulates dQ for its
// half of the columns. Column kernel: warp 0 takes S^T and dV += P^T.dO,
// warp 1 dP^T and dK += dS^T.q, with P^T from warp 0.
constexpr int kPairThreads = 2 * kThreads;
// the head dims that take the warp-pair kernels (the saved-statistics form,
// head dims 32 and 64, has none)
template <int C>
constexpr bool kPairs = C == 256;

template <int C>
struct RowPairShape {
  static constexpr int kBk = 16;  // keys per tile
  static constexpr int kTile = kBk * f32_pitch<C>();
  // q tile, dO tile, 2 stages x (k tile, v tile), an exchange tile a pair
  static constexpr int kSmemBytes =
      (2 * kRows * f32_pitch<C>() + 4 * kTile + kWarps * 16 * kBk) * 4;
};

template <int C>
struct ColPairShape {
  static constexpr int kBq = 16;  // q rows per step of the sweep
  static constexpr int kTile = kBq * f32_pitch<C>();
  // k tile, v tile, 2 stages x (q tile, dO tile, lse, delta), an exchange
  // tile a pair
  static constexpr int kSmemBytes =
      (2 * kRows * f32_pitch<C>() + 4 * kTile + 4 * kBq + kWarps * 16 * kBq) * 4;
};

template <int C>
__global__ void __launch_bounds__(kPairThreads)
    attn_bwd_tf32_rows_pair(const float* __restrict__ qkv, const float* __restrict__ dout,
                            float* __restrict__ dqkv, float* __restrict__ lse,
                            float* __restrict__ delta, int T, int N, float scale) {
  using Sh = RowPairShape<C>;
  constexpr int kBk = Sh::kBk, P = f32_pitch<C>(), kNk = kBk / 8, kHalf = C / 2;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + kRows * P;
  float* k_s = do_s + kRows * P;  // [2][kBk][P]
  float* v_s = k_s + 2 * Sh::kTile;  // [2][kBk][P]
  float* x_s = v_s + 2 * Sh::kTile;  // [kWarps][16 * kBk]

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int pair = warp % kWarps, role = warp / kWarps;
  const long stride = 3L * N * C, out_stride = static_cast<long>(N) * C;
  const float* base = qkv + (long)b * T * stride;
  const float* k_base = base + (long)(N + n) * C;
  const float* v_base = base + (long)(2 * N + n) * C;
  const float scale_log2 = scale * kLog2e;
  const int tiles = (T + kBk - 1) / kBk, steps = 2 * tiles;
  // step `it` of the two sweeps reads key tile it % tiles from stage it % 2
  auto fetch = [&](int it) {
    const int j = it % tiles, st = it % 2;
    load_tile_f32<kBk, C, kPairThreads>(k_s + st * Sh::kTile, k_base + (long)j * kBk * stride,
                                        stride, T - j * kBk);
    load_tile_f32<kBk, C, kPairThreads>(v_s + st * Sh::kTile, v_base + (long)j * kBk * stride,
                                        stride, T - j * kBk);
    cp_async_commit();
  };
  load_tile_f32<kRows, C, kPairThreads>(q_s, base + (long)q0 * stride + n * C, stride, T - q0);
  load_tile_f32<kRows, C, kPairThreads>(do_s, dout + ((long)b * T + q0) * out_stride + n * C,
                                        out_stride, T - q0);
  fetch(0);  // one group with q and dO

  // warp 0 of the pair reads q against k, warp 1 dO against v
  const RowPtr a_w = row_ptr<C>(role ? do_s : q_s, pair * 16, lane);
  float* x = x_s + pair * 16 * kBk + lane;  // the pair's exchange tile, this lane's slots
  const int r0 = q0 + pair * 16;
  const long stat0 = ((long)b * N + n) * T;
  RowStats st;  // warp 0's
  float dq[kHalf / 16][8] = {};  // this warp's half of the columns
  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = k_s + (it % 2) * Sh::kTile;
    float a[kNk][4];  // warp 0: S, scaled and masked; warp 1: dP
    dot_rows<C, kNk>(a, a_w, row_ptr<C>(role ? v_s + (it % 2) * Sh::kTile : k_t, 0, lane));
    if (role) {
#pragma unroll
      for (int i = 0; i < kNk; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(i * 4 + e) * 32] = a[i][e];
      }
    } else {
      scale_mask(a, scale_log2, T - (it % tiles) * kBk, t4);
    }
    __syncthreads();  // dP is in the exchange tile
    if (!role) {
      float dp[kNk][4];
#pragma unroll
      for (int i = 0; i < kNk; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[i][e] = x[(i * 4 + e) * 32];
      }
      if (it < tiles) {  // sweep 1: the row statistics
        st.step(a, dp);
        if (it == tiles - 1) st.finish(lse, delta, stat0, r0, T, lane);
      } else {  // sweep 2: dS for both warps of the pair
        st.ds(a, dp);
#pragma unroll
        for (int i = 0; i < kNk; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[(i * 4 + e) * 32] = a[i][e];
        }
      }
    }
    if (it >= tiles) {  // sweep 2: dQ += dS . k, each warp its half of the columns
      __syncthreads();  // dS is in the exchange tile
      if (role) {
#pragma unroll
        for (int i = 0; i < kNk; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = x[(i * 4 + e) * 32];
        }
      }
      uint32_t sh[kNk][4], sl[kNk][4];
      to_a(sh, sl, a);
      acc_cols<C, kHalf / 16, kNk>(dq, sh, sl, col_ptr<C>(k_t, lane) + role * kHalf);
    }
    __syncthreads();  // this stage and the exchange tile are free
  }
  store_rows_f32<kHalf / 16>(dqkv + ((long)b * T + r0) * stride + n * C + role * kHalf, stride, dq,
                             scale, T - r0, lane);
}

template <int C>
__global__ void __launch_bounds__(kPairThreads)
    attn_bwd_tf32_cols_pair(const float* __restrict__ qkv, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dqkv, int T, int N, float scale) {
  using Sh = ColPairShape<C>;
  constexpr int kBq = Sh::kBq, P = f32_pitch<C>(), kNq = kBq / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + kRows * P;
  float* q_s = v_s + kRows * P;       // [2][kBq][P]
  float* do_s = q_s + 2 * Sh::kTile;  // [2][kBq][P]
  float* lse_s = do_s + 2 * Sh::kTile;  // [2][kBq]
  float* dlt_s = lse_s + 2 * kBq;       // [2][kBq]
  float* x_s = dlt_s + 2 * kBq;         // [kWarps][16 * kBq]

  const int b = blockIdx.z, n = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int pair = warp % kWarps, role = warp / kWarps;
  const long stride = 3L * N * C, out_stride = static_cast<long>(N) * C;
  const float* base = qkv + (long)b * T * stride;
  const float* q_base = base + (long)n * C;
  const float* do_base = dout + (long)b * T * out_stride + (long)n * C;
  const long stat0 = ((long)b * N + n) * T;
  const float scale_log2 = scale * kLog2e;
  const int tiles = (T + kBq - 1) / kBq;
  auto fetch = [&](int i) {  // q and dO tile i into stage i % 2, with lse and delta
    const int st = i % 2, valid = T - i * kBq;
    load_tile_f32<kBq, C, kPairThreads>(q_s + st * Sh::kTile, q_base + (long)i * kBq * stride,
                                        stride, valid);
    load_tile_f32<kBq, C, kPairThreads>(do_s + st * Sh::kTile,
                                        do_base + (long)i * kBq * out_stride, out_stride, valid);
    load_floats<kPairThreads>(lse_s + st * kBq, lse + stat0 + i * kBq, kBq, valid);
    load_floats<kPairThreads>(dlt_s + st * kBq, delta + stat0 + i * kBq, kBq, valid);
    cp_async_commit();
  };
  load_tile_f32<kRows, C, kPairThreads>(k_s, base + (long)k0 * stride + (long)(N + n) * C,
                                        stride, T - k0);
  load_tile_f32<kRows, C, kPairThreads>(v_s, base + (long)k0 * stride + (long)(2 * N + n) * C,
                                        stride, T - k0);
  fetch(0);  // one group with k and v

  // warp 0 of the pair reads k against q (S^T), warp 1 v against dO (dP^T)
  const RowPtr a_w = row_ptr<C>(role ? v_s : k_s, pair * 16, lane);
  float* x = x_s + pair * 16 * kBq + lane;  // the pair's exchange tile, this lane's slots
  float acc[C / 16][8] = {};  // warp 0: dV; warp 1: dK
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      fetch(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = i % 2;
    const float* q_t = q_s + st * Sh::kTile;
    const float* do_t = do_s + st * Sh::kTile;
    float a[kNq][4];  // warp 0: S^T, then P^T; warp 1: dP^T, then dS^T
    dot_rows<C, kNq>(a, a_w, row_ptr<C>(role ? do_t : q_t, 0, lane));
    if (!role) {  // P^T = exp(S^T - lse) per q column, to both warps
#pragma unroll
      for (int j = 0; j < kNq; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t4 + (e & 1);
          a[j][e] = exp2f(fmaf(a[j][e], scale_log2, -lse_s[st * kBq + col] * kLog2e));
          x[(j * 4 + e) * 32] = a[j][e];
        }
      }
    }
    __syncthreads();  // P^T is in the exchange tile
    if (role) {  // dS^T = P^T o (dP^T - delta); rows past T read as zeros add nothing
#pragma unroll
      for (int j = 0; j < kNq; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t4 + (e & 1);
          a[j][e] = x[(j * 4 + e) * 32] * (a[j][e] - dlt_s[st * kBq + col]);
        }
      }
    }
    uint32_t h[kNq][4], lo[kNq][4];
    to_a(h, lo, a);
    // warp 0: dV += P^T . dO; warp 1: dK += dS^T . q
    acc_cols<C, C / 16, kNq>(acc, h, lo, col_ptr<C>(role ? q_t : do_t, lane));
    __syncthreads();  // this stage and the exchange tile are free
  }

  const int r0 = k0 + pair * 16;
  store_rows_f32<C / 16>(dqkv + ((long)b * T + r0) * stride + (long)((role ? 1 : 2) * N + n) * C,
                         stride, acc, role ? scale : 1.f, T - r0, lane);
}

template <int C, bool kSaved>
int launch_rows(const void* qkv, const void* out, const void* dout, void* dqkv, float* lse,
                float* delta, int B, int T, int N, cudaStream_t stream) {
  if (T <= 0 || T % 32) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(C));
  const dim3 grid((T + kRows - 1) / kRows, N, B);
  const float* x = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* dx = static_cast<float*>(dqkv);
  if constexpr (kPairs<C> && !kSaved) {
    auto kernel = attn_bwd_tf32_rows_pair<C>;
    const cudaError_t err = allow_smem(kernel, RowPairShape<C>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kPairThreads, RowPairShape<C>::kSmemBytes, stream>>>(x, g, dx, lse, delta, T,
                                                                        N, scale);
  } else {
    auto kernel = attn_bwd_tf32_rows<C, kSaved>;
    const cudaError_t err = allow_smem(kernel, RowShape<C>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, RowShape<C>::kSmemBytes, stream>>>(
        x, g, dx, lse, delta, T, N, scale, static_cast<const float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_cols(const void* qkv, const void* dout, const float* lse, const float* delta,
                void* dqkv, int B, int T, int N, cudaStream_t stream) {
  if (T <= 0 || T % 32) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(C));
  const dim3 grid((T + kRows - 1) / kRows, N, B);
  const float* x = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* dx = static_cast<float*>(dqkv);
  if constexpr (kPairs<C>) {
    auto kernel = attn_bwd_tf32_cols_pair<C>;
    const cudaError_t err = allow_smem(kernel, ColPairShape<C>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kPairThreads, ColPairShape<C>::kSmemBytes, stream>>>(x, g, lse, delta, dx, T,
                                                                        N, scale);
  } else {
    auto kernel = attn_bwd_tf32_cols<C>;
    const cudaError_t err = allow_smem(kernel, ColShape<C>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, ColShape<C>::kSmemBytes, stream>>>(x, g, lse, delta, dx, T, N,
                                                                scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int C>
struct RowsLauncher {
  static int run(const void* qkv, const void* dout, void* dqkv, float* lse, float* delta, int B,
                 int T, int N, cudaStream_t stream) {
    return launch_rows<C, false>(qkv, nullptr, dout, dqkv, lse, delta, B, T, N, stream);
  }
};

template <int C>
struct ColsLauncher {
  static int run(const void* qkv, const void* dout, const float* lse, const float* delta,
                 void* dqkv, int B, int T, int N, cudaStream_t stream) {
    return launch_cols<C>(qkv, dout, lse, delta, dqkv, B, T, N, stream);
  }
};

template <int C>
int launch_kv(const void* qkv, const void* out, const void* dout, void* dqkv, float* lse,
              float* delta, int B, int T, int N, cudaStream_t stream) {
  const int err = launch_rows<C, true>(qkv, out, dout, dqkv, lse, delta, B, T, N, stream);
  if (err) return err;
  return launch_cols<C>(qkv, dout, lse, delta, dqkv, B, T, N, stream);
}

}  // namespace
}  // namespace vdiff

// The full-row row kernel: qkv (B, T, 3*N*C) and dout (B, T, N*C) f32 in; dQ
// into the q columns of dqkv (B, T, 3*N*C) f32; lse (natural log) and delta
// (B, N, T) f32 out, which vdiff_attn_bwd_tf32_cols reads. T a multiple of
// 32, C in {32, 64, 128, 256}, every pointer 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_tf32_rows(const void* qkv, const void* dout, void* dqkv, void* lse,
                                        void* delta, int B, int T, int N, int C, void* stream) {
  return vdiff::tc::dispatch_head_dim<vdiff::RowsLauncher>(
      C, qkv, dout, dqkv, static_cast<float*>(lse), static_cast<float*>(delta), B, T, N,
      static_cast<cudaStream_t>(stream));
}

// The column kernel: dK and dV into the k and v columns of dqkv from qkv,
// dout and the row statistics lse, delta (B, N, T) f32. The same shapes,
// head dims and alignment.
extern "C" int vdiff_attn_bwd_tf32_cols(const void* qkv, const void* dout, const void* lse,
                                        const void* delta, void* dqkv, int B, int T, int N, int C,
                                        void* stream) {
  return vdiff::tc::dispatch_head_dim<vdiff::ColsLauncher>(
      C, qkv, dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dqkv, B, T,
      N, static_cast<cudaStream_t>(stream));
}

// B9: qkv (B, T, 3*N*C), the forward's out (B, T, N*C) and dout (B, T, N*C)
// f32 and its lse (B, N, T) f32 (natural log) in; d(qkv) (B, T, 3*N*C) f32
// out; delta (B, N, T) f32 scratch, written by the saved-statistics row
// kernel and read by the column kernel. T a multiple of 32, C 32 or 64 (JAX's
// pack1 head dims), every pointer 16-byte aligned. Returns the first
// cudaError_t of the two launches (0 on success). Does not synchronise.
extern "C" int vdiff_attn_bwd_tf32_kv(const void* qkv, const void* out, const void* lse,
                                      const void* dout, void* dqkv, void* delta, int B, int T,
                                      int N, int C, void* stream) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(const_cast<void*>(lse));
  float* d = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return vdiff::launch_kv<32>(qkv, out, dout, dqkv, l, d, B, T, N, s);
    case 64: return vdiff::launch_kv<64>(qkv, out, dout, dqkv, l, d, B, T, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
