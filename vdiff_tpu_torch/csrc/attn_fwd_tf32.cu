// f32 attention forward on the tensor cores (3xTF32), straight off the fused
// qkv projection: out = (e . v) / l with e = exp(s - max), s = q.k^T / sqrt(C).
//
// One kernel serves five Pallas kernels of vdiff_tpu/ops/attention.py for
// f32 inputs, each through its own wrapper and launch counter:
//   _flash_kernel (B1: flash_attention_qkv at T <= 512, the eval CLI's nll
//     at T = 256 and T = 64), _attn_fwd_kernel_qblk (B2: T > 512, the nll's
//     T = 1024 call), _attn_fwd_kernel (B3: flash_attention_trainable's
//     forward at T <= 512, the quality gate's f32 train stage) and
//     _attn_fwd_kernel_pack1 (B6: head dims 32/64, celeba's nll) through
//     entry vdiff_attn_fwd_tc_f32;
//   _attn_fwd_kernel_pack1_lse (B7: the forward of
//     pack1_attention_trainable_kv) through the lse instantiation (entry
//     vdiff_attn_fwd_tc_f32_lse).
// All five compute softmax(q.k^T / sqrt(C)).v; B3's branch that normalises P
// before P.v, B2's direct softmax and B1's online rescale move roundings
// only: the kernel divides the output once. It replaces the f32-FMA bodies
// attn_direct_fwd.cuh (B2, B3) and attn_fwd_online.cu (B1, B6, B7), which
// stay built as yardsticks.
//
// 3xTF32 (attn_tf32.cuh): each f32 operand split into two TF32 parts, hi
// and lo, three products per f32 product with f32 accumulators, good to
// ~2^-21 relative, the order of an f32 FMA's rounding. The tensor cores
// truncate as they add, so
// no large sum runs long on them: the cross terms accumulate apart from
// hi.hi in both products, q.k^T's hi.hi restarts every 64 columns (32 at
// C <= 64) into an f32 total, and each key tile's e.v starts from zero and is
// added to the output with one f32 FMA. Against an f64 twin the largest error
// is 0.3-1.1 of the f32-FMA kernels' on the same inputs (33 f32 checks of
// chip_smoke.py), 1.3-1.6 of it at C = 256 with q.k^T summed whole on the
// tensor cores (scripts/probe_torch_tf32.py,
// scripts/ablate_torch_tf32.py).
//
// Bound on the H100: per (batch, head) 4*T*T*C f32 operations on 4*T*C f32
// elements (16*T*C bytes), T/4 operations per byte. At three TF32 products
// per f32 product the tensor cores give 495 / 3 = 165 TFLOP/s of f32-accurate
// work (the FMA units 67): compute bound above T ~ 200 (49 operations a
// byte), bytes at T = 64. The f32-FMA kernels it replaces ran at ~11
// TFLOP/s, bound by shared-memory reads. What this design does:
//   * both products run mma.sync.m16n8k8 with tf32 operands and f32
//     accumulators, three per f32 product;
//   * one block per (q tile, head, batch), one warp per 16 q rows; the q
//     tile stays in shared memory as f32 and each warp splits its fragments
//     per k-step (at C = 256 the (16, C) f32 output alone takes 128 registers
//     a thread, so q cannot live in registers; a q tile split once into hi
//     and lo in shared memory measured slower at 64 rows and does not fit
//     beside k and v at 128);
//   * fragments load as float2 pairs with ld.shared (ldmatrix moves b16
//     only): the k-index of both products is permuted so that a lane's two
//     A or B values are neighbours in memory (q.k^T: k-index t <-> column
//     2t, t + 4 <-> 2t + 1; e.v: k-index t <-> key 2t, t + 4 <-> key
//     2t + 1, which makes the q.k^T accumulators the e.v A fragments with no
//     shuffle), and e.v's two n8 tiles of a 16-column group take the even and
//     odd columns, so a lane's output is 4 neighbouring columns (one float4
//     store). Row pitches C + 8 floats (q, k) and C + 4 (v) put the lanes of
//     each half warp on 32 different banks;
//   * one k and one v tile (32 keys at C >= 128, 64 at C <= 64) arrive by
//     cp.async, 16 bytes a thread, straight from the (B, T, 3*N*C) rows; each
//     is refilled as soon as every warp is done with it (k tile j + 1 during
//     the softmax and e.v of tile j, v tile j + 1 during q.k^T of tile
//     j + 1), which leaves room for 128-row q tiles at C = 256;
//   * the softmax is online in f32 registers (running max and sum per row,
//     the scale 1/sqrt(C) on f32 S), so nothing of the score row is kept and
//     T is not capped: any T that is a multiple of 32 runs, the ragged last
//     key tile masked to -inf and the rows past T read as zeros.
// Tile budget (shared memory at q tiles of 128 / 64 rows): C = 256: 198 /
// 132 KB; C = 128: 102 / 68 KB; C = 64: 71 / 53 KB; C = 32: 39 / 29 KB. At
// C >= 64 a thread takes 255 registers, so an SM holds one 8-warp block or
// two 4-warp blocks. The caller picks the q tile (kWarps = 8 or 4) from (B, T,
// N) (ops/attention.py::fwd_tf32_q_rows: 128 rows where T > 64 and the grid
// still fills the card, else 64); it moves no result. A 32-row tile was
// within 4% of the better of these at every path shape and is not built. The
// lse instantiation runs 64-row tiles at head dims 32 and 64 only (B7's).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/probe_torch_tf32.py
// --time, device time in ms; before = the f32-FMA kernel, SDPA f32 beside):
//   B2 (64, 1024, 1, 256), 128 rows: 1.718 (64 rows 2.492; before 6.426;
//      SDPA 1.668)
//   B1 (64, 256, 1, 256), 128 rows:  0.1267 (0.4541; SDPA 0.1354)
//   B1 (64, 64, 1, 256), 64 rows:    0.0283 (0.0393; SDPA 0.0182)
//   B3 (128, 256, 1, 256), 128 rows: 0.2556 (0.7639; SDPA 0.2206)
//   B6 (1, 4096, 6, 64), 128 rows:   0.7736 (1.5869; SDPA 0.7922)
// Where the time goes (scripts/ablate_torch_tf32.py, B2 at 128 rows): 1.6725
// as built, 0.7412 with one TF32 product (the mma.sync instructions are most
// of it), 1.1012 without the splits, 1.8831 with lo rounded by a second
// cvt.rna, 1.4205 with hi rounded by the integer form too (kept on cvt.rna,
// which leaves NaN and inf as they are).
//
// Numerics: max, sums and rescales are f32; the output is divided by the f32
// row sum once. lse (kLse) is the natural-log logsumexp of the scaled
// scores, (m + log2 l) * ln2 from the running max m and sum l of the log2
// domain, written as f32 (B, N, T), the convention of attn_fwd_tc.cu.

#include "attn_tf32.cuh"

namespace vdiff {
namespace {

using namespace tc;

// Row pitches (floats) of the f32 tiles. q and k are read as float2 at
// (row g, column 2t): a pitch of 8 mod 32 banks; v as float2 at (row 2t,
// column 2g): 4 mod 32.
template <int C>
__host__ __device__ constexpr int qk_pitch() {
  return C + 8;
}
template <int C>
__host__ __device__ constexpr int v_pitch() {
  return C + 4;
}

template <int C, int kWarps>
struct Tf32Shape {
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBq = 16 * kWarps;        // q rows per block
  static constexpr int kBk = C >= 128 ? 32 : 64;  // keys per tile
  static constexpr int kKTile = kBk * qk_pitch<C>();
  static constexpr int kVTile = kBk * v_pitch<C>();
  // q tile + one k tile + one v tile, f32
  static constexpr int kSmemBytes = (kBq * qk_pitch<C>() + kKTile + kVTile) * 4;
};

// Start copying rows [0, ROWS) of a (rows, C) f32 block with row stride
// `stride` elements into a tile of row pitch PITCH; rows at or past `valid`
// read as zero.
template <int ROWS, int C, int PITCH, int NT>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              long stride, int valid) {
  constexpr int kChunks = C / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i - r * kChunks) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * PITCH + c, src + (ok ? r * stride : 0) + c, ok);
  }
}

template <int C, bool kLse, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
    attn_fwd_tf32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                         float* __restrict__ lse, int T, int N, float scale_log2) {
  using S = Tf32Shape<C, kWarps>;
  constexpr int kThreads = S::kThreads, kBq = S::kBq, kBk = S::kBk;
  constexpr int kQp = qk_pitch<C>(), kVp = v_pitch<C>();
  constexpr int kNg = C / 16;   // 16-column groups of a warp's output rows
  constexpr int kNk = kBk / 8;  // n8 tiles of a warp's score rows
  constexpr int kChunk = C <= 64 ? 32 : 64;  // columns of q . k^T's hi . hi sums

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kBq * kQp;  // [kBk][kQp]
  float* v_s = k_s + S::kKTile;   // [kBk][kVp]

  const int b = blockIdx.z, n = blockIdx.y, q0 = blockIdx.x * kBq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long stride = 3L * N * C;
  const float* base = qkv + (long)b * T * stride;
  const float* k_base = base + (long)(N + n) * C;
  const float* v_base = base + (long)(2 * N + n) * C;
  const int tiles = (T + kBk - 1) / kBk;
  auto fetch_k = [&](int j) {
    if (j < tiles)
      load_tile_f32<kBk, C, kQp, kThreads>(k_s, k_base + (long)j * kBk * stride, stride,
                                           T - j * kBk);
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  auto fetch_v = [&](int j) {
    if (j < tiles)
      load_tile_f32<kBk, C, kVp, kThreads>(v_s, v_base + (long)j * kBk * stride, stride,
                                           T - j * kBk);
    cp_async_commit();
  };
  load_tile_f32<kBq, C, kQp, kThreads>(q_s, base + (long)q0 * stride + n * C, stride, T - q0);
  fetch_k(0);  // one group with q
  fetch_v(0);

  // this lane's rows g and g + 8 of the warp's 16, from column 2 * t4
  const float* q_w = q_s + (warp * 16 + g) * kQp + 2 * t4;
  const float* k_t = k_s + g * kQp + 2 * t4;
  const float* v_t = v_s + 2 * t4 * kVp + 2 * g;
  // o[c][0..3]: row g, columns 16c + 4t4 .. 16c + 4t4 + 3; o[c][4..7]: row g + 8
  float o[kNg][8] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8 (log2 units)
  // one k and one v tile, each refilled as soon as every warp is done with
  // it: k tile j + 1 arrives during the softmax and e . v of tile j, v tile
  // j + 1 during q . k^T of tile j + 1
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // k tile j (v tile j may be in flight)
    __syncthreads();

    // s = q . k^T: k-index t4 <-> column kk + 2t4, t4 + 4 <-> kk + 2t4 + 1.
    // hi . hi of each kChunk columns accumulates from zero on the tensor
    // cores (which truncate as they add) and is added to the f32 total st,
    // so no truncating sum runs over more than kChunk / 8 k-steps; the cross
    // terms, 2^-11 of it, accumulate apart over all C
    float st[kNk][4] = {}, sh[kNk][4] = {}, sl[kNk][4] = {};
#pragma unroll
    for (int kk = 0; kk < C; kk += 8) {
      const float2 x0 = *reinterpret_cast<const float2*>(q_w + kk);
      const float2 x1 = *reinterpret_cast<const float2*>(q_w + 8 * kQp + kk);
      uint32_t ah[4], al[4];
      split(x0.x, ah[0], al[0]);
      split(x1.x, ah[1], al[1]);
      split(x0.y, ah[2], al[2]);
      split(x1.y, ah[3], al[3]);
#pragma unroll
      for (int i = 0; i < kNk; ++i) {
        const float2 y = *reinterpret_cast<const float2*>(k_t + i * 8 * kQp + kk);
        mma3(sh[i], sl[i], ah, al, y.x, y.y);
      }
      if (kk % kChunk == kChunk - 8 || kk + 8 == C) {
#pragma unroll
        for (int i = 0; i < kNk; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[i][e] += sh[i][e];
            sh[i][e] = 0.f;
          }
        }
      }
    }

    __syncthreads();  // every warp is done with k tile j
    fetch_k(j + 1);

    // scale in f32, mask the keys past T, online softmax per row
    const int valid = T - j * kBk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kNk; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[i][e] = i * 8 + 2 * t4 + (e & 1) < valid ? (st[i][e] + sl[i][e]) * scale_log2
                                                    : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], st[i][e]);
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
    // e, split into A fragments of e . v: key tile i's accumulators (g, 2t4),
    // (g, 2t4 + 1), (g + 8, 2t4), (g + 8, 2t4 + 1) are A's (g, t4), (g, t4 + 4),
    // (g + 8, t4), (g + 8, t4 + 4) under k-index t4 <-> key 2t4
    uint32_t ph[kNk][4], pl[kNk][4];
#pragma unroll
    for (int i = 0; i < kNk; ++i) {
      float e4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        e4[e] = exp2f(st[i][e] - m[e / 2]);
        l[e / 2] += e4[e];
      }
      split(e4[0], ph[i][0], pl[i][0]);
      split(e4[2], ph[i][1], pl[i][1]);
      split(e4[1], ph[i][2], pl[i][2]);
      split(e4[3], ph[i][3], pl[i][3]);
    }

    cp_async_wait<1>();  // v tile j (k tile j + 1 may be in flight)
    __syncthreads();
    // o = o * alpha + e . v; the even n8 tile of column group c takes columns
    // 16c + 2g, the odd one 16c + 2g + 1. hi . hi and the cross terms of the
    // tile accumulate apart from zero, so the tensor cores' accumulation
    // rounds the large sum 4 times a 32-key tile, not 12
#pragma unroll
    for (int c = 0; c < kNg; ++c) {
      float ev[4] = {}, od[4] = {}, evx[4] = {}, odx[4] = {};
#pragma unroll
      for (int i = 0; i < kNk; ++i) {
        const float2 y0 = *reinterpret_cast<const float2*>(v_t + i * 8 * kVp + 16 * c);
        const float2 y1 = *reinterpret_cast<const float2*>(v_t + (i * 8 + 1) * kVp + 16 * c);
        mma3(ev, evx, ph[i], pl[i], y0.x, y1.x);
        mma3(od, odx, ph[i], pl[i], y0.y, y1.y);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[c][4 * h + 0] = fmaf(o[c][4 * h + 0], alpha[h], ev[2 * h] + evx[2 * h]);
        o[c][4 * h + 1] = fmaf(o[c][4 * h + 1], alpha[h], od[2 * h] + odx[2 * h]);
        o[c][4 * h + 2] = fmaf(o[c][4 * h + 2], alpha[h], ev[2 * h + 1] + evx[2 * h + 1]);
        o[c][4 * h + 3] = fmaf(o[c][4 * h + 3], alpha[h], od[2 * h + 1] + odx[2 * h + 1]);
      }
    }
    __syncthreads();  // every warp is done with v tile j
    fetch_v(j + 1);
  }

  const float lh[2] = {quad_sum(l[0]), quad_sum(l[1])};
  const int r0 = q0 + warp * 16;
  if constexpr (kLse) {
    const int r = r0 + g;  // rows r and r + 8; m is the same in all four lanes
    float* row = lse + ((long)b * N + n) * T;
    if (t4 == 0 && r < T) row[r] = (m[0] + log2f(lh[0])) * kLn2;
    if (t4 == 0 && r + 8 < T) row[r + 8] = (m[1] + log2f(lh[1])) * kLn2;
  }
  const long ostride = (long)N * C;
  float* dst = out + ((long)b * T + r0) * ostride + n * C + 4 * t4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= T - r0) continue;
#pragma unroll
    for (int c = 0; c < kNg; ++c) {
      *reinterpret_cast<float4*>(dst + r * ostride + 16 * c) =
          make_float4(o[c][4 * h] / lh[h], o[c][4 * h + 1] / lh[h], o[c][4 * h + 2] / lh[h],
                      o[c][4 * h + 3] / lh[h]);
    }
  }
}

// lse == nullptr launches the instantiation without the lse output; q_rows
// (64 or 128) picks the q tile, 64 only with lse, which is built for B7's
// head dims 32 and 64 only.
template <int C>
struct Tf32Launcher {
  template <int kWarps>
  static int launch(const void* qkv, void* out, float* lse, int B, int T, int N,
                    cudaStream_t stream) {
    using S = Tf32Shape<C, kWarps>;
    auto kernel = attn_fwd_tf32_kernel<C, false, kWarps>;
    if constexpr (kWarps == 4 && C <= 64) {
      if (lse) kernel = attn_fwd_tf32_kernel<C, true, kWarps>;
    } else if (lse) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = allow_smem(kernel, S::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + S::kBq - 1) / S::kBq, N, B);
    kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), lse, T, N,
        kLog2e / sqrtf(static_cast<float>(C)));
    return static_cast<int>(cudaGetLastError());
  }

  static int run(const void* qkv, void* out, float* lse, int B, int T, int N, int q_rows,
                 cudaStream_t stream) {
    if (T <= 0 || T % 32) return static_cast<int>(cudaErrorInvalidValue);
    switch (q_rows) {
      case 128: return launch<8>(qkv, out, lse, B, T, N, stream);
      case 64: return launch<4>(qkv, out, lse, B, T, N, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

}  // namespace
}  // namespace vdiff

// qkv (B, T, 3*N*C) f32 in, out (B, T, N*C) f32; T a multiple of 32, C in
// {32, 64, 128, 256}, q_rows 64 or 128 (the q tile; it moves no result),
// both pointers 16-byte aligned. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
extern "C" int vdiff_attn_fwd_tc_f32(const void* qkv, void* out, int B, int T, int N, int C,
                                     int q_rows, void* stream) {
  return vdiff::tc::dispatch_head_dim<vdiff::Tf32Launcher>(C, qkv, out, nullptr, B, T, N, q_rows,
                                                           static_cast<cudaStream_t>(stream));
}

// The same at 64-row q tiles, and each row's logsumexp of the scaled scores
// into lse, f32 (B, N, T); C in {32, 64} (B7's head dims).
extern "C" int vdiff_attn_fwd_tc_f32_lse(const void* qkv, void* out, void* lse, int B, int T,
                                         int N, int C, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return vdiff::tc::dispatch_head_dim<vdiff::Tf32Launcher>(C, qkv, out, static_cast<float*>(lse),
                                                           B, T, N, 64,
                                                           static_cast<cudaStream_t>(stream));
}
