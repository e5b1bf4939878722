// bf16 GroupNorm (+FiLM) -> SiLU -> 3x3 SAME conv (+bias, +skip) of an NHWC
// activation on the tensor cores, the normalised activation never written to
// device memory.
//
// Replaces vdiff_tpu/ops/conv3x3.py::_gn_silu_conv_kernel (B11, through
// fused_gn_silu_conv3x3) for bf16 inputs; f32 inputs stay on
// gn_silu_conv3x3.cu, whose bf16 instantiation stays there too as the FMA
// kernel this one is timed against. The function is that file's:
// y = silu(x*A + B) in f32 with the f32 coefficients of gn_common.cuh, rounded
// once to bf16; out = conv3x3(y, W) with bf16 operands and f32 accumulation,
// + bias (f32) + skip (f32), one cast. SAME pads y, not x: a tap outside the
// image is a zero operand, not silu(B). Without gamma the prologue is left
// out (a bare conv of x). Only the order of each output's f32 sum differs
// from the FMA kernel's.
//
// Bound on the H100: operations, 2*9*C_in*C_out per output pixel (0.078 ms at
// B = 64, 32x32, 256 -> 256 against 0.030 ms of bytes). The FMA kernel ran at
// ~20 TFLOP/s, bound by shared-memory reads, and applied the prologue to
// every value at each of the 9 taps. What this design does:
//   * An implicit GEMM per image, M = pixels, N = C_out, K = 9*C_in ordered
//     chunk-major: for each chunk of kCk = 32 input channels, the 9 taps.
//     A block computes an 8 x TW pixel tile (TW = 16 or 8: M = 128 or 64
//     pixels) of one image times 128 output channels with 8 warps; each
//     warp owns 32 pixels x M/2 channels of f32 accumulators in registers.
//     The host picks TW from the image's width (conv3x3.py::conv_tc_tile).
//     On the H100, 64-channel blocks ran no faster anywhere: a tie where
//     128-channel blocks leave SMs idle (B = 64 at 8x8: 128 blocks), 1.3x
//     slower at 32x32 and on celeba's 8x8 level, since each block repeats
//     the prologue for its pixels.
//   * The prologue runs once per input value and block: for each chunk the
//     block stages its halo tile, (8 + 2) x (TW + 2) pixels x 32 channels,
//     in shared memory as y = silu(x*A + B), computed in f32 and rounded
//     once to bf16, zeros outside the image. SiLU costs the SFU; per tap it
//     would set the pace (9x the work), per halo pixel it is ~1.4x the
//     tile's own pixels.
//   * The 9 taps read one-pixel-shifted windows of that tile: ldmatrix takes
//     one row address per lane, so the A fragment of a tap is a gather of
//     16 halo rows at no cost. Products are mma.sync.m16n8k16 (bf16 in, f32
//     accumulate). wgmma's shared-memory descriptors want core-matrix
//     aligned tiles, which a one-pixel shift breaks.
//   * x arrives by cp.async in a raw tile of its own, two chunks ahead
//     (chunk k + 2's copies start at chunk k's first tap), and chunk k + 1's
//     transform, raw tile -> halo tile, is spread over the first taps of
//     chunk k, one 8-channel group of each thread per tap, so SFU work
//     overlaps the tensor cores'. Staging x through registers instead held
//     12 registers a thread across the products: the 128 x 128 tile then
//     needed ~170 registers, one block an SM, and ran 0.69 ms at B = 64,
//     32x32, 256 -> 256 on the H100, each phase (prologue, weight copies,
//     products) adding its time to the others'.
//   * Weights, (9*C_in, ldw) K-major as the wrapper lays them out, arrive
//     by cp.async one (chunk, tap) step at a time, kStages steps in flight;
//     ldmatrix.trans turns their [k][n] tiles into B fragments.
//   * Halo rows are 80 bytes and weight rows 272 bytes apart, so the
//     8 rows of each ldmatrix land in 8 different bank groups.
//   * SiLU takes the SFU's exp and reciprocal (__expf, __fdividef) in f32:
//     like any f32 SiLU it may round y to the other neighbouring bf16 value
//     from the twin's, which the B11 limit's flip term covers.
//   * Epilogue: + f32 bias, + f32 skip, one cast, pairs of channels per store.
// Shared memory: 2 raw x tiles + 2 halo tiles + kStages weight tiles + the
// image's A and B (8*C_in bytes): 90 KB + 8*C_in at TW = 16, so two blocks
// share an SM (launch bounds hold a thread to 128 registers).
//
// Layout: x (B, H, W, C_in), skip and out (B, H, W, C_out), all bf16
// contiguous; w (9*C_in, ldw) bf16, ldw >= C_out a multiple of 8 (columns
// past C_out zero), 16-byte aligned; bias, gamma, beta f32; shift/scale as in
// gn_film_silu.cu; coef f32 scratch of 2*B*C_in values.

#include "attn_tc.cuh"
#include "gn_common.cuh"

namespace vdiff {
namespace {

using tc::bf16;

constexpr int kConvThreads = 256;  // 8 warps
constexpr int kCk = 32;            // input channels per K chunk
constexpr int kHp = kCk + 8;       // halo row pitch (bf16): 80 bytes
constexpr int kStages = 4;         // weight tiles in flight
constexpr int kTh = 8;             // output rows of a block

constexpr int kBn = 128;           // output channels of a block

template <int TW>
struct ConvTile {
  static constexpr int kM = kTh * TW;             // output pixels of a block
  static constexpr int kHw = TW + 2;              // halo width
  static constexpr int kHalo = (kTh + 2) * kHw;   // halo pixels
  static constexpr int kWm = kM / 32;             // warps along M: 32 pixels each
  static constexpr int kWn = 8 / kWm;             // warps along N
  static constexpr int kNt = kBn / kWn;            // channels of a warp
  static constexpr int kNj = kNt / 8;             // n8 tiles of a warp
  static constexpr int kWp = kBn + 8;              // weight row pitch (bf16)
  // 8-channel groups of a halo tile, and how many each thread owns
  static constexpr int kGroups = kHalo * (kCk / 8);
  static constexpr int kPerThread = (kGroups + kConvThreads - 1) / kConvThreads;
  static constexpr int kHaloElems = kHalo * kHp;
  static constexpr int kWTile = kCk * kWp;
  // 2 raw x tiles, 2 halo (y) tiles, kStages weight tiles, bf16
  static constexpr int kSmemBytes = (4 * kHaloElems + kStages * kWTile) * 2;
  static_assert(kM % 32 == 0 && kWm * kWn == 8 && kNj % 2 == 0, "warp layout");
  static_assert(kPerThread < 9, "a chunk's transform is spread over its first taps");
  static_assert(kCk * (kBn / 8) % kConvThreads == 0, "whole weight rows per thread");
};

// y = silu(v) = v / (1 + exp(-v)) in f32 with the SFU's exp and reciprocal
__device__ __forceinline__ float fast_silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

template <int TW, bool kGn, bool kSkip>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv3x3_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ coef_a,
                      const float* __restrict__ coef_b, const bf16* __restrict__ w, int ldw,
                      const float* __restrict__ bias, const bf16* __restrict__ skip,
                      bf16* __restrict__ out, int H, int W, int C, int CO, int vec, int pairs) {
  using Tl = ConvTile<TW>;
  constexpr int kHw = Tl::kHw, kNj = Tl::kNj, kWp = Tl::kWp, kPer = Tl::kPerThread;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* raw_s = reinterpret_cast<bf16*>(smem);        // [2][kHalo][kHp]: x of a chunk
  bf16* halo_s = raw_s + 2 * Tl::kHaloElems;           // [2][kHalo][kHp]: y of a chunk
  bf16* w_s = halo_s + 2 * Tl::kHaloElems;             // [kStages][kCk][kWp]
  float* coef_s = reinterpret_cast<float*>(w_s + kStages * Tl::kWTile);  // kGn: A, B (C each)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * kTh, x0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * kBn, b = blockIdx.z;
  const long HW = static_cast<long>(H) * W;
  const bf16* xb = x + b * HW * C;

  if constexpr (kGn) {
    for (int c = tid; c < C; c += kConvThreads) {
      coef_s[c] = coef_a[(long)b * C + c];
      coef_s[C + c] = coef_b[(long)b * C + c];
    }
  }

  const int nck = (C + kCk - 1) / kCk;
  const int steps = 9 * nck;

  // weights of step s = (chunk s / 9, tap s % 9): rows tap*C + c0 .. + kCk,
  // columns n0 .. n0 + kBn; rows past C and columns past ldw read as zero.
  // Thread tid copies the 16-byte pieces i = tid + j*256 of the tile: row
  // i / (kBn / 8), columns (i % (kBn / 8)) * 8 .. + 8.
  constexpr int kPieces = kCk * (kBn / 8) / kConvThreads;
  constexpr int kRowStep = kConvThreads / (kBn / 8);  // rows between a thread's pieces
  const int w_r = tid / (kBn / 8), w_q = (tid % (kBn / 8)) * 8;
  const bool w_col_ok = n0 + w_q < ldw;
  auto load_w = [&](int s) {
    const int ck = s / 9, tap = s - ck * 9, c0 = ck * kCk;
    bf16* dst = w_s + (s % kStages) * Tl::kWTile + w_r * kWp + w_q;
    const bf16* src = w + ((long)tap * C + c0 + w_r) * ldw + n0 + w_q;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const bool ok = w_col_ok && c0 + w_r + j * kRowStep < C;
      tc::cp_async16(dst + j * kRowStep * kWp, ok ? src + (long)j * kRowStep * ldw : w, ok);
    }
  };

  // x of chunk ck into raw tile `buf`, as the thread's own groups: group
  // g = tid + i*256 is halo pixel g / 4, channels c0 + 8*(g % 4) .. + 8;
  // zero outside the image or past C. 16-byte copies in flight (cp.async)
  // when C_in % 8 == 0 and x is aligned, element loads otherwise.
  auto load_x = [&](int ck, int buf) {
    const int c0 = ck * kCk;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int g = tid + i * kConvThreads;
      if (g >= Tl::kGroups) break;
      const int p = g / (kCk / 8), c = c0 + (g % (kCk / 8)) * 8;
      const int gy = y0 + p / kHw - 1, gx = x0 + p % kHw - 1;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
      bf16* dst = raw_s + buf * Tl::kHaloElems + p * kHp + (g % (kCk / 8)) * 8;
      const bf16* src = xb + ((long)gy * W + gx) * C + c;
      if (vec) {
        tc::cp_async16(dst, ok ? src : x, ok);
      } else {
        uint32_t u[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bf16 zero = __float2bfloat16(0.f);
          __nv_bfloat162 two = __halves2bfloat162(ok && c + 2 * j < C ? src[2 * j] : zero,
                                                  ok && c + 2 * j + 1 < C ? src[2 * j + 1] : zero);
          u[j] = *reinterpret_cast<uint32_t*>(&two);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
  };

  // the thread's group i of chunk ck from raw tile `buf` into halo tile
  // `buf`: y = silu(x*A + B) in f32, rounded once; a halo pixel outside the
  // image, or a channel past C, is 0 (SAME pads y)
  auto transform = [&](int i, int ck, int buf) {
    const int g = tid + i * kConvThreads;
    if (g >= Tl::kGroups) return;
    const int p = g / (kCk / 8), c = ck * kCk + (g % (kCk / 8)) * 8;
    const int off = buf * Tl::kHaloElems + p * kHp + (g % (kCk / 8)) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(raw_s + off);
    if constexpr (kGn) {
      const int gy = y0 + p / kHw - 1, gx = x0 + p % kHw - 1;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float a8[8], b8[8];
      if (C % 8 == 0 && c < C) {  // c .. c + 7 all exist: four 16-byte loads
        const float4* a4 = reinterpret_cast<const float4*>(coef_s + c);
        const float4* b4 = reinterpret_cast<const float4*>(coef_s + C + c);
        *reinterpret_cast<float4*>(a8) = a4[0];
        *reinterpret_cast<float4*>(a8 + 4) = a4[1];
        *reinterpret_cast<float4*>(b8) = b4[0];
        *reinterpret_cast<float4*>(b8 + 4) = b4[1];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          a8[e] = c + e < C ? coef_s[c + e] : 0.f;
          b8[e] = c + e < C ? coef_s[C + c + e] : 0.f;
        }
      }
      const __nv_bfloat162* in2 = reinterpret_cast<const __nv_bfloat162*>(&v);
      uint32_t o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(in2[j]);
        const int ca = c + 2 * j;
        const float ya = inside && ca < C ? fast_silu(fmaf(f.x, a8[2 * j], b8[2 * j])) : 0.f;
        const float yb =
            inside && ca + 1 < C ? fast_silu(fmaf(f.y, a8[2 * j + 1], b8[2 * j + 1])) : 0.f;
        o[j] = tc::pack_bf16(ya, yb);
      }
      v = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(halo_s + off) = v;
  };

  // this lane's A rows: halo pixel of output pixel row (lane % 16) of the
  // warp's first m16 tile, for tap (0, 0); its second m16 tile starts 16
  // pixels (16 / TW rows) further
  const int wm = warp % Tl::kWm, wn = warp / Tl::kWm;
  const int m_a = wm * 32 + lane % 16;
  const bf16* a_base = halo_s + ((m_a / TW) * kHw + m_a % TW) * kHp + (lane / 16) * 8;
  constexpr int kMi1 = (16 / TW) * kHw * kHp;  // second m16 tile's offset

  float acc[2][kNj][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < kNj; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  // chunks 0 and 1 of x with the first step's weights, then the next
  // kStages - 2 steps' weights, one group each
  load_x(0, 0);
  if (nck > 1) load_x(1, 1);
  load_w(0);
  tc::cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < steps) load_w(s);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<kStages - 2>();
  __syncthreads();  // coef_s and chunk 0's x are complete
#pragma unroll
  for (int i = 0; i < kPer; ++i) transform(i, 0, 0);

  int ck = 0, tap = 0;
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // step s's weights and chunk ck's halo tile are in; step s - 1 is read
    if (ck + 1 < nck) {
      // chunk ck + 1 into the other halo tile, one group of each thread per
      // tap; then chunk ck + 2's x into the raw tile chunk ck left
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (tap == i) transform(i, ck + 1, (ck + 1) & 1);
      }
      if (tap == 0 && ck + 2 < nck) load_x(ck + 2, ck & 1);
    }
    if (s + kStages - 1 < steps) load_w(s + kStages - 1);
    tc::cp_async_commit();

    const bf16* ht = a_base + (ck & 1) * Tl::kHaloElems + ((tap / 3) * kHw + tap % 3) * kHp;
    const bf16* wt = w_s + (s % kStages) * Tl::kWTile;
#pragma unroll
    for (int kk = 0; kk < kCk; kk += 16) {
      uint32_t a[2][4];
      tc::ldmatrix_x4(a[0], ht + kk);
      tc::ldmatrix_x4(a[1], ht + kMi1 + kk);
#pragma unroll
      for (int j = 0; j < kNj; j += 2) {
        uint32_t bb[4];
        tc::load_b_kn<kBn>(bb, wt, kk, wn * Tl::kNt + j * 8, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          tc::mma(acc[mi][j], a[mi], bb[0], bb[1]);
          tc::mma(acc[mi][j + 1], a[mi], bb[2], bb[3]);
        }
      }
    }
    if (++tap == 9) {
      tap = 0;
      ++ck;
    }
  }

  // epilogue: rows g, g + 8 of each m16 tile, channel pairs 2t, 2t + 1
  const int g4 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + mi * 16 + g4 + 8 * h;
      const int gy = y0 + m / TW, gx = x0 + m % TW;
      if (gy >= H || gx >= W) continue;
      const long row = (b * HW + (long)gy * W + gx) * CO;
#pragma unroll
      for (int j = 0; j < kNj; ++j) {
        const int n = n0 + wn * Tl::kNt + j * 8 + 2 * t4;
        if (n >= CO) continue;
        float v0 = acc[mi][j][2 * h] + bias[n];
        if (pairs) {  // C_out even: n + 1 < C_out, 4-byte aligned
          float v1 = acc[mi][j][2 * h + 1] + bias[n + 1];
          if constexpr (kSkip) {
            const float2 sk = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(skip + row + n));
            v0 += sk.x;
            v1 += sk.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + row + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if constexpr (kSkip) v0 += __bfloat162float(skip[row + n]);
          out[row + n] = __float2bfloat16(v0);
          if (n + 1 < CO) {
            float v1 = acc[mi][j][2 * h + 1] + bias[n + 1];
            if constexpr (kSkip) v1 += __bfloat162float(skip[row + n + 1]);
            out[row + n + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

struct ConvArgs {
  const bf16* x;
  const float* coef;
  const bf16* w;
  int ldw;
  const float* bias;
  const bf16* skip;
  bf16* out;
  int B, H, W, C, CO, vec, pairs;
};

template <int TW, bool kGn, bool kSkip>
int launch_conv_tc(const ConvArgs& a, cudaStream_t stream) {
  using Tl = ConvTile<TW>;
  const int smem = Tl::kSmemBytes + (kGn ? 2 * a.C * static_cast<int>(sizeof(float)) : 0);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_tc_kernel<TW, kGn, kSkip>;
  const cudaError_t err = tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>((a.H + kTh - 1) / kTh) * ((a.W + TW - 1) / TW);
  const dim3 grid(static_cast<unsigned>(tiles), (a.CO + kBn - 1) / kBn, a.B);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      a.x, a.coef, kGn ? a.coef + (long)a.B * a.C : nullptr, a.w, a.ldw, a.bias, a.skip, a.out,
      a.H, a.W, a.C, a.CO, a.vec, a.pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int TW>
int launch_tile(const ConvArgs& a, bool gn, cudaStream_t stream) {
  if (gn) {
    return a.skip ? launch_conv_tc<TW, true, true>(a, stream)
                  : launch_conv_tc<TW, true, false>(a, stream);
  }
  return a.skip ? launch_conv_tc<TW, false, true>(a, stream)
                : launch_conv_tc<TW, false, false>(a, stream);
}

}  // namespace
}  // namespace vdiff

// gamma == null: bare conv (beta, shift, scale, coef unused). tile_w (16 or
// 8) output columns, 8 output rows and 128 output channels a block. Returns the cudaError_t of the first launch that failed (0 on
// success), cudaErrorInvalidValue for arguments the kernels do not take.
// Does not synchronise.
extern "C" int vdiff_gn_silu_conv3x3_tc(const void* x, const void* w, int ldw, const void* bias,
                                        const void* gamma, const void* beta, const void* shift,
                                        const void* scale, int film_stride, int film_f32,
                                        const void* skip, void* out, void* coef, int B, int H,
                                        int W, int C, int CO, int G, float eps, int tile_w,
                                        void* stream) {
  using namespace vdiff;
  auto s = static_cast<cudaStream_t>(stream);
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 || B > 65535 || ldw < CO || ldw % 8 ||
      addr(w) % 16 || (CO + kBn - 1) / kBn > 65535 ||
      static_cast<long>((H + kTh - 1) / kTh) * ((W + 7) / 8) > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool gn = gamma != nullptr;
  if (gn && coef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ConvArgs a{static_cast<const bf16*>(x), static_cast<const float*>(coef),
                   static_cast<const bf16*>(w), ldw, static_cast<const float*>(bias),
                   static_cast<const bf16*>(skip), static_cast<bf16*>(out), B, H, W, C, CO,
                   C % 8 == 0 && addr(x) % 16 == 0,
                   CO % 2 == 0 && addr(out) % 4 == 0 && addr(skip) % 4 == 0};
  if (gn) {
    float* c = static_cast<float*>(coef);
    const int err = gn::launch<bf16, false>(x, gamma, beta, shift, scale, film_stride, film_f32,
                                            nullptr, c, c + (long)B * C, B, H * W, C, G, eps, 1,
                                            s);
    if (err) return err;
  }
  switch (tile_w) {
    case 16: return launch_tile<16>(a, gn, s);
    case 8: return launch_tile<8>(a, gn, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
