// GroupNorm (+FiLM) -> SiLU -> 3x3 SAME conv (+bias, +skip) of an NHWC
// activation, the normalised activation never written to device memory.
//
// Replaces vdiff_tpu/ops/conv3x3.py::_gn_silu_conv_kernel (B11, through
// fused_gn_silu_conv3x3): y = silu(x*A + B) in f32 with the f32 coefficients
// of gn_common.cuh, cast to x's type; out = conv3x3(y, W) with operands in
// x's type and f32 accumulation, + bias (f32) + skip (f32), one cast. Without
// gamma the prologue is left out (a bare conv of x).
//
// The TPU kernel keeps whole images in VMEM, so its statistics and its conv
// are one program. A block here cannot hold an image (32x32x256 bf16 is
// 512 KB against 227 KB), and statistics need the whole image before any
// output, so the entry launches two kernels: gn::kernel<E, false> leaves the
// (B, C_in) coefficients A and B, then conv3x3_kernel applies silu(x*A + B) to
// each input value as it loads it. The TPU kernel's flat roll over a block of
// images with a boundary mask, its (M, P) image-membership matmuls and its
// im2col lane concat are Mosaic devices; here a tile belongs to one image and
// a tap outside the image is a zero operand. The zero stands for y, not for x:
// SAME padding pads the normalised activation, so an outside tap contributes
// 0 and not silu(B).
//
// The conv is an implicit GEMM per image: M = H*W pixels, N = C_out,
// K = 9*C_in ordered tap-major (dy, dx, c), the order of the (9*C_in, C_out)
// weight matrix. A block computes a 64-pixel x 64-channel output tile with 256
// threads of 4x4 outputs each, walking K in chunks of 16: the next chunk's
// global loads start before the current chunk's FMAs, the prologue runs
// as a chunk is stored to shared memory, and the image's A and B sit in
// shared memory for the whole block.
//
// Bound on the H100: operations (2*9*C_in*C_out per output pixel). This first
// version runs the product as f32 FMAs on the widened operands (exact for
// bf16 values, so only the order of the f32 sum differs from a tensor-core
// product); its ceiling is shared-memory bandwidth (two 16-byte reads per 16
// FMAs), far under the tensor cores' rate. The weights (9*256*256 bf16 =
// 1.18 MB) do not fit on chip and stream in K chunks through L2. Tensor-core
// products (wgmma on bf16 tiles) come later.
//
// Layout: x (B, H, W, C_in), skip and out (B, H, W, C_out) contiguous, f32 or
// bf16; w (9*C_in, C_out) in x's type; bias, gamma, beta f32; shift/scale as
// in gn_film_silu.cu; coef f32 scratch of 2*B*C_in values.

#include "gn_common.cuh"

namespace vdiff {
namespace {

constexpr int kBm = 64;       // output pixels per block
constexpr int kBn = 64;       // output channels per block
constexpr int kBk = 16;       // K chunk
constexpr int kAp = kBm + 4;  // pitch of the A tile: rows stay 16-byte aligned
constexpr int kStaticSmem = (kBk * kAp + kBk * kBn) * 4;

template <typename E, bool kGn, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const E* __restrict__ x, const float* __restrict__ coef_a,
                   const float* __restrict__ coef_b, const E* __restrict__ w,
                   const float* __restrict__ bias, const E* __restrict__ skip,
                   E* __restrict__ out, int H, int W, int C, int CO) {
  __shared__ __align__(16) float a_s[kBk][kAp];  // [k][pixel]
  __shared__ __align__(16) float b_s[kBk][kBn];  // [k][channel]
  extern __shared__ float coef_s[];              // kGn: A then B of this image, C each

  const int tid = threadIdx.x;
  const int b = blockIdx.z, n0 = blockIdx.y * kBn, m0 = blockIdx.x * kBm;
  const int HW = H * W;
  if constexpr (kGn) {
    for (int c = tid; c < C; c += kThreads) {
      coef_s[c] = coef_a[(long)b * C + c];
      coef_s[C + c] = coef_b[(long)b * C + c];
    }
  }

  // loads of the A tile: pixel am, 4 neighbouring channels from ak0
  const int am = tid / 4, ak0 = (tid % 4) * 4;
  const int apix = m0 + am;
  const int ah = apix / W, aw = apix - ah * W;
  // loads of the B tile: K row bk, 4 neighbouring output channels from bn0
  const int bk = tid / 16, bn0 = (tid % 16) * 4;

  const int kchunks = (C + kBk - 1) / kBk;
  const int steps = 9 * kchunks;
  float a_raw[4], b_raw[4];
  int a_mask = 0;  // bit j: a_raw[j] lies inside the image and the channels

  auto load = [&](int step) {
    const int tap = step / kchunks, c0 = (step - tap * kchunks) * kBk;
    const int sh = ah + tap / 3 - 1, sw = aw + tap % 3 - 1;
    const bool inside = apix < HW && sh >= 0 && sh < H && sw >= 0 && sw < W;
    const E* src = x + ((long)b * HW + (long)sh * W + sw) * C;
    a_mask = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + ak0 + j;
      a_raw[j] = 0.f;
      if (inside && c < C) {
        a_raw[j] = to_f32(src[c]);
        a_mask |= 1 << j;
      }
    }
    const int kc = c0 + bk;
    const E* wrow = w + ((long)tap * C + kc) * CO;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + bn0 + j;
      b_raw[j] = (kc < C && n < CO) ? to_f32(wrow[n]) : 0.f;
    }
  };

  auto store = [&](int step) {
    const int c0 = (step % kchunks) * kBk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = a_raw[j];
      if constexpr (kGn) {
        if ((a_mask >> j) & 1) {  // a tap outside the image stays 0: the conv pads y
          const int c = c0 + ak0 + j;
          v = round_to<E>(gn::silu(fmaf(v, coef_s[c], coef_s[C + c])));
        }
      }
      a_s[ak0 + j][am] = v;
      b_s[bk][bn0 + j] = b_raw[j];
    }
  };

  const int ty = tid / 16, tx = tid % 16;  // outputs: pixels ty*4.., channels tx*4..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  __syncthreads();  // coef_s is complete
  for (int step = 0; step < steps; ++step) {
    store(step);
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the FMAs below
#pragma unroll
    for (int k = 0; k < kBk; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are consumed before the next store
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= HW) continue;
    const long row = ((long)b * HW + m) * CO;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= CO) continue;
      float v = acc[i][j] + bias[n];
      if constexpr (kSkip) v += to_f32(skip[row + n]);
      out[row + n] = from_f32<E>(v);
    }
  }
}

template <typename E, bool kGn, bool kSkip>
int launch_conv(const void* x, const float* coef, const void* w, const void* bias,
                const void* skip, void* out, int B, int H, int W, int C, int CO,
                cudaStream_t stream) {
  const int dyn = kGn ? 2 * C * static_cast<int>(sizeof(float)) : 0;
  if (dyn + kStaticSmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H * W + kBm - 1) / kBm, (CO + kBn - 1) / kBn, B);
  conv3x3_kernel<E, kGn, kSkip><<<grid, kThreads, dyn, stream>>>(
      static_cast<const E*>(x), coef, kGn ? coef + (long)B * C : nullptr, static_cast<const E*>(w),
      static_cast<const float*>(bias), static_cast<const E*>(skip), static_cast<E*>(out), H, W,
      C, CO);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int run(const void* x, const void* w, const void* bias, const void* gamma, const void* beta,
        const void* shift, const void* scale, int film_stride, int film_f32, const void* skip,
        void* out, float* coef, int B, int H, int W, int C, int CO, int G, float eps,
        cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || CO <= 0 || B > 65535 || (CO + kBn - 1) / kBn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (gamma == nullptr) {
    return skip ? launch_conv<E, false, true>(x, nullptr, w, bias, skip, out, B, H, W, C, CO, stream)
                : launch_conv<E, false, false>(x, nullptr, w, bias, skip, out, B, H, W, C, CO, stream);
  }
  if (coef == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int err = gn::launch<E, false>(x, gamma, beta, shift, scale, film_stride, film_f32, nullptr,
                                       coef, coef + (long)B * C, B, H * W, C, G, eps, 1, stream);
  if (err) return err;
  return skip ? launch_conv<E, true, true>(x, coef, w, bias, skip, out, B, H, W, C, CO, stream)
              : launch_conv<E, true, false>(x, coef, w, bias, skip, out, B, H, W, C, CO, stream);
}

}  // namespace
}  // namespace vdiff

// gamma == null: bare conv (beta, shift, scale, coef unused). Returns the
// cudaError_t of the first launch that failed (0 on success). Does not
// synchronise.
extern "C" int vdiff_gn_silu_conv3x3(const void* x, const void* w, const void* bias,
                                     const void* gamma, const void* beta, const void* shift,
                                     const void* scale, int film_stride, int film_f32,
                                     const void* skip, void* out, void* coef, int B, int H, int W,
                                     int C, int CO, int G, float eps, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<float*>(coef);
  if (is_bf16)
    return vdiff::run<__nv_bfloat16>(x, w, bias, gamma, beta, shift, scale, film_stride, film_f32,
                                     skip, out, c, B, H, W, C, CO, G, eps, s);
  return vdiff::run<float>(x, w, bias, gamma, beta, shift, scale, film_stride, film_f32, skip, out,
                           c, B, H, W, C, CO, G, eps, s);
}
