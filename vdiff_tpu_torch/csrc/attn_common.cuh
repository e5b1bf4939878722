// Shared pieces of the attention forward kernels: dtype conversion, warp
// reductions, the tile loader that reads one head's q/k/v columns straight out
// of the fused (B, T, 3*N*C) projection, and the launch-side helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vdiff {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;  // H100: 227 KB per block (opt-in)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy `rows` rows of C columns (row stride `row_stride` elements) into shared
// memory as f32 with row pitch `pitch`, multiplied by `scale`. Neighbouring
// threads read neighbouring columns, so each row is one coalesced read.
template <typename E, int C>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const E* __restrict__ src,
                                          long row_stride, int rows, float scale) {
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C;
    const int c = i - r * C;
    dst[r * pitch + c] = to_f32(src[r * row_stride + c]) * scale;
  }
}

// Dispatch a launcher templated on <element type, head dim> over the runtime
// dtype flag and head dim; unsupported head dims are refused.
template <template <typename, int> class Launcher, typename... Args>
int dispatch(int is_bf16, int C, Args... args) {
  switch (C) {
#define VDIFF_CASE(CC)                                                      \
  case CC:                                                                  \
    return is_bf16 ? Launcher<__nv_bfloat16, CC>::run(args...)              \
                   : Launcher<float, CC>::run(args...);
    VDIFF_CASE(32)
    VDIFF_CASE(64)
    VDIFF_CASE(128)
    VDIFF_CASE(256)
#undef VDIFF_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace vdiff
