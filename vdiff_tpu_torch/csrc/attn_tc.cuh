// Tensor-core building blocks of the bf16 attention kernels (attn_fwd_tc.cu,
// attn_bwd_tc.cu): asynchronous tile copies into padded shared memory,
// ldmatrix fragment loads and the bf16 mma.sync.m16n8k16 product with f32
// accumulators.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (lane = 4*g + t):
//   A (16x16, row-major) 4 regs: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//                                (g+8, 2t+8..), two bf16 each, low half first;
//   B (16x8)             2 regs: (k 2t..2t+1, n g), (k 2t+8..2t+9, n g);
//   C/D (16x8, f32)      4 regs: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
// The accumulators of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of the next product over those 16 columns (pack_a), so
// P and dS go from one product to the next in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdiff {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row pitch of a (rows, C) bf16 tile in shared memory: 16 bytes of padding
// put the 8 rows that one ldmatrix reads in 8 different bank groups.
template <int C>
__host__ __device__ constexpr int pitch() {
  return C + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without blocking; zero-filled when !valid (the
// source pointer must still be a mapped address: callers clamp it).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [0, ROWS) of a (rows, C) bf16 block with row stride
// `stride` elements into a padded tile; rows at or past `valid` read as zero.
template <int ROWS, int C, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, long stride,
                                          int valid) {
  constexpr int kChunks = C / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * pitch<C>() + c, src + (ok ? r * stride : 0) + c, ok);
  }
}

// `n` floats (a multiple of 4) into shared memory; entries at or past
// `valid` (a multiple of 4) read as zero.
template <int NT>
__device__ __forceinline__ void load_floats(float* dst, const float* __restrict__ src, int n,
                                            int valid) {
  for (int i = threadIdx.x * 4; i < n; i += NT * 4) {
    const bool ok = i < valid;
    cp_async16(dst + i, src + (ok ? i : 0), ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major tile.
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int k0, int lane) {
  ldmatrix_x4(a, tile + (lane % 16) * pitch<C>() + k0 + (lane / 16) * 8);
}

// B fragments of two n8 tiles (n0, n0 + 8) over k [k0, k0 + 16) from a tile
// stored n-major (element (k, n) at row n, column k; K for q.k^T): b[0..1]
// for n0, b[2..3] for n0 + 8.
template <int C>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * pitch<C>() + k0 + ((lane / 8) % 2) * 8);
}

// The same from a tile stored k-major (element (k, n) at row k, column n;
// V for P.v, K for dS.k): ldmatrix transposes each 8x8 block on the way.
template <int C>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile, int k0, int n0,
                                          int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * pitch<C>() + n0 +
                           (lane / 16) * 8);
}

// d += a . b on the tensor cores (bf16 operands, f32 accumulators).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (16 rows x 16 columns, bf16) from the f32 accumulators of the
// n8 tiles 2j and 2j + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Sum and max over the four lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Store rows g and g + 8 of a warp's 16-row f32 accumulator block (NC n8
// tiles) as bf16 into a (rows, stride) array; rows at or past `valid` are
// skipped.
template <int NC>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long stride,
                                           const float (&acc)[NC][4], int valid, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + r * stride + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// Run Launcher<C>::run(args...) for a head dim the kernels take.
template <template <int> class Launcher, typename... Args>
int dispatch_head_dim(int C, Args... args) {
  switch (C) {
    case 32: return Launcher<32>::run(args...);
    case 64: return Launcher<64>::run(args...);
    case 128: return Launcher<128>::run(args...);
    case 256: return Launcher<256>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Ask for the dynamic shared memory a kernel needs above 48 KB.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace tc
}  // namespace vdiff
