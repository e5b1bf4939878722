// 3xTF32 building blocks of the f32 attention kernels on the tensor cores
// (attn_fwd_tf32.cu, attn_bwd_tf32.cu): the split of an f32 operand into two
// TF32 parts and the mma.sync.m16n8k8 product on them.
//
// One TF32 product keeps ~11 significant bits, not f32's 24. Each f32 operand
// x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact
// in f32), and a product is hi.hi + hi.lo + lo.hi with f32 accumulators;
// lo.lo (~2^-22 relative) is dropped. Products of TF32 values are exact in
// f32, so each f32 product is good to ~2^-21 relative, the order of an f32
// FMA's rounding.
//
// Fragment layouts of mma.sync.aligned.m16n8k8.row.col with tf32 operands
// (lane = 4*g + t): A (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (k t, n g),
// (k t+4, n g); C/D (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma once

#include "attn_tc.cuh"

namespace vdiff {
namespace tc {

// x = hi + lo + O(2^-22 |x|): hi = x rounded to TF32, nearest with ties away
// (cvt.rna.tf32.f32, which keeps NaN and inf what they are); lo = x - hi,
// exact in f32, rounded the same way by two integer instructions, (bits +
// 2^12) & ~(2^13 - 1): cvt.rna's values (for finite x, lo is small and finite,
// so the carry never reaches the top of the exponent) at less cost than a
// second cvt on this card (scripts/ablate_torch_tf32.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ uint32_t to_tf32_small(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32_small(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores, m16n8k8, tf32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d + x += a . b in 3xTF32: hi . hi into d, the cross terms into x.
__device__ __forceinline__ void mma3(float (&d)[4], float (&x)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(x, al, h0, h1);
  mma_tf32(x, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

}  // namespace tc
}  // namespace vdiff
