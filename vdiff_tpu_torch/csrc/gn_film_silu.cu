// GroupNorm (+FiLM) (+SiLU) of an NHWC activation as one kernel.
//
// Replaces vdiff_tpu/ops/groupnorm.py::_gn_kernel (B10, through
// gn_film_silu_pallas): per sample, f32 sums of x and x*x folded to groups,
// the normalisation, affine and FiLM folded into one per-channel pair (A, B)
// kept in f32, y = x*A + B and the optional SiLU in f32, one cast to x's type.
// The TPU kernel holds one whole sample in VMEM (grid (B,)); a 32x32x256 bf16
// sample is 512 KB, over the 227 KB a block may use here, and 64 blocks would
// leave half the card idle. So a block takes one sample and a run of whole
// groups about 32 channels wide (gn_common.cuh): it reads its slab once for
// the sums and once more, out of the L2 cache, to write y.
//
// Bound on the H100: bytes (x read, y written; a handful of FLOPs per
// element). What the design does about it: x is read in place from the
// channels_last activation, each warp load covers 64-128 neighbouring bytes of
// one pixel, the second read of the slab (64 KB a block at 32x32 bf16) comes
// from L2, and nothing but y goes back to device memory. Vector loads and a
// slab kept in shared memory come later.
//
// Layout: x and out (B, HW, C) contiguous, f32 or bf16; gamma/beta (C,) f32;
// shift/scale rows of C values, `film_stride` elements apart, f32 or bf16
// (the two halves of one (B, 2C) projection output), or both null.

#include "gn_common.cuh"

// Returns the cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_gn_film_silu(const void* x, const void* gamma, const void* beta,
                                  const void* shift, const void* scale, int film_stride,
                                  int film_f32, void* out, int B, int HW, int C, int G, float eps,
                                  int apply_silu, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vdiff::gn::launch<__nv_bfloat16, true>(x, gamma, beta, shift, scale, film_stride,
                                                  film_f32, out, nullptr, nullptr, B, HW, C, G,
                                                  eps, apply_silu, s);
  return vdiff::gn::launch<float, true>(x, gamma, beta, shift, scale, film_stride, film_f32, out,
                                        nullptr, nullptr, B, HW, C, G, eps, apply_silu, s);
}
