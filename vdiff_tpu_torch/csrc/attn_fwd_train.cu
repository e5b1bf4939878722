// Training attention forward for short token rows, straight off the fused qkv
// projection.
//
// Replaces vdiff_tpu/ops/attention.py::_attn_fwd_kernel (reached through
// flash_attention_trainable's _flash_trainable_fwd for T <= 512; the UNets'
// T = 64 and T = 256 attention, 17 calls per CIFAR training forward, 16 per
// celeba one) for f32 inputs; bf16 calls run the tensor-core forward,
// attn_fwd_tc.cu, and chip_smoke.py times this kernel beside it on the same
// bf16 inputs. The Pallas
// kernel takes a whole (T, T) tile for G heads per program; a (256, 256) f32
// tile is 256 KB, more than the 227 KB a block may use on the H100, so this
// kernel is q-tiled: one block per (batch, head, 16-row q tile) holds the
// whole (16, T) score row (16 KB at T = 256) in shared memory, so the softmax
// stays exact. It keeps the Pallas kernel's branch: the probabilities are
// normalised before the P.V product when C >= T (CIFAR's T = 64 and T = 256 at
// C = 256), and the (16, C) output is divided by the row sums otherwise.
//
// Bound on the H100: compute, 4*T*T*C FLOPs per (batch, head) on 4*T*C
// elements; the first version runs f32 FMAs from shared memory. The kernel
// body, and what its design does about the bound, are shared with B2 in
// attn_direct_fwd.cuh. The f32-FMA backward of the same first port is
// attn_bwd_rows.cu + attn_bwd_cols.cu.

#include "attn_direct_fwd.cuh"

namespace vdiff {
namespace {

template <typename E, int C>
struct TrainFwdLauncher {
  static int run(const void* qkv, void* out, int B, int T, int N, cudaStream_t stream) {
    return C >= T ? direct_fwd::launch<E, C, true>(qkv, out, B, T, N, stream)
                  : direct_fwd::launch<E, C, false>(qkv, out, B, T, N, stream);
  }
};

}  // namespace
}  // namespace vdiff

// Returns the cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_fwd_train(const void* qkv, void* out, int B, int T, int N, int C,
                                    int is_bf16, void* stream) {
  return vdiff::dispatch<vdiff::TrainFwdLauncher>(is_bf16, C, qkv, out, B, T, N,
                                                  static_cast<cudaStream_t>(stream));
}
