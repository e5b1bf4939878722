// Direct-softmax attention forward for long token rows, straight off the fused
// qkv projection.
//
// Replaces vdiff_tpu/ops/attention.py::_attn_fwd_kernel_qblk (reached through
// flash_attention_qkv for T > 512 when sampling, and through
// _flash_trainable_fwd's _qblk_fwd_call for T > 512 when training). Per
// (batch, head, 16-row q tile) the block keeps the whole (16, T) f32 score row
// in shared memory and divides the (16, C) output by the row sums, the Pallas
// kernel's output-divide form. The kernel, its bound on the H100 and what its
// design does about it are in attn_direct_fwd.cuh, which it shares with the
// training forward (attn_fwd_train.cu).

#include "attn_direct_fwd.cuh"

namespace vdiff {
namespace {

template <typename E, int C>
struct QblkLauncher {
  static int run(const void* qkv, void* out, int B, int T, int N, cudaStream_t stream) {
    return direct_fwd::launch<E, C, false>(qkv, out, B, T, N, stream);
  }
};

}  // namespace
}  // namespace vdiff

// Returns the cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int vdiff_attn_fwd_qblk(const void* qkv, void* out, int B, int T, int N, int C,
                                   int is_bf16, void* stream) {
  return vdiff::dispatch<vdiff::QblkLauncher>(is_bf16, C, qkv, out, B, T, N,
                                              static_cast<cudaStream_t>(stream));
}

// Largest token count the direct-softmax forward kernels (this one and
// attn_fwd_train) take at head dim C (their score row lives in shared
// memory); 0 for an unsupported head dim.
extern "C" int vdiff_attn_fwd_qblk_max_t(int C) { return vdiff::direct_fwd::max_t(C); }
