"""First look at the bf16 tensor-core attention kernels of the port on one GPU.

    python scripts/probe_torch_tc.py [--time]

Prints the GPU's name and power limit; ptxas's register, shared-memory and
spill report for attn_fwd_tc.cu and attn_bwd_tc.cu; the build time of the
kernel library; the largest error of attn_fwd_tc (B2, bf16) against the f32
twin with its limit 2^-8·|ref| + 2^-8·(P·|v|) + 1e-4, and of attn_bwd_tc (B5,
bf16) against the bf16 backward twin with chip_smoke's limit, at small and
ragged shapes (T a multiple of 32 and not of 64, every head dim) and at the
paths' shapes; then B7's and B8's bf16 calls, which run the same kernels
(attn_fwd_pack1_lse: the lse entry of attn_fwd_tc.cu, its output held to the
same limit, its lse to chip_smoke's LSE_ATOL, and its output bit for bit
equal to attn_fwd_tc's; attn_bwd_pack1), at ragged and path shapes (twins on
batch slices 0 and B-1 at T=4096). With --time, the new kernels' times beside
the f32-FMA kernels they replace on the same bf16 inputs, SDPA and the bound.
A short check before a full chip_smoke run. Needs a CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402

FWD_SHAPES = [(2, 96, 1, 64), (2, 160, 3, 32), (2, 1056, 1, 256), (2, 1024, 2, 128),
              (32, 256, 9, 64), (32, 1024, 9, 64), (64, 1024, 1, 256)]
BWD_SHAPES = [(2, 96, 2, 64), (2, 160, 1, 128), (2, 1056, 1, 256), (2, 1024, 1, 32),
              (48, 1024, 9, 64), (128, 1024, 1, 256)]
# B7 (head dims 32/64): ragged T, then the celeba train step's up_1_us
LSE_SHAPES = [(2, 96, 2, 64), (2, 160, 4, 32), (48, 4096, 6, 64)]
# B8: ragged T, then the celeba train step's three shapes
PACK1_BWD_SHAPES = [(2, 96, 2, 64), (2, 160, 4, 32), (48, 1024, 6, 64), (48, 256, 6, 64),
                    (48, 256, 12, 64)]


def ptxas_report():
    nvcc = kernels.find_nvcc()
    for src in ("attn_fwd_tc.cu", "attn_bwd_tc.cu"):
        r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
                            os.path.join(kernels.CSRC_DIR, src)], capture_output=True, text=True)
        lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln or "error" in ln]
        print(f"ptxas {src}:\n" + "\n".join(lines), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    S.phase_card()
    ptxas_report()
    t0 = time.perf_counter()
    kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, T, N, C in FWD_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        err = S._check_tc_fwd(f"attn_fwd_tc {(B, T, N, C)}", A.attn_fwd_tc(qkv, N), qkv, N)
        print(f"fwd {(B, T, N, C)}: max_abs_err {err}", flush=True)
        if args.time and T >= 256:
            rec = {"ms": S.cuda_ms(lambda: A.attn_fwd_tc(qkv, N)),
                   "fma_ms": S.cuda_ms(lambda: S.fma_fwd(qkv, N)),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N)),
                   **S._bound("fwd", B, T, N, C, torch.bfloat16)}
            print(f"fwd {(B, T, N, C)}: " + S._fmt(rec), flush=True)
    for B, T, N, C in BWD_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(torch.bfloat16)
        err = S._check_bwd(f"attn_bwd_tc {(B, T, N, C)}", A.attn_bwd_tc(qkv, g, N),
                           A.attention_qkv_bwd_reference(qkv, g, N), torch.bfloat16)
        if args.time and T >= 1024:
            rec = {"ms": S.cuda_ms(lambda: A.attn_bwd_tc(qkv, g, N), iters=10),
                   "fma_ms": S.cuda_ms(lambda: S.fma_bwd(qkv, g, N), iters=10),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N, g), iters=10),
                   **S._bound("bwd", B, T, N, C, torch.bfloat16)}
            print(f"bwd {(B, T, N, C)}: max_abs_err {err} " + S._fmt(rec), flush=True)
        del qkv, g
        torch.cuda.empty_cache()
    for B, T, N, C in LSE_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        idx = list(range(B)) if T <= 1024 else [0, B - 1]
        out, lse = A.attn_fwd_pack1_lse(qkv, N)
        err = S._check_tc_fwd(f"attn_fwd_pack1_lse {(B, T, N, C)}", out[idx], qkv[idx], N)
        lse_err = (lse[idx] - A.attention_qkv_lse_reference(qkv[idx].float(), N)[1]).abs().max().item()
        same = torch.equal(out, A.attn_fwd_tc(qkv, N))
        print(f"fwd_lse {(B, T, N, C)}: max_abs_err {err} lse_err {lse_err} "
              f"out equal to attn_fwd_tc's: {same}", flush=True)
        if lse_err > S.LSE_ATOL or not same:
            S.fail(f"attn_fwd_pack1_lse {(B, T, N, C)}: lse err {lse_err}, equal {same}")
        if args.time and T >= 1024:
            rec = {"ms": S.cuda_ms(lambda: A.attn_fwd_pack1_lse(qkv, N), iters=5),
                   "fma_ms": S.cuda_ms(lambda: S.fma_fwd_lse(qkv, N), iters=3, warmup=1),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N), iters=5),
                   **S._bound("fwd_lse", B, T, N, C, torch.bfloat16)}
            print(f"fwd_lse {(B, T, N, C)}: " + S._fmt(rec), flush=True)
        del qkv, out, lse
        torch.cuda.empty_cache()
    for B, T, N, C in PACK1_BWD_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(torch.bfloat16)
        err = S._check_bwd(f"attn_bwd_pack1 {(B, T, N, C)}", A.attn_bwd_pack1(qkv, g, N),
                           A.attention_qkv_bwd_reference(qkv, g, N), torch.bfloat16)
        if args.time and B > 2:
            rec = {"ms": S.cuda_ms(lambda: A.attn_bwd_pack1(qkv, g, N), iters=10),
                   "fma_ms": S.cuda_ms(lambda: S.fma_bwd(qkv, g, N), iters=5),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N, g), iters=10),
                   **S._bound("bwd", B, T, N, C, torch.bfloat16)}
            print(f"bwd_pack1 {(B, T, N, C)}: max_abs_err {err} " + S._fmt(rec), flush=True)
        del qkv, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
