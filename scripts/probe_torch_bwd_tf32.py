"""First look at the f32 (3xTF32) tensor-core attention backward of the port,
``csrc/attn_bwd_tf32.cu``, on one GPU.

    python scripts/probe_torch_bwd_tf32.py [--time]

Prints the GPU's name and power limit; ptxas's register, shared-memory and
spill report for attn_bwd_tf32.cu; the build time of the kernel library;
then, for f32 calls of B4/B5 (attn_bwd), B8 (attn_bwd_pack1) and B9
(attn_bwd_pack1_kv, on B7's own out and lse) at ragged shapes (T a multiple
of 32 and not of 64, every head dim) and at the train paths' shapes,
chip_smoke's two checks: per d(qkv) slot within 1e-4 of max|ref| of the f32
twin, and against an f64 twin within twice the largest error of the f32-FMA
kernels the call ran before, on the same inputs (at T=4096 on batch slices
0, 1, B-2, B-1). With --time, each call's time beside the FMA kernels', SDPA's
f32 forward + backward (TF32 off) and the bound at 165 TFLOP/s, and for
attn_bwd the row and column kernels alone beside the FMA row and column
passes. A short check before a full chip_smoke run. Needs a CUDA device.
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

# (wrapper, B, T, N, C): ragged T and odd batches first (RAGGED of them,
# untimed), then the paths' shapes
RAGGED = 8
SHAPES = [
    ("attn_bwd", 2, 96, 2, 32), ("attn_bwd", 2, 160, 2, 64), ("attn_bwd", 3, 96, 1, 128),
    ("attn_bwd", 2, 96, 1, 256), ("attn_bwd", 1, 544, 3, 32), ("attn_bwd_pack1", 2, 96, 2, 64),
    ("attn_bwd_pack1_kv", 2, 160, 2, 64), ("attn_bwd_pack1_kv", 2, 96, 4, 32),
    ("attn_bwd", 128, 256, 1, 256), ("attn_bwd", 128, 64, 1, 256),     # B4, CIFAR train
    ("attn_bwd", 128, 1024, 1, 256),                                   # B5
    ("attn_bwd", 128, 256, 1, 128), ("attn_bwd", 128, 1024, 1, 128),   # mnist
    ("attn_bwd_pack1", 48, 1024, 6, 64), ("attn_bwd_pack1", 48, 256, 6, 64),  # B8, celeba
    ("attn_bwd_pack1", 48, 256, 12, 64), ("attn_bwd", 48, 1024, 9, 64),
    ("attn_bwd_pack1_kv", 48, 4096, 6, 64),                            # B9
]


def ptxas_report():
    r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                        os.devnull, os.path.join(kernels.CSRC_DIR, "attn_bwd_tf32.cu")],
                       capture_output=True, text=True)
    lines = [ln for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln or "error" in ln]
    print("ptxas attn_bwd_tf32.cu:\n" + "\n".join(lines), flush=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)


def case(name, B, T, N, C, gen, timed):
    tag = f"{name} B={B} T={T} N={N} C={C} f32"
    qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen)
    g = torch.randn(B, T, N * C, device="cuda", generator=gen)
    idx = list(range(B)) if T <= S.TWIN_FULL_BATCH_MAX_T else [0, 1, B - 2, B - 1]
    if name == "attn_bwd_pack1_kv":
        out, lse = A.attn_fwd_pack1_lse(qkv, N)
        fn = lambda: A.attn_bwd_pack1_kv(qkv, out, lse, g, N)
        fma = lambda: S.fma_bwd_kv(qkv, out, lse, g, N)
        ref = A.attention_qkv_bwd_kv_reference(qkv[idx], out[idx], lse[idx], g[idx], N)
        kind = "bwd_kv"
    else:
        fn = lambda: getattr(A, name)(qkv, g, N)
        fma = lambda: S.fma_bwd(qkv, g, N)
        ref = A.attention_qkv_bwd_reference(qkv[idx], g[idx], N)
        kind = "bwd"
    errs = S._check_f32_bwd(tag, fn()[idx], ref, qkv[idx], g[idx], N, fma()[idx])
    del ref
    torch.cuda.empty_cache()
    if not timed:
        return
    rec = {"ms": S.cuda_ms(fn, iters=5, warmup=2), "before_ms": S.cuda_ms(fma, iters=5, warmup=2),
           "library_ms": S.cuda_ms(S._sdpa(qkv, N, g), iters=5, warmup=2),
           **S._bound(kind, B, T, N, C, torch.float32), **errs}
    if name == "attn_bwd":
        dqkv = torch.empty_like(qkv)
        lse, delta = A.attn_bwd_rows(qkv, g, N, dqkv)
        rec["rows_ms"] = S.cuda_ms(lambda: A.attn_bwd_rows(qkv, g, N, dqkv), iters=5, warmup=2)
        rec["cols_ms"] = S.cuda_ms(lambda: A.attn_bwd_cols(qkv, g, N, lse, delta, dqkv), iters=5,
                                   warmup=2)
        rec["before_rows_ms"] = S.cuda_ms(lambda: S.fma_bwd_rows(qkv, g, N, dqkv), iters=5,
                                          warmup=2)
        rec["before_cols_ms"] = S.cuda_ms(lambda: S.fma_bwd_cols(qkv, g, N, lse, delta, dqkv),
                                          iters=5, warmup=2)
    rec["tflops"] = 10 * B * N * T * T * C / rec["ms"] / 1e9
    print(f"{tag}: " + S._fmt(rec), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--time", action="store_true", help="time each path shape")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_bwd_tf32: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    ptxas_report()
    t0 = time.perf_counter()
    kernels.library()
    print(f"library built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for i, shape in enumerate(SHAPES):
        case(*shape, gen, args.time and i >= RAGGED)
    print("probe_torch_bwd_tf32: ok", flush=True)


if __name__ == "__main__":
    main()
