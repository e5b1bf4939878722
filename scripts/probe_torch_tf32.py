"""First look at the f32 (3xTF32) tensor-core attention forward of the port,
``csrc/attn_fwd_tf32.cu``, on one GPU.

    python scripts/probe_torch_tf32.py [--time]

Prints the GPU's name and power limit; ptxas's register, shared-memory and
spill report for attn_fwd_tf32.cu; the build time of the kernel library;
then, for f32 calls of B1 (attn_fwd_online), B2 (attn_fwd_qblk), B3
(attn_fwd_train), B6 (attn_fwd_pack1) and B7 (attn_fwd_pack1_lse) at ragged
shapes (T a multiple of 32 and not of 64, every head dim) and at the paths'
shapes, chip_smoke's two checks: within 1e-4 of the f32 twin, and against an
f64 twin within twice the largest error of the f32-FMA kernel the call ran
before, on the same inputs (B7's lse within 1e-4 of the f64 twin's); the
output at each q tile (64, 128 rows) must be the same bit for bit. A one-pass
TF32 product (torch.matmul with TF32 on, the twin's arithmetic otherwise) is
printed beside them, to show what the split buys. With --time, each call's
time at each q tile beside the FMA kernel's, the twin's, SDPA's (f32, TF32
off) and the bound at 165 TFLOP/s. A short check before a full chip_smoke
run. Needs a CUDA device.
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
RAGGED = 9
SHAPES = [
    ("attn_fwd_online", 2, 96, 2, 256), ("attn_fwd_online", 3, 160, 1, 128),
    ("attn_fwd_qblk", 2, 1056, 1, 256), ("attn_fwd_qblk", 2, 544, 3, 32),
    ("attn_fwd_train", 3, 224, 2, 64), ("attn_fwd_pack1", 2, 96, 2, 64),
    ("attn_fwd_pack1", 2, 160, 4, 32), ("attn_fwd_pack1_lse", 2, 96, 2, 64),
    ("attn_fwd_pack1_lse", 2, 160, 4, 32),
    ("attn_fwd_online", 64, 256, 1, 256), ("attn_fwd_online", 64, 64, 1, 256),  # nll
    ("attn_fwd_qblk", 64, 1024, 1, 256),                                          # nll
    ("attn_fwd_train", 128, 256, 1, 256), ("attn_fwd_train", 128, 64, 1, 256),    # gate train
    ("attn_fwd_qblk", 128, 1024, 1, 256),
    ("attn_fwd_pack1", 1, 4096, 6, 64), ("attn_fwd_pack1", 1, 1024, 6, 64),       # celeba nll
    ("attn_fwd_pack1", 1, 256, 12, 64),
    ("attn_fwd_online", 32, 64, 12, 64), ("attn_fwd_qblk", 32, 1024, 9, 64),
    ("attn_fwd_online", 128, 256, 1, 128), ("attn_fwd_qblk", 128, 1024, 1, 128),  # mnist
    ("attn_fwd_pack1_lse", 48, 4096, 6, 64),
]
FMA = {"attn_fwd_online": S.fma_fwd_online, "attn_fwd_qblk": S.fma_fwd,
       "attn_fwd_train": S.fma_fwd_train, "attn_fwd_pack1": S.fma_fwd_online}


def ptxas_report():
    r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                        os.devnull, os.path.join(kernels.CSRC_DIR, "attn_fwd_tf32.cu")],
                       capture_output=True, text=True)
    lines = [ln for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln or "error" in ln]
    print("ptxas attn_fwd_tf32.cu:\n" + "\n".join(lines), flush=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)


def one_pass_tf32(qkv, N):
    """The twin with its products in one TF32 pass (torch's matmul with TF32
    on): what the split into hi and lo buys."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        B, T, three_nc = qkv.shape
        C = three_nc // (3 * N)
        q, k, v = qkv.reshape(B, T, 3, N, C).permute(2, 0, 3, 1, 4)
        p = torch.softmax(q @ k.transpose(-1, -2) / C ** 0.5, dim=-1)
        return (p @ v).permute(0, 2, 1, 3).reshape(B, T, N * C)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def probe(name, B, T, N, C, timed, gen):
    """One f32 call's checks and, with ``timed``, its times."""
    qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen)
    tag = f"{name} f32 {(B, T, N, C)}"
    big = T > S.TWIN_FULL_BATCH_MAX_T and B > 2
    idx = [0, 1, B - 2, B - 1] if big else list(range(B))
    if name == "attn_fwd_pack1_lse":
        out, lse = A.attn_fwd_pack1_lse(qkv, N)
        fma_out, fma_lse = S.fma_fwd_lse(qkv, N)
        ref_out, ref_lse = A.attention_qkv_lse_reference(qkv[idx], N)
        errs = S._check_f32_fwd(tag, out[idx], qkv[idx], N, fma_out[idx], ref_out, lse[idx],
                                fma_lse[idx])
        lse_err = (lse[idx] - ref_lse).abs().max().item()
        errs["lse_vs_f32_twin"] = lse_err
        if not lse_err <= S.LSE_ATOL:
            S.fail(f"{tag}: lse vs the f32 twin {lse_err}")
        fn, fma, kind = (lambda: A.attn_fwd_pack1_lse(qkv, N)), (lambda: S.fma_fwd_lse(qkv, N)), \
            "fwd_lse"
        del ref_out, ref_lse, fma_out, fma_lse
    else:
        fn = getattr(A, name)
        out = fn(qkv, N)
        ref = (A.attention_qkv_lse_reference(qkv[idx], N)[0] if name == "attn_fwd_pack1" else
               None)
        errs = S._check_f32_fwd(tag, out[idx], qkv[idx], N, FMA[name](qkv, N)[idx], ref)
        for rows in (64, 128):
            if not torch.equal(out, A._fwd_tc("probe", qkv, N, B, T, C, rows)):
                S.fail(f"{tag}: the {rows}-row q tile's output differs from the wrapper's")
        fn, fma, kind = (lambda: getattr(A, name)(qkv, N)), (lambda: FMA[name](qkv, N)), "fwd"
    want, _ = S._f64_twin(qkv[idx], N)
    errs["one_pass_tf32_f64_err"] = (one_pass_tf32(qkv[idx], N).double() - want).abs().max().item()
    del want, out
    print(f"{tag}: " + S._fmt(errs), flush=True)
    if timed:
        rec = {"ms": S.cuda_ms(fn, iters=10), "before_ms": S.cuda_ms(fma, iters=5),
               "plain_ms": S.cuda_ms(lambda: A.attention_qkv_reference(qkv, N), iters=5),
               "library_ms": S.cuda_ms(S._sdpa(qkv, N), iters=10),
               **S._bound(kind, B, T, N, C, torch.float32)}
        if kind == "fwd":
            for rows in (64, 128):
                rec[f"ms_rows{rows}"] = S.cuda_ms(
                    lambda: A._fwd_tc("probe", qkv, N, B, T, C, rows), iters=10)
        print(f"{tag} (q rows {A.fwd_tf32_q_rows(B, T, N)}): " + S._fmt(rec), flush=True)
    del qkv
    torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--time", action="store_true", help="time each call at the paths' shapes")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S.phase_card()
    ptxas_report()
    t0 = time.perf_counter()
    kernels.library()
    print(f"library built in {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(18)
    failed = []
    for i, shape in enumerate(SHAPES):
        try:
            probe(*shape, timed=args.time and i >= RAGGED, gen=gen)
        except RuntimeError as e:  # report every shape, then fail
            print(f"FAILED {shape}: {e}", flush=True)
            failed.append(shape)
            torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"probe_torch_tf32: {len(failed)} shapes failed: {failed}")
    print("probe_torch_tf32: ok", flush=True)


if __name__ == "__main__":
    main()
