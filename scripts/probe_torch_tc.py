"""First look at the bf16 tensor-core attention kernels of the port on one GPU.

    python scripts/probe_torch_tc.py [--time] [--parent-csrc DIR]

Prints the GPU's name and power limit; ptxas's register, shared-memory and
spill report for attn_fwd_tc.cu and attn_bwd_tc.cu; the build time of the
kernel library; the largest error of attn_fwd_tc (B2, bf16) against the f32
twin with its limit 2^-8·|ref| + 2^-8·(P·|v|) + 1e-4, and of attn_bwd_tc (B5,
bf16) against the bf16 backward twin with chip_smoke's limit, at small and
ragged shapes (T a multiple of 32 and not of 64, every head dim) and at the
paths' shapes; then B7's and B8's bf16 calls, which run the same kernels
(attn_fwd_pack1_lse: the lse entry of attn_fwd_tc.cu, its output held to the
same limit, its lse to chip_smoke's LSE_ATOL, and its output bit for bit
equal to attn_fwd_tc's; attn_bwd_pack1), and B6's and B9's (attn_fwd_pack1:
attn_fwd_tc.cu, its output held to the same limit and bit for bit equal to
attn_fwd_tc's; attn_bwd_pack1_kv: the saved-statistics entry of
attn_bwd_tc.cu on B7's (out, lse), held to chip_smoke's bf16 backward limit
against the kv-chunked twin, with its distance from the full-row twin
printed beside it), at ragged and path shapes (twins on batch slices 0 and
B-1 at T=4096); then B1's and B3's bf16 calls (attn_fwd_online,
attn_fwd_train: attn_fwd_tc.cu at the q tile fwd_tc_q_rows picks) at every
CIFAR and celeba path shape and at ragged T, held to the same limit, with the
output at each q tile (32, 64 rows) bit for bit the wrapper's; then B4's
(attn_bwd at T <= 512: attn_bwd_tc.cu's full-row entry) at every CIFAR and
celeba train shape and at ragged T, held to chip_smoke's bf16 backward limit.
With --time, the new kernels' times beside the f32-FMA kernels they replace
on the same bf16 inputs, SDPA and the bound, and for B1 and B3 the time at
each q tile. ptxas's report
covers the fused conv sources too. With --parent-csrc, the SASS of
attn_bwd_tc.cu's full-row row kernel and of attn_fwd_tc.cu's 64-row
forward (with and without lse) at every head dim, of gn_silu_conv3x3.cu's
f32 conv instantiations and both files' GroupNorm statistics kernels,
against the same kernels built from DIR (an older tree's csrc), and of the
new gn_silu_conv3x3_tc.cu's statistics pass
against DIR's gn_silu_conv3x3.cu's: "identical" when the instructions
match. A short check before a full chip_smoke run. Needs a CUDA device.
"""

import argparse
import os
import re
import subprocess
import sys
import tempfile
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
# B6: ragged T, then the celeba sampler's up_1_us and the train step's shapes
PACK1_FWD_SHAPES = [(2, 96, 2, 64), (2, 160, 4, 32), (32, 4096, 6, 64), (48, 1024, 6, 64),
                    (48, 256, 12, 64)]
# B9: ragged T, then the celeba train step's up_1_us
KV_SHAPES = [(2, 96, 2, 64), (2, 160, 4, 32), (48, 4096, 6, 64)]
# B1 and B3 (wrapper, B, T, N, C): ragged T, then every shape of the CIFAR and
# celeba sampling (B1) and train (B3) paths
SHORT_SHAPES = [("attn_fwd_online", 2, 96, 2, 256), ("attn_fwd_train", 3, 160, 1, 128),
                ("attn_fwd_online", 64, 256, 1, 256), ("attn_fwd_online", 64, 64, 1, 256),
                ("attn_fwd_online", 32, 64, 12, 64), ("attn_fwd_online", 32, 64, 9, 64),
                ("attn_fwd_train", 128, 256, 1, 256), ("attn_fwd_train", 128, 64, 1, 256),
                ("attn_fwd_train", 48, 256, 9, 64), ("attn_fwd_train", 48, 64, 12, 64),
                ("attn_fwd_train", 48, 64, 9, 64)]
FMA = {"attn_fwd_online": S.fma_fwd_online, "attn_fwd_train": S.fma_fwd_train}
# B4 (attn_bwd at T <= 512): ragged T, then every shape of the CIFAR and
# celeba train paths
B4_SHAPES = [(2, 96, 2, 64), (3, 160, 1, 128), (2, 224, 1, 256), (128, 256, 1, 256),
             (128, 64, 1, 256), (48, 256, 9, 64), (48, 64, 12, 64), (48, 64, 9, 64)]


def short_bwd(timed):
    """B4's bf16 calls at B4_SHAPES: the wrapper's d(qkv) held to the bf16
    backward limit, and with ``timed`` its time beside the FMA pair's,
    SDPA's and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for B, T, N, C in B4_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(torch.bfloat16)
        out = A.attn_bwd(qkv, g, N)
        err = S._check_bwd(f"attn_bwd {(B, T, N, C)}", out,
                           A.attention_qkv_bwd_reference(qkv, g, N), torch.bfloat16)
        if timed and B > 3:
            rec = {"max_abs_err": err, "ms": S.cuda_ms(lambda: A.attn_bwd(qkv, g, N)),
                   "fma_ms": S.cuda_ms(lambda: S.fma_bwd(qkv, g, N), iters=10),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N, g)),
                   **S._bound("bwd", B, T, N, C, torch.bfloat16)}
            print(f"attn_bwd {(B, T, N, C)}: " + S._fmt(rec), flush=True)
        del qkv, g, out
    torch.cuda.empty_cache()


def ptxas_report():
    nvcc = kernels.find_nvcc()
    for src in dict.fromkeys(new for new, _, _ in SASS_KERNELS):
        r = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
                            os.path.join(kernels.CSRC_DIR, src)], capture_output=True, text=True)
        lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln or "error" in ln]
        print(f"ptxas {src}:\n" + "\n".join(lines), flush=True)


# (source, the parent's source it is held to, kernel name pattern → the
# template arguments that key it): the full-row row kernel (kSaved=false) and
# the 64-row forward, both before and after that forward took its warp count
# as a template argument; the FMA conv in f32 (kGn, kSkip); the
# GroupNorm statistics kernels (element type, kApply); and the tensor-core
# conv file's statistics pass against the FMA conv file's (B10's kernel,
# gn_film_silu.cu, is scripts/probe_torch_fused.py's)
_GN = r"2gn6kernelI(f|13__nv_bfloat16)Lb([01])EE"
SASS_KERNELS = (
    ("attn_bwd_tc.cu", "attn_bwd_tc.cu", r"attn_bwd_tc_rowsILi(\d+)E(?:Lb0E)?E"),
    ("attn_fwd_tc.cu", "attn_fwd_tc.cu", r"attn_fwd_tc_kernelILi(\d+)ELb([01])E(?:Li4E)?E"),
    ("gn_silu_conv3x3.cu", "gn_silu_conv3x3.cu", r"conv3x3_kernelIfLb([01])ELb([01])EE"),
    ("gn_silu_conv3x3.cu", "gn_silu_conv3x3.cu", _GN),
    ("gn_silu_conv3x3_tc.cu", "gn_silu_conv3x3.cu", _GN),
)


def _sass(src, pattern):
    """{template arguments: SASS instructions} of the kernels of ``src``
    whose mangled names match ``pattern``, addresses and encodings dropped."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-cubin", "-o", cubin, src],
                       check=True, capture_output=True)
        cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                              text=True).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            head = re.search(pattern + r"\w*$", line.strip())
            name = head.groups() if head else None
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
        if name is not None and ins:
            found.setdefault(name, []).append(ins.group(1).strip())
    return found


def sass_report(parent_csrc):
    for src, parent_src, pattern in SASS_KERNELS:
        new = _sass(os.path.join(kernels.CSRC_DIR, src), pattern)
        old = _sass(os.path.join(parent_csrc, parent_src), pattern)
        for key in sorted(new if src != parent_src else old):
            same = new.get(key) == old.get(key)
            print(f"sass {src} {key}: {len(new.get(key, []))} instructions against "
                  f"{len(old.get(key, []))} in {parent_csrc}/{parent_src}: "
                  f"{'identical' if same else 'DIFFERENT'}", flush=True)


def short_rows(timed):
    """B1's and B3's bf16 calls at SHORT_SHAPES: the wrapper's output held to
    the tensor-core limit, each q tile's bit for bit the wrapper's, and with
    ``timed`` each q tile's time beside the FMA kernel's, SDPA's and the
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, B, T, N, C in SHORT_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        out = getattr(A, name)(qkv, N)
        err = S._check_tc_fwd(f"{name} {(B, T, N, C)}", out, qkv, N)
        rows = A.fwd_tc_q_rows(B, T, N)
        same = {r: torch.equal(out, A._fwd_tc("probe", qkv, N, B, T, C, r)) for r in (32, 64)}
        print(f"{name} {(B, T, N, C)}: max_abs_err {err}, q rows {rows}, output equal at each "
              f"q tile: {same}", flush=True)
        if not all(same.values()):
            S.fail(f"{name} {(B, T, N, C)}: the q tile moved the output")
        if timed and B > 3:
            rec = {f"ms_rows{r}": S.cuda_ms(lambda: A._fwd_tc("probe", qkv, N, B, T, C, r))
                   for r in (64, 32)}
            rec.update({"ms": S.cuda_ms(lambda: getattr(A, name)(qkv, N)),
                        "fma_ms": S.cuda_ms(lambda: FMA[name](qkv, N)),
                        "library_ms": S.cuda_ms(S._sdpa(qkv, N)),
                        **S._bound("fwd", B, T, N, C, torch.bfloat16)})
            print(f"{name} {(B, T, N, C)}: " + S._fmt(rec), flush=True)
        del qkv, out
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent-csrc")
    args = ap.parse_args()
    S.phase_card()
    ptxas_report()
    if args.parent_csrc:
        sass_report(args.parent_csrc)
    t0 = time.perf_counter()
    kernels.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    short_bwd(args.time)
    short_rows(args.time)
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
    for B, T, N, C in PACK1_FWD_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        idx = list(range(B)) if T <= 1024 else [0, B - 1]
        out = A.attn_fwd_pack1(qkv, N)
        err = S._check_tc_fwd(f"attn_fwd_pack1 {(B, T, N, C)}", out[idx], qkv[idx], N)
        same = torch.equal(out, A.attn_fwd_tc(qkv, N))
        print(f"fwd_pack1 {(B, T, N, C)}: max_abs_err {err} out equal to attn_fwd_tc's: {same}",
              flush=True)
        if not same:
            S.fail(f"attn_fwd_pack1 {(B, T, N, C)}: output differs from attn_fwd_tc's")
        if args.time and B > 2:
            rec = {"ms": S.cuda_ms(lambda: A.attn_fwd_pack1(qkv, N), iters=10),
                   "fma_ms": S.cuda_ms(lambda: S.fma_fwd_online(qkv, N), iters=3, warmup=1),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N), iters=10),
                   **S._bound("fwd", B, T, N, C, torch.bfloat16)}
            print(f"fwd_pack1 {(B, T, N, C)}: " + S._fmt(rec), flush=True)
        del qkv, out
        torch.cuda.empty_cache()
    for B, T, N, C in KV_SHAPES:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(torch.bfloat16)
        g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(torch.bfloat16)
        idx = list(range(B)) if T <= 1024 else [0, B - 1]
        out, lse = A.attn_fwd_pack1_lse(qkv, N)
        got = A.attn_bwd_pack1_kv(qkv, out, lse, g, N)
        sq, sg = qkv[idx], g[idx]
        err = S._check_bwd(f"attn_bwd_pack1_kv {(B, T, N, C)}", got[idx],
                           A.attention_qkv_bwd_kv_reference(sq, out[idx], lse[idx], sg, N),
                           torch.bfloat16)
        full = (got[idx].float() - A.attention_qkv_bwd_reference(sq, sg, N).float()).abs().max()
        print(f"bwd_kv {(B, T, N, C)}: max_abs_err {err}, from the full-row twin {full.item()}",
              flush=True)
        del sq, sg, got
        if args.time and B > 2:
            rec = {"ms": S.cuda_ms(lambda: A.attn_bwd_pack1_kv(qkv, out, lse, g, N), iters=10),
                   "fma_ms": S.cuda_ms(lambda: S.fma_bwd_kv(qkv, out, lse, g, N), iters=3,
                                       warmup=1),
                   "library_ms": S.cuda_ms(S._sdpa(qkv, N, g), iters=10),
                   **S._bound("bwd_kv", B, T, N, C, torch.bfloat16)}
            print(f"bwd_kv {(B, T, N, C)}: " + S._fmt(rec), flush=True)
        del qkv, g, out, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
