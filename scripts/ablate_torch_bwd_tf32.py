"""Tile and warp choices of the f32 (3xTF32) attention backward, by ablation,
on one GPU.

    python scripts/ablate_torch_bwd_tf32.py

Builds ``vdiff_tpu_torch/csrc/attn_bwd_tf32.cu`` several times, each copy
with one choice changed (the copy gets an ``#ifdef`` around it; the source in
the package is not touched), and runs each build's entries on the same f32
inputs at the train paths' shapes: the full-row pair
(``vdiff_attn_bwd_tf32_rows`` then ``_cols``) or B9's saved-statistics
entry (``vdiff_attn_bwd_tf32_kv``, on B7's own out and lse). Each line gives
the build's time (chip_smoke's device-held timer) and its largest error
against the f64 twin; the base build runs first and again last, so the two
show the timer's spread. Builds:

* ``base``: the kernels as they are (warp pairs at C = 256; 64-key and
  64-row tiles at C <= 64, 32 at C = 128);
* ``tiles32``: 32-key (row kernel) and 32-row (column kernel) tiles at
  C <= 64 as well, halving the score tiles' registers;
* ``pairs128``, ``pairs64``: the warp-pair kernels from C = 128 or C = 64 up
  (B9's saved-statistics row kernel keeps four warps).

Prints the card's name and power limit and each build's ptxas registers and
spills. Needs a CUDA device and nvcc; writes its builds to a temporary
directory.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402

SOURCE = os.path.join(kernels.CSRC_DIR, "attn_bwd_tf32.cu")
# (text of the source, what replaces it in the copy)
GUARDS = {
    "ROW_TILE": ("  static constexpr int kBk = C >= 128 ? 32 : 64;  // keys per tile\n",
                 "#ifdef TILES32\n  static constexpr int kBk = 32;\n#else\n"
                 "  static constexpr int kBk = C >= 128 ? 32 : 64;  // keys per tile\n#endif\n"),
    "COL_TILE": ("  static constexpr int kBq = C >= 128 ? 32 : 64;  // q rows per step of the sweep\n",
                 "#ifdef TILES32\n  static constexpr int kBq = 32;\n#else\n"
                 "  static constexpr int kBq = C >= 128 ? 32 : 64;  // q rows per step of the "
                 "sweep\n#endif\n"),
    "PAIRS": ("constexpr bool kPairs = C == 256;\n",
              "#ifdef PAIRS_FROM\nconstexpr bool kPairs = C >= PAIRS_FROM;\n#else\n"
              "constexpr bool kPairs = C == 256;\n#endif\n"),
}
BUILDS = {"base": [], "tiles32": ["-DTILES32"], "pairs128": ["-DPAIRS_FROM=128"],
          "pairs64": ["-DPAIRS_FROM=64"]}
ENTRIES = ("vdiff_attn_bwd_tf32_rows", "vdiff_attn_bwd_tf32_cols", "vdiff_attn_bwd_tf32_kv")
# (B, T, N, C, kv): the default f32 train steps' backward calls: CIFAR's B4
# and B5 (one head of 256), mnist's head of 128, celeba's B8 and B5 (heads of
# 64) and B9 at T=4096
SHAPES = [(128, 256, 1, 256, False), (128, 64, 1, 256, False), (128, 1024, 1, 256, False),
          (128, 256, 1, 128, False), (48, 1024, 6, 64, False), (48, 256, 12, 64, False),
          (48, 1024, 9, 64, False), (48, 4096, 6, 64, True)]


def ablated_source():
    src = open(SOURCE).read()
    for name, (old, new) in GUARDS.items():
        if src.count(old) != 1:
            raise SystemExit(f"ablate: the anchor of {name} is not in {SOURCE} once; update GUARDS")
        src = src.replace(old, new)
    return src


def build(tmp):
    path = os.path.join(tmp, "attn_bwd_tf32.cu")
    with open(path, "w") as f:
        f.write(ablated_source())
    nvcc = kernels.find_nvcc()
    procs = {}
    for name, flags in BUILDS.items():
        so = os.path.join(tmp, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", kernels.CSRC_DIR, *flags,
             "-o", so, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablate: {name} failed to build:\n{out}")
        regs = [ln.split(":")[-1].strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"{name}: ptxas\n  " + "\n  ".join(regs), flush=True)
        lib = ctypes.CDLL(so)
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = kernels._ENTRY_POINTS[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, qkv, g, N, saved):
    """d(qkv) from one build's entries, or None if a launch was refused."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    stream = torch.cuda.current_stream().cuda_stream
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(B, N, T, device="cuda")
    if saved is not None:
        out, lse = saved
        err = lib.vdiff_attn_bwd_tf32_kv(qkv.data_ptr(), out.data_ptr(), lse.data_ptr(),
                                         g.data_ptr(), dqkv.data_ptr(), delta.data_ptr(), B, T, N,
                                         C, stream)
        return None if err else dqkv
    lse = torch.empty_like(delta)
    err = lib.vdiff_attn_bwd_tf32_rows(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                                       lse.data_ptr(), delta.data_ptr(), B, T, N, C, stream)
    err = err or lib.vdiff_attn_bwd_tf32_cols(qkv.data_ptr(), g.data_ptr(), lse.data_ptr(),
                                              delta.data_ptr(), dqkv.data_ptr(), B, T, N, C,
                                              stream)
    return None if err else dqkv


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        order = list(libs) + ["base"]
        gen = torch.Generator(device="cuda").manual_seed(19)
        for B, T, N, C, kv in SHAPES:
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen)
            g = torch.randn(B, T, N * C, device="cuda", generator=gen)
            idx = list(range(B)) if T <= S.TWIN_FULL_BATCH_MAX_T else [0, 1, B - 2, B - 1]
            saved = A.attn_fwd_pack1_lse(qkv, N) if kv else None
            want = S._f64_bwd_twin(qkv[idx], g[idx], N)
            line = []
            for name in order:
                got = run(libs[name], qkv, g, N, saved)
                if got is None:
                    line.append(f"{name} refused")
                    continue
                torch.cuda.synchronize()
                err = (got[idx].double() - want).abs().max().item()
                ms = S.cuda_ms(lambda: run(libs[name], qkv, g, N, saved), iters=5, warmup=2)
                line.append(f"{name} {ms:.4f} ms err {err:.3e}")
            print(f"{(B, T, N, C)}{' kv' if kv else ''}: " + "; ".join(line), flush=True)
            del qkv, g, saved, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
