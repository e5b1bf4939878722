"""Where the time and the error of the f32 (3xTF32) attention forward go, by
ablation, on one GPU.

    python scripts/ablate_torch_tf32.py

Builds ``vdiff_tpu_torch/csrc/attn_fwd_tf32.cu`` several times, each copy
with one part changed (the copy gets an ``#ifdef`` around that part; the
source in the package is not touched), and runs each build's entry
``vdiff_attn_fwd_tc_f32`` on the same f32 inputs at the eval path's shapes and
q tiles: its time (chip_smoke's device-held timer) and its largest error
against the f64 twin beside the f32-FMA kernel's. A build that leaves a part
out computes a wrong result and says only what that part costs:

* ``base``: the kernel as it is;
* ``no_cross``: the two cross products (hi.lo, lo.hi) left out: one TF32
  product, a third of the mma.sync instructions and of the splits' work;
* ``no_split``: each operand passed whole as both hi and lo (no cvt.rna, no
  subtraction): the splits' instructions left out, every mma kept;
* ``chunk32``, ``no_chunk``: q.k^T's hi.hi sum restarted every 4 k-steps
  (32 columns) or never, where the kernel restarts it every 8 (64 columns;
  4 at C <= 64) and adds it to an f32 total: how far the tensor cores'
  truncating accumulation moves the error;
* ``cvt_lo``: lo rounded by cvt.rna.tf32.f32 as hi is, where the kernel
  takes two integer instructions (the same values); ``int_hi``: hi by the
  integer form too (the same values for finite x; a NaN whose payload
  carries into the sign would read as zero, so the kernel keeps cvt there);
  ``dekker_hi``: hi by Dekker's split in three f32 instructions, c = 8193·x,
  hi = c − (c − x) (nearest with ties to even, so a tie rounds the other way;
  NaN stays NaN, inf becomes NaN);
* ``more_blocks``: launch bounds that hold C <= 128 to the registers of 12
  warps an SM (3 blocks of 4 warps), where the compiler otherwise takes 255
  a thread (2 blocks);
* ``presplit_q``: the q tile split once into hi and lo in shared memory (a
  second q tile) after it arrives, each warp loading both parts per k-step
  instead of splitting (the 128-row tile at C=256 then needs 330 KB: refused
  at launch, printed as such).

Prints the card's name and power limit, each build's ptxas registers and
spills, and per shape and q tile one line of times (ms) and errors. Needs a
CUDA device and nvcc; writes its builds to a temporary directory.
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

SOURCE = os.path.join(kernels.CSRC_DIR, "attn_fwd_tf32.cu")
# the 3xTF32 header the source includes, inlined into the copy so that its
# split and products can be guarded too
HEADER = os.path.join(kernels.CSRC_DIR, "attn_tf32.cuh")
# (text of the source, what replaces it in the copy)
GUARDS = {
    "NO_CROSS": ("  mma_tf32(x, al, h0, h1);\n  mma_tf32(x, ah, l0, l1);\n",
                 "#ifndef NO_CROSS\n  mma_tf32(x, al, h0, h1);\n  mma_tf32(x, ah, l0, l1);\n"
                 "#endif\n"),
    "NO_SPLIT": ("  hi = to_tf32(x);\n  lo = to_tf32_small(x - __uint_as_float(hi));\n",
                 "#ifdef NO_SPLIT\n  hi = lo = __float_as_uint(x);\n#elif defined(CVT_LO)\n"
                 "  hi = to_tf32(x);\n  lo = to_tf32(x - __uint_as_float(hi));\n"
                 "#elif defined(INT_HI)\n  hi = to_tf32_small(x);\n"
                 "  lo = to_tf32_small(x - __uint_as_float(hi));\n"
                 "#elif defined(DEKKER_HI)\n  const float c = __fmul_rn(x, 8193.f);\n"
                 "  hi = __float_as_uint(__fsub_rn(c, __fsub_rn(c, x)));\n"
                 "  lo = to_tf32_small(x - __uint_as_float(hi));\n#else\n"
                 "  hi = to_tf32(x);\n  lo = to_tf32_small(x - __uint_as_float(hi));\n#endif\n"),
    "CHUNK": ("      if (kk % kChunk == kChunk - 8 || kk + 8 == C) {\n",
              "#ifdef CHUNK_COLS\n      if (kk % CHUNK_COLS == CHUNK_COLS - 8 || kk + 8 == C) {\n"
              "#else\n      if (kk % kChunk == kChunk - 8 || kk + 8 == C) {\n#endif\n"),
    "PRESPLIT_SMEM": ("  static constexpr int kSmemBytes = (kBq * qk_pitch<C>() + kKTile + kVTile) "
                      "* 4;\n",
                      "#ifdef PRESPLIT_Q\n  static constexpr int kSmemBytes = "
                      "(2 * kBq * qk_pitch<C>() + kKTile + kVTile) * 4;\n#else\n"
                      "  static constexpr int kSmemBytes = (kBq * qk_pitch<C>() + kKTile + kVTile) "
                      "* 4;\n#endif\n"),
    "PRESPLIT_PASS": ("    cp_async_wait<1>();  // k tile j (v tile j may be in flight)\n"
                      "    __syncthreads();\n",
                      "    cp_async_wait<1>();  // k tile j (v tile j may be in flight)\n"
                      "    __syncthreads();\n#ifdef PRESPLIT_Q\n    if (j == 0) {\n"
                      "      for (int e = threadIdx.x; e < kBq * kQp; e += kThreads) {\n"
                      "        uint32_t h, l;\n        split(q_s[e], h, l);\n"
                      "        q_s[e] = __uint_as_float(h);\n"
                      "        q_lo[e] = __uint_as_float(l);\n      }\n"
                      "      __syncthreads();\n    }\n#endif\n"),
    "PRESPLIT_PTR": ("  const float* q_w = q_s + (warp * 16 + g) * kQp + 2 * t4;\n",
                     "  const float* q_w = q_s + (warp * 16 + g) * kQp + 2 * t4;\n"
                     "#ifdef PRESPLIT_Q\n  float* q_lo = v_s + S::kVTile;\n"
                     "  const float* ql_w = q_lo + (warp * 16 + g) * kQp + 2 * t4;\n#endif\n"),
    "PRESPLIT_LOAD": ("      split(x0.x, ah[0], al[0]);\n      split(x1.x, ah[1], al[1]);\n"
                      "      split(x0.y, ah[2], al[2]);\n      split(x1.y, ah[3], al[3]);\n",
                      "#ifdef PRESPLIT_Q\n"
                      "      const float2 z0 = *reinterpret_cast<const float2*>(ql_w + kk);\n"
                      "      const float2 z1 =\n"
                      "          *reinterpret_cast<const float2*>(ql_w + 8 * kQp + kk);\n"
                      "      ah[0] = __float_as_uint(x0.x); al[0] = __float_as_uint(z0.x);\n"
                      "      ah[1] = __float_as_uint(x1.x); al[1] = __float_as_uint(z1.x);\n"
                      "      ah[2] = __float_as_uint(x0.y); al[2] = __float_as_uint(z0.y);\n"
                      "      ah[3] = __float_as_uint(x1.y); al[3] = __float_as_uint(z1.y);\n"
                      "#else\n"
                      "      split(x0.x, ah[0], al[0]);\n      split(x1.x, ah[1], al[1]);\n"
                      "      split(x0.y, ah[2], al[2]);\n      split(x1.y, ah[3], al[3]);\n"
                      "#endif\n"),
    "MORE_BLOCKS": ("__global__ void __launch_bounds__(32 * kWarps)\n",
                    "#ifdef MORE_BLOCKS\n__global__ void __launch_bounds__(32 * kWarps, "
                    "C <= 128 ? 12 / kWarps : 1)\n#else\n"
                    "__global__ void __launch_bounds__(32 * kWarps)\n#endif\n"),
}
BUILDS = {"base": [], "no_cross": ["-DNO_CROSS"], "no_split": ["-DNO_SPLIT"],
          "chunk32": ["-DCHUNK_COLS=32"], "no_chunk": ["-DCHUNK_COLS=4096"],
          "cvt_lo": ["-DCVT_LO"], "int_hi": ["-DINT_HI"], "dekker_hi": ["-DDEKKER_HI"],
          "presplit_q": ["-DPRESPLIT_Q"], "more_blocks": ["-DMORE_BLOCKS"]}
# (B, T, N, C): the eval path's (nll: B1 at T=256 and 64, B2 at 1024), the
# gate's train forward, celeba's nll at T=4096
SHAPES = [(64, 1024, 1, 256), (64, 256, 1, 256), (64, 64, 1, 256), (128, 256, 1, 256),
          (1, 4096, 6, 64), (1, 1024, 6, 64)]


def ablated_source():
    header = open(HEADER).read().replace("#pragma once\n", "")
    src = open(SOURCE).read().replace('#include "attn_tf32.cuh"\n', header)
    for name, (old, new) in GUARDS.items():
        if src.count(old) != 1:
            raise SystemExit(f"ablate: the anchor of {name} is not in {SOURCE} once; update GUARDS")
        src = src.replace(old, new)
    return src


def build(tmp):
    path = os.path.join(tmp, "attn_fwd_tf32.cu")
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
        lib.vdiff_attn_fwd_tc_f32.argtypes = kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_f32"]
        lib.vdiff_attn_fwd_tc_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, qkv, N, rows):
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    out = torch.empty(B, T, N * C, device="cuda")
    err = lib.vdiff_attn_fwd_tc_f32(qkv.data_ptr(), out.data_ptr(), B, T, N, C, rows,
                                    torch.cuda.current_stream().cuda_stream)
    return out if err == 0 else None


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    S.phase_card()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        gen = torch.Generator(device="cuda").manual_seed(18)
        for B, T, N, C in SHAPES:
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen)
            want, _ = S._f64_twin(qkv, N)
            fma_err = (S.fma_fwd_online(qkv, N).double() - want).abs().max().item()
            print(f"{(B, T, N, C)}: f32-FMA kernel (attn_fwd_online.cu) "
                  f"{S.cuda_ms(lambda: S.fma_fwd_online(qkv, N)):.4f} ms, f64 err {fma_err:.3e}",
                  flush=True)
            for rows in (64, 128):
                line = []
                for name, lib in libs.items():
                    out = run(lib, qkv, N, rows)
                    if out is None:
                        line.append(f"{name} refused")
                        continue
                    torch.cuda.synchronize()
                    err = (out.double() - want).abs().max().item()
                    ms = S.cuda_ms(lambda: run(lib, qkv, N, rows), iters=10)
                    line.append(f"{name} {ms:.4f} ms err {err:.3e} ({err / fma_err:.2f}x)")
                print(f"  rows {rows}: " + "; ".join(line), flush=True)
            del qkv, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
