"""Where the time of B11's tensor-core conv pass goes, by ablation, on one GPU.

    python scripts/ablate_torch_conv_tc.py

Builds ``vdiff_tpu_torch/csrc/gn_silu_conv3x3_tc.cu`` several times, each copy
with one part of the conv pass switched off (the copy's main loop gets an
``#ifndef`` around that part; the source in the package is not touched), and
times each build's entry ``vdiff_gn_silu_conv3x3_tc`` on the same bf16
inputs with chip_smoke's device-held timer: the fused sampling path's conv2
form (GN + FiLM + SiLU prologue, skip) at B=64 and 32x32, 16x16, 8x8 with
256 channels, and celeba's 384 and 768 widths at B=32. A build without a
part computes a wrong result and says only what that part costs:

* ``base``: the kernel as it is;
* ``precise_silu``: SiLU with the IEEE division and expf of the FMA kernel
  (``gn::silu``) instead of the SFU's ``__fdividef`` and ``__expf``;
* ``no_transform``: the prologue (raw x tile → y halo tile) left out;
* ``no_weights``: no weight tile copied;
* ``no_products``: no ldmatrix and no mma;
* ``one_block``: launch bounds that let one block an SM take more registers.

Prints the card's name and power limit, each build's ptxas registers and
spills, and one line of times (ms, the statistics pass included) per shape.
Needs a CUDA device and nvcc; writes its builds to a temporary directory.
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
from vdiff_tpu_torch.ops import conv3x3 as C3  # noqa: E402
from vdiff_tpu_torch.ops.groupnorm import film_args  # noqa: E402

SOURCE = os.path.join(kernels.CSRC_DIR, "gn_silu_conv3x3_tc.cu")
# (text of the source, what replaces it in the copy)
GUARDS = {
    "NO_TRANSFORM": ("        if (tap == i) transform(i, ck + 1, (ck + 1) & 1);\n",
                     "#ifndef NO_TRANSFORM\n        if (tap == i) transform(i, ck + 1, (ck + 1) & 1);\n"
                     "#endif\n"),
    "NO_WEIGHTS": ("    if (s + kStages - 1 < steps) load_w(s + kStages - 1);\n",
                   "#ifndef NO_WEIGHTS\n    if (s + kStages - 1 < steps) load_w(s + kStages - 1);\n"
                   "#endif\n"),
    "NO_PRODUCTS": ("#pragma unroll\n    for (int kk = 0; kk < kCk; kk += 16) {\n",
                    "#ifndef NO_PRODUCTS\n#pragma unroll\n    for (int kk = 0; kk < kCk; kk += 16) {\n"),
    "NO_PRODUCTS_END": ("    if (++tap == 9) {\n", "#endif\n    if (++tap == 9) {\n"),
    "PRECISE_SILU": ("{ return __fdividef(v, 1.f + __expf(-v)); }",
                     "{\n#ifdef PRECISE_SILU\n  return gn::silu(v);\n#else\n"
                     "  return __fdividef(v, 1.f + __expf(-v));\n#endif\n}"),
    "ONE_BLOCK": ("__launch_bounds__(kConvThreads, 2)", "__launch_bounds__(kConvThreads, MIN_BLOCKS)"),
}
BUILDS = {"base": [], "precise_silu": ["-DPRECISE_SILU"], "no_transform": ["-DNO_TRANSFORM"],
          "no_weights": ["-DNO_WEIGHTS"], "no_products": ["-DNO_PRODUCTS"],
          "one_block": ["-DMIN_BLOCKS=1"]}
# (B, H, C_in = C_out): the fused sampling path's conv2 forms, celeba's widths
SHAPES = [(64, 32, 256), (64, 16, 256), (64, 8, 256), (32, 32, 384), (32, 8, 768)]


def ablated_source():
    src = open(SOURCE).read()
    for name, (old, new) in GUARDS.items():
        if src.count(old) != 1:
            raise SystemExit(f"ablate: the anchor of {name} is not in {SOURCE} once; update GUARDS")
        src = src.replace(old, new)
    # MIN_BLOCKS must exist before the kernel's launch bounds use it
    return src.replace('#include "gn_common.cuh"\n',
                       '#include "gn_common.cuh"\n#ifndef MIN_BLOCKS\n#define MIN_BLOCKS 2\n#endif\n', 1)


def build(tmp):
    path = os.path.join(tmp, "conv.cu")
    with open(path, "w") as f:
        f.write(ablated_source())
    nvcc = kernels.find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", kernels.CSRC_DIR, *flags,
         "-o", os.path.join(tmp, f"{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, flags in BUILDS.items()}
    entries = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablate: build {name} failed\n{out}")
        regs = [ln.split("Used ")[1].split(" reg")[0] for ln in out.splitlines() if "Used" in ln]
        spills = sorted({ln.strip() for ln in out.splitlines() if "spill" in ln})
        print(f"{name}: registers {regs}, {spills}", flush=True)
        fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")).vdiff_gn_silu_conv3x3_tc
        fn.argtypes = kernels._ENTRY_POINTS["vdiff_gn_silu_conv3x3_tc"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_conv_tc: needs a CUDA device")
    S.phase_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(tmp)
        for B, H, C in SHAPES:
            x, gamma, beta, shift, scale, w, bias, res = S._fused_inputs(
                B, H, H, C, C, torch.bfloat16, gen, True, True)
            w2 = w.permute(2, 3, 1, 0).reshape(9 * C, C).to(torch.bfloat16).contiguous()
            out = torch.empty_like(res)
            coef = torch.empty(2, B, C, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn):
                err = fn(x.data_ptr(), w2.data_ptr(), C, bias.data_ptr(), gamma.data_ptr(),
                         beta.data_ptr(), *film_args(shift, scale), res.data_ptr(),
                         out.data_ptr(), coef.data_ptr(), B, H, H, C, C, 32, 1e-6,
                         C3.conv_tc_tile(H), stream)
                if err:
                    raise SystemExit(f"ablate: launch failed with CUDA error {err}")

            times = {name: S.cuda_ms(lambda: run(fn), iters=5) for name, fn in entries.items()}
            print(f"(B, H, W, C) = {(B, H, H, C)}: " + S._fmt(times), flush=True)


if __name__ == "__main__":
    main()
