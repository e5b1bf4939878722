"""Where the time of B10 (gn_film_silu_kernel) goes, by ablation, on one GPU.

    python scripts/ablate_torch_gn.py [--parent-csrc DIR]

Builds ``vdiff_tpu_torch/csrc/gn_film_silu.cu`` several times, each copy with
one part switched off (the copy gets an ``#ifdef`` around that part; the
source in the package is not touched), and times each build's entry on the
same bf16 inputs, split as ``ops/groupnorm.py::gn_plan`` says, with
chip_smoke's device-held timer, at the fused paths' shapes (CIFAR at B=64,
celeba at B=32). A build without a part computes a wrong result and says
only what that part costs:

* ``base``: the kernel as it is;
* ``empty``: every block returns at once (the launch and the grid alone);
* ``no_load``: the slab is not copied in (shared memory read as it lies);
* ``no_stats``: no sums, folds or cluster exchange (A and B from whatever
  the group sums hold);
* ``no_store``: y computed but not written;
* ``precise_silu``: SiLU with expf and the IEEE division (``gn::silu``, the
  parent kernel's) instead of the SFU's ``__expf`` and ``__fdividef``.

With --parent-csrc DIR (an older tree's csrc), DIR's gn_film_silu.cu (the
two-pass kernel of gn_common.cuh) is built the same way as ``parent`` (as
it is), ``parent_empty`` (every block returns at once) and
``parent_no_apply`` (the statistics pass alone) and timed at the same
shapes. One more column times the shortest PyTorch kernel (a one-element
fill) with the same timer: the card's per-launch floor. Prints the card's
name and power limit, each build's ptxas registers and spills, and one line
of times (ms) per shape. Needs a CUDA device and nvcc; writes its builds to
a temporary directory.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402
from probe_torch_fused import PARENT_ARGS  # noqa: E402

SOURCE = os.path.join(kernels.CSRC_DIR, "gn_film_silu.cu")
# (text of the source, what replaces it in the copy)
GUARDS = {
    "EMPTY": ("  extern __shared__ __align__(16) unsigned char smem[];\n",
              "  extern __shared__ __align__(16) unsigned char smem[];\n#ifdef EMPTY\n  return;\n"
              "#endif\n"),
    "NO_LOAD": ("  for (int p = pl; p < np; p += P) tc::cp_async16(",
                "  for (int p = pl; p < np * !NO_LOAD; p += P) tc::cp_async16("),
    "NO_STATS": ("  // 2. this thread's per-channel sums",
                 "#if !NO_STATS\n  // 2. this thread's per-channel sums"),
    "NO_STATS_END": ("  const float n = (float)HW * (float)cg_;\n",
                     "#endif\n  const float n = (float)HW * (float)cg_;\n"),
    "NO_STORE": ("    *reinterpret_cast<uint4*>(ob + (long)p * C) = Vec16<E>::pack(f);\n",
                 "    if (!NO_STORE || f[0] == 1234.5f)\n"
                 "      *reinterpret_cast<uint4*>(ob + (long)p * C) = Vec16<E>::pack(f);\n"),
    "PRECISE_SILU": ("f[j] = kSilu ? __fdividef(y, 1.f + __expf(-y)) : y;",
                     "f[j] = kSilu ? (PRECISE_SILU ? gn::silu(y)\n"
                     "                             : __fdividef(y, 1.f + __expf(-y))) : y;"),
}
DEFAULTS = "".join(f"#ifndef {m}\n#define {m} 0\n#endif\n"
                   for m in ("NO_LOAD", "NO_STATS", "NO_STORE", "PRECISE_SILU"))
BUILDS = {"base": [], "empty": ["-DEMPTY"], "no_load": ["-DNO_LOAD=1"],
          "no_stats": ["-DNO_STATS=1"], "no_store": ["-DNO_STORE=1"],
          "precise_silu": ["-DPRECISE_SILU=1"]}
# the parent's gn_common.cuh kernel: every block returns at once, or the
# apply loop leaves at its first pixel (the statistics pass alone)
PARENT_GUARDS = {
    "EMPTY": ("  const int b = blockIdx.y;\n",
              "#ifdef EMPTY\n  return;\n#endif\n  const int b = blockIdx.y;\n"),
    "NO_APPLY": ("        float y = fmaf(to_f32(xb[(long)p * C + c]), a, o);\n",
                 "#ifdef NO_APPLY\n        if (p >= 0) break;\n#endif\n"
                 "        float y = fmaf(to_f32(xb[(long)p * C + c]), a, o);\n"),
}
PARENT_BUILDS = {"parent": [], "parent_empty": ["-DEMPTY"], "parent_no_apply": ["-DNO_APPLY"]}
# (B, H, C, film, silu): the fused paths' bf16 shapes
SHAPES = [(64, 8, 256, False, False), (64, 16, 512, False, False), (64, 32, 256, False, False),
          (64, 32, 256, True, True), (32, 64, 576, False, True), (32, 8, 1536, False, True)]


def guarded(text, guards, where):
    for name, (old, new) in guards.items():
        if text.count(old) != 1:
            raise SystemExit(f"ablate: the anchor of {name} is not in {where} once; update it")
        text = text.replace(old, new)
    return text


def build(tmp, src, builds, argtypes, includes):
    """{build name: the built entry vdiff_gn_film_silu} for ``src``'s text
    under each build's flags."""
    path = os.path.join(tmp, "gn.cu")
    with open(path, "w") as f:
        f.write(src)
    nvcc = kernels.find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", includes, *flags,
         "-o", os.path.join(tmp, f"{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in builds.items()}
    entries = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"ablate: build {name} failed\n{out}")
        regs = [ln.split("Used ")[1].split(" reg")[0] for ln in out.splitlines() if "Used" in ln]
        spills = sorted({ln.strip() for ln in out.splitlines() if "spill" in ln})
        print(f"{name}: registers {regs}, {spills}", flush=True)
        fn = ctypes.CDLL(os.path.join(tmp, f"{name}.so")).vdiff_gn_film_silu
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", help="an older tree's vdiff_tpu_torch/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_gn: needs a CUDA device")
    S.phase_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        new_dir, old_dir = os.path.join(tmp, "new"), os.path.join(tmp, "old")
        os.makedirs(new_dir)
        src = DEFAULTS + guarded(open(SOURCE).read(), GUARDS, SOURCE)
        entries = build(new_dir, src, BUILDS, kernels._ENTRY_POINTS["vdiff_gn_film_silu"],
                        kernels.CSRC_DIR)
        parents = {}
        if args.parent_csrc:
            shutil.copytree(args.parent_csrc, old_dir)
            common = os.path.join(old_dir, "gn_common.cuh")
            with open(common) as f:
                text = guarded(f.read(), PARENT_GUARDS, common)
            with open(common, "w") as f:
                f.write(text)
            parents = build(old_dir, open(os.path.join(old_dir, "gn_film_silu.cu")).read(),
                            PARENT_BUILDS, PARENT_ARGS, old_dir)
        for B, H, C, film, silu in SHAPES:
            dt = torch.bfloat16
            x, gamma, beta, shift, scale, *_ = S._fused_inputs(B, H, H, C, 1, dt, gen, film, False)
            plan = G.gn_plan(H, H, C, 32, dt)
            out = torch.empty_like(x)
            film_ptrs = G.film_args(shift, scale)
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn):
                err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *film_ptrs,
                         out.data_ptr(), B, H * H, C, 32, 1e-6, int(silu), 1, plan.groups,
                         plan.ranks, plan.pixels, plan.threads, stream)
                if err:
                    raise SystemExit(f"ablate: launch failed with CUDA error {err}")

            def run_parent(fn):
                err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *film_ptrs,
                         out.data_ptr(), B, H * H, C, 32, 1e-6, int(silu), 1, stream)
                if err:
                    raise SystemExit(f"ablate: parent launch failed with CUDA error {err}")

            times = {name: S.cuda_ms(lambda: run(fn)) for name, fn in entries.items()}
            times.update({name: S.cuda_ms(lambda: run_parent(fn)) for name, fn in parents.items()})
            times["wrapper"] = S.cuda_ms(lambda: G.gn_film_silu_kernel(x, gamma, beta, shift, scale,
                                                                       apply_silu=silu))
            one = x.view(-1)[:1]
            times["one_element_fill"] = S.cuda_ms(lambda: one.fill_(1))
            print(f"(B, H, W, C) = {(B, H, H, C)} film={film} silu={silu} {plan} bound "
                  f"{S._gn_bound(B, H, H, C, dt, film)['bound_ms']}: " + S._fmt(times), flush=True)
            del x, out


if __name__ == "__main__":
    main()
