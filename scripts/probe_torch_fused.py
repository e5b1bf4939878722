"""First look at the fused inference kernels of the port on one GPU.

    python scripts/probe_torch_fused.py [--parent-csrc DIR]

Prints the GPU's name and power limit; ptxas's register and spill report for
gn_film_silu.cu, gn_silu_conv3x3.cu and gn_silu_conv3x3_tc.cu; the build time
of the kernel library; the largest error of gn_film_silu_kernel (B10) and
fused_gn_silu_conv3x3 (B11) against their twins run in f32 on the same
values, f32 and bf16, at small odd shapes (group widths 6 and 42, a
non-square image, C_in != C_out, ragged tiles) and at the CIFAR sampler's
shapes (B=64); B11's bf16 calls (the tensor-core conv) held to chip_smoke's
limit, with every tile's output bit for bit the wrapper's; bf16 kernel times
there (chip_smoke's device-held timer) beside the unfused chain's, the FMA
conv's, cuDNN's conv alone, each tile's and the conv wrapper's weight
re-layout; B10's bf16 time at the fused paths' shapes (CIFAR at B=64,
celeba at B=32) with gn_plan's split and with other run widths and slab
budgets (each held to chip_smoke's limit; another split adds the sums in
another order, so its bits may differ); the full-width cifar10_cond UNet
in bf16 at B=2 with both switches on against the same model with both off;
and the time of one bf16 UNet forward at B=64 with the switches off,
VDIFF_FUSED_GN=1 alone, and both on.

With --parent-csrc DIR (an older tree's vdiff_tpu_torch/csrc), also builds
DIR's gn_film_silu.cu and times that B10 on the same inputs in the same call
(parent, new, new, parent), and compares the SASS of every kernel of
gn_silu_conv3x3.cu and gn_silu_conv3x3_tc.cu (B11: the statistics pass of
gn_common.cuh, the FMA and the tensor-core conv) with DIR's: "identical"
when the instructions match; a difference fails the run at its end.
A short check before a full chip_smoke run. Needs a CUDA device.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config  # noqa: E402
from vdiff_tpu_torch.ops import conv3x3 as C3  # noqa: E402
from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402
from probe_torch_tc import _sass  # noqa: E402


def run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    return r.stdout + r.stderr


def err(a, b):
    torch.cuda.synchronize()
    return (a.float() - b.float()).abs().max().item()


def gn_inputs(B, H, W, C, dt, gen, film):
    x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2 + 0.5).to(dt)
    gamma = torch.randn(C, device="cuda", generator=gen) * 0.1 + 1
    beta = torch.randn(C, device="cuda", generator=gen) * 0.1
    fc = (torch.randn(B, 2 * C, device="cuda", generator=gen) * 0.2).to(dt) if film else None
    shift, scale = fc.chunk(2, dim=-1) if film else (None, None)
    return x, gamma, beta, shift, scale


def f32(t):
    return None if t is None else t.float()


def check_gn(gen):
    for B, H, W, C, film, silu in [(3, 5, 7, 192, True, True), (2, 8, 8, 1344, False, True),
                                   (2, 4, 4, 32, True, False), (64, 32, 32, 256, True, True),
                                   (64, 16, 16, 512, False, False), (64, 8, 8, 256, False, True)]:
        for dt in (torch.float32, torch.bfloat16):
            x, gamma, beta, shift, scale = gn_inputs(B, H, W, C, dt, gen, film)
            out = G.gn_film_silu_kernel(x, gamma, beta, shift, scale, apply_silu=silu)
            ref = G.gn_film_silu_kernel_reference(x.float(), gamma, beta, f32(shift), f32(scale),
                                                  apply_silu=silu)
            print(f"b10 {(B, H, W, C)} film={film} silu={silu} {dt}: err {err(out, ref)} "
                  f"|ref| {ref.abs().max().item()}", flush=True)


def conv_inputs(B, H, W, C, CO, dt, gen, film, has_skip):
    x, gamma, beta, shift, scale = gn_inputs(B, H, W, C, dt, gen, film)
    w = torch.randn(CO, C, 3, 3, device="cuda", generator=gen) * (1.0 / (9 * C)) ** 0.5
    bias = torch.randn(CO, device="cuda", generator=gen) * 0.1
    skip = torch.randn(B, H, W, CO, device="cuda", generator=gen).to(dt) if has_skip else None
    return x, w, bias, gamma, beta, shift, scale, skip


TILES = (16, 8)  # output columns a block


def check_conv(gen):
    for B, H, W, C, CO, film, has_skip, gn in [
            (3, 5, 7, 192, 72, True, True, True), (2, 9, 9, 32, 33, False, False, True),
            (2, 9, 9, 20, 40, False, True, False), (2, 8, 8, 64, 64, False, True, False),
            (1, 17, 23, 96, 8, True, False, True), (64, 32, 32, 256, 256, True, True, True),
            (64, 16, 16, 256, 256, False, False, True), (64, 8, 8, 512, 256, True, True, True)]:
        for dt in (torch.float32, torch.bfloat16):
            x, w, bias, gamma, beta, shift, scale, skip = conv_inputs(B, H, W, C, CO, dt, gen,
                                                                      film and gn, has_skip)
            if not gn:
                gamma = beta = None
            args = (x, w, bias, gamma, beta, shift, scale, skip)
            out = C3.fused_gn_silu_conv3x3(*args)
            twin = C3.fused_gn_silu_conv3x3_reference_f32(*args)
            tag = f"b11 {(B, H, W, C, CO)} film={film and gn} skip={has_skip} gn={gn} {dt}"
            line = (f"{tag}: err vs the twin before its cast {err(out, twin)} |twin| "
                    f"{twin.abs().max().item()}")
            if dt == torch.bfloat16:
                flip = 0.0
                if gn:
                    y = G.gn_film_silu_kernel_reference(x, gamma, beta, shift, scale)
                    flip = S.FUSED_FLIP_RTOL * y.abs().max().item() * w.abs().max().item()
                S._check_fused(tag, out, twin, dt, flip)
                same = {t: torch.equal(out, C3._launch_tc(*args, 32, 1e-6, tile_w=t)) for t in TILES}
                line += f", within the limit (flip {flip}); each tile's output equal: {same}"
                if not all(same.values()):
                    S.fail(f"{tag}: the tile moved the output")
            print(line, flush=True)


def time_kernels(gen):
    dt = torch.bfloat16
    for B, H, C in ((64, 32, 256), (64, 16, 256), (64, 8, 256), (32, 32, 384), (32, 8, 768)):
        x, w, bias, gamma, beta, shift, scale, skip = conv_inputs(B, H, H, C, C, dt, gen,
                                                                  True, True)
        args = (x, w, bias, gamma, beta, shift, scale, skip)
        wb, bb = w.to(dt).contiguous(memory_format=torch.channels_last), bias.to(dt)
        nchw = x.permute(0, 3, 1, 2)
        ms = S.cuda_ms
        print(f"{(B, H, H, C)}: b10 film+silu {ms(lambda: G.gn_film_silu_kernel(x, gamma, beta, shift, scale))} ms, "
              f"default chain {ms(lambda: G.gn_film_silu(x, gamma, beta, shift, scale, use_kernel=False))} ms, "
              f"F.group_norm {ms(lambda: F.group_norm(nchw, 32, gamma.to(dt), beta.to(dt), 1e-6))} ms; "
              f"b11 conv2 form {ms(lambda: C3.fused_gn_silu_conv3x3(*args), 5)} ms "
              f"(tile width {C3.conv_tc_tile(H)}), "
              f"conv1 form {ms(lambda: C3.fused_gn_silu_conv3x3(x, w, bias, gamma, beta), 5)} ms, "
              f"FMA conv2 form {ms(lambda: C3._launch_fma(*args, 32, 1e-6), 3)} ms, "
              f"cuDNN bf16 conv alone {ms(lambda: F.conv2d(nchw, wb, bb, padding=1))} ms, "
              f"weight re-layout {ms(lambda: w.permute(2, 3, 1, 0).reshape(9 * C, C).to(dt).contiguous())} ms, "
              f"bound {S._conv_bound(B, H, H, C, C, dt, True, True, True)}", flush=True)
        tiles = {t: ms(lambda: C3._launch_tc(*args, 32, 1e-6, tile_w=t), 5) for t in TILES}
        print(f"{(B, H, H, C)}: b11 conv2 form by tile width: {tiles}", flush=True)


# B10 on the fused paths in bf16: (B, H, W, C, film, silu)
B10_SHAPES = [(64, 32, 32, 256, False, False), (64, 32, 32, 256, True, True),
              (64, 16, 16, 512, False, False), (64, 16, 16, 256, True, True),
              (64, 8, 8, 256, False, False), (64, 8, 8, 256, True, True),
              (32, 64, 64, 192, True, True), (32, 64, 64, 384, False, True),
              (32, 64, 64, 576, False, True), (32, 8, 8, 1536, False, True)]
# other splits timed beside gn_plan's own: its keyword arguments
PLAN_VARIANTS = ({"cluster_slab_bytes": G.SLAB_BYTES}, {"cluster_slab_bytes": 24 * 1024},
                 {"run_bytes": 128}, {"run_bytes": 32}, {"warps": 8}, {"warps": 4},
                 {"warps": 2})
# the parent's entry: x, gamma, beta, shift, scale, film_stride, film_f32, out, B, HW, C, G,
# eps, silu, bf16, stream
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGS = [_P] * 5 + [_I] * 2 + [_P] + [_I] * 4 + [ctypes.c_float] + [_I] * 2 + [_P]


def parent_b10(csrc, tmp):
    """DIR's B10 entry, built from DIR's gn_film_silu.cu, as a function of
    (x, gamma, beta, shift, scale, silu)."""
    so = os.path.join(tmp, "parent_gn.so")
    subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(csrc, "gn_film_silu.cu")], check=True)
    fn = ctypes.CDLL(so).vdiff_gn_film_silu
    fn.argtypes, fn.restype = PARENT_ARGS, ctypes.c_int

    def call(x, gamma, beta, shift, scale, silu):
        B, H, W, C = x.shape
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *G.film_args(shift, scale),
                 out.data_ptr(), B, H * W, C, 32, 1e-6, int(silu), int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent B10: CUDA error {err}")
        return out

    call.entry = fn
    return call


def time_b10(gen, parent):
    """B10 in bf16 at the fused paths' shapes: gn_plan's split against the
    twin's limit, other splits, and with ``parent`` the parent's kernel on
    the same inputs (parent, new, new, parent)."""
    dt = torch.bfloat16
    for B, H, W, C, film, silu in B10_SHAPES:
        x, gamma, beta, shift, scale = gn_inputs(B, H, W, C, dt, gen, film)
        ref = G.gn_film_silu_kernel_reference(x.float(), gamma, beta, f32(shift), f32(scale),
                                              apply_silu=silu)
        out = G.gn_film_silu_kernel(x, gamma, beta, shift, scale, apply_silu=silu)
        err = S._check_fused(f"b10 {(B, H, W, C)}", out, ref, dt)
        del ref
        plan = G.gn_plan(H, W, C, 32, dt)
        line = (f"b10 {(B, H, W, C)} film={film} silu={silu}: err {err}, plan {plan}, bound "
                f"{S._gn_bound(B, H, W, C, dt, film)['bound_ms']} ms")

        def new():
            return G.gn_film_silu_kernel(x, gamma, beta, shift, scale, apply_silu=silu)

        if parent is not None:
            def old():
                return parent(x, gamma, beta, shift, scale, silu)

            S._check_fused(f"parent b10 {(B, H, W, C)}", old(), G.gn_film_silu_kernel_reference(
                x.float(), gamma, beta, f32(shift), f32(scale), apply_silu=silu), dt)
            t = [S.cuda_ms(f) for f in (old, new, new, old)]
            line += f", parent {t[0]} / {t[3]} ms, new {t[1]} / {t[2]} ms"
        else:
            line += f", new {S.cuda_ms(new)} ms"
        for kw in PLAN_VARIANTS:
            p = G.gn_plan(H, W, C, 32, dt, **kw)

            def fn():
                return G.launch_planned(x, gamma, beta, shift, scale, 32, 1e-6, silu, p)

            S._check_fused(f"b10 {(B, H, W, C)} {p}", fn(), G.gn_film_silu_kernel_reference(
                x.float(), gamma, beta, f32(shift), f32(scale), apply_silu=silu), dt)
            same = torch.equal(fn(), out)
            line += (f"; {kw}: run {p.run_bytes} B, cluster {p.ranks}, {p.threads} threads, "
                     f"{p.pixels} px: {S.cuda_ms(fn)} ms, same bits {same}")
        print(line, flush=True)
        del x, out
    torch.cuda.empty_cache()


# a kernel's mangled name after its anonymous namespace, whose hash follows
# the file's path: _ZN5vdiff<n>_GLOBAL__N__<hex>_<n>_<file>_<hex8><the rest>
KERNEL_NAME = r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}(\d+\w+)"


def host_us(gen, parent):
    """Host time of one call (µs, the mean of 200 enqueued without waiting)
    at (64, 8, 8, 256) with FiLM and SiLU: the wrapper, gn_plan (cached),
    the new entry and, with ``parent``, the parent's entry, both called
    straight through ctypes."""
    x, gamma, beta, shift, scale = gn_inputs(64, 8, 8, 256, torch.bfloat16, gen, True)
    plan = G.gn_plan(8, 8, 256, 32, torch.bfloat16)
    lib = kernels.library()
    out = torch.empty_like(x)
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *G.film_args(shift, scale),
            out.data_ptr(), 64, 64, 256, 32, 1e-6, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {"wrapper": lambda: G.gn_film_silu_kernel(x, gamma, beta, shift, scale),
             "gn_plan": lambda: G.gn_plan(8, 8, 256, 32, torch.bfloat16),
             "entry": lambda: lib.vdiff_gn_film_silu(*args, plan.groups, plan.ranks, plan.pixels,
                                                     plan.threads, stream)}
    if parent is not None:
        calls["parent_entry"] = lambda: parent.entry(*args, stream)
    line = []
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        line.append(f"{name} {(time.perf_counter() - t0) / 200 * 1e6:.2f}")
        torch.cuda.synchronize()
    print("b10 host us a call: " + ", ".join(line), flush=True)


def sass_report(parent_csrc):
    """Every kernel of B11's two sources against DIR's build of the same
    file; returns the kernels that differ."""
    different = []
    for src in ("gn_silu_conv3x3.cu", "gn_silu_conv3x3_tc.cu"):
        new = _sass(os.path.join(kernels.CSRC_DIR, src), KERNEL_NAME)
        old = _sass(os.path.join(parent_csrc, src), KERNEL_NAME)
        for key in sorted(set(new) | set(old)):
            same = new.get(key) == old.get(key)
            print(f"sass {src} {key[0]}: {len(new.get(key, []))} instructions against "
                  f"{len(old.get(key, []))} in {parent_csrc}: "
                  f"{'identical' if same else 'DIFFERENT'}", flush=True)
            if not same:
                different.append((src, key[0]))
    return different


def unet(gen):
    cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, "cifar10_cond.json"))
    cpu_gen = torch.Generator().manual_seed(1234)
    model = build_unet(cfg["model"], in_channels=3, model_out_type=cfg["diffusion"]["model_out_type"],
                       num_classes=10, multitags=False, dtype=torch.bfloat16, generator=cpu_gen)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2 and not bool(p.any()):
                p.normal_(0.0, 0.05, generator=cpu_gen)
    model = model.cuda().eval()
    outs = {}
    for B in (2, 64):
        x = torch.randn(B, 32, 32, 3, device="cuda", generator=gen)
        t = torch.rand(B, device="cuda", generator=gen)
        y = torch.randint(0, 11, (B,), device="cuda", generator=gen).float()
        for gn, conv in (("0", "0"), ("1", "0"), ("1", "1")):
            os.environ["VDIFF_FUSED_GN"], os.environ["VDIFF_FUSED_CONV"] = gn, conv
            G.gn_film_silu_kernel.launches = C3.fused_gn_silu_conv3x3.launches = 0
            with torch.inference_mode():
                out = model(x, t, y)
                torch.cuda.synchronize()
                counts = (G.gn_film_silu_kernel.launches, C3.fused_gn_silu_conv3x3.launches)
                t0 = time.perf_counter()
                for _ in range(3):
                    model(x, t, y)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 3 * 1e3
            outs[gn, conv] = out
            print(f"unet B={B} GN={gn} CONV={conv}: launches b10, b11 = {counts}, {ms:.2f} ms per "
                  f"forward, max|out| {out.abs().max().item()}, vs both off "
                  f"{err(out, outs['0', '0'])}", flush=True)
    os.environ["VDIFF_FUSED_GN"] = os.environ["VDIFF_FUSED_CONV"] = "0"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-csrc", help="an older tree's vdiff_tpu_torch/csrc")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_fused: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(sys.version, torch.__version__, torch.version.cuda)
    nvcc = kernels.find_nvcc()
    for src in ("gn_film_silu.cu", "gn_silu_conv3x3.cu", "gn_silu_conv3x3_tc.cu"):
        out = run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
                   os.path.join(kernels.CSRC_DIR, src)])
        print("\n".join(line for line in out.splitlines()
                        if "registers" in line or "spill" in line or "error" in line.lower()
                        or "warning" in line.lower() or "Compiling" in line))
    different = sass_report(args.parent_csrc) if args.parent_csrc else []
    t0 = time.perf_counter()
    kernels.library()
    print("build", time.perf_counter() - t0, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_gn(gen)
    with tempfile.TemporaryDirectory() as tmp:
        parent = parent_b10(args.parent_csrc, tmp) if args.parent_csrc else None
        host_us(gen, parent)
        time_b10(gen, parent)
    check_conv(gen)
    torch.cuda.empty_cache()
    time_kernels(gen)
    unet(gen)
    if different:
        S.fail(f"B11's SASS differs from {args.parent_csrc}'s: {different}")


if __name__ == "__main__":
    main()
