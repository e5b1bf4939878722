"""First look at the fused inference kernels of the port on one GPU.

    python scripts/probe_torch_fused.py

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
re-layout; the full-width cifar10_cond UNet in bf16 at B=2 with both switches
on against the same model with both off; and the time of one bf16 UNet
forward at B=64 with the switches off, VDIFF_FUSED_GN=1 alone, and both on.
A short check before a full chip_smoke run. Needs a CUDA device.
"""

import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config  # noqa: E402
from vdiff_tpu_torch.ops import conv3x3 as C3  # noqa: E402
from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402


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
                        or "warning" in line.lower()))
    t0 = time.perf_counter()
    kernels.library()
    print("build", time.perf_counter() - t0, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_gn(gen)
    check_conv(gen)
    torch.cuda.empty_cache()
    time_kernels(gen)
    unet(gen)


if __name__ == "__main__":
    main()
