"""First look at the celeba kernels and train step of the port on one GPU.

    python scripts/probe_torch_celeba.py [B ...]

Prints the GPU's name and power limit; ptxas's register and spill report for
the sources of the head-dim 32/64 kernels (attn_fwd_tc.cu, attn_bwd_tc.cu,
attn_fwd_tf32.cu, attn_bwd_tf32.cu); the
build time of the kernel library; for B=2 at (T, N, C) = (256, 4, 32),
(4096, 6, 64), (1024, 6, 64) and (256, 12, 64), f32 and bf16, the largest
error of attn_fwd_pack1 (B6), attn_fwd_pack1_lse (B7, and its lse),
attn_bwd_pack1 (B8, T <= 1024) and attn_bwd_pack1_kv (B9) against their
twins, and of B9 against the full-row backward twin run in f32 (which
differs by δ's source and the bf16 roundings); bf16 kernel times at the
celeba path's shapes; then 3 bf16 train steps of the full-width celeba model
at each batch B given (default 48) with their time, loss, peak device memory
and launch counts. A short check before a full chip_smoke run. Needs a CUDA
device.
"""

import copy
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.factory import (CONFIG_DIR, build_diffusion, build_unet,  # noqa: E402
                                     load_experiment_config)
from vdiff_tpu_torch.ops import attention as A  # noqa: E402
from vdiff_tpu_torch.train_lib import Optimizer, make_train_step  # noqa: E402


def run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    return r.stdout + r.stderr


def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_kernels(gen):
    for B, T, N, C in [(2, 256, 4, 32), (2, 4096, 6, 64), (2, 1024, 6, 64), (2, 256, 12, 64)]:
        for dt in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).to(dt)
            g = torch.randn(B, T, N * C, device="cuda", generator=gen).to(dt)
            o6 = A.attn_fwd_pack1(qkv, N)
            o7, lse = A.attn_fwd_pack1_lse(qkv, N)
            r7, rl = A.attention_qkv_lse_reference(qkv.float(), N)
            line = f"B={B} T={T} N={N} C={C} {dt}: b6 {err(o6, r7)} b7 {err(o7, r7)} lse {err(lse, rl)}"
            if T <= 1024:
                line += f" b8 {err(A.attn_bwd_pack1(qkv, g, N), A.attention_qkv_bwd_reference(qkv, g, N))}"
            d9 = A.attn_bwd_pack1_kv(qkv, o7, lse, g, N)
            line += f" b9 {err(d9, A.attention_qkv_bwd_kv_reference(qkv, o7, lse, g, N))}"
            line += f" b9-vs-fullrow(f32) {err(d9, A.attention_qkv_bwd_reference(qkv.float(), g.float(), N))}"
            torch.cuda.synchronize()
            print(line, flush=True)


def time_kernels(gen):
    N, C = 6, 64
    for name, B, T in [("b6", 32, 4096), ("b6", 32, 1024), ("b7", 48, 4096), ("b8", 48, 1024),
                       ("b9", 48, 4096)]:
        qkv = torch.randn(B, T, 3 * N * C, device="cuda", generator=gen).bfloat16()
        g = torch.randn(B, T, N * C, device="cuda", generator=gen).bfloat16()
        if name == "b6":
            t = cuda_ms(lambda: A.attn_fwd_pack1(qkv, N))
        elif name == "b7":
            t = cuda_ms(lambda: A.attn_fwd_pack1_lse(qkv, N))
        elif name == "b8":
            t = cuda_ms(lambda: A.attn_bwd_pack1(qkv, g, N))
        else:
            out, lse = A.attn_fwd_pack1_lse(qkv, N)
            t = cuda_ms(lambda: A.attn_bwd_pack1_kv(qkv, out, lse, g, N), 3)
        print(name, B, T, "ms", t, flush=True)
        del qkv, g
    torch.cuda.empty_cache()


def train_steps(batches, gen):
    cfg, _ = load_experiment_config(os.path.join(CONFIG_DIR, "celeba.json"))
    model = build_unet(cfg["model"], in_channels=3, model_out_type="both", num_classes=40,
                       multitags=True, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0)).cuda()
    ema = copy.deepcopy(model).requires_grad_(False)
    diffusion, timesteps = build_diffusion(cfg["diffusion"], w_guide=0.1, p_uncond=0.1)
    opt = Optimizer(model.parameters(), lr=3e-4, warmup=1000, grad_norm=1.0)
    step = make_train_step(model, diffusion, opt, timesteps, use_cfg=True, ema_model=ema)
    names = [n for n in dir(A) if hasattr(getattr(A, n), "launches")]
    for B in batches:
        x = torch.rand(B, 64, 64, 3, device="cuda", generator=gen) * 2 - 1
        y = (torch.rand(B, 40, device="cuda", generator=gen) < 0.5).float()
        torch.cuda.reset_peak_memory_stats()
        for i in range(3):
            for n in names:
                getattr(A, n).launches = 0
            t0 = time.perf_counter()
            loss = step(x, y, 0, i).item()
            torch.cuda.synchronize()
            print(f"B={B} step {i}: {time.perf_counter() - t0:.3f} s loss {loss} peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
                  {n: getattr(A, n).launches for n in names}, flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_celeba: needs a CUDA device")
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    print(sys.version, torch.__version__, torch.version.cuda)
    nvcc = kernels.find_nvcc()
    for src in ("attn_fwd_tc.cu", "attn_bwd_tc.cu", "attn_fwd_tf32.cu", "attn_bwd_tf32.cu"):
        out = run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", os.devnull,
                   os.path.join(kernels.CSRC_DIR, src)])
        print("\n".join(line for line in out.splitlines()
                        if "registers" in line or "spill" in line or "error" in line.lower()))
    t0 = time.perf_counter()
    kernels.library()
    print("build", time.perf_counter() - t0, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_kernels(gen)
    torch.cuda.empty_cache()
    time_kernels(gen)
    train_steps([int(a) for a in sys.argv[1:]] or [48], gen)


if __name__ == "__main__":
    main()
