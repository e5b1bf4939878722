"""How the one-kernel GroupNorm(+FiLM)(+SiLU) splits a call
(vdiff_tpu_torch.ops.groupnorm.gn_plan): the plan of every B10 call on the
four fused paths (cifar10_cond at B=64 and celeba at B=32, with
VDIFF_FUSED_GN=1 alone and with both switches, read off the full-width models
on the meta device) and of odd shapes, held to the kernel's rules; a split of
the statistics as the plan cuts them against the Pallas kernel in interpret
mode; and the calls the plan refuses."""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402
from vdiff_tpu_torch.models import unet as U  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402
from vdiff_tpu_torch.ops import conv3x3 as C3  # noqa: E402
from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402

pytest_plugins = ["torch_limits"]

# (model, batch, VDIFF_FUSED_CONV) → B10 launches of one forward (with
# VDIFF_FUSED_GN=1); the counts tests/test_torch_conv3x3.py pins at B=2
PATHS = {("cifar10_cond", 64, "0"): 73, ("cifar10_cond", 64, "1"): 35,
         ("celeba", 32, "0"): 100, ("celeba", 32, "1"): 77}
# the arguments of vdiff_gn_film_silu that the rules read
_B, _HW, _C, _G, _BF16, _GROUPS, _RANKS, _PIXELS, _THREADS = 8, 9, 10, 11, 14, 15, 16, 17, 18


def _full_width(name):
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/{name}.json")
    celeba = name == "celeba"
    with torch.device("meta"):
        return build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                          model_out_type=cfg["diffusion"]["model_out_type"],
                          num_classes=40 if celeba else 10, multitags=celeba,
                          dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def path_calls():
    """{(model, B, conv switch): the argument tuples of every B10 launch of
    one bf16 inference forward}, meta tensors taking the wrappers' launch
    path into a recording stub library."""
    from vdiff_tpu_torch import kernels
    from vdiff_tpu_torch.models import layers

    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        lib = P.RecordingStubLibrary()
        mp.setattr(kernels, "library", lambda: lib)
        mp.setattr(A, "_need_cuda", lambda *a: None)
        mp.setattr(G, "need_cuda", lambda *a: None)
        mp.setattr(C3, "need_cuda", lambda *a: None)
        mp.setattr(torch.cuda, "current_stream", lambda *a: types.SimpleNamespace(cuda_stream=0))
        # the meta device's conv drops channels_last; cuDNN and the CPU keep it
        mp.setattr(U, "conv2d", lambda x, conv, dt: layers.conv2d(x, conv, dt).contiguous(
            memory_format=torch.channels_last))
        mp.setenv("VDIFF_FUSED_GN", "1")
        for name in ("cifar10_cond", "celeba"):
            model = _full_width(name)
            for (model_name, B, conv) in PATHS:
                if model_name != name:
                    continue
                res = 64 if name == "celeba" else 32
                x, t = torch.empty(B, res, res, 3, device="meta"), torch.empty(B, device="meta")
                y = torch.empty(B, 40, device="meta") if name == "celeba" else t
                mp.setenv("VDIFF_FUSED_CONV", conv)
                lib.launched.clear()
                with torch.no_grad():
                    model(x, t, y)
                calls[name, B, conv] = [a for n, a in lib.launched if n == "vdiff_gn_film_silu"]
    return calls


def check_plan(HW, C, groups_total, size, groups, ranks, pixels, threads):
    """The kernel's rules for one call's split."""
    cg = C // groups_total
    run_ch = groups * cg
    assert groups_total % groups == 0, "a run is whole groups and the runs tile C"
    assert run_ch * size % 16 == 0, "16-byte loads and stores"
    vecs = run_ch * size // 16
    assert vecs <= 32 and threads % 32 == 0 and threads <= 32 * G.MAX_WARPS, "whole warps"
    runs = groups_total // groups
    chan = np.zeros(C, np.int64)
    for r in range(runs):
        chan[r * run_ch:(r + 1) * run_ch] += 1
    assert (chan == 1).all(), "every channel in exactly one run"
    assert 1 <= ranks <= G.MAX_RANKS
    px = np.zeros(HW, np.int64)
    for k in range(ranks):
        lo, hi = k * pixels, min(HW, (k + 1) * pixels)
        assert hi > lo, "every block of a cluster takes pixels"
        px[lo:hi] += 1
    assert (px == 1).all(), "every pixel in exactly one block of the cluster"
    # one block within its budget, else a cluster within its budget where
    # 16 blocks allow it (celeba's widest 64x64 slabs need more)
    slab = pixels * run_ch * size
    if ranks == 1:
        assert slab <= G.SLAB_BYTES, "a block's slab within its budget"
    elif HW * run_ch * size <= G.MAX_RANKS * G.CLUSTER_SLAB_BYTES:
        assert slab <= G.CLUSTER_SLAB_BYTES, "a block's part of the slab within its budget"
    # with the warps' sums, the parameters, the group sums
    smem = 16 * pixels * vecs + 4 * (2 * threads // 32 * run_ch + 4 * run_ch + 2 * groups)
    assert smem <= G.MAX_SMEM_BYTES


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_b10_call_of_the_fused_paths_keeps_the_rules(path_calls, path):
    calls = path_calls[path]
    assert len(calls) == PATHS[path]
    shapes = set()
    for a in calls:
        assert a[_B] == path[1] and a[_BF16] == 1
        check_plan(a[_HW], a[_C], a[_G], 2, *(a[i] for i in (_GROUPS, _RANKS, _PIXELS, _THREADS)))
        shapes.add((a[_HW], a[_C], a[_RANKS]))
    if path[0] == "celeba":  # 64x64 slabs: clusters; 576 channels take 16 blocks
        assert (4096, 576, 16) in shapes and (4096, 192, 8) in shapes
    else:  # every CIFAR slab fits one block
        assert {r for _, _, r in shapes} == {1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,groups", [(5, 7, 192, 32), (8, 8, 1344, 32), (4, 6, 24, 4),
                                          (4, 4, 32, 32), (64, 64, 1344, 32),
                                          (64, 64, 1536, 32), (8, 8, 1536, 32)])
def test_odd_shape_plans_keep_the_rules(dtype, H, W, C, groups):
    """Groups of 6, 42, 48 and 1 channels, 4 groups of 6, a non-square
    image, and celeba's widest slabs (64x64 at 1344 and 1536 channels)."""
    plan = G.gn_plan(H, W, C, groups, dtype)
    check_plan(H * W, C, groups, dtype.itemsize, plan.groups, plan.ranks, plan.pixels,
               plan.threads)
    assert plan.run_bytes == plan.groups * C // groups * dtype.itemsize


@pytest.mark.parametrize("H,C,dtype,want", [
    (32, 256, torch.bfloat16, (4, 64, 1)),   # CIFAR: groups of 8, 64 KB slabs
    (16, 512, torch.bfloat16, (2, 64, 1)),
    (8, 256, torch.bfloat16, (4, 64, 1)),
    (64, 192, torch.bfloat16, (8, 96, 8)),   # celeba 64x64: 393 KB slabs over 8 blocks
    (64, 384, torch.bfloat16, (4, 96, 8)),
    (64, 576, torch.bfloat16, (4, 144, 16)),  # 590 KB over 16 blocks
    (32, 256, torch.float32, (2, 64, 1)),
    (64, 576, torch.float32, (2, 144, 16)),
])
def test_plan_picks_the_run_and_the_cluster(H, C, dtype, want):
    plan = G.gn_plan(H, H, C, 32, dtype)
    assert (plan.groups, plan.run_bytes, plan.ranks) == want
    assert plan.pixels == H * H // plan.ranks


@pytest.mark.parametrize("H,C,groups,dtype,match", [
    (8, 36, 6, torch.bfloat16, "multiple of 16"),     # 72 bytes a pixel
    (8, 6, 2, torch.float32, "multiple of 16"),      # 24 bytes a pixel
    (256, 576, 32, torch.bfloat16, "no cluster"),     # 9.4 MB slabs
    (4, 4608, 1, torch.float32, "more than a warp"),  # one group of 1,152 vectors
])
def test_plan_refuses_what_the_kernel_cannot_take(H, C, groups, dtype, match):
    with pytest.raises(ValueError, match=match):
        G.gn_plan(H, H, C, groups, dtype)


def split_gn(x, gamma, beta, shift, scale, num_groups, eps, apply_silu, plan):
    """The kernel's statistics as the plan cuts them, in f32: per (run,
    rank) block its channels' sums over its pixels, folded to groups, then
    the ranks' group sums added in rank order; A, B and y as the twin."""
    B, H, W, C = x.shape
    HW, cg = H * W, C // num_groups
    run_ch = plan.groups * cg
    xs = x.float().reshape(B, HW, C)
    s1 = torch.zeros(B, num_groups)
    s2 = torch.zeros(B, num_groups)
    for c0 in range(0, C, run_ch):
        g0 = c0 // cg
        for k in range(plan.ranks):
            slab = xs[:, k * plan.pixels:(k + 1) * plan.pixels, c0:c0 + run_ch]
            s1[:, g0:g0 + plan.groups] += slab.sum(1).reshape(B, plan.groups, cg).sum(2)
            s2[:, g0:g0 + plan.groups] += (slab * slab).sum(1).reshape(B, plan.groups, cg).sum(2)
    n = HW * cg
    mean = s1 / n
    inv = torch.rsqrt(s2 / n - mean * mean + eps)
    a = gamma[None] * inv.repeat_interleave(cg, 1)
    b = beta[None] - mean.repeat_interleave(cg, 1) * a
    if shift is not None:
        a, b = a * (1 + scale.float()), b * (1 + scale.float()) + shift.float()
    y = xs * a[:, None] + b[:, None]
    if apply_silu:
        y = torch.nn.functional.silu(y)
    return y.reshape(B, H, W, C).to(x.dtype)


@pytest.mark.parametrize("H,C,silu", [(64, 576, True), (64, 192, False), (5, 192, True)])
def test_the_split_statistics_match_the_pallas_kernel_in_interpret_mode(H, C, silu):
    """celeba's cluster slabs (576 channels over 16 blocks, 192 over 8) and a
    ragged one-block slab, f32, FiLM on, against JAX's _gn_kernel."""
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.groupnorm import gn_film_silu_pallas

    rng = np.random.RandomState(C + H)
    B, W = 1, (H + 2 if H < 8 else H)
    x = (rng.randn(B, H, W, C) * 2 + 0.5).astype(np.float32)
    gamma = (rng.randn(C) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    shift, scale = ((rng.randn(B, C) * 0.2).astype(np.float32) for _ in range(2))
    plan = G.gn_plan(H, W, C, 32, torch.bfloat16)  # bf16's split, held here in f32
    assert plan.ranks == {64: 16 if C == 576 else 8}.get(H, 1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(gn_film_silu_pallas(*(jnp.asarray(a) for a in (x, gamma, beta, shift,
                                                                         scale)),
                                             apply_silu=silu))
    out = split_gn(*(torch.from_numpy(a) for a in (x, gamma, beta, shift, scale)), 32, 1e-6,
                   silu, plan)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_the_entry_point_and_the_plan_agree_with_the_source():
    """No compiler here: the C entry's parameters are the argument types the
    loader declares, and the source's block and cluster limits are the
    plan's."""
    import re

    from vdiff_tpu_torch import kernels

    src = open(f"{kernels.CSRC_DIR}/gn_film_silu.cu").read()
    params = re.search(r'extern "C" int vdiff_gn_film_silu\(([^)]*)\)', src).group(1).split(",")
    kinds = {"void*": kernels._P, "int": kernels._I, "float": kernels._F}
    # "const void* x" → "void*", "int HW" → "int"
    got = [kinds[re.sub(r"const |\s|\w+$", "", p.strip())] for p in params]
    assert got == kernels._ENTRY_POINTS["vdiff_gn_film_silu"]
    assert f"constexpr int kGnThreads = {32 * G.MAX_WARPS};" in src
    assert f"constexpr int kMaxRanks = {G.MAX_RANKS};" in src
    assert "gn_film_silu.cu" in kernels.SOURCES
