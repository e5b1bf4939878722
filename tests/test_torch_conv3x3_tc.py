"""B11's bf16 calls on the tensor cores, on the CPU, where no CUDA kernel runs.

bf16 CUDA calls of ``fused_gn_silu_conv3x3`` run the statistics pass of
``gn_common.cuh`` and then the tensor-core conv of ``gn_silu_conv3x3_tc.cu``
at the tile ``conv_tc_tile`` picks; f32 calls keep the FMA conv of
``gn_silu_conv3x3.cu``. The kernel's tile algorithm, emulated in torch
(``tests/torch_parity.py::emulate_conv3x3_tc``: halo tiles of y = silu(x·A +
B) rounded once to bf16, zero outside the image, the 9 taps as shifted
windows, K chunks summed in f32), is held on bf16 inputs made from a numpy
seed against JAX's ``fused_gn_silu_conv3x3`` (the Pallas
``_gn_silu_conv_kernel`` in interpret mode), within the limit chip_smoke.py
holds the kernel to on the card: 2^-8·|out| + 1e-4 + 2^-7·max|y|·max|w| (half
a bf16 ulp of the output, and one y operand that two f32 SiLUs round to
neighbouring bf16 values). Then the tile picker, the dispatch on dtype into a
stub library (meta tensors) and the build registration.
"""

import os
import re
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_parity as P  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.ops import conv3x3 as C3  # noqa: E402
from vdiff_tpu_torch.ops import groupnorm as G  # noqa: E402

# chip_smoke.py's B11 bf16 limit: BF16_RTOL, F32_ATOL, FUSED_FLIP_RTOL
RTOL, ATOL, FLIP = 2.0 ** -8, 1e-4, 2.0 ** -7
GROUPS = 8


def _inputs(B, H, W, C, CO, film, skip, gn, seed):
    """bf16 x, FiLM rows and skip, f32 OIHW weights, bias, gamma and beta,
    drawn with numpy as chip_smoke draws them on the card."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x = (f(B, H, W, C) * 2 + 0.5).bfloat16()
    w, bias = f(CO, C, 3, 3) * (9 * C) ** -0.5, f(CO) * 0.1
    gamma, beta = (f(C) * 0.1 + 1, f(C) * 0.1) if gn else (None, None)
    shift, scale = (f(B, C) * 0.2).bfloat16(), (f(B, C) * 0.2).bfloat16()
    if not film:
        shift = scale = None
    res = f(B, H, W, CO).bfloat16() if skip else None
    return x, w, bias, gamma, beta, shift, scale, res


def _tol(ref, x, w, gamma, beta, shift, scale):
    flip = 0.0
    if gamma is not None:
        y = G.gn_film_silu_kernel_reference(x, gamma, beta, shift, scale, num_groups=GROUPS)
        flip = FLIP * y.float().abs().max().item() * w.abs().max().item()
    return RTOL * np.abs(ref) + ATOL + flip


def _jax(x, w, bias, gamma, beta, shift, scale, res):
    from vdiff_tpu.ops.conv3x3 import fused_gn_silu_conv3x3

    j = lambda t, dt=jnp.float32: None if t is None else jnp.asarray(t.float().numpy(), dt)
    out = fused_gn_silu_conv3x3(
        j(x, jnp.bfloat16), jnp.asarray(w.permute(2, 3, 1, 0).numpy()), j(bias), j(gamma),
        j(beta), j(shift, jnp.bfloat16), j(scale, jnp.bfloat16), j(res, jnp.bfloat16),
        num_groups=GROUPS, eps=1e-6, interpret=True)
    assert out.dtype == jnp.bfloat16
    return np.asarray(jnp.asarray(out, jnp.float32))


# (B, H, W, C_in, C_out, film, skip, gn): the picker's tiles at 8x8 (8 wide)
# and 16x16 (16 wide), ragged images (5x7 in one 8x8 tile; 9x9 in two rows of
# 8x16 tiles, the second half outside), C_in past one 32-channel chunk and
# ragged (48, 24 < 32), C_out not a multiple of 8 (the padded weight columns)
CASES = [
    (2, 8, 8, 64, 32, True, True, True),
    (1, 16, 16, 32, 48, False, False, True),
    (2, 16, 16, 48, 40, True, False, True),
    (2, 5, 7, 48, 40, True, True, True),
    (1, 9, 9, 32, 24, False, True, False),
    (2, 9, 9, 24, 16, False, False, True),
    (1, 8, 8, 32, 12, True, True, True),
]


@pytest.mark.parametrize("B,H,W,C,CO,film,skip,gn", CASES)
def test_tiles_match_the_pallas_kernel(B, H, W, C, CO, film, skip, gn):
    args = _inputs(B, H, W, C, CO, film, skip, gn, seed=H * W + C + CO)
    x, w, bias, gamma, beta, shift, scale, res = args
    got = P.emulate_conv3x3_tc(*args, num_groups=GROUPS, tile_w=C3.conv_tc_tile(W))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, CO)
    ref = _jax(*args)
    tol = _tol(got.numpy(), x, w, gamma, beta, shift, scale)
    err = np.abs(ref - got.numpy())
    assert (err <= tol).all(), f"vs JAX: largest excess {(err - tol).max()}"
    # the kernel's bf16 output against the twin before its one cast, as on
    # the card
    twin = C3.fused_gn_silu_conv3x3_reference_f32(*args, num_groups=GROUPS).numpy()
    err = np.abs(got.bfloat16().float().numpy() - twin)
    tol = _tol(twin, x, w, gamma, beta, shift, scale)
    assert (err <= tol).all(), f"vs the twin: largest excess {(err - tol).max()}"


def test_halo_pads_y_not_x():
    """With beta large every silu(B) is far from 0: the halo's zeros outside
    the image must stand for y. The emulation agrees with the twin (which
    pads y), and a version that pads x first moves every border pixel."""
    x, w, bias, gamma, beta, *_ = _inputs(1, 8, 8, 32, 16, False, False, True, seed=3)
    beta = beta + 3.0
    got = P.emulate_conv3x3_tc(x, w, bias, gamma, beta, num_groups=GROUPS, tile_w=8)
    twin = C3.fused_gn_silu_conv3x3_reference_f32(x, w, bias, gamma, beta, num_groups=GROUPS)
    tol = _tol(twin.numpy(), x, w, gamma, beta, None, None)
    assert (np.abs(got.numpy() - twin.numpy()) <= tol).all()
    a, b = G.coefficients(x, gamma, beta, None, None, GROUPS, 1e-6)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y = torch.nn.functional.silu(xp * a[:, None, None] + b[:, None, None]).bfloat16().float()
    pad_x = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), w.bfloat16().float(),
                                       bias).permute(0, 2, 3, 1)
    diff = (pad_x - twin).abs()
    assert diff[:, 1:-1, 1:-1].max() < 1e-4 and diff[:, [0, -1]].mean() > 0.5


# image width → output columns a block: the fused sampling path's 32, 16 and
# 8 (celeba's too), and odd widths
PICKS = {32: 16, 16: 16, 8: 8, 7: 8, 9: 16, 23: 16, 1: 8}


@pytest.mark.parametrize("W", sorted(PICKS))
def test_tile_picker(W):
    assert C3.conv_tc_tile(W) == PICKS[W]


@pytest.fixture
def stub(monkeypatch):
    """Meta tensors take the wrapper's launch path into a recording stub
    library; returns it."""
    lib = P.RecordingStubLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(C3, "need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(C3.fused_gn_silu_conv3x3, "launches", 0)
    return lib


@pytest.mark.parametrize("B,H,W,C,CO,gn", [(64, 32, 32, 256, 256, True), (64, 8, 8, 256, 256, True),
                                           (2, 9, 9, 32, 33, False)])
def test_dispatch_on_dtype(stub, B, H, W, C, CO, gn):
    """bf16: vdiff_gn_silu_conv3x3_tc at the picked tile width, with the weights
    padded to a multiple of 8 columns; f32: vdiff_gn_silu_conv3x3; one count
    per call either way."""
    for n, dtype in enumerate((torch.bfloat16, torch.float32), 1):
        meta = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
        x = meta(B, H, W, C, dt=dtype)
        gamma, beta = (meta(C), meta(C)) if gn else (None, None)
        out = C3.fused_gn_silu_conv3x3(x, meta(CO, C, 3, 3), meta(CO), gamma, beta,
                                       skip=meta(B, H, W, CO, dt=dtype))
        assert (out.shape, out.dtype) == ((B, H, W, CO), dtype)
        assert C3.fused_gn_silu_conv3x3.launches == n
        name, args = stub.launched[-1]
        if dtype == torch.bfloat16:
            assert name == "vdiff_gn_silu_conv3x3_tc"
            # ldw | B, H, W, C, CO, G | tile_w
            assert args[2] == -(-CO // 8) * 8
            assert args[13:19] == (B, H, W, C, CO, 32)
            assert args[20] == C3.conv_tc_tile(W)
            assert (args[4] is None) == (not gn) and (args[12] is None) == (not gn)
        else:
            assert name == "vdiff_gn_silu_conv3x3"
            assert args[12:18] == (B, H, W, C, CO, 32) and args[19] == 0
    assert [name for name, _ in stub.launched] == ["vdiff_gn_silu_conv3x3_tc",
                                                   "vdiff_gn_silu_conv3x3"]


def test_tc_entry_is_built_and_bound():
    """kernels.py compiles gn_silu_conv3x3_tc.cu and binds its entry; the
    source runs mma.sync on ldmatrix fragments with cp.async x and weight tiles,
    reuses gn_common.cuh's statistics pass, calls no library, and keeps the
    tile sizes the emulation assumes."""
    assert "gn_silu_conv3x3_tc.cu" in kernels.SOURCES
    assert len(kernels._ENTRY_POINTS["vdiff_gn_silu_conv3x3_tc"]) == 22
    src = open(os.path.join(kernels.CSRC_DIR, "gn_silu_conv3x3_tc.cu")).read()
    assert re.search(r'extern "C" int vdiff_gn_silu_conv3x3_tc\(', src)
    for token in ("tc::mma(", "tc::ldmatrix_x4(", "tc::load_b_kn<kBn>", "tc::cp_async16(",
                  "gn::launch<bf16, false>", '#include "gn_common.cuh"'):
        assert token in src, token
    assert not re.search(r"cublas|cudnn|cutlass", src, re.I)
    assert f"kCk = {P.CONV_CHUNK};" in src and f"kTh = {P.CONV_TILE_H};" in src
    for tile_w in set(PICKS.values()):
        assert f"case {tile_w}: return launch_tile<{tile_w}>" in src
