"""The f32 attention forward of the port on the tensor cores
(``csrc/attn_fwd_tf32.cu``, 3xTF32), on the CPU, where no CUDA kernel runs.

f32 CUDA calls of B1 (``attn_fwd_online``), B2 (``attn_fwd_qblk``), B3
(``attn_fwd_train``), B6 (``attn_fwd_pack1``) and B7 (``attn_fwd_pack1_lse``)
run this kernel. Its tile algorithm is written out here in torch at the
kernel's key tiles: each f32 operand split as the kernel's ``cvt.rna`` does,
hi = x rounded to TF32 (nearest, ties away: ``(bits + 0x1000) & -0x2000``)
and lo = x − hi rounded the same way; each product hi·hi + (hi·lo + lo·hi),
the cross terms summed apart (products of TF32 values are exact in f32; the
kernel's restarts of the hi·hi sum every 32 or 64 columns matter only for
the tensor cores' truncating sums, which torch's rounded f32 sums are not);
the online softmax in f32 in the log2 domain, the scale on f32 S, each key
tile's e·v added to the rescaled output, the output divided once. On f32
inputs made from a numpy seed at unit scale it is held within 1e-5 of JAX's
Pallas kernels in interpret mode: ``flash_attention_qkv`` at T=256 (B1's
``_flash_kernel``), ``_attn_fwd_kernel_qblk`` at a ragged T=544 (B2's, one q
block), the pack1 forward at C=64, N=2, T=256 (B6) and the pack1 lse forward
(B7, its lse too). The same algorithm with one TF32 product (each operand
rounded to TF32 once) misses that bar at every case: the split is what keeps
f32 f32.

Then the wrappers, on meta tensors into a recording stub library: f32 calls
of the five launch the new entries, each counted under its own wrapper only;
what the kernel cannot take is refused before any launch; the build
registers and hashes the new source, and the q tile picked at each f32 path
shape. ~10 s on one worker.
"""

import math
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
from vdiff_tpu_torch.ops import attention as A  # noqa: E402

pytest_plugins = ["torch_limits"]

# keys per tile of attn_fwd_tf32.cu by head dim (Tf32Shape::kBk)
KEY_TILE = {32: 64, 64: 64, 128: 32, 256: 32}
# the bar: 3xTF32 within it of JAX's f32 kernels at unit-scale inputs, one
# TF32 product not
ATOL = 1e-5
PACK1_BQ = 128


def tf32(x):
    """cvt.rna.tf32.f32: f32 rounded to 10 explicit mantissa bits, ties away."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, passes):
    """a @ b as the kernel's mma.sync does it: 3 passes, hi·hi + (hi·lo +
    lo·hi) with the cross terms summed apart; 1 pass, the TF32 operands."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def emulate_fwd_tf32(qkv, N, passes=3):
    """attn_fwd_tf32.cu's algorithm on f32 qkv (B, T, 3·N·C): per key tile s =
    (q·kᵀ)·(log2e/√C) in f32, running max m and sum l rescaled by
    exp2(m_old − m_new), o = o·α + e·v; out = o / l. Returns (out (B, T, N·C),
    lse (B, N, T) = (m + log2 l)·ln2)."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    q, k, v = (a.permute(0, 2, 1, 3) for a in qkv.reshape(B, T, 3, N, C).unbind(2))
    bk, scale_log2 = KEY_TILE[C], float(P.LOG2E / np.sqrt(np.float32(C)))
    m = torch.full((B, N, T, 1), -math.inf)
    l = torch.zeros(B, N, T, 1)
    o = torch.zeros(B, N, T, C)
    for j in range(0, T, bk):
        s = _mm(q, k[:, :, j:j + bk].transpose(-1, -2), passes) * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _mm(p, v[:, :, j:j + bk], passes)
        m = m_new
    out = (o / l).permute(0, 2, 1, 3).reshape(B, T, N * C)
    return out, ((m + torch.log2(l)) * float(P.LN2)).squeeze(-1)


def _inputs(B, T, N, C, seed):
    """Seeded unit-scale f32 qkv (B, T, 3·N·C), drawn with numpy."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(B, T, 3 * N * C).astype(np.float32))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _fold(a, N):
    """(B, T, N·C) → (B·N, T, C), JAX's head folding."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).transpose(0, 2, 1, 3).reshape(B * N, T, NC // N)


def _unfold(a, B, N):
    BN, T, C = a.shape
    return a.reshape(B, N, T, C).transpose(0, 2, 1, 3).reshape(B, T, N * C)


def _jax_b1(qkv, N):
    from jax.experimental.pallas import tpu as pltpu

    from vdiff_tpu.ops.attention import flash_attention_qkv

    with pltpu.force_tpu_interpret_mode():
        return _np(flash_attention_qkv(jnp.asarray(qkv.numpy()), N)), None


def _jax_b2(qkv, N):
    from vdiff_tpu.ops.attention import _qblk_fwd_call

    B, T, _ = qkv.shape
    q, k, v = (_fold(a, N) for a in np.split(qkv.numpy(), 3, axis=-1))
    out = _qblk_fwd_call(*(jnp.asarray(a) for a in (q, k, v)), T, interpret=True)
    return _unfold(_np(out), B, N), None


def _jax_b6(qkv, N):
    from vdiff_tpu.ops.attention import _pack1_fwd_call

    C = qkv.shape[-1] // (3 * N)
    return _np(_pack1_fwd_call(jnp.asarray(qkv.numpy()), N, C, PACK1_BQ, interpret=True)), None


def _jax_b7(qkv, N):
    from vdiff_tpu.ops.attention import _pack1_fwd_lse_call

    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    out, lse = _pack1_fwd_lse_call(jnp.asarray(qkv.numpy()), N, C, PACK1_BQ, interpret=True)
    # JAX broadcasts lse over each head's C lanes: one lane a head
    return _np(out), _np(lse).reshape(B, T, N, C)[..., 0].transpose(0, 2, 1)


# (JAX's kernel, B, T, N, C): B1 at T=256 through flash_attention_qkv; B2's
# body at a ragged T > 512 (a multiple of 32 and not of 64: the last key tile
# half masked) in one q block; B6 and B7 at JAX's pack1 gate (N·C = 128)
CASES = {"b1_flash_kernel": (_jax_b1, 1, 256, 1, 256), "b2_qblk_ragged": (_jax_b2, 1, 544, 2, 32),
         "b6_pack1": (_jax_b6, 1, 256, 2, 64), "b7_pack1_lse": (_jax_b7, 1, 256, 2, 64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_tiles_match_pallas_and_one_pass_does_not(case):
    jax_fn, B, T, N, C = CASES[case]
    qkv = _inputs(B, T, N, C, seed=T + C)
    ref, ref_lse = jax_fn(qkv, N)
    out, lse = emulate_fwd_tf32(qkv, N)
    assert out.dtype == torch.float32 and out.shape == (B, T, N * C)
    err = np.abs(out.numpy() - ref).max()
    assert err <= ATOL, f"3xTF32 vs JAX: {err}"
    if ref_lse is not None:
        np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=ATOL)
    one, one_lse = emulate_fwd_tf32(qkv, N, passes=1)
    worst = max(np.abs(one.numpy() - ref).max(),
                0.0 if ref_lse is None else np.abs(one_lse.numpy() - ref_lse).max())
    assert worst > ATOL, f"one TF32 pass within {ATOL} of JAX ({worst}): the bar shows nothing"
    # and the port's CPU twin, which the wrappers return on the CPU
    twin = (A.attention_qkv_lse_reference(qkv, N)[0] if case.startswith(("b6", "b7"))
            else A.attention_qkv_reference(qkv, N))
    assert np.abs(out.numpy() - twin.numpy()).max() <= ATOL


def test_tf32_rounding_is_cvt_rna():
    """Nearest with ties away from zero at 10 explicit mantissa bits, and lo
    = x − hi carries the rest: hi + lo within 2^-22 of x."""
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10
    tie = one * (1 + ulp / 2)  # halfway between 1 and 1 + ulp: away from zero
    assert torch.equal(tf32(tie), one * (1 + ulp))
    below = one * (1 + ulp / 2 - 2.0 ** -23)
    assert torch.equal(tf32(below), one)
    x = _inputs(1, 64, 1, 64, seed=3).flatten()
    hi = tf32(x)
    lo = tf32(x - hi)
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
    assert ((hi - x).abs() > 2.0 ** -14 * x.abs()).any()  # one part alone is not f32


COUNTERS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd_rows",
            "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc", "attn_fwd_pack1", "attn_fwd_pack1_lse",
            "attn_bwd_pack1", "attn_bwd_pack1_kv", "attn_bwd")


@pytest.fixture
def recorded(monkeypatch):
    """Meta tensors take the wrappers' launch path into a recording stub
    library; returns a function that reads (calls with their arguments,
    nonzero launch counts) and clears both."""
    lib = P.RecordingStubLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    for name in COUNTERS:
        monkeypatch.setattr(getattr(A, name), "launches", 0)

    def read():
        calls = list(lib.launched)
        counts = {name: getattr(A, name).launches for name in COUNTERS if getattr(A, name).launches}
        lib.launched.clear()
        for name in COUNTERS:
            getattr(A, name).launches = 0
        return calls, counts

    return read


# (wrapper, B, T, N, C): the f32 paths' shapes (the eval CLI's nll, the gate's
# train stage, celeba's nll, B7 at celeba's train step) and a T past B2's old
# f32 cap (2848 at C=256)
F32_CALLS = [("attn_fwd_online", 64, 256, 1, 256), ("attn_fwd_online", 64, 64, 1, 256),
             ("attn_fwd_qblk", 64, 1024, 1, 256), ("attn_fwd_qblk", 2, 4096, 1, 256),
             ("attn_fwd_train", 128, 256, 1, 256), ("attn_fwd_pack1", 1, 4096, 6, 64),
             ("attn_fwd_pack1_lse", 48, 4096, 6, 64)]


@pytest.mark.parametrize("wrapper,B,T,N,C", F32_CALLS)
def test_f32_calls_launch_the_tf32_entries(recorded, wrapper, B, T, N, C):
    """One launch of vdiff_attn_fwd_tc_f32 (q rows from fwd_tf32_q_rows) or, for
    B7, vdiff_attn_fwd_tc_f32_lse, counted under the wrapper alone; no FMA
    entry and no T cap query."""
    qkv = torch.empty(B, T, 3 * N * C, device="meta")
    got = getattr(A, wrapper)(qkv, N)
    out = got[0] if wrapper == "attn_fwd_pack1_lse" else got
    assert (out.shape, out.dtype) == ((B, T, N * C), torch.float32)
    calls, counts = recorded()
    if wrapper == "attn_fwd_pack1_lse":
        assert got[1].shape == (B, N, T) and got[1].dtype == torch.float32
        assert calls == [("vdiff_attn_fwd_tc_f32_lse", (0, 0, 0, B, T, N, C, 0))]
    else:
        assert calls == [("vdiff_attn_fwd_tc_f32", (0, 0, B, T, N, C,
                                                    A.fwd_tf32_q_rows(B, T, N), 0))]
    assert counts == {wrapper: 1}


# (B, T, N) → q rows of attn_fwd_tf32.cu at every f32 path shape: 128 where
# T > 64 and the 128-row grid fills the card, else 64 (ops/attention.py)
TF32_Q_ROWS = {
    (64, 256, 1): 128, (64, 64, 1): 64, (64, 1024, 1): 128,     # the eval CLI's nll
    (128, 256, 1): 128, (128, 64, 1): 64, (128, 1024, 1): 128,  # the gate's train stage
    (1, 4096, 6): 128, (1, 1024, 6): 64, (1, 256, 6): 64,      # celeba's nll
    (1, 256, 12): 64, (1, 64, 12): 64, (1, 1024, 9): 64, (1, 256, 9): 64, (1, 64, 9): 64,
    (16, 256, 1): 64, (16, 64, 1): 64, (16, 1024, 1): 128,      # --progressive under TP/SP
}


@pytest.mark.parametrize("shape,rows", sorted(TF32_Q_ROWS.items()))
def test_q_tile_at_the_f32_path_shapes(shape, rows):
    assert A.fwd_tf32_q_rows(*shape) == rows


def _qkv(bad):
    """An f32 qkv that the kernel cannot take, and the error it raises."""
    if bad == "misaligned":  # contiguous, 4 bytes past a 16-byte boundary
        return torch.empty(1 + 256 * 3 * 64, device="meta")[1:].view(1, 256, 3 * 64), ValueError
    if bad == "head_dim":
        return torch.empty(1, 256, 3 * 48, device="meta"), ValueError
    if bad == "tokens":
        return torch.empty(1, 240, 3 * 64, device="meta"), ValueError
    if bad == "layout":
        return torch.empty(1, 256, 2 * 3 * 64, device="meta")[..., ::2], ValueError
    return torch.empty(1, 256, 3 * 64, dtype=torch.float16, device="meta"), TypeError


@pytest.mark.parametrize("bad", ["misaligned", "head_dim", "tokens", "layout", "float16"])
@pytest.mark.parametrize("wrapper", ["attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train",
                                     "attn_fwd_pack1", "attn_fwd_pack1_lse"])
def test_refusals_raise_before_any_launch(recorded, wrapper, bad):
    qkv, err = _qkv(bad)
    with pytest.raises(err):
        getattr(A, wrapper)(qkv, 1)
    assert recorded() == ([], {})


def test_the_new_source_is_built_hashed_and_bound(monkeypatch, tmp_path):
    """kernels.py compiles attn_fwd_tf32.cu (its digest changes with the
    file), binds both entries with the bf16 entries' arguments, and the
    source, with the 3xTF32 header it includes (attn_tf32.cuh, shared with
    the f32 backward), runs the 3xTF32 products at the key tiles the
    emulation assumes."""
    assert "attn_fwd_tf32.cu" in kernels.SOURCES
    assert kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_f32"] == kernels._ENTRY_POINTS[
        "vdiff_attn_fwd_tc"]
    assert kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_f32_lse"] == kernels._ENTRY_POINTS[
        "vdiff_attn_fwd_tc_lse"]
    d0 = kernels.source_digest()
    for name in kernels.SOURCES + kernels.HEADERS:
        (tmp_path / name).write_bytes(open(os.path.join(kernels.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
    assert kernels.source_digest() == d0
    (tmp_path / "attn_fwd_tf32.cu").write_text((tmp_path / "attn_fwd_tf32.cu").read_text() + "\n")
    assert kernels.source_digest() != d0
    monkeypatch.undo()
    src = open(os.path.join(kernels.CSRC_DIR, "attn_fwd_tf32.cu")).read()
    assert '#include "attn_tf32.cuh"' in src and "attn_tf32.cuh" in kernels.HEADERS
    src += open(os.path.join(kernels.CSRC_DIR, "attn_tf32.cuh")).read()
    for token in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32", "cvt.rna.tf32.f32",
                  "cp.async" if "cp.async" in src else "cp_async16",
                  'extern "C" int vdiff_attn_fwd_tc_f32(', 'extern "C" int vdiff_attn_fwd_tc_f32_lse('):
        assert token in src
    assert re.search(r"kBk = C >= 128 \? 32 : 64;", src)
    assert {C: (32 if C >= 128 else 64) for C in KEY_TILE} == KEY_TILE
