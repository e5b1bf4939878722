"""B6-B9 of the port on the tensor cores, on the CPU, where no CUDA kernel
runs.

bf16 CUDA calls of ``attn_fwd_pack1`` (B6) run ``attn_fwd_tc.cu``, those of
``attn_fwd_pack1_lse`` (B7) its lse entry, those of ``attn_bwd_pack1`` (B8)
``attn_bwd_tc.cu`` and those of ``attn_bwd_pack1_kv`` (B9) that file's
saved-statistics entry. The kernels' tile algorithms, emulated in torch
(``tests/torch_parity.py``), are held on bf16 inputs made from a numpy seed
against JAX's head-dim 32/64 Pallas kernels in interpret mode at small blocks
(bq = 128, kv chunks of 128, as tests/test_torch_celeba_attention.py runs
them), within the limits chip_smoke.py holds the kernels to on the card:

* B6's and B7's output: 2^-8·|ref| + 2^-8·(P·|v|) + 1e-4 per element (B2's
  limit: the kernel rounds e to bf16 as the operand of e·v, which moves an
  output by at most 2^-9·Σ p|v|, where JAX's B6 and B7 take e·v in f32); B7's
  lse within 1e-4 (f32 on both sides, other roundings only). JAX broadcasts
  lse over each head's C lanes of a (B, T, N·C) array; one lane is taken.
* B8's and B9's d(qkv): per slot 2^-7·|ref| + 2^-8·max|ref| (both round P
  and dS to bf16 as operands; f32 sums in another order can move a rounding
  one step). B9 takes δ = Σ_C dO∘O from the saved output, as JAX's does; a
  case where the full-row rowsum(P∘dP) differs shows that it must.
* B9 on the tensor-core B7's output, against JAX's B9 on JAX's B7: see
  :func:`_out_shift_slack`.

Then the wrappers' dispatch on dtype into a recording stub library (meta
tensors), their refusals, and the build registration of the new entry.
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

SHAPES = [(2, 256, 2, 64), (2, 256, 4, 32)]  # (B, T, N, C): N·C = 128, JAX's pack1 gate
BQ, BKV = 128, 128
# lse against JAX's and the twins', f32 on both sides (chip_smoke's LSE_ATOL)
LSE_ATOL = 1e-4


def _jax_bf16(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _jax_lse(lse, B, T, N, C):
    """JAX's lane-broadcast (B, T, N·C) lse → (B, N, T)."""
    return _np(lse).reshape(B, T, N, C)[..., 0].transpose(0, 2, 1)


def _jax_dqkv(dq, dk, dv):
    """JAX's three outputs → one bf16 d(qkv), as its custom VJPs concatenate."""
    return _np(jnp.concatenate([dq, dk.astype(jnp.bfloat16), dv.astype(jnp.bfloat16)], -1))


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b7_tc_forward_matches_pallas_pack1_lse(B, T, N, C):
    from vdiff_tpu.ops.attention import _pack1_fwd_lse_call

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=7 * C + N)
    ref_out, ref_lse = _pack1_fwd_lse_call(_jax_bf16(qkv), N, C, BQ, interpret=True)
    out, lse = P.emulate_fwd_tc(qkv, N)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, N * C)
    assert lse.dtype == torch.float32 and lse.shape == (B, N, T)
    P.check_fwd_tc(out, _np(ref_out), qkv, N)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(ref_lse, B, T, N, C), rtol=0, atol=LSE_ATOL)
    # and the port's f32 twin of B7, whose lse the card's check reads
    _, twin_lse = A.attention_qkv_lse_reference(qkv.float(), N)
    np.testing.assert_allclose(lse.numpy(), twin_lse.numpy(), rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b8_tc_backward_matches_pallas_pack1(B, T, N, C):
    from vdiff_tpu.ops.attention import _pack1_bwd_call

    qkv, g = P.bf16_inputs(B, T, N, C, seed=8 * C + N)
    ref = _jax_dqkv(*_pack1_bwd_call(_jax_bf16(qkv), _jax_bf16(g), N, C, BQ, interpret=True))
    got = P.emulate_bwd_tc(qkv, g, N)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    P.check_bwd_tc(got, ref)
    P.check_bwd_tc(got, A.attention_qkv_bwd_reference(qkv, g, N).float().numpy())


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b6_tc_forward_matches_pallas_pack1(B, T, N, C):
    from vdiff_tpu.ops.attention import _pack1_fwd_call

    qkv, _ = P.bf16_inputs(B, T, N, C, seed=6 * C + N)
    ref = _np(_pack1_fwd_call(_jax_bf16(qkv), N, C, BQ, interpret=True))
    out, _ = P.emulate_fwd_tc(qkv, N)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, N * C)
    P.check_fwd_tc(out, ref, qkv, N)
    # and the CPU twin attn_fwd_pack1 returns, B6's f32 e·v cast once
    P.check_fwd_tc(out, A.attn_fwd_pack1(qkv, N).float().numpy(), qkv, N)


def _jax_b7(qkv, N, C):
    """JAX's B7 on bf16 ``qkv``: (its jax out, its jax lse, out as a bf16
    tensor, lse as (B, N, T) f32)."""
    from vdiff_tpu.ops.attention import _pack1_fwd_lse_call

    B, T, _ = qkv.shape
    jout, jlse = _pack1_fwd_lse_call(_jax_bf16(qkv), N, C, BQ, interpret=True)
    out = torch.from_numpy(np.array(_np(jout))).bfloat16()
    return jout, jlse, out, torch.from_numpy(np.array(_jax_lse(jlse, B, T, N, C)))


def _jax_b9(qkv, jout, jlse, g, N, C):
    from vdiff_tpu.ops.attention import _pack1_bwd_kv_call

    return _jax_dqkv(*_pack1_bwd_kv_call(_jax_bf16(qkv), jout, jlse, _jax_bf16(g), N, C, BQ, BKV,
                                         interpret=True))


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b9_tc_backward_matches_pallas_pack1_kv(B, T, N, C):
    """The saved-statistics entry's algorithm on JAX's B7 (out, lse) against
    JAX's B9 on the same, and against the port's B9 twin."""
    qkv, g = P.bf16_inputs(B, T, N, C, seed=10 * C + N)
    jout, jlse, out, lse = _jax_b7(qkv, N, C)
    ref = _jax_b9(qkv, jout, jlse, g, N, C)
    got = P.emulate_bwd_tc_kv(qkv, out, lse, g, N)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    P.check_bwd_tc(got, ref)
    P.check_bwd_tc(got, A.attention_qkv_bwd_kv_reference(qkv, out, lse, g, N).float().numpy())


def test_b9_tc_takes_delta_from_the_saved_output():
    """δ = Σ_C dO∘O from the saved bf16 O, as JAX's B9 takes it, and not the
    full-row rowsum(P∘dP) of the other entry. A case where the two differ:
    v carries an offset of 4, so each output's bf16 rounding is up to 2^-6,
    and d(out) leans the way each output was rounded, so the differences add
    up over the C columns of a row. With the saved δ the algorithm stays
    within the bf16 backward limit of JAX's B9; with the full-row δ of the
    same row it does not."""
    B, T, N, C = SHAPES[0]
    rng = np.random.RandomState(12)
    x = (rng.randn(B, T, 3 * N * C) * 0.5).astype(np.float32)
    x[..., 2 * N * C:] += 4.0
    qkv = torch.from_numpy(x).bfloat16()
    jout, jlse, out, lse = _jax_b7(qkv, N, C)
    rounding = out.float() - A.attention_qkv_lse_reference(qkv.float(), N)[0]
    noise = torch.from_numpy(rng.randn(B, T, N * C).astype(np.float32))
    g = (torch.sign(rounding) + 0.25 * noise).bfloat16()
    ref = _jax_b9(qkv, jout, jlse, g, N, C)

    saved = P.saved_delta(out, g, N)
    got = P.emulate_bwd_tc_kv(qkv, out, lse, g, N)
    assert torch.equal(got, P.emulate_bwd_tc_stats(qkv, g, N, lse, saved))
    P.check_bwd_tc(got, ref)

    q, k, v = P._split(qkv, N)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(C), -1)
    full_row = (p * (P._do(g, N) @ v.transpose(-1, -2))).sum(-1)
    assert (full_row - saved).abs().max() > 0.1
    with pytest.raises(AssertionError, match="largest excess"):
        P.check_bwd_tc(P.emulate_bwd_tc_stats(qkv, g, N, lse, full_row), ref)


def _out_shift_slack(qkv, g, N):
    """How far B9's d(qkv) may move, per element, when it reads the tensor-core
    B7's (out, lse) in place of JAX's B7's, from the limits those are held to.

    out: each lies within tol = 2^-8·|o| + 2^-8·(P·|v|) + 1e-4 of the f32 twin
    o (JAX's within half an ulp, 2^-9·|o|), so the two differ by at most
    2·tol, and B9's δ_i = Σ_c dO_ic·O_ic by at most Δδ_i = Σ_c |dO_ic|·2·tol_ic.
    δ enters only dS_ij = P_ij·(dP_ij − δ_i): dQ_i moves by at most
    Δδ_i·Σ_j P_ij|k_j|/√C, dK_j by Σ_i P_ij·Δδ_i·|q_i|/√C, dV not at all.
    lse: each within 1e-4 of the twin's, so P = exp(S − lse) moves by at most
    ε = 2.0002e-4 of itself, and dS, dQ, dK, dV by ε times the sums of the
    magnitudes of their terms. P, dP and dS are the f32 twin's."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    x = qkv.float()
    o = A.attention_qkv_reference(x, N)
    x_abs_v = x.clone()
    x_abs_v[..., 2 * N * C:] = x_abs_v[..., 2 * N * C:].abs()
    tol = P.FWD_RTOL * o.abs() + P.FWD_RTOL * A.attention_qkv_reference(x_abs_v, N) + P.FWD_ATOL
    do = g.float().reshape(B, T, N, C)
    d_delta = (do.abs() * 2 * tol.reshape(B, T, N, C)).sum(-1).permute(0, 2, 1)[..., None]
    q, k, v = (a.permute(0, 2, 1, 3) for a in x.reshape(B, T, 3, N, C).unbind(2))
    do = do.permute(0, 2, 1, 3)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(C), dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).abs()
    eps = 2 * LSE_ATOL * 1.0001  # e^x − 1 ≤ 1.0001·x for x ≤ 2e-4
    pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
    dq = (d_delta * (p @ k.abs()) + eps * (ds @ k.abs())) / math.sqrt(C)
    dk = (pt @ (d_delta * q.abs()) + eps * (dst @ q.abs())) / math.sqrt(C)
    dv = eps * (pt @ do.abs())
    return torch.cat([a.permute(0, 2, 1, 3).reshape(B, T, N * C) for a in (dq, dk, dv)], -1)


def _check_chain(got, ref, slack):
    """The bf16 backward limit plus :func:`_out_shift_slack`, slot by slot."""
    for slot, a, r, s in zip("qkv", *(np.split(t, 3, -1) for t in (got, ref, slack))):
        tol = P.BWD_RTOL * np.abs(r) + P.BWD_SCALE * np.abs(r).max() + s
        err = np.abs(a - r)
        assert (err <= tol).all(), f"d{slot}: largest excess {(err - tol).max()}"


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b9_on_the_tc_forward_stays_near_jax_b9_on_jax_b7(B, T, N, C):
    """The chain of the kv-streamed training path: JAX's B9 on JAX's B7
    (out, lse) against the port's B9 twin on the emulated tensor-core B7's
    (out, lse), within the bf16 backward limit plus :func:`_out_shift_slack`.
    The changed B7 output does not push B9's gradients off JAX's."""
    qkv, g = P.bf16_inputs(B, T, N, C, seed=9 * C + N)
    jout, jlse, _, _ = _jax_b7(qkv, N, C)
    ref = _jax_b9(qkv, jout, jlse, g, N, C)
    out, lse = P.emulate_fwd_tc(qkv, N)
    got = A.attention_qkv_bwd_kv_reference(qkv, out, lse, g, N).float().numpy()
    _check_chain(got, ref, _out_shift_slack(qkv, g, N).numpy())


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_tc_b7_then_tc_b9_stays_near_jax_b7_then_jax_b9(B, T, N, C):
    """The bf16 training path as the card runs it: the emulated tensor-core
    B7, then the emulated tensor-core B9 on its (out, lse), against JAX's B7
    then JAX's B9, within the bf16 backward limit plus
    :func:`_out_shift_slack`."""
    qkv, g = P.bf16_inputs(B, T, N, C, seed=9 * C + N)
    jout, jlse, _, _ = _jax_b7(qkv, N, C)
    ref = _jax_b9(qkv, jout, jlse, g, N, C)
    out, lse = P.emulate_fwd_tc(qkv, N)
    got = P.emulate_bwd_tc_kv(qkv, out, lse, g, N).float().numpy()
    _check_chain(got, ref, _out_shift_slack(qkv, g, N).numpy())


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

COUNTERS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd_rows",
            "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc", "attn_fwd_pack1", "attn_fwd_pack1_lse",
            "attn_bwd_pack1", "attn_bwd_pack1_kv", "attn_bwd")


@pytest.fixture
def recorded(monkeypatch):
    """Meta tensors take the wrappers' launch path into a recording stub
    library; returns a function that reads (entry points asked for, nonzero
    launch counts) and clears both."""
    lib = P.RecordingStubLibrary()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(A, "_need_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    for name in COUNTERS:
        monkeypatch.setattr(getattr(A, name), "launches", 0)

    def read():
        calls = list(lib.calls)
        counts = {name: getattr(A, name).launches for name in COUNTERS if getattr(A, name).launches}
        lib.calls.clear()
        for name in COUNTERS:
            getattr(A, name).launches = 0
        return calls, counts

    return read


@pytest.mark.parametrize("T", [256, 1024, 2048, 4096])
def test_pack1_dispatch_on_dtype(recorded, T):
    """bf16 calls reach the bf16 tensor-core entries, f32 calls the f32
    (3xTF32) ones (``attn_fwd_tf32.cu``, ``attn_bwd_tf32.cu``); each counts
    under its own wrapper only, never under attn_fwd_tc, attn_bwd_tc or the
    pair's counters. Neither backward has a T cap to ask for (T=2048 and 4096
    were past the f32-FMA row kernel's cap at C=64)."""
    N, C = 2, 64
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        qkv = torch.empty(2, T, 3 * N * C, dtype=dtype, device="meta")
        g = torch.empty(2, T, N * C, dtype=dtype, device="meta")
        out = A.attn_fwd_pack1(qkv, N)
        assert (out.shape, out.dtype) == ((2, T, N * C), dtype)
        assert recorded() == (["vdiff_attn_fwd_tc" if bf16 else "vdiff_attn_fwd_tc_f32"],
                              {"attn_fwd_pack1": 1})
        out, lse = A.attn_fwd_pack1_lse(qkv, N)
        assert (out.shape, out.dtype, lse.shape, lse.dtype) == ((2, T, N * C), dtype, (2, N, T),
                                                                torch.float32)
        assert recorded() == (["vdiff_attn_fwd_tc_lse" if bf16 else "vdiff_attn_fwd_tc_f32_lse"],
                              {"attn_fwd_pack1_lse": 1})
        assert A.attn_bwd_pack1(qkv, g, N).shape == qkv.shape
        want = (["vdiff_attn_bwd_tc"] if bf16 else
                ["vdiff_attn_bwd_tf32_rows", "vdiff_attn_bwd_tf32_cols"])
        assert recorded() == (want, {"attn_bwd_pack1": 1})
        assert A.attn_bwd_pack1_kv(qkv, out, lse, g, N).shape == qkv.shape
        assert recorded() == (["vdiff_attn_bwd_tc_kv" if bf16 else "vdiff_attn_bwd_tf32_kv"],
                              {"attn_bwd_pack1_kv": 1})


def test_bf16_celeba_step_reaches_the_tc_entries(recorded):
    """One bf16 training forward and backward of the full-width celeba UNet
    on the meta device: B8 ×9, B5 ×1 and B4 ×16 launch vdiff_attn_bwd_tc, B9
    ×1 vdiff_attn_bwd_tc_kv, B7 ×1 vdiff_attn_fwd_tc_lse, B6 ×9, B3 ×16 and
    B2 ×1 vdiff_attn_fwd_tc; no FMA entry runs; the per-counter launch counts
    are chip_smoke's CELEBA_STEP_LAUNCHES_BF16 (B4's under attn_bwd)."""
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/celeba.json")
    with torch.device("meta"):
        model = build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                           model_out_type=cfg["diffusion"]["model_out_type"], num_classes=40,
                           multitags=True, dtype=torch.bfloat16)
    x, t = torch.empty(2, 64, 64, 3, device="meta"), torch.empty(2, device="meta")
    model(x, t, torch.empty(2, 40, device="meta"), train=True).float().sum().backward()
    calls, counts = recorded()
    entries = {name: calls.count(name) for name in set(calls)}
    assert entries == {"vdiff_attn_fwd_tc_lse": 1, "vdiff_attn_fwd_tc": 26,
                       "vdiff_attn_bwd_tc": 26, "vdiff_attn_bwd_tc_kv": 1}
    assert counts == {"attn_fwd_pack1": 9, "attn_fwd_pack1_lse": 1, "attn_bwd_pack1": 9,
                      "attn_bwd_pack1_kv": 1, "attn_fwd_train": 16, "attn_fwd_tc": 1,
                      "attn_bwd": 16, "attn_bwd_tc": 1}


@pytest.mark.parametrize("wrapper", ["attn_fwd_pack1", "attn_fwd_pack1_lse", "attn_bwd_pack1",
                                     "attn_bwd_pack1_kv"])
def test_bf16_pack1_calls_refuse_unaligned_tensors(recorded, wrapper):
    """Contiguous bf16 tensors 2 bytes past a 16-byte boundary: the
    tensor-core kernels' cp.async tiles cannot read them, so the call is
    refused before any launch. The same call on aligned tensors launches."""
    N, C, T = 2, 64, 256

    def call(offset):
        qkv = torch.empty(offset + T * 3 * N * C, dtype=torch.bfloat16, device="meta")
        g = torch.empty(offset + T * N * C, dtype=torch.bfloat16, device="meta")
        qkv, g = qkv[offset:].view(1, T, 3 * N * C), g[offset:].view(1, T, N * C)
        if wrapper == "attn_bwd_pack1_kv":
            out = torch.empty(offset + T * N * C, dtype=torch.bfloat16, device="meta")
            out = out[offset:].view(1, T, N * C)
            lse = torch.empty(1, N, T, device="meta")
            return A.attn_bwd_pack1_kv(qkv, out, lse, g, N)
        if wrapper == "attn_bwd_pack1":
            return A.attn_bwd_pack1(qkv, g, N)
        return getattr(A, wrapper)(qkv, N)

    with pytest.raises(ValueError, match="16-byte"):
        call(1)
    assert recorded() == ([], {})
    call(8)  # 16 bytes in: aligned
    assert recorded()[1] == {wrapper: 1}


def test_lse_entry_is_built_and_bound():
    """kernels.py binds vdiff_attn_fwd_tc_lse (qkv, out, lse, B, T, N, C,
    stream) and attn_fwd_tc.cu exports it from the lse instantiation of the
    forward kernel (templated on the q tile's warps as well)."""
    assert "attn_fwd_tc.cu" in kernels.SOURCES
    assert len(kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_lse"]) == 8
    assert kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_lse"][:3] == [kernels._P] * 3
    src = open(os.path.join(kernels.CSRC_DIR, "attn_fwd_tc.cu")).read()
    assert re.search(r'extern "C" int vdiff_attn_fwd_tc_lse\(', src)
    assert "template <int C, bool kLse, int kWarps>" in src and "if constexpr (kLse)" in src
    assert "attn_fwd_tc_kernel<C, true, kWarps>" in src
    assert "attn_fwd_tc_kernel<C, false, kWarps>" in src


def test_kv_entry_is_built_and_bound():
    """kernels.py binds vdiff_attn_bwd_tc_kv (qkv, out, lse, dout, dqkv,
    delta, B, T, N, C, stream) and attn_bwd_tc.cu exports it, launching the
    saved-statistics instantiation of the row kernel at head dims 32 and 64;
    the full-row entry keeps the other instantiation."""
    assert "attn_bwd_tc.cu" in kernels.SOURCES
    assert kernels._ENTRY_POINTS["vdiff_attn_bwd_tc_kv"] == [kernels._P] * 6 + [kernels._I] * 4 + [
        kernels._P]
    src = open(os.path.join(kernels.CSRC_DIR, "attn_bwd_tc.cu")).read()
    assert re.search(r'extern "C" int vdiff_attn_bwd_tc_kv\(', src)
    assert "template <int C, bool kSaved>" in src and "if constexpr (kSaved)" in src
    assert "launch_bwd<C, false>" in src
    assert "launch_bwd<32, true>" in src and "launch_bwd<64, true>" in src
