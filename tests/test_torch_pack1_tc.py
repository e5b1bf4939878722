"""B7 and B8 of the port on the tensor cores, on the CPU, where no CUDA kernel
runs.

bf16 CUDA calls of ``attn_fwd_pack1_lse`` (B7) run the lse entry of
``attn_fwd_tc.cu`` and those of ``attn_bwd_pack1`` (B8) run
``attn_bwd_tc.cu``. The kernels' tile algorithms, emulated in torch
(``tests/torch_parity.py``), are held on bf16 inputs made from a numpy seed
against JAX's head-dim 32/64 Pallas kernels in interpret mode at small blocks
(bq = 128, kv chunks of 128, as tests/test_torch_celeba_attention.py runs
them), within the limits chip_smoke.py holds the kernels to on the card:

* B7's output: 2^-8·|ref| + 2^-8·(P·|v|) + 1e-4 per element (B2's limit: the
  kernel rounds e to bf16 as the operand of e·v, which moves an output by at
  most 2^-9·Σ p|v|, where JAX's B7 takes e·v in f32); its lse within 1e-4
  (f32 on both sides, other roundings only). JAX broadcasts lse over each
  head's C lanes of a (B, T, N·C) array; one lane is taken.
* B8's d(qkv): per slot 2^-7·|ref| + 2^-8·max|ref| (both round P and dS to
  bf16 as operands; f32 sums in another order can move a rounding one step).
* B9 (JAX's, and the port's twin) on B7's output: see
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


@pytest.mark.parametrize("B,T,N,C", SHAPES)
def test_b9_on_the_tc_forward_stays_near_jax_b9_on_jax_b7(B, T, N, C):
    """The chain of the kv-streamed training path: JAX's B9 on JAX's B7
    (out, lse) against the port's B9 twin on the emulated tensor-core B7's
    (out, lse), within the bf16 backward limit plus :func:`_out_shift_slack`.
    The changed B7 output does not push B9's gradients off JAX's."""
    from vdiff_tpu.ops.attention import _pack1_bwd_kv_call, _pack1_fwd_lse_call

    qkv, g = P.bf16_inputs(B, T, N, C, seed=9 * C + N)
    jq, jg = _jax_bf16(qkv), _jax_bf16(g)
    jout, jlse = _pack1_fwd_lse_call(jq, N, C, BQ, interpret=True)
    ref = _jax_dqkv(*_pack1_bwd_kv_call(jq, jout, jlse, jg, N, C, BQ, BKV, interpret=True))
    out, lse = P.emulate_fwd_tc(qkv, N)
    got = A.attention_qkv_bwd_kv_reference(qkv, out, lse, g, N).float().numpy()
    slack = _out_shift_slack(qkv, g, N).numpy()
    for slot, a, r, s in zip("qkv", *(np.split(t, 3, -1) for t in (got, ref, slack))):
        tol = P.BWD_RTOL * np.abs(r) + P.BWD_SCALE * np.abs(r).max() + s
        err = np.abs(a - r)
        assert (err <= tol).all(), f"d{slot}: largest excess {(err - tol).max()}"


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

COUNTERS = ("attn_fwd_online", "attn_fwd_qblk", "attn_fwd_train", "attn_bwd_rows",
            "attn_bwd_cols", "attn_fwd_tc", "attn_bwd_tc", "attn_fwd_pack1", "attn_fwd_pack1_lse",
            "attn_bwd_pack1", "attn_bwd_pack1_kv")


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
    """bf16 calls reach the tensor-core entries and f32 calls the FMA ones;
    each counts under its own wrapper only. The f32 backward asks for the
    row kernel's T cap; the bf16 one has none to ask for (T=2048 and 4096
    are past the f32 cap at C=64)."""
    N, C = 2, 64
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        qkv = torch.empty(2, T, 3 * N * C, dtype=dtype, device="meta")
        g = torch.empty(2, T, N * C, dtype=dtype, device="meta")
        out, lse = A.attn_fwd_pack1_lse(qkv, N)
        assert (out.shape, out.dtype, lse.shape, lse.dtype) == ((2, T, N * C), dtype, (2, N, T),
                                                                torch.float32)
        assert recorded() == (["vdiff_attn_fwd_tc_lse" if bf16 else "vdiff_attn_fwd_pack1_lse"],
                              {"attn_fwd_pack1_lse": 1})
        assert A.attn_bwd_pack1(qkv, g, N).shape == qkv.shape
        want = (["vdiff_attn_bwd_tc"] if bf16 else
                ["vdiff_attn_bwd_rows_max_t", "vdiff_attn_bwd_rows", "vdiff_attn_bwd_cols"])
        assert recorded() == (want, {"attn_bwd_pack1": 1})


def test_bf16_celeba_step_reaches_the_tc_entries(recorded):
    """One bf16 training forward and backward of the full-width celeba UNet
    on the meta device: B8 ×9 and B5 ×1 launch vdiff_attn_bwd_tc, B7 ×1
    vdiff_attn_fwd_tc_lse, B2 ×1 vdiff_attn_fwd_tc; the FMA entries of B7 and
    the pair run only B4's 16 calls; the counts are chip_smoke's
    CELEBA_STEP_LAUNCHES_BF16."""
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/celeba.json")
    with torch.device("meta"):
        model = build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                           model_out_type=cfg["diffusion"]["model_out_type"], num_classes=40,
                           multitags=True, dtype=torch.bfloat16)
    x, t = torch.empty(2, 64, 64, 3, device="meta"), torch.empty(2, device="meta")
    model(x, t, torch.empty(2, 40, device="meta"), train=True).float().sum().backward()
    calls, counts = recorded()
    entries = {name: calls.count(name) for name in set(calls) if not name.endswith("_max_t")}
    assert entries == {"vdiff_attn_fwd_online": 9, "vdiff_attn_fwd_tc_lse": 1,
                       "vdiff_attn_fwd_train": 16, "vdiff_attn_fwd_tc": 1,
                       "vdiff_attn_bwd_tc": 10, "vdiff_attn_bwd_pack1_kv": 1,
                       "vdiff_attn_bwd_rows": 16, "vdiff_attn_bwd_cols": 16}
    assert counts == {"attn_fwd_pack1": 9, "attn_fwd_pack1_lse": 1, "attn_bwd_pack1": 9,
                      "attn_bwd_pack1_kv": 1, "attn_fwd_train": 16, "attn_fwd_tc": 1,
                      "attn_bwd_rows": 16, "attn_bwd_cols": 16, "attn_bwd_tc": 1}


@pytest.mark.parametrize("wrapper", ["attn_fwd_pack1_lse", "attn_bwd_pack1"])
def test_bf16_pack1_calls_refuse_unaligned_tensors(recorded, wrapper):
    """Contiguous bf16 tensors 2 bytes past a 16-byte boundary: the
    tensor-core kernels' cp.async tiles cannot read them, so the call is
    refused before any launch. The same call on aligned tensors launches."""
    N, C, T = 2, 64, 256

    def call(offset):
        qkv = torch.empty(offset + T * 3 * N * C, dtype=torch.bfloat16, device="meta")
        g = torch.empty(offset + T * N * C, dtype=torch.bfloat16, device="meta")
        qkv, g = qkv[offset:].view(1, T, 3 * N * C), g[offset:].view(1, T, N * C)
        return A.attn_fwd_pack1_lse(qkv, N) if wrapper == "attn_fwd_pack1_lse" else \
            A.attn_bwd_pack1(qkv, g, N)

    with pytest.raises(ValueError, match="16-byte"):
        call(1)
    assert recorded() == ([], {})
    call(8)  # 16 bytes in: aligned
    assert recorded()[1] == {wrapper: 1}


def test_lse_entry_is_built_and_bound():
    """kernels.py binds vdiff_attn_fwd_tc_lse (qkv, out, lse, B, T, N, C,
    stream) and attn_fwd_tc.cu exports it from the lse instantiation of the
    forward kernel."""
    assert "attn_fwd_tc.cu" in kernels.SOURCES
    assert len(kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_lse"]) == 8
    assert kernels._ENTRY_POINTS["vdiff_attn_fwd_tc_lse"][:3] == [kernels._P] * 3
    src = open(os.path.join(kernels.CSRC_DIR, "attn_fwd_tc.cu")).read()
    assert re.search(r'extern "C" int vdiff_attn_fwd_tc_lse\(', src)
    assert "template <int C, bool kLse>" in src and "if constexpr (kLse)" in src
    assert "attn_fwd_tc_kernel<C, true>" in src and "attn_fwd_tc_kernel<C, false>" in src
