"""The f32 attention backward of the port on the tensor cores
(``csrc/attn_bwd_tf32.cu``, 3xTF32), on the CPU, where no CUDA kernel runs.

f32 CUDA calls of B4 and B5 (``attn_bwd``, through ``attn_bwd_rows`` and
``attn_bwd_cols``), B8 (``attn_bwd_pack1``) and B9 (``attn_bwd_pack1_kv``)
run this file's kernels. Their tile algorithm is written out here in torch
at the kernels' key and q tiles, every product split as the kernels' cvt.rna
does (``tests/test_torch_attention_tf32.py::_mm``: hi·hi + (hi·lo + lo·hi),
the cross terms summed apart): the full-row row kernel's two sweeps (dP and
S per key tile, the running max, sum and d = Σ e·dP rescaled online, then
lse = m + log2 l and δ = d / l; then P = exp2(S − lse), dS = P∘(dP − δ),
dQ += dS·k), the saved-statistics row kernel (lse from the forward, δ =
Σ dO∘O from its saved output), and the column kernel (per q tile dPᵀ and Sᵀ,
Pᵀ = exp2(Sᵀ·log2e/√C − lse·log2e), dV += Pᵀ·dO, dK += dSᵀ·q). On f32 inputs
made from a numpy seed at unit scale it is held within 1e-5 of JAX's Pallas
backward kernels in interpret mode: the VJP of ``flash_attention_trainable``
at T=256 (B4's ``_attn_bwd_kernel``), ``_attn_bwd_kernel_qblk``'s body at a
ragged T=544 (B5), ``_pack1_bwd_call`` at C=64, N=2, T=256 (B8) and
``_pack1_bwd_kv_call`` at small blocks on JAX's own forward residuals (B9).
The same algorithm with one TF32 product (each operand rounded to TF32 once)
misses that bar in every case.

Then the wrappers, on meta tensors into a recording stub library: every f32
call launches the new entries (no f32-FMA entry, no T cap query), each
counted as before; what the kernels cannot take is refused before any
launch; the build registers and hashes the new source. ~14 s on one worker.
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
from tests.test_torch_attention_tc import _pallas_bwd_one_block  # noqa: E402
from tests.test_torch_attention_tf32 import _mm  # noqa: E402
from vdiff_tpu_torch import kernels  # noqa: E402
from vdiff_tpu_torch.ops import attention as A  # noqa: E402

pytest_plugins = ["torch_limits"]

# keys per tile of the row kernel and q rows per tile of the column kernel of
# attn_bwd_tf32.cu by head dim (RowShape::kBk, ColShape::kBq; at C=256 the
# warp-pair kernels' RowPairShape::kBk, ColPairShape::kBq)
KEY_TILE = {32: 64, 64: 64, 128: 32, 256: 16}
Q_TILE = dict(KEY_TILE)
# the bar: 3xTF32 within it of JAX's f32 kernels at unit-scale inputs, one
# TF32 product not (PR 18's forward bar)
ATOL = 1e-5
PACK1_BQ = PACK1_BKV = 128
LOG2E, LN2 = float(P.LOG2E), float(P.LN2)
# the f32-FMA entries the wrappers no longer reach
FMA_ENTRIES = ("vdiff_attn_bwd_rows", "vdiff_attn_bwd_rows_max_t", "vdiff_attn_bwd_cols",
               "vdiff_attn_bwd_pack1_kv")


def _heads(a, N):
    """(B, T, N·C) → (B, N, T, C)."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).permute(0, 2, 1, 3)


def _scales(C):
    scale = np.float32(1.0) / np.sqrt(np.float32(C))
    return float(scale), float(scale * np.float32(LOG2E))


def _dqkv(q, k, v, do, lse2, delta, passes):
    """Both kernels on the row statistics, lse2 (log2 units) and δ, each
    (B, N, T, 1): the row kernel's dQ sweep, then the column kernel; dQ and
    dK scaled by 1/√C at the end. Returns d(qkv) (B, T, 3·N·C) f32."""
    B, N, T, C = q.shape
    scale, scale_log2 = _scales(C)
    mm = lambda a, b: _mm(a, b, passes)
    dq = torch.zeros_like(q)
    bk = KEY_TILE[C]
    for j in range(0, T, bk):
        kj, vj = k[:, :, j:j + bk], v[:, :, j:j + bk]
        dp = mm(do, vj.transpose(-1, -2))
        s = mm(q, kj.transpose(-1, -2)) * scale_log2
        dq = dq + mm(torch.exp2(s - lse2) * (dp - delta), kj)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    bq = Q_TILE[C]
    lse_t, delta_t = (lse2 * LN2).transpose(-1, -2), delta.transpose(-1, -2)
    for i in range(0, T, bq):
        qi, doi = q[:, :, i:i + bq], do[:, :, i:i + bq]
        dpt = mm(v, doi.transpose(-1, -2))  # (keys, q rows)
        st = mm(k, qi.transpose(-1, -2))
        pt = torch.exp2(st * scale_log2 - lse_t[..., i:i + bq] * LOG2E)
        dv = dv + mm(pt, doi)
        dk = dk + mm(pt * (dpt - delta_t[..., i:i + bq]), qi)
    out = [a.permute(0, 2, 1, 3) for a in (dq * scale, dk * scale, dv)]
    return torch.stack(out, dim=2).reshape(B, T, 3 * N * C)


def emulate_bwd_tf32(qkv, g, N, passes=3):
    """The full-row entries (vdiff_attn_bwd_tf32_rows, then _cols) on f32 qkv
    (B, T, 3·N·C) and d(out) g: sweep 1 over the key tiles keeps per row the
    running max m, l = Σ exp2(s − m) and d = Σ exp2(s − m)·dP, both rescaled
    as m grows; lse2 = m + log2 l and δ = d / l; then :func:`_dqkv`."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    q, k, v = (_heads(a, N) for a in qkv.chunk(3, -1))
    do = _heads(g, N)
    scale_log2 = _scales(C)[1]
    m = torch.full((B, N, T, 1), -math.inf)
    l, d = torch.zeros(B, N, T, 1), torch.zeros(B, N, T, 1)
    bk = KEY_TILE[C]
    for j in range(0, T, bk):
        dp = _mm(do, v[:, :, j:j + bk].transpose(-1, -2), passes)
        s = _mm(q, k[:, :, j:j + bk].transpose(-1, -2), passes) * scale_log2
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        d = d * alpha + (p * dp).sum(-1, keepdim=True)
        m = m_new
    return _dqkv(q, k, v, do, m + torch.log2(l), d / l, passes)


def emulate_bwd_tf32_kv(qkv, out, lse, g, N, passes=3):
    """The saved-statistics entry (vdiff_attn_bwd_tf32_kv): the forward's lse
    (B, N, T, natural log) as lse2 = lse·log2e, δ = Σ_C dO∘O from its saved
    output, then :func:`_dqkv`."""
    q, k, v = (_heads(a, N) for a in qkv.chunk(3, -1))
    do = _heads(g, N)
    delta = (do * _heads(out, N)).sum(-1, keepdim=True)
    return _dqkv(q, k, v, do, lse[..., None] * LOG2E, delta, passes)


def _inputs(B, T, N, C, seed):
    """Seeded unit-scale f32 qkv (B, T, 3·N·C) and d(out) (B, T, N·C)."""
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(B, T, 3 * N * C).astype(np.float32)),
            torch.from_numpy(rng.randn(B, T, N * C).astype(np.float32)))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _fold(a, N):
    """(B, T, N·C) → (B·N, T, C), JAX's head folding."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).transpose(0, 2, 1, 3).reshape(B * N, T, NC // N)


def _unfold(a, B, N):
    BN, T, C = a.shape
    return a.reshape(B, N, T, C).transpose(0, 2, 1, 3).reshape(B, T, N * C)


def _folded(qkv, g, N):
    q, k, v = (jnp.asarray(_fold(a, N)) for a in np.split(qkv.numpy(), 3, axis=-1))
    return q, k, v, jnp.asarray(_fold(g.numpy(), N))


def _jax_b4(qkv, g, N):
    from vdiff_tpu.ops.attention import flash_attention_trainable

    B = qkv.shape[0]
    q, k, v, do = _folded(qkv, g, N)
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_trainable(q, k, v, True), q, k, v)
    return np.concatenate([_unfold(_np(d), B, N) for d in vjp(do)], -1), None


def _jax_b5(qkv, g, N):
    B = qkv.shape[0]
    return np.concatenate([_unfold(_np(d), B, N)
                           for d in _pallas_bwd_one_block(*_folded(qkv, g, N))], -1), None


def _jax_b8(qkv, g, N):
    from vdiff_tpu.ops.attention import _pack1_bwd_call

    C = g.shape[-1] // N
    d = _pack1_bwd_call(jnp.asarray(qkv.numpy()), jnp.asarray(g.numpy()), N, C, PACK1_BQ,
                        interpret=True)
    return np.concatenate([_np(a) for a in d], -1), None


def _jax_b9(qkv, g, N):
    """JAX's forward residuals (out f32, lse lane-broadcast) and its kv
    backward; returns d(qkv) and (out, lse (B, N, T)) for the emulation."""
    from vdiff_tpu.ops.attention import _pack1_bwd_kv_call, _pack1_fwd_lse_call

    B, T, NC = g.shape
    C = NC // N
    jq, jg = jnp.asarray(qkv.numpy()), jnp.asarray(g.numpy())
    out, lse = _pack1_fwd_lse_call(jq, N, C, PACK1_BQ, interpret=True)
    d = _pack1_bwd_kv_call(jq, out, lse, jg, N, C, PACK1_BQ, PACK1_BKV, interpret=True)
    saved = (torch.from_numpy(np.array(_np(out))),
             torch.from_numpy(np.ascontiguousarray(
                 _np(lse).reshape(B, T, N, C)[..., 0].transpose(0, 2, 1))))
    return np.concatenate([_np(a) for a in d], -1), saved


# (JAX's kernel, B, T, N, C): B4 at T=256 with CIFAR's head of 256 through
# flash_attention_trainable's VJP; B5's body at a ragged T > 512 (a multiple
# of 32 and not of 64: the last key and q tiles half masked) in one q block;
# B8 and B9 at JAX's pack1 gate (N·C = 128), B9 over two kv chunks
CASES = {"b4_attn_bwd_kernel": (_jax_b4, 1, 256, 1, 256),
         "b5_qblk_ragged": (_jax_b5, 1, 544, 2, 32),
         "b8_pack1": (_jax_b8, 1, 256, 2, 64), "b9_pack1_kv": (_jax_b9, 1, 256, 2, 64)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_tiles_match_pallas_and_one_pass_does_not(case):
    jax_fn, B, T, N, C = CASES[case]
    qkv, g = _inputs(B, T, N, C, seed=T + N + C)
    ref, saved = jax_fn(qkv, g, N)
    emulate = ((lambda passes: emulate_bwd_tf32_kv(qkv, *saved, g, N, passes)) if saved else
               (lambda passes: emulate_bwd_tf32(qkv, g, N, passes)))
    got = emulate(3)
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= ATOL, f"3xTF32 vs JAX: {err}"
    worst = np.abs(emulate(1).numpy() - ref).max()
    assert worst > ATOL, f"one TF32 pass within {ATOL} of JAX ({worst}): the bar shows nothing"
    # and the port's CPU twin, which the wrappers return on the CPU
    twin = (A.attention_qkv_bwd_kv_reference(qkv, *saved, g, N) if saved else
            A.attention_qkv_bwd_reference(qkv, g, N))
    assert np.abs(got.numpy() - twin.numpy()).max() <= ATOL


COUNTERS = ("attn_bwd", "attn_bwd_rows", "attn_bwd_cols", "attn_bwd_tc", "attn_bwd_pack1",
            "attn_bwd_pack1_kv", "attn_fwd_pack1_lse", "attn_fwd_train", "attn_fwd_qblk",
            "attn_fwd_pack1", "attn_fwd_tc", "attn_fwd_online")


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
        assert not set(lib.calls) & set(FMA_ENTRIES), lib.calls
        lib.launched.clear()
        lib.calls.clear()
        for name in COUNTERS:
            getattr(A, name).launches = 0
        return calls, counts

    return read


def _meta(B, T, N, C, dtype=torch.float32):
    return (torch.empty(B, T, 3 * N * C, dtype=dtype, device="meta"),
            torch.empty(B, T, N * C, dtype=dtype, device="meta"))


# (wrapper, B, T, N, C): the f32 paths' shapes (the default train CLI: CIFAR's
# B4 at T=256 and 64, B5 at 1024; mnist's head of 128; celeba's B8, B4 and B5
# at N=9, B9 at T=4096) and a T past the f32-FMA row kernel's cap (1280 at
# C=256)
F32_CALLS = [("attn_bwd", 128, 256, 1, 256), ("attn_bwd", 128, 64, 1, 256),
             ("attn_bwd", 128, 1024, 1, 256), ("attn_bwd", 128, 256, 1, 128),
             ("attn_bwd", 48, 1024, 9, 64), ("attn_bwd", 2, 2048, 1, 256),
             ("attn_bwd_pack1", 48, 1024, 6, 64), ("attn_bwd_pack1", 48, 256, 12, 64),
             ("attn_bwd_pack1", 2, 4096, 2, 32), ("attn_bwd_pack1_kv", 48, 4096, 6, 64),
             ("attn_bwd_pack1_kv", 2, 256, 4, 32)]


@pytest.mark.parametrize("wrapper,B,T,N,C", F32_CALLS)
def test_f32_calls_launch_the_tf32_entries(recorded, wrapper, B, T, N, C):
    """attn_bwd: the row entry then the column entry, counted under
    attn_bwd_rows and attn_bwd_cols (B4 and B5 alike); attn_bwd_pack1: the
    same two entries, one count of its own; attn_bwd_pack1_kv: the
    saved-statistics entry, one count of its own. No f32-FMA entry, no T cap
    query."""
    qkv, g = _meta(B, T, N, C)
    if wrapper == "attn_bwd_pack1_kv":
        out, lse = torch.empty(B, T, N * C, device="meta"), torch.empty(B, N, T, device="meta")
        dqkv = A.attn_bwd_pack1_kv(qkv, out, lse, g, N)
    else:
        dqkv = getattr(A, wrapper)(qkv, g, N)
    assert (dqkv.shape, dqkv.dtype) == (qkv.shape, torch.float32)
    calls, counts = recorded()
    names = [name for name, _ in calls]
    # every entry: pointers, then B, T, N, C, then the stream
    assert all(args[-5:-1] == (B, T, N, C) and args[-1] == 0 for _, args in calls)
    if wrapper == "attn_bwd_pack1_kv":
        assert names == ["vdiff_attn_bwd_tf32_kv"] and counts == {wrapper: 1}
    else:
        assert names == ["vdiff_attn_bwd_tf32_rows", "vdiff_attn_bwd_tf32_cols"]
        assert counts == ({"attn_bwd_rows": 1, "attn_bwd_cols": 1} if wrapper == "attn_bwd"
                          else {wrapper: 1})


# the f32 train steps of both full-width models on the meta device: the
# counts chip_smoke.py asserts (TRAIN_STEP_LAUNCHES, CELEBA_STEP_LAUNCHES),
# every backward call on the new entries
F32_STEPS = {
    "cifar10_cond": ({"attn_fwd_train": 17, "attn_fwd_qblk": 1, "attn_bwd_rows": 18,
                      "attn_bwd_cols": 18},
                     {"vdiff_attn_fwd_tc_f32": 18, "vdiff_attn_bwd_tf32_rows": 18,
                      "vdiff_attn_bwd_tf32_cols": 18}),
    "celeba": ({"attn_fwd_pack1": 9, "attn_fwd_pack1_lse": 1, "attn_bwd_pack1": 9,
                "attn_bwd_pack1_kv": 1, "attn_fwd_train": 16, "attn_fwd_qblk": 1,
                "attn_bwd_rows": 17, "attn_bwd_cols": 17},
               {"vdiff_attn_fwd_tc_f32": 26, "vdiff_attn_fwd_tc_f32_lse": 1,
                "vdiff_attn_bwd_tf32_rows": 26, "vdiff_attn_bwd_tf32_cols": 26,
                "vdiff_attn_bwd_tf32_kv": 1}),
}


@pytest.mark.parametrize("name", sorted(F32_STEPS))
def test_f32_train_step_reaches_the_tf32_entries(recorded, name):
    from vdiff_tpu_torch.factory import CONFIG_DIR, build_unet, load_experiment_config

    counts, entries = F32_STEPS[name]
    cfg, _ = load_experiment_config(f"{CONFIG_DIR}/{name}.json")
    celeba = name == "celeba"
    with torch.device("meta"):
        model = build_unet(dict(cfg["model"], drop_rate=0.0), in_channels=3,
                           model_out_type=cfg["diffusion"]["model_out_type"],
                           num_classes=40 if celeba else 10, multitags=celeba)
    res, B = (64, 2) if celeba else (32, 2)
    y = torch.empty(B, 40, device="meta") if celeba else torch.empty(B, device="meta")
    model(torch.empty(B, res, res, 3, device="meta"), torch.empty(B, device="meta"), y,
          train=True).sum().backward()
    calls, got = recorded()
    assert {n: [c for c, _ in calls].count(n) for n, _ in calls} == entries
    assert got == counts


def _bad(bad, wrapper):
    """f32 inputs that the kernels cannot take, and the error they raise."""
    N, C, T = 2, 64, 256
    qkv, g = _meta(1, T, N, C)
    if bad == "misaligned_qkv":  # contiguous, 4 bytes past a 16-byte boundary
        qkv = torch.empty(1 + T * 3 * N * C, device="meta")[1:].view(1, T, 3 * N * C)
    elif bad == "misaligned_g":
        g = torch.empty(1 + T * N * C, device="meta")[1:].view(1, T, N * C)
    elif bad == "head_dim":
        qkv, g = _meta(1, T, N, 48)
    elif bad == "tokens":
        qkv, g = _meta(1, 240, N, C)
    elif bad == "layout":
        qkv = torch.empty(1, T, 2 * 3 * N * C, device="meta")[..., ::2]
    else:
        qkv, g = _meta(1, T, N, C, torch.float16)
        return qkv, g, TypeError
    return qkv, g, ValueError


@pytest.mark.parametrize("bad", ["misaligned_qkv", "misaligned_g", "head_dim", "tokens", "layout",
                                 "float16"])
@pytest.mark.parametrize("wrapper", ["attn_bwd", "attn_bwd_pack1", "attn_bwd_pack1_kv"])
def test_refusals_raise_before_any_launch(recorded, wrapper, bad):
    qkv, g, err = _bad(bad, wrapper)
    B, T, NC = g.shape
    with pytest.raises(err):
        if wrapper == "attn_bwd_pack1_kv":
            A.attn_bwd_pack1_kv(qkv, torch.empty_like(g), torch.empty(B, 2, T, device="meta"), g,
                                2)
        else:
            getattr(A, wrapper)(qkv, g, 2)
    assert recorded() == ([], {})


@pytest.mark.parametrize("which", ["out", "lse"])
def test_saved_statistics_must_be_aligned(recorded, which):
    """B9's kernels read the saved out and lse by 16-byte copies too."""
    qkv, g = _meta(1, 256, 2, 64)
    out = torch.empty(1 + 256 * 128, device="meta")
    lse = torch.empty(1 + 2 * 256, device="meta")
    out = out[1 if which == "out" else 0:][:256 * 128].view(1, 256, 128)
    lse = lse[1 if which == "lse" else 0:][:2 * 256].view(1, 2, 256)
    with pytest.raises(ValueError, match="16-byte"):
        A.attn_bwd_pack1_kv(qkv, out, lse, g, 2)
    assert recorded() == ([], {})


def test_the_pair_takes_f32_only(recorded):
    """The row and column wrappers are the f32 kernels' stages: a bf16 call
    is refused before any launch (bf16 goes to attn_bwd_tc.cu by attn_bwd)."""
    qkv, g = _meta(1, 256, 1, 64, torch.bfloat16)
    lse = torch.empty(1, 1, 256, device="meta")
    with pytest.raises(TypeError):
        A.attn_bwd_rows(qkv, g, 1, torch.empty_like(qkv))
    with pytest.raises(TypeError):
        A.attn_bwd_cols(qkv, g, 1, lse, lse, torch.empty_like(qkv))
    assert recorded() == ([], {})


def test_the_new_source_is_built_hashed_and_bound(monkeypatch, tmp_path):
    """kernels.py compiles attn_bwd_tf32.cu and hashes it with the 3xTF32
    header it includes (the digest changes with either), binds the three
    entries with the bf16 backward entries' arguments, and the source runs
    3xTF32 products at the tiles the emulation assumes."""
    assert "attn_bwd_tf32.cu" in kernels.SOURCES and "attn_tf32.cuh" in kernels.HEADERS
    ep = kernels._ENTRY_POINTS
    assert ep["vdiff_attn_bwd_tf32_rows"] == ep["vdiff_attn_bwd_tc"]
    assert ep["vdiff_attn_bwd_tf32_cols"] == ep["vdiff_attn_bwd_tc"]
    assert ep["vdiff_attn_bwd_tf32_kv"] == ep["vdiff_attn_bwd_tc_kv"]
    d0 = kernels.source_digest()
    for name in kernels.SOURCES + kernels.HEADERS:
        (tmp_path / name).write_bytes(open(os.path.join(kernels.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
    assert kernels.source_digest() == d0
    for name in ("attn_bwd_tf32.cu", "attn_tf32.cuh"):
        (tmp_path / name).write_text((tmp_path / name).read_text() + "\n")
        d1 = kernels.source_digest()
        assert d1 != d0
        d0 = d1
    monkeypatch.undo()
    src = open(os.path.join(kernels.CSRC_DIR, "attn_bwd_tf32.cu")).read()
    header = open(os.path.join(kernels.CSRC_DIR, "attn_tf32.cuh")).read()
    assert '#include "attn_tf32.cuh"' in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "cvt.rna.tf32.f32" in header and "mma3(" in src and "cp_async16(" in src
    for entry in ("vdiff_attn_bwd_tf32_rows(", "vdiff_attn_bwd_tf32_cols(",
                  "vdiff_attn_bwd_tf32_kv("):
        assert f'extern "C" int {entry}' in src
    assert re.search(r"kBk = C >= 128 \? 32 : 64;", src)
    assert re.search(r"kBq = C >= 128 \? 32 : 64;", src)
    assert re.search(r"struct RowPairShape \{\n  static constexpr int kBk = 16;", src)
    assert re.search(r"struct ColPairShape \{\n  static constexpr int kBq = 16;", src)
    assert "constexpr bool kPairs = C == 256;" in src
    assert {C: (16 if C == 256 else 32 if C == 128 else 64) for C in KEY_TILE} == KEY_TILE == Q_TILE
