"""B4 of the port on the tensor cores, on the CPU, where no CUDA kernel runs.

bf16 CUDA calls of ``attn_bwd`` at T ≤ 512 (B4, the train steps' backward at
T=256 and T=64) run ``attn_bwd_tc.cu``'s full-row entry, B5's kernel, counted
under ``attn_bwd``; f32 calls run the 3xTF32 pair of ``attn_bwd_tf32.cu``
(row kernel → column kernel), each counted under its own wrapper. The kernel's tile
algorithm, emulated in torch (``tests/torch_parity.py::emulate_bwd_tc``), is
held on bf16 inputs made from a numpy seed against the VJP of JAX's
``flash_attention_trainable``, which at T ≤ 512 reaches the Pallas
``_attn_bwd_kernel`` (run in interpret mode), within the limit chip_smoke.py
holds the kernel to on the card: per d(qkv) slot 2^-7·|ref| + 2^-8·max|ref|.
Then the dispatch on dtype into a recording stub library (meta tensors) and
the refusal of unaligned bf16 input.
"""

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


def _fold(a, N):
    """(B, T, N·C) → (B·N, T, C), flash_attention_trainable's layout."""
    B, T, NC = a.shape
    return a.reshape(B, T, N, NC // N).transpose(0, 2, 1, 3).reshape(B * N, T, NC // N)


def _unfold(a, B, N):
    BN, T, C = a.shape
    return a.reshape(B, N, T, C).transpose(0, 2, 1, 3).reshape(B, T, N * C)


@pytest.mark.parametrize("B,T,N,C", [(1, 64, 1, 256), (1, 256, 1, 256), (2, 64, 3, 64),
                                     (1, 256, 3, 64)])
def test_bwd_tiles_match_pallas_attn_bwd_kernel(B, T, N, C):
    """The CIFAR shapes (one head of 256; the key tile is 32 wide) and
    celeba's head dim 64 (64-key tiles, three heads). JAX's VJP runs
    _attn_bwd_kernel over whole (T, T) tiles; the emulation sweeps key tiles
    with an online softmax, the kernel's order."""
    from vdiff_tpu.ops.attention import flash_attention_trainable

    qkv, g = P.bf16_inputs(B, T, N, C, seed=T + N + C)
    q, k, v = (_fold(a, N) for a in np.split(qkv.float().numpy(), 3, axis=-1))
    _, vjp = jax.vjp(lambda q, k, v: flash_attention_trainable(q, k, v, True),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    grads = vjp(jnp.asarray(_fold(g.float().numpy(), N), jnp.bfloat16))
    dref = np.concatenate([_unfold(np.asarray(jnp.asarray(d, jnp.float32)), B, N)
                           for d in grads], -1)
    got = P.emulate_bwd_tc(qkv, g, N)
    assert got.dtype == torch.bfloat16 and got.shape == qkv.shape
    P.check_bwd_tc(got, dref)
    P.check_bwd_tc(got, A.attention_qkv_bwd_reference(qkv, g, N).float().numpy())


COUNTERS = ("attn_bwd", "attn_bwd_tc", "attn_bwd_rows", "attn_bwd_cols", "attn_bwd_pack1")


@pytest.fixture
def recorded(monkeypatch):
    """Meta tensors take the wrappers' launch path into a recording stub
    library; returns a function that reads (entry points asked for with
    their arguments, nonzero launch counts) and clears both."""
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
        lib.calls.clear()
        for name in COUNTERS:
            getattr(A, name).launches = 0
        return calls, counts

    return read


@pytest.mark.parametrize("B,T,N,C", [(128, 64, 1, 256), (2, 256, 1, 256), (2, 64, 12, 64),
                                     (2, 512, 9, 64)])
def test_dispatch_on_dtype(recorded, B, T, N, C):
    """bf16: one vdiff_attn_bwd_tc launch, counted under attn_bwd alone;
    f32: the 3xTF32 row kernel and column kernel (no T cap query), counted
    under their own wrappers."""
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.empty(B, T, 3 * N * C, dtype=dtype, device="meta")
        g = torch.empty(B, T, N * C, dtype=dtype, device="meta")
        dqkv = A.attn_bwd(qkv, g, N)
        assert (dqkv.shape, dqkv.dtype) == (qkv.shape, dtype)
        calls, counts = recorded()
        if dtype == torch.bfloat16:
            assert [name for name, _ in calls] == ["vdiff_attn_bwd_tc"]
            # qkv, dout, dqkv, lse, delta | B, T, N, C | stream
            assert calls[0][1][5:9] == (B, T, N, C)
            assert counts == {"attn_bwd": 1}
        else:
            assert [name for name, _ in calls] == ["vdiff_attn_bwd_tf32_rows",
                                                   "vdiff_attn_bwd_tf32_cols"]
            # qkv, dout, dqkv, lse, delta | B, T, N, C | stream
            assert all(args[5:9] == (B, T, N, C) for _, args in calls)
            assert counts == {"attn_bwd_rows": 1, "attn_bwd_cols": 1}


@pytest.mark.parametrize("which", ["qkv", "g"])
def test_unaligned_bf16_is_refused_before_any_launch(recorded, which):
    """A contiguous bf16 tensor 2 bytes past a 16-byte boundary: the kernel's
    cp.async tiles cannot read it, so the call raises and nothing launches;
    it never falls back to the FMA pair. The aligned call launches."""
    N, C, T = 1, 256, 256

    def call(offset):
        qkv = torch.empty(offset + T * 3 * N * C, dtype=torch.bfloat16, device="meta")
        g = torch.empty(offset + T * N * C, dtype=torch.bfloat16, device="meta")
        qkv = qkv[offset if which == "qkv" else 0:][:T * 3 * N * C].view(1, T, 3 * N * C)
        g = g[offset if which == "g" else 0:][:T * N * C].view(1, T, N * C)
        return A.attn_bwd(qkv, g, N)

    with pytest.raises(ValueError, match="16-byte"):
        call(1)
    assert recorded() == ([], {})
    call(8)  # 16 bytes in: aligned
    assert recorded()[1] == {"attn_bwd": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_calls_return_the_twin_and_count_no_launch(dtype):
    qkv, g = (a.to(dtype) for a in P.bf16_inputs(2, 64, 3, 64, seed=6))
    before = [getattr(A, name).launches for name in COUNTERS]
    torch.testing.assert_close(A.attn_bwd(qkv, g, 3), A.attention_qkv_bwd_reference(qkv, g, 3),
                               rtol=0, atol=0)
    assert [getattr(A, name).launches for name in COUNTERS] == before
