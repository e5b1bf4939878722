"""Shared fixtures of the port's parity tests: one small UNet configuration,
its JAX params (every constant leaf perturbed, so zero-init layers and biases
all carry signal) and the port UNet loaded with the same weights; torch
emulations of the bf16 tensor-core kernels' tile algorithms
(``attn_fwd_tc.cu``, both entries of ``attn_bwd_tc.cu``,
``gn_silu_conv3x3_tc.cu``), which no CPU can run; and stubs of
the kernel library for tests that drive the launch path on the meta
device."""

import functools
import math

import numpy as np
import torch

# hid 32 with one head of width 32; 32×32 inputs give attention at T=256 and
# T=64, and at T=1024 in the up-resample block of level 1 — the flagship's
# three token counts.
SMALL = dict(
    in_channels=3, hid_channels=32, out_channels=3, ch_multipliers=(1, 1, 1),
    num_res_blocks=1, apply_attn=(False, True, True), drop_rate=0.0, num_heads=1,
    num_classes=10,
)
RES = 32


def perturb(params, seed=0):
    """Add N(0, 0.05) noise to every leaf that is constant (zero-init
    kernels and biases, unit GroupNorm scales)."""
    import jax

    rng = np.random.RandomState(seed)

    def f(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            a = a + rng.normal(0.0, 0.05, a.shape).astype(a.dtype)
        return a

    return jax.tree.map(f, params)


@functools.lru_cache(maxsize=None)
def jax_unet(num_res_blocks=1, out_channels=3, dtype_name="float32"):
    """(JAX UNet, perturbed params as numpy) for SMALL with the overrides."""
    import jax
    import jax.numpy as jnp

    from vdiff_tpu.models.unet import UNet

    cfg = dict(SMALL, num_res_blocks=num_res_blocks, out_channels=out_channels)
    dtype = None if dtype_name == "float32" else jnp.dtype(dtype_name)
    model = UNet(dtype=dtype, **cfg)
    x = jnp.zeros((1, RES, RES, 3))
    params = model.init(jax.random.key(0), x, jnp.zeros((1,)), jnp.ones((1,)))["params"]
    return model, perturb(params, seed=num_res_blocks)


@functools.lru_cache(maxsize=None)
def jax_apply(num_res_blocks=1, out_channels=3, dtype_name="float32"):
    """Jitted forward of :func:`jax_unet`: (x, t, y) numpy → numpy."""
    import jax

    model, params = jax_unet(num_res_blocks, out_channels, dtype_name)
    fn = jax.jit(lambda x, t, y: model.apply({"params": params}, x, t, y))
    return lambda x, t, y: np.asarray(fn(x, t, y))


def port_unet(num_res_blocks=1, out_channels=3, dtype_name="float32"):
    """The port UNet with :func:`jax_unet`'s weights (via
    flax_params_to_state_dict, strict load)."""
    import torch

    from vdiff_tpu_torch.models.convert import flax_params_to_state_dict
    from vdiff_tpu_torch.models.unet import UNet

    cfg = dict(SMALL, num_res_blocks=num_res_blocks, out_channels=out_channels)
    _, params = jax_unet(num_res_blocks, out_channels, dtype_name)
    model = UNet(dtype=getattr(torch, dtype_name), **cfg)
    sd = flax_params_to_state_dict(params, cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval()


def inputs(B=2, seed=0):
    """x (B, 32, 32, 3), t (B,), labels (B,) with the null class 0 included."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, RES, RES, 3).astype(np.float32)
    t = rng.rand(B).astype(np.float32)
    y = np.arange(B, dtype=np.float32) % (SMALL["num_classes"] + 1)
    return x, t, y


# chip_smoke.py's limits. Forward: per element 2^-8·|ref| + 2^-8·(P·|v|) +
# 1e-4 against the f32 twin (e rounded to bf16 moves an output by at most
# 2^-9·Σ p|v|; the output's own rounding by half an ulp). Backward: per
# d(qkv) slot 2^-7·|ref| + 2^-8·max|ref| against the bf16 twin.
FWD_RTOL, FWD_ATOL = 2.0 ** -8, 1e-4
BWD_RTOL, BWD_SCALE = 2.0 ** -7, 2.0 ** -8


def bf16_inputs(B, T, N, C, seed):
    """Seeded bf16 qkv (B, T, 3·N·C) and d(out) (B, T, N·C), drawn with numpy."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy((rng.randn(B, T, 3 * N * C) * 0.5).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(B, T, N * C).astype(np.float32)).bfloat16()
    return qkv, g


def check_fwd_tc(got, ref, qkv, N):
    """chip_smoke's forward limit of the tensor-core kernels' bf16 output
    ``got`` against ``ref`` and against the f32 twin, with P·|v| on qkv."""
    from vdiff_tpu_torch.ops import attention as A

    x = qkv.float()
    twin = A.attention_qkv_reference(x, N).numpy()
    x[..., 2 * x.shape[-1] // 3:] = x[..., 2 * x.shape[-1] // 3:].abs()
    pv = A.attention_qkv_reference(x, N).numpy()
    tol = FWD_RTOL * np.abs(twin) + FWD_RTOL * pv + FWD_ATOL
    for name, other in (("reference", ref), ("f32 twin", twin)):
        err = np.abs(got.float().numpy() - other)
        assert (err <= tol).all(), f"vs {name}: largest excess {(err - tol).max()}"


def check_bwd_tc(got, ref):
    """chip_smoke's bf16 backward limit, slot by slot, of d(qkv) ``got``
    against ``ref`` (numpy)."""
    got = got.float().numpy()
    for a, r in zip(np.split(got, 3, -1), np.split(ref, 3, -1)):
        tol = BWD_RTOL * np.abs(r) + BWD_SCALE * np.abs(r).max()
        assert (np.abs(a - r) <= tol).all(), f"largest excess {(np.abs(a - r) - tol).max()}"


# the kernels' tile sizes by head dim: keys per tile of the forward and of the
# backward's row kernel (FwdShape::kBk, RowShape::kBk), q rows per step of the
# column kernel (ColShape::kBq); 64 q rows a forward / row block, 64 keys a
# column block
KEY_TILE = {32: 64, 64: 64, 128: 64, 256: 32}
COL_Q_TILE = {32: 64, 64: 64, 128: 32, 256: 32}
LOG2E, LN2 = np.float32(1.4426950408889634), np.float32(0.6931471805599453)


def _split(qkv, N):
    """(B, T, 3·N·C) → f32 q, k, v as (B, N, T, C)."""
    B, T, three_nc = qkv.shape
    C = three_nc // (3 * N)
    return [a.float().permute(0, 2, 1, 3) for a in qkv.reshape(B, T, 3, N, C).unbind(2)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate_fwd_tc(qkv, N):
    """attn_fwd_tc.cu's algorithm: per key tile s = (q·kᵀ)·(log2e/√C) in f32
    (keys past T at -inf), running max m and sum l rescaled by exp2(m_old −
    m_new), o += bf16(exp2(s − m))·v; out = o / l, one cast to bf16. Returns
    (out (B, T, N·C) bf16, lse (B, N, T) f32), lse = (m + log2 l)·ln2 as the
    kernel's lse entry writes it."""
    q, k, v = _split(qkv, N)
    B, _, T, C = q.shape
    bk, scale_log2 = KEY_TILE[C], LOG2E / np.sqrt(np.float32(C))
    m = torch.full((B, N, T, 1), -math.inf)
    l = torch.zeros(B, N, T, 1)
    o = torch.zeros(B, N, T, C)
    for j in range(0, T, bk):
        s = (q @ k[:, :, j:j + bk].transpose(-1, -2)) * float(scale_log2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _bf16(p) @ v[:, :, j:j + bk]
        m = m_new
    out = (o / l).permute(0, 2, 1, 3).reshape(B, T, N * C).to(torch.bfloat16)
    return out, ((m + torch.log2(l)) * float(LN2)).squeeze(-1)


def _bwd_scales(C):
    """attn_bwd_tc.cu's f32 scale = 1/√C and scale·log2e, as Python floats."""
    scale = np.float32(1.0) / np.sqrt(np.float32(C))
    return float(scale), float(scale * LOG2E)


def _do(g, N):
    """d(out) (B, T, N·C) → f32 (B, N, T, C)."""
    return g.float().reshape(g.shape[0], g.shape[1], N, -1).permute(0, 2, 1, 3)


def _bwd_rows_dq(q, k, v, do, lse2, delta):
    """attn_bwd_tc.cu's dQ sweep of the row kernel: per key tile s as in the
    forward, P = exp2(s − lse2) with lse2 in log2 units, dS = bf16(P∘(dP −
    δ)), dQ += dS·k; unscaled."""
    T, C = q.shape[-2:]
    bk, scale_log2 = KEY_TILE[C], _bwd_scales(C)[1]
    dq = torch.zeros_like(q)
    for j in range(0, T, bk):
        s = (q @ k[:, :, j:j + bk].transpose(-1, -2)) * scale_log2
        dp = do @ v[:, :, j:j + bk].transpose(-1, -2)
        ds = _bf16(torch.exp2(s - lse2) * (dp - delta))
        dq = dq + ds @ k[:, :, j:j + bk]
    return dq


def _bwd_cols(q, k, v, do, lse, delta):
    """attn_bwd_tc.cu's column kernel, per q tile: P = exp2(S·log2e/√C −
    lse·log2e) from lse (natural log) and δ as read from device memory, dS as
    in the row kernel, dV += bf16(P)ᵀ·dO, dK += dSᵀ·q; unscaled."""
    T, C = q.shape[-2:]
    bq, scale_log2 = COL_Q_TILE[C], _bwd_scales(C)[1]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(0, T, bq):
        rows = slice(i, i + bq)
        s = k @ q[:, :, rows].transpose(-1, -2)  # (B, N, keys, q rows)
        p = torch.exp2(s * scale_log2 - (lse[:, :, rows] * float(LOG2E)).transpose(-1, -2))
        dp = v @ do[:, :, rows].transpose(-1, -2)
        ds = _bf16(p * (dp - delta[:, :, rows].transpose(-1, -2)))
        dv = dv + _bf16(p) @ do[:, :, rows]
        dk = dk + ds @ q[:, :, rows]
    return dk, dv


def _bwd_tc_dqkv(q, k, v, do, lse2, lse, delta):
    """Both kernels on the row statistics: lse2 (log2 units) for the row
    kernel, lse (natural log) and δ (B, N, T, 1) as the column kernel reads
    them. dQ and dK scaled by 1/√C at the end, one cast of each to bf16."""
    B, N, T, C = q.shape
    scale = _bwd_scales(C)[0]
    dq = _bwd_rows_dq(q, k, v, do, lse2, delta)
    dk, dv = _bwd_cols(q, k, v, do, lse, delta)
    out = [a.permute(0, 2, 1, 3) for a in (dq * scale, dk * scale, dv)]
    return torch.stack(out, dim=2).reshape(B, T, 3 * N * C).to(torch.bfloat16)


def emulate_bwd_tc(qkv, g, N):
    """attn_bwd_tc.cu's full-row algorithm (entry vdiff_attn_bwd_tc). Row
    kernel, sweep 1 over key tiles: s as in the forward, running max m,
    l = Σ exp2(s − m) and d = Σ exp2(s − m)·dP, both rescaled as m grows;
    lse = (m + log2 l)·ln2 and δ = d / l (f32, the full row). Sweep 2
    (:func:`_bwd_rows_dq`) with lse2 = m + log2 l; then the column kernel
    (:func:`_bwd_cols`)."""
    q, k, v = _split(qkv, N)
    do = _do(g, N)
    B, _, T, C = q.shape
    bk, scale_log2 = KEY_TILE[C], _bwd_scales(C)[1]
    m = torch.full((B, N, T, 1), -math.inf)
    l = torch.zeros(B, N, T, 1)
    d = torch.zeros(B, N, T, 1)
    for j in range(0, T, bk):
        s = (q @ k[:, :, j:j + bk].transpose(-1, -2)) * scale_log2
        dp = do @ v[:, :, j:j + bk].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        d = d * alpha + (p * dp).sum(-1, keepdim=True)
        m = m_new
    lse2 = m + torch.log2(l)
    lse = lse2 * float(LN2)  # as written to device memory
    return _bwd_tc_dqkv(q, k, v, do, lse2, lse, d / l)


def emulate_bwd_tc_stats(qkv, g, N, lse, delta):
    """attn_bwd_tc.cu's saved-statistics algorithm (entry
    vdiff_attn_bwd_tc_kv) on given row statistics, lse (natural log) and δ,
    each (B, N, T) f32: one dQ sweep with lse2 = lse·log2e in f32, then the
    column kernel."""
    q, k, v = _split(qkv, N)
    lse, delta = lse.float()[..., None], delta.float()[..., None]
    return _bwd_tc_dqkv(q, k, v, _do(g, N), lse * float(LOG2E), lse, delta)


def saved_delta(out, g, N):
    """δ = Σ_C dO∘O from the saved output ``out`` in its own dtype, summed in
    f32: (B, N, T)."""
    return (_do(g, N) * _do(out, N)).sum(-1)


def emulate_bwd_tc_kv(qkv, out, lse, g, N):
    """attn_bwd_tc.cu's kv entry: the forward's lse (B, N, T) and
    δ = :func:`saved_delta` from its saved output, then
    :func:`emulate_bwd_tc_stats`."""
    return emulate_bwd_tc_stats(qkv, g, N, lse, saved_delta(out, g, N))


# gn_silu_conv3x3_tc.cu's tiles: 8 output rows a block, input channels per K
# chunk (ConvTile, kTh, kCk)
CONV_TILE_H, CONV_CHUNK = 8, 32


def emulate_conv3x3_tc(x, weight, bias, gamma=None, beta=None, film_shift=None, film_scale=None,
                       skip=None, *, num_groups=32, eps=1e-6, tile_w=16):
    """gn_silu_conv3x3_tc.cu's tile algorithm on bf16 NHWC ``x``, OIHW
    ``weight``: per block of CONV_TILE_H × ``tile_w`` output pixels, per chunk
    of CONV_CHUNK input channels, the halo tile (two more rows and columns)
    as y = silu(x·A + B) in f32 with the statistics pass's f32 coefficients,
    rounded once to bf16, zero outside the image (bare x without gamma); then
    the 9 taps as one-pixel-shifted windows of it, each times the bf16
    weights of its (tap, chunk) rows, summed in f32 chunk by chunk and tap by
    tap. Returns the f32 (B, H, W, C_out) sums + f32 bias + f32 skip, before
    the kernel's one cast to bf16. SiLU here is torch's; the kernel's takes
    the SFU's exp and reciprocal, so a y may round to the other neighbouring
    bf16 value, which the B11 limit's flip term covers."""
    from vdiff_tpu_torch.ops.groupnorm import coefficients

    B, H, W, C = x.shape
    CO = weight.shape[0]
    th, ck = CONV_TILE_H, CONV_CHUNK
    if gamma is not None:
        a, b = coefficients(x, gamma, beta, film_shift, film_scale, num_groups, eps)
        a, b = a[:, None, None, :], b[:, None, None, :]
    taps = weight.permute(2, 3, 1, 0).to(torch.bfloat16).float()  # (dy, dx, c, o)
    out = torch.zeros(B, H, W, CO)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tile_w):
            gy, gx = torch.arange(y0 - 1, y0 + th + 1), torch.arange(x0 - 1, x0 + tile_w + 1)
            inside = (((gy >= 0) & (gy < H))[:, None] & ((gx >= 0) & (gx < W))[None, :])[..., None]
            xh = x[:, gy.clamp(0, H - 1)][:, :, gx.clamp(0, W - 1)].float()
            acc = torch.zeros(B, th, tile_w, CO)
            for c0 in range(0, C, ck):
                xc = xh[..., c0:c0 + ck]
                yc = (torch.nn.functional.silu(xc * a[..., c0:c0 + ck] + b[..., c0:c0 + ck])
                      if gamma is not None else xc)
                yc = torch.where(inside, _bf16(yc), torch.zeros(()))
                for dy in range(3):
                    for dx in range(3):
                        win = yc[:, dy:dy + th, dx:dx + tile_w]
                        acc = acc + win @ taps[dy, dx, c0:c0 + ck]
            h, w = min(th, H - y0), min(tile_w, W - x0)
            out[:, y0:y0 + h, x0:x0 + w] = acc[:, :h, :w]
    out = out + bias.float()
    return out + skip.float() if skip is not None else out


class StubLibrary:
    """Stands in for the kernel library: every launch succeeds and does
    nothing; the *_max_t queries allow any T."""

    def __getattr__(self, name):
        return (lambda *a: 1 << 20) if name.endswith("_max_t") else (lambda *a: 0)


class RecordingStubLibrary(StubLibrary):
    """:class:`StubLibrary` that records, in order, the name of every entry
    point asked for (launches and *_max_t queries) in ``calls``, and every
    call made, with its arguments, in ``launched``."""

    def __init__(self):
        self.calls = []
        self.launched = []

    def __getattr__(self, name):
        self.calls.append(name)
        fn = super().__getattr__(name)

        def call(*args):
            self.launched.append((name, args))
            return fn(*args)

        return call
