"""UNet denoiser (counterpart of ``vdiff_tpu/models/unet.py``).

The module tree carries the reference's state_dict key names
(``time_embed.0/.2``, ``class_embed.1`` — or ``class_embed`` for multi-tag
conditioning —, ``in_conv``,
``downsamples.level_i.j(.0/.1)``, ``middle.0/1/2``, ``upsamples.level_i.j``,
``out_conv.0/.2``; ``norm1/conv1/fc/norm2/conv2/skip`` in residual blocks and
``norm/proj_in/proj_out`` in attention blocks), so reference ``.pt`` files load
as they are and ``vdiff_tpu.models.convert.torch_unet_to_flax`` reads a
port state_dict unchanged.

Layout: :class:`UNet` takes and returns NHWC, like the JAX model. Inside it
works on NCHW tensors in ``channels_last`` memory, so every NHWC↔NCHW change
is a free view. Compute dtype follows Flax: parameters stay float32 and are
cast to ``dtype`` where used; the output conv runs in float32 (Flax promotes
the bf16 activation with its f32 kernel there).

``train=True`` is JAX's training mode: dropout between norm2 and conv2 of each
residual block (bits from the ``generator`` passed in) and differentiable
attention (``spatial_attention_qkv(train=True)``). Its other use, as in JAX,
is ``fuse = not train``: at inference a residual block sends conv1 (when
nothing resamples between norm1 and the conv, and the block is not one that
JAX runs concat-free) and conv2 (with FiLM and the residual add) to the fused
GN→SiLU→conv3x3 kernel wherever ``ops.conv3x3.fusable`` holds
(``VDIFF_FUSED_CONV=1``), and every GroupNorm that stays alone leaves the choice
of the one-kernel form to ``ops.groupnorm.gn_film_silu`` (``VDIFF_FUSED_GN=1``).
Both switches are off by default, as in the JAX package.

``remat``/``remat_policy`` are JAX's activation checkpointing of the blocks
that ``UNet._block`` builds (the ``downsamples``/``upsamples`` entries that are
residual blocks, with or without attention; not ``middle``, ``in_conv``, the
output head or the strided/upsampling convs of ``resample_with_res=False``).
It applies in training with grad enabled only, runs the blocks through
:func:`.remat.checkpoint_block` without wrapping a module, so the state_dict
keys stay the same in every mode, and is described in :mod:`.remat`.

``resample_with_res=False`` resamples between levels with a stride-2 3x3 conv
(padding 1 on each side, JAX's fix of the reference's pad 0, which breaks the
H/2 shape) and a nearest upsample followed by a 3x3 conv, keyed as the
reference's ``downsamples.level_i.{nres}`` and ``upsamples.level_i.{nres+1}.1``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import spatial_attention_qkv
from ..ops.conv3x3 import fusable, fused_gn_silu_conv3x3
from ..ops.groupnorm import gn_film_silu
from ..ops.numerics import get_timestep_embedding
from .layers import (
    EfficientDropout,
    avg_pool_2x,
    conv2d,
    lecun_trunc_normal_,
    linear,
    nearest_upsample,
    one_hot_exclude_zero,
)
from .remat import check_policy, checkpoint_block, checkpoint_region


def _cat(x, skip_in):
    return x if skip_in is None else torch.cat([x, skip_in], dim=1)


def _zero_init(m: nn.Module) -> nn.Module:
    m.init_scale = 0.0  # read by UNet.reset_parameters
    return m


class GroupNorm32(nn.Module):
    """GroupNorm(32, eps=1e-6) with optional FiLM and SiLU, on NCHW x."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, shift=None, scale=None, *, silu: bool, fuse: bool = False):
        """``fuse`` (inference) leaves the one-kernel form to
        :func:`gn_film_silu`'s switch; without it the default chain runs."""
        y = gn_film_silu(x.permute(0, 2, 3, 1), self.weight, self.bias, shift, scale,
                         num_groups=32, eps=1e-6, apply_silu=silu,
                         use_kernel=None if fuse else False, shard=self.__dict__.get("spatial"))
        return y.permute(0, 3, 1, 2)


def _fused_conv(x, conv, norm, shift=None, scale=None, skip=None):
    """GN(+FiLM)→SiLU→``conv`` (+skip) of NCHW ``channels_last`` tensors
    through the fused kernel, which works on their NHWC views. A sharded
    model cannot take it (its skip and FiLM epilogue would need the rank's
    channels, its statistics the other ranks' rows)."""
    if "tp_shard" in conv.__dict__ or "spatial" in conv.__dict__:
        raise RuntimeError("VDIFF_FUSED_CONV=1: the fused GN→SiLU→conv kernel does not run "
                           "on a model sharded by --tp or --spatial-shard")
    out = fused_gn_silu_conv3x3(
        x.permute(0, 2, 3, 1), conv.weight, conv.bias, norm.weight, norm.bias, shift, scale,
        None if skip is None else skip.permute(0, 2, 3, 1), num_groups=32, eps=1e-6)
    return out.permute(0, 3, 1, 2)


class ResidualBlock(nn.Module):
    """FiLM-conditioned residual block: GN→SiLU→resample→conv3x3, then
    (1+scale)·GN(h)+shift → SiLU → zero-init conv3x3, plus the (1x1-conv)
    skip of the resampled input."""

    def __init__(self, in_channels: int, out_channels: int, embed_dim: int,
                 resampling: str = "none", dtype: torch.dtype = torch.float32,
                 drop_rate: float = 0.0, skip_in_channels: int = 0):
        """``skip_in_channels`` of the ``in_channels`` are an up-path skip
        concatenated onto the input. JAX runs the front of such a block
        concat-free (per-part GN and convs) when it has a 1x1 skip conv and
        no GroupNorm group straddles the seam; the port concatenates, the same
        math, and only keeps conv1 of those blocks out of the fused kernel,
        as JAX does."""
        super().__init__()
        self.dtype = dtype
        self.resampling = resampling
        cg = in_channels // 32
        self.concat_free_in_jax = (
            skip_in_channels > 0 and resampling == "none" and in_channels != out_channels
            and in_channels % 32 == 0 and (in_channels - skip_in_channels) % cg == 0
            and skip_in_channels % cg == 0)
        self.dropout = EfficientDropout(drop_rate)
        self.resample = {"upsample": nearest_upsample, "downsample": avg_pool_2x,
                         "none": lambda a: a}[resampling]
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.fc = nn.Linear(embed_dim, 2 * out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = _zero_init(nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x, t_emb, train=False, generator=None):
        fuse = not train  # the inference kernels: no autograd through them, no dropout
        c_out = self.conv1.out_channels
        skip = self._skip_path(x)
        if (fuse and self.resampling == "none" and not self.concat_free_in_jax
                and fusable(x.permute(0, 2, 3, 1), c_out)):
            h = _fused_conv(x, self.conv1, self.norm1)
        else:
            h = self._conv1(x, fuse=fuse)
        if fuse and fusable(h.permute(0, 2, 3, 1), c_out):
            shift, scale = self._film(t_emb)
            return _fused_conv(h, self.conv2, self.norm2, shift, scale, skip.to(h.dtype))
        # conv2 last: a checkpoint's recompute stops before the last op that saves
        return self._conv2(h, t_emb, train, generator) + skip

    def forward_saving_convs(self, x, skip_in, t_emb, generator):
        """The training forward of ``cat(x, skip_in)`` as one checkpoint
        region per conv (``remat_policy="conv"``, :mod:`.remat`)."""
        skip = checkpoint_region(self._skip_path, x, skip_in)
        h = checkpoint_region(self._conv1, x, skip_in)
        return checkpoint_region(self._conv2, h, t_emb, True, generator=generator) + skip

    def _skip_path(self, x, skip_in=None):
        skip = self.resample(_cat(x, skip_in))
        return skip if self.skip is None else conv2d(skip, self.skip, self.dtype)

    def _conv1(self, x, skip_in=None, fuse=False):
        """GN→SiLU→resample→conv1, the GroupNorm alone (not the fused conv)."""
        h = self.norm1(_cat(x, skip_in), silu=True, fuse=fuse)
        return conv2d(self.resample(h), self.conv1, self.dtype)

    def _film(self, t_emb):
        return linear(F.silu(t_emb), self.fc, self.dtype).chunk(2, dim=-1)

    def _conv2(self, h, t_emb, train, generator=None):
        """FiLM Dense, GN→FiLM→SiLU→dropout→conv2, GroupNorm alone."""
        shift, scale = self._film(t_emb)
        h = self.norm2(h, shift, scale, silu=True, fuse=not train)
        return conv2d(self.dropout(h, train, generator), self.conv2, self.dtype)


class AttentionBlock(nn.Module):
    """Self-attention over spatial tokens: GN → fused qkv projection →
    attention kernels → zero-init output projection → residual. The 1x1
    projections run as token matmuls on the (B, H·W, C) view."""

    def __init__(self, channels: int, head_dim: Optional[int] = None,
                 num_heads: Optional[int] = None):
        super().__init__()
        if head_dim is None:
            assert num_heads is not None and channels % num_heads == 0
            head_dim = channels // num_heads
        if num_heads is None:
            assert channels % head_dim == 0
            num_heads = channels // head_dim
        self.num_heads = num_heads
        hid = head_dim * num_heads
        self.norm = GroupNorm32(channels)
        self.proj_in = nn.Conv2d(channels, 3 * hid, 1)
        self.proj_out = _zero_init(nn.Conv2d(hid, channels, 1))

    def forward(self, x, train=False):
        sp = self.__dict__.get("spatial")
        if sp is None:
            out = spatial_attention_qkv(self._qkv(x, train), self.num_heads, train=train)
        else:  # a height shard: the kernel runs on every rank's tokens, the rank keeps its own
            qkv = sp.gather_tokens(self._qkv(x, train))
            out = sp.own_tokens(spatial_attention_qkv(qkv, self.num_heads, train=train))
        return self._project_out(out, x)

    def forward_saving_convs(self, x):
        """The training forward with the qkv projection and the attention
        each one checkpoint region (``remat_policy="conv"``, :mod:`.remat`)."""
        qkv = checkpoint_region(self._qkv, x, True)
        out = checkpoint_region(spatial_attention_qkv, qkv, self.num_heads, True)
        return self._project_out(out, x)

    def _qkv(self, x, train):
        B, C, H, W = x.shape
        tokens = self.norm(x, silu=False, fuse=not train).permute(0, 2, 3, 1).reshape(B, H * W, C)
        return linear(tokens, self.proj_in, tokens.dtype)

    def _project_out(self, out, x):
        B, C, H, W = x.shape
        out = linear(out, self.proj_out, out.dtype)
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class _ResAttn(nn.Sequential):
    """Residual block followed by attention (the reference's
    ``Sequential(res, attn)``, keys ``.0``/``.1``)."""

    def forward(self, x, t_emb, train=False, generator=None):
        return self[1](self[0](x, t_emb, train, generator), train)

    def forward_saving_convs(self, x, skip_in, t_emb, generator):
        return self[1].forward_saving_convs(self[0].forward_saving_convs(x, skip_in, t_emb, generator))


class _ConvDownsample(nn.Conv2d):
    """``resample_with_res=False``'s downsampling: a 3x3 conv with stride 2
    and padding (1, 1)."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__(channels, channels, 3, stride=2, padding=1)
        self.dtype = dtype

    def forward(self, x, t_emb=None, train=False, generator=None):
        return conv2d(x, self, self.dtype)


class _ConvUpsample(nn.Sequential):
    """``resample_with_res=False``'s upsampling: nearest ×2, then a 3x3 SAME
    conv (the reference's ``Sequential(Upsample, Conv2d)``, keys ``.1``)."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv2d(channels, channels, 3, padding=1))
        self.dtype = dtype

    def forward(self, x, t_emb=None, train=False, generator=None):
        return conv2d(self[0](x), self[1], self.dtype)


class UNet(nn.Module):
    """Improved-DDPM UNet; constructor arguments mirror the JAX ``UNet``.

    ``forward(x, t, y, train=False, generator=None)``: x (B, H, W, C_in)
    NHWC, t (B,), y (B,) class labels (0 = null class), (B, K) tags with
    ``multitags`` (all zeros = the null label), or None →
    (B, H, W, C_out) f32. With ``train`` and a nonzero ``drop_rate`` the
    dropout bits come from ``generator``. ``remat`` checkpoints every down and
    up block in training; ``remat_policy="conv"`` does so by itself, keeping
    the outputs JAX names ``unet_mm`` (:mod:`.remat`); another policy is a
    ``ValueError``.
    """

    def __init__(
        self,
        in_channels: int,
        hid_channels: int,
        out_channels: int,
        ch_multipliers: Sequence[int],
        num_res_blocks: int,
        apply_attn: Union[bool, Sequence[bool]],
        embedding_dim: Optional[int] = None,
        drop_rate: float = 0.0,
        head_dim: Optional[int] = None,
        num_heads: Optional[int] = None,
        num_classes: int = 0,
        multitags: bool = False,
        resample_with_res: bool = True,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        check_policy(remat_policy)
        self.remat = remat or remat_policy is not None
        self.remat_policy = remat_policy
        self.hid_channels = hid_channels
        self.num_res_blocks = num_res_blocks
        self.num_classes = num_classes
        self.multitags = multitags
        self.dtype = dtype
        levels = len(ch_multipliers)
        attn_flags = [apply_attn] * levels if isinstance(apply_attn, bool) else list(apply_attn)
        if head_dim is None and num_heads is None:
            num_heads = 1
        embed_dim = embedding_dim or 4 * hid_channels
        chs = [m * hid_channels for m in ch_multipliers]

        def block(level, in_ch, out_ch, resampling="none", skip_in=0):
            res = ResidualBlock(in_ch, out_ch, embed_dim, resampling, dtype, drop_rate, skip_in)
            if not attn_flags[level]:
                return res
            return _ResAttn(res, AttentionBlock(out_ch, head_dim, num_heads))

        self.time_embed = nn.Sequential(
            nn.Linear(hid_channels, embed_dim), nn.SiLU(), nn.Linear(embed_dim, embed_dim)
        )
        if num_classes > 0 and multitags:  # the reference's bare Linear over the tags
            self.class_embed = nn.Linear(num_classes, embed_dim)
        elif num_classes > 0:  # the reference's Sequential(OneHot, Linear)
            self.class_embed = nn.Sequential(nn.Identity(), nn.Linear(num_classes, embed_dim))
        self.in_conv = nn.Conv2d(in_channels, hid_channels, 3, padding=1)

        self.downsamples = nn.ModuleDict()
        for i in range(levels):
            prev = chs[i - 1] if i else hid_channels
            mods = [block(i, prev, chs[i])]
            mods += [block(i, chs[i], chs[i]) for _ in range(1, num_res_blocks)]
            if i != levels - 1 and resample_with_res:
                mods.append(block(i, chs[i], chs[i], "downsample"))
            elif i != levels - 1:
                mods.append(_ConvDownsample(chs[i], dtype))
            self.downsamples[f"level_{i}"] = nn.ModuleList(mods)

        mid = chs[-1]
        self.middle = nn.ModuleList([
            ResidualBlock(mid, mid, embed_dim, dtype=dtype, drop_rate=drop_rate),
            AttentionBlock(mid, head_dim, num_heads),
            ResidualBlock(mid, mid, embed_dim, dtype=dtype, drop_rate=drop_rate),
        ])

        self.upsamples = nn.ModuleDict()
        for i in range(levels):
            nxt = hid_channels if i == 0 else chs[i - 1]
            prev = chs[-1] if i == levels - 1 else chs[i + 1]
            mods = [block(i, prev + chs[i], chs[i], skip_in=chs[i])]
            mods += [block(i, 2 * chs[i], chs[i], skip_in=chs[i])
                     for _ in range(1, num_res_blocks)]
            mods.append(block(i, nxt + chs[i], chs[i], skip_in=nxt))
            if i != 0 and resample_with_res:
                mods.append(block(i, chs[i], chs[i], "upsample"))
            elif i != 0:
                mods.append(_ConvUpsample(chs[i], dtype))
            self.upsamples[f"level_{i}"] = nn.ModuleList(mods)

        self.out_conv = nn.Sequential(
            GroupNorm32(hid_channels), nn.SiLU(),
            _zero_init(nn.Conv2d(hid_channels, out_channels, 3, padding=1)),
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference initialisation: LeCun-truncated weights (zero for the
        zero-init output projections), zero biases, unit GroupNorm scales."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_trunc_normal_(m.weight, getattr(m, "init_scale", 1.0), generator)
                m.bias.zero_()
            elif isinstance(m, GroupNorm32):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x, t, y=None, train=False, generator=None):
        dt = self.dtype
        t_emb = get_timestep_embedding(t, self.hid_channels)
        t_emb = linear(t_emb, self.time_embed[0], dt)
        t_emb = linear(F.silu(t_emb), self.time_embed[2], dt)
        if self.num_classes > 0 and y is not None and self.multitags:
            # (B, K) tags over √(number of nonzero tags), at least 1
            count = (y != 0).sum(dim=1).to(y.dtype).clamp(min=1.0).sqrt()
            t_emb = t_emb + linear(y / count[:, None], self.class_embed, dt)
        elif self.num_classes > 0 and y is not None:
            onehot = one_hot_exclude_zero(y, self.num_classes)
            t_emb = t_emb + linear(onehot, self.class_embed[1], dt)

        remat = self.remat and train and torch.is_grad_enabled()

        def run(blk, h, skip_in=None):
            if remat and isinstance(blk, (ResidualBlock, _ResAttn)):
                return checkpoint_block(blk, h, skip_in, t_emb, generator, self.remat_policy)
            return blk(_cat(h, skip_in), t_emb, train, generator)

        hs = [conv2d(x.permute(0, 3, 1, 2), self.in_conv, dt)]
        for level in self.downsamples.values():
            for blk in level:
                hs.append(run(blk, hs[-1]))

        h = self.middle[0](hs[-1], t_emb, train, generator)
        h = self.middle[1](h, train)
        h = self.middle[2](h, t_emb, train, generator)

        for i in reversed(range(len(self.upsamples))):
            for j, blk in enumerate(self.upsamples[f"level_{i}"]):
                # all but the trailing upsample take a skip
                h = run(blk, h, hs.pop() if j <= self.num_res_blocks else None)
        assert not hs

        h = self.out_conv[0](h, silu=True, fuse=not train)
        h = conv2d(h, self.out_conv[2], torch.float32)
        return h.permute(0, 2, 3, 1)
