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
                         use_kernel=None if fuse else False)
        return y.permute(0, 3, 1, 2)


def _fused_conv(x, conv, norm, shift=None, scale=None, skip=None):
    """GN(+FiLM)→SiLU→``conv`` (+skip) of NCHW ``channels_last`` tensors
    through the fused kernel, which works on their NHWC views."""
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
        skip = self.resample(x)
        if self.skip is not None:
            skip = conv2d(skip, self.skip, self.dtype)
        if (fuse and self.resampling == "none" and not self.concat_free_in_jax
                and fusable(x.permute(0, 2, 3, 1), c_out)):
            h = _fused_conv(x, self.conv1, self.norm1)
        else:
            h = conv2d(self.resample(self.norm1(x, silu=True, fuse=fuse)), self.conv1, self.dtype)
        shift, scale = linear(F.silu(t_emb), self.fc, self.dtype).chunk(2, dim=-1)
        if fuse and fusable(h.permute(0, 2, 3, 1), c_out):
            return _fused_conv(h, self.conv2, self.norm2, shift, scale, skip.to(h.dtype))
        h = self.norm2(h, shift, scale, silu=True, fuse=fuse)
        h = self.dropout(h, train, generator)
        return conv2d(h, self.conv2, self.dtype) + skip


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
        B, C, H, W = x.shape
        tokens = self.norm(x, silu=False, fuse=not train).permute(0, 2, 3, 1).reshape(B, H * W, C)
        dt = tokens.dtype
        qkv = F.linear(tokens, self.proj_in.weight.flatten(1).to(dt), self.proj_in.bias.to(dt))
        out = spatial_attention_qkv(qkv, self.num_heads, train=train)
        out = F.linear(out, self.proj_out.weight.flatten(1).to(dt), self.proj_out.bias.to(dt))
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class _ResAttn(nn.Sequential):
    """Residual block followed by attention (the reference's
    ``Sequential(res, attn)``, keys ``.0``/``.1``)."""

    def forward(self, x, t_emb, train=False, generator=None):
        return self[1](self[0](x, t_emb, train, generator), train)


class UNet(nn.Module):
    """Improved-DDPM UNet; constructor arguments mirror the JAX ``UNet``.

    ``forward(x, t, y, train=False, generator=None)``: x (B, H, W, C_in)
    NHWC, t (B,), y (B,) class labels (0 = null class), (B, K) tags with
    ``multitags`` (all zeros = the null label), or None →
    (B, H, W, C_out) f32. With ``train`` and a nonzero ``drop_rate`` the
    dropout bits come from ``generator``.
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
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not resample_with_res:
            raise NotImplementedError("resample_with_res=False (strided-conv resampling) is not ported")
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
            if i != levels - 1:
                mods.append(block(i, chs[i], chs[i], "downsample"))
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
            if i != 0:
                mods.append(block(i, chs[i], chs[i], "upsample"))
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

        hs = [conv2d(x.permute(0, 3, 1, 2), self.in_conv, dt)]
        for level in self.downsamples.values():
            for blk in level:
                hs.append(blk(hs[-1], t_emb, train, generator))

        h = self.middle[0](hs[-1], t_emb, train, generator)
        h = self.middle[1](h, train)
        h = self.middle[2](h, t_emb, train, generator)

        for i in reversed(range(len(self.upsamples))):
            for j, blk in enumerate(self.upsamples[f"level_{i}"]):
                if j <= self.num_res_blocks:  # all but the trailing upsample block
                    h = torch.cat([h, hs.pop()], dim=1)
                h = blk(h, t_emb, train, generator)
        assert not hs

        h = self.out_conv[0](h, silu=True, fuse=not train)
        h = conv2d(h, self.out_conv[2], torch.float32)
        return h.permute(0, 2, 3, 1)
