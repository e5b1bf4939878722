"""The plain float32 UNet of the benchmark: the improved-DDPM denoiser written
out in plain PyTorch operations, with no kernel, graph or cache of the
program under test.

The weights are a flat ``{name: tensor}`` dict whose names are the published
reference's state_dict keys (tqch/v-diffusion-torch), so one dict made from
the seed serves the program and this model alike. Activations are NCHW.

``quant`` is the control's hook: a function applied to the inputs and the
weight of every convolution and projection, and to q, k, the softmax weights
and v of every attention, which puts a lower precision in the places where
the program rounds. ``keep`` holds the training dropout masks, one bool
tensor a residual block in the order the forward reaches them.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def channels(cfg: dict) -> List[int]:
    return [m * cfg["hid_channels"] for m in cfg["ch_multipliers"]]


def embed_dim(cfg: dict) -> int:
    return cfg.get("embedding_dim") or 4 * cfg["hid_channels"]


def heads(cfg: dict, c: int) -> int:
    """Heads of an attention block of ``c`` channels: ``num_heads`` where the
    configuration sets it, else channels / ``head_dim``."""
    if cfg.get("num_heads"):
        return cfg["num_heads"]
    return c // cfg["head_dim"]


def blocks(cfg: dict):
    """The residual blocks in forward order: (key, in, out, resampling,
    attention) for every block of the down path, the middle and the up path."""
    chs, hid, nres = channels(cfg), cfg["hid_channels"], cfg["num_res_blocks"]
    attn, levels = cfg["apply_attn"], len(chs)
    out = []
    for i in range(levels):
        prev = chs[i - 1] if i else hid
        out.append((f"downsamples.level_{i}.0", prev, chs[i], "none", attn[i]))
        for j in range(1, nres):
            out.append((f"downsamples.level_{i}.{j}", chs[i], chs[i], "none", attn[i]))
        if i != levels - 1:
            out.append((f"downsamples.level_{i}.{nres}", chs[i], chs[i], "down", attn[i]))
    out.append(("middle.0", chs[-1], chs[-1], "none", False))
    out.append(("middle.2", chs[-1], chs[-1], "none", False))
    for i in reversed(range(levels)):
        nxt = hid if i == 0 else chs[i - 1]
        prev = chs[-1] if i == levels - 1 else chs[i + 1]
        out.append((f"upsamples.level_{i}.0", prev + chs[i], chs[i], "none", attn[i]))
        for j in range(1, nres):
            out.append((f"upsamples.level_{i}.{j}", 2 * chs[i], chs[i], "none", attn[i]))
        out.append((f"upsamples.level_{i}.{nres}", nxt + chs[i], chs[i], "none", attn[i]))
        if i != 0:
            out.append((f"upsamples.level_{i}.{nres + 1}", chs[i], chs[i], "up", attn[i]))
    return out


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every weight's name and shape, in a fixed order."""
    E, hid = embed_dim(cfg), cfg["hid_channels"]
    shapes = {"time_embed.0.weight": (E, hid), "time_embed.0.bias": (E,),
              "time_embed.2.weight": (E, E), "time_embed.2.bias": (E,)}
    K = cfg.get("num_classes", 0)
    if K and cfg.get("multitags"):
        shapes.update({"class_embed.weight": (E, K), "class_embed.bias": (E,)})
    elif K:
        shapes.update({"class_embed.1.weight": (E, K), "class_embed.1.bias": (E,)})
    shapes.update({"in_conv.weight": (hid, cfg["in_channels"], 3, 3), "in_conv.bias": (hid,)})

    def res(key, cin, cout):
        shapes.update({f"{key}.norm1.weight": (cin,), f"{key}.norm1.bias": (cin,),
                       f"{key}.conv1.weight": (cout, cin, 3, 3), f"{key}.conv1.bias": (cout,),
                       f"{key}.fc.weight": (2 * cout, E), f"{key}.fc.bias": (2 * cout,),
                       f"{key}.norm2.weight": (cout,), f"{key}.norm2.bias": (cout,),
                       f"{key}.conv2.weight": (cout, cout, 3, 3), f"{key}.conv2.bias": (cout,)})
        if cin != cout:
            shapes.update({f"{key}.skip.weight": (cout, cin, 1, 1), f"{key}.skip.bias": (cout,)})

    def attn(key, c):
        hc = heads(cfg, c) * (cfg.get("head_dim") or c // heads(cfg, c))
        shapes.update({f"{key}.norm.weight": (c,), f"{key}.norm.bias": (c,),
                       f"{key}.proj_in.weight": (3 * hc, c, 1, 1), f"{key}.proj_in.bias": (3 * hc,),
                       f"{key}.proj_out.weight": (c, hc, 1, 1), f"{key}.proj_out.bias": (c,)})

    for key, cin, cout, _, has_attn in blocks(cfg):
        if key == "middle.2":
            attn("middle.1", cin)
        if has_attn:
            res(f"{key}.0", cin, cout)
            attn(f"{key}.1", cout)
        else:
            res(key, cin, cout)
    shapes.update({"out_conv.0.weight": (hid,), "out_conv.0.bias": (hid,),
                   "out_conv.2.weight": (cfg["out_channels"], hid, 3, 3),
                   "out_conv.2.bias": (cfg["out_channels"],)})
    return shapes


def dropout_shapes(cfg: dict, batch: int, resolution: int) -> List[tuple]:
    """The NCHW shape of each residual block's dropout input, in the order
    the forward reaches them (the order its random bits are drawn in)."""
    out, res = [], resolution
    for _, _, cout, resampling, _ in blocks(cfg):
        res = res // 2 if resampling == "down" else res * 2 if resampling == "up" else res
        out.append((batch, cout, res, res))
    return out


def drop_threshold(rate: float) -> int:
    """Dropout keeps an element iff its uniform 16-bit draw is at least this."""
    return int(round(rate * 65536.0))


def keep_prob(rate: float) -> float:
    return 1.0 - drop_threshold(rate) / 65536.0


def timestep_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding (fairseq convention): [sin, cos] of scale·t times
    10000^(-k / (dim/2 - 1))."""
    t = scale * t.float().reshape(-1)
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) / (half - 1)
                     * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1)


def _identity(a: torch.Tensor) -> torch.Tensor:
    return a


class PlainUNet:
    """The forward of one configuration on one weight dict."""

    def __init__(self, cfg: dict, params: Params,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.cfg, self.p = cfg, params
        self.q = quant or _identity

    def linear(self, x, key):
        w = self.p[f"{key}.weight"]
        return F.linear(self.q(x), self.q(w.flatten(1)), self.p[f"{key}.bias"])

    def conv(self, x, key, padding):
        return F.conv2d(self.q(x), self.q(self.p[f"{key}.weight"]), self.p[f"{key}.bias"],
                        padding=padding)

    def group_norm(self, x, key, shift=None, scale=None, silu=True):
        """GroupNorm(32, eps 1e-6) of NCHW x, then (1 + scale)·h + shift, then SiLU."""
        h = F.group_norm(x, 32, self.p[f"{key}.weight"], self.p[f"{key}.bias"], eps=1e-6)
        if scale is not None:
            h = h * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]
        return F.silu(h) if silu else h

    def attention(self, x, key):
        B, C, H, W = x.shape
        n = heads(self.cfg, C)
        tokens = self.group_norm(x, f"{key}.norm", silu=False).permute(0, 2, 3, 1)
        qkv = self.linear(tokens.reshape(B, H * W, C), f"{key}.proj_in")
        d = qkv.shape[-1] // (3 * n)
        q, k, v = qkv.reshape(B, H * W, 3, n, d).unbind(2)
        logits = torch.einsum("btnc,bsnc->bnts", self.q(q), self.q(k)) / math.sqrt(d)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bnts,bsnc->btnc", self.q(weights), self.q(v)).reshape(B, H * W, n * d)
        out = self.linear(out, f"{key}.proj_out")
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x

    def res_block(self, x, temb, key, resampling, keep):
        resample = {"none": _identity, "down": lambda a: F.avg_pool2d(a, 2),
                    "up": lambda a: F.interpolate(a, scale_factor=2, mode="nearest")}[resampling]
        skip = resample(x)
        if f"{key}.skip.weight" in self.p:
            skip = self.conv(skip, f"{key}.skip", 0)
        h = self.conv(resample(self.group_norm(x, f"{key}.norm1")), f"{key}.conv1", 1)
        shift, scale = self.linear(F.silu(temb), f"{key}.fc").chunk(2, dim=-1)
        h = self.group_norm(h, f"{key}.norm2", shift, scale)
        if keep is not None:
            scale = torch.full((), 1.0 / keep_prob(self.cfg["drop_rate"]), dtype=h.dtype,
                               device=h.device)
            h = torch.where(keep, h * scale, torch.zeros((), dtype=h.dtype, device=h.device))
        return self.conv(h, f"{key}.conv2", 1) + skip

    def __call__(self, x_nhwc: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
                 keep: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """x (B, H, W, C) NHWC, t (B,), y (B,) classes (0 the null class) or
        (B, K) tags (all zeros the null label) → (B, H, W, C_out) float32."""
        cfg = self.cfg
        temb = timestep_embedding(t, cfg["hid_channels"])
        temb = self.linear(F.silu(self.linear(temb, "time_embed.0")), "time_embed.2")
        K = cfg.get("num_classes", 0)
        if K and y is not None and cfg.get("multitags"):
            count = (y != 0).sum(dim=1).to(y.dtype).clamp(min=1.0).sqrt()
            temb = temb + self.linear(y / count[:, None], "class_embed")
        elif K and y is not None:
            onehot = F.one_hot((y.long() - 1).clamp(min=0), K).float()
            onehot = torch.where((y == 0)[:, None], torch.zeros_like(onehot), onehot)
            temb = temb + self.linear(onehot, "class_embed.1")

        masks = iter(keep) if keep is not None else None
        nres = cfg["num_res_blocks"]

        def block(h, key, resampling, has_attn):
            m = next(masks) if masks is not None else None
            if not has_attn:
                return self.res_block(h, temb, key, resampling, m)
            return self.attention(self.res_block(h, temb, f"{key}.0", resampling, m), f"{key}.1")

        hs = [self.conv(x_nhwc.permute(0, 3, 1, 2), "in_conv", 1)]
        h = None
        for key, _, _, resampling, has_attn in blocks(cfg):
            if key.startswith("downsamples"):
                hs.append(block(hs[-1], key, resampling, has_attn))
            elif key == "middle.0":
                h = block(hs[-1], key, resampling, False)
                h = self.attention(h, "middle.1")
            elif key == "middle.2":
                h = block(h, key, resampling, False)
            else:
                j = int(key.rsplit(".", 1)[1])
                if j <= nres:
                    h = torch.cat([h, hs.pop()], dim=1)
                h = block(h, key, resampling, has_attn)
        assert not hs
        h = self.group_norm(h, "out_conv.0")
        return self.conv(h, "out_conv.2", 1).permute(0, 2, 3, 1)
