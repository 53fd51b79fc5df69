"""Building blocks of the CondUNet, as ``nn.Module``s on NHWC tensors.

Port of ``superdiff_tpu/models/layers.py``. Activations stay NHWC
``(B, H, W, C)`` as in the JAX package; a convolution sees them through a
``permute`` to NCHW, which is a channels-last view, so no copy is made on
the way in or out. Parameters keep PyTorch's layouts (conv ``(O, I, kh, kw)``,
linear ``(out, in)``); ``compat/flax_params.py`` converts Flax trees.

Numerics follow Flax: each layer casts its input and weights to the
layer's ``compute_dtype``; GroupNorm reduces ``E[x]`` and ``E[x^2]`` in
float32 (variance ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-5) and returns
``norm_dtype``; FiLM is applied in ``norm_dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``(B,)`` timesteps -> ``(B, dim)`` float32, ``concat(sin, cos)`` with
    frequencies ``exp(-log(1e4) * i / (half - 1))``."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def num_groups_for(channels: int, max_groups: int) -> int:
    """Largest group count <= max_groups that divides ``channels``."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def linear(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), m.weight.to(dtype), m.bias.to(dtype))


def _same_pad(n: int, k: int, s: int):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(m: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype,
              stride: int = 1) -> torch.Tensor:
    """Flax ``nn.Conv(padding="SAME", dtype=dtype)`` on an NHWC tensor.

    SAME padding is computed as Flax does: a 3x3 stride-2 conv on an even
    size pads ``(0, 1)``, not ``(1, 1)``."""
    xc = x.to(dtype).permute(0, 3, 1, 2)            # NCHW, channels-last view
    kh, kw = m.kernel_size
    (pt, pb), (pl, pr) = (_same_pad(xc.shape[2], kh, stride),
                          _same_pad(xc.shape[3], kw, stride))
    if pt == pb and pl == pr:
        padding = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        padding = 0
    w = m.weight.to(dtype)
    if xc.is_cuda and not w.is_contiguous(memory_format=torch.channels_last):
        w = w.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, w, m.bias.to(dtype), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm`` on NHWC: parameters ``weight`` (Flax ``scale``)
    and ``bias``, statistics in float32, output in ``out_dtype``."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        xg = x.float().reshape(B, -1, G, C // G)
        mu = xg.mean(dim=(1, 3), keepdim=True)
        mu2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().view(
            1, 1, G, C // G)
        y = (xg - mu) * mul + self.bias.float().view(1, 1, G, C // G)
        return y.reshape(x.shape).to(out_dtype)


class TimeEmbeddingMLP(nn.Module):
    """Sinusoidal embedding -> Linear -> SiLU -> Linear (float32)."""

    def __init__(self, dim: int, out_dim: Optional[int] = None, device=None):
        super().__init__()
        self.dim = dim
        self.dense_0 = nn.Linear(dim, dim * 4, device=device)
        self.dense_1 = nn.Linear(dim * 4, out_dim or dim, device=device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = sinusoidal_time_embedding(t, self.dim)
        h = F.silu(linear(self.dense_0, h, torch.float32))
        return linear(self.dense_1, h, torch.float32)


class ResBlock(nn.Module):
    """DDPM residual block with FiLM (scale-shift) conditioning.

    ``norm_0 -> SiLU -> conv_0``, FiLM from ``emb_proj(SiLU(emb))`` after
    ``norm_1``, ``SiLU -> conv_1`` (zero-initialised), 1x1 ``skip_proj`` when
    the channel count changes. ``dropout > 0`` drops activations between the
    second SiLU and ``conv_1`` in ``train()`` mode only.
    """

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 compute_dtype=torch.float32, groups: int = 32,
                 norm_dtype=torch.float32, dropout: float = 0.0, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm_dtype = norm_dtype
        self.dropout = dropout
        self.norm_0 = GroupNorm(num_groups_for(in_channels, groups),
                                in_channels, device=device)
        self.conv_0 = nn.Conv2d(in_channels, out_channels, 3, device=device)
        self.emb_proj = nn.Linear(emb_dim, 2 * out_channels, device=device)
        self.norm_1 = GroupNorm(num_groups_for(out_channels, groups),
                                out_channels, device=device)
        self.conv_1 = nn.Conv2d(out_channels, out_channels, 3, device=device)
        nn.init.zeros_(self.conv_1.weight)
        nn.init.zeros_(self.conv_1.bias)
        if in_channels != out_channels:
            self.skip_proj = nn.Conv2d(in_channels, out_channels, 1,
                                       device=device)
        else:
            self.skip_proj = None

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        cd, nd = self.compute_dtype, self.norm_dtype
        h = F.silu(self.norm_0(x, nd))
        h = conv_nhwc(self.conv_0, h, cd)
        cond = linear(self.emb_proj, F.silu(emb.float()), torch.float32)
        scale, shift = cond.chunk(2, dim=-1)                 # (B, C) each
        h = self.norm_1(h, nd)
        h = (h * (1.0 + scale.to(nd)[:, None, None, :])
             + shift.to(nd)[:, None, None, :])
        h = F.silu(h).to(cd)
        if self.dropout > 0.0:
            h = F.dropout(h, self.dropout, training=self.training)
        h = conv_nhwc(self.conv_1, h, cd)
        if self.skip_proj is not None:
            x = conv_nhwc(self.skip_proj, x, cd)
        return (x + h).to(cd)


class SelfAttention2D(nn.Module):
    """Multi-head self-attention over flattened spatial positions.

    The fused ``qkv`` projection is split into ``(B, S, H, D)`` strided views
    that go into :func:`multihead_attention` without copies."""

    def __init__(self, channels: int, num_heads: int = 4,
                 compute_dtype=torch.float32, norm_dtype=torch.float32,
                 device=None):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.norm_dtype = norm_dtype
        self.norm = GroupNorm(num_groups_for(channels, 32), channels,
                              device=device)
        self.qkv = nn.Linear(channels, 3 * channels, device=device)
        self.proj = nn.Linear(channels, channels, device=device)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from superdiff_torch.ops.attention import multihead_attention

        B, H, W, C = x.shape
        cd = self.compute_dtype
        h = self.norm(x, self.norm_dtype).to(cd).reshape(B, H * W, C)
        qkv = linear(self.qkv, h, cd)
        hd = C // self.num_heads
        q, k, v = (a.view(B, H * W, self.num_heads, hd)
                   for a in qkv.split(C, dim=-1))
        out = multihead_attention(q, k, v).reshape(B, H * W, C)
        out = linear(self.proj, out, cd)
        return x + out.reshape(B, H, W, C)


class Downsample(nn.Module):
    """Stride-2 3x3 conv downsampling (keeps channels, Flax SAME padding)."""

    def __init__(self, channels: int, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(channels, channels, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, x, self.compute_dtype, stride=2)


class Upsample(nn.Module):
    """Nearest-neighbour 2x upsample + 3x3 conv."""

    def __init__(self, channels: int, compute_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(channels, channels, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                           mode="nearest")
        return conv_nhwc(self.conv, up.permute(0, 2, 3, 1),
                         self.compute_dtype)
