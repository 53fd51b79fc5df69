"""Building blocks of the CondUNet and the RefUNet, as ``nn.Module``s on
NHWC tensors.

Port of ``superdiff_tpu/models/layers.py``. Activations stay NHWC
``(B, H, W, C)`` as in the JAX package; a convolution sees them through a
``permute`` to NCHW, which is a channels-last view, so no copy is made on
the way in or out. Parameters keep PyTorch's layouts (conv ``(O, I, kh, kw)``,
linear ``(out, in)``); ``compat/flax_params.py`` converts Flax trees.

Numerics follow Flax: each layer casts its input and weights to the
layer's ``compute_dtype``; GroupNorm reduces ``E[x]`` and ``E[x^2]`` in
float32 (variance ``E[x^2] - E[x]^2`` clipped at 0, eps 1e-5) and returns
``norm_dtype``; FiLM is applied in ``norm_dtype``. The ResBlock's and the
CondUNet's GroupNorm -> (FiLM) -> SiLU chains go through
``GroupNorm.film_silu`` (kernel B4 on the card when no gradient is wanted,
with the same rounding points). ``GroupNormSiLU`` and ``NormAct`` compute
GroupNorm -> FiLM -> SiLU as one function in float32 (``GroupNormSiLU``:
kernel B4 on the card).
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
              stride: int = 1, bias: bool = True) -> torch.Tensor:
    """Flax ``nn.Conv(padding="SAME", dtype=dtype)`` on an NHWC tensor
    (``bias=False`` leaves the bias out).

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
    # (a weight mapped by torch.func.vmap, stacked models, has no layout
    # to ask about)
    if (xc.is_cuda and not torch._C._functorch.is_batchedtensor(w)
            and not w.is_contiguous(memory_format=torch.channels_last)):
        w = w.contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, w, m.bias.to(dtype) if bias else None, stride=stride,
                 padding=padding)
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
        from superdiff_torch.ops.fused_norm import group_norm_plain

        return group_norm_plain(x, self.weight, self.bias, self.num_groups,
                                self.eps, out_dtype)

    def film_silu(self, x: torch.Tensor, norm_dtype: torch.dtype,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This norm, then ``h * (1 + scale) + shift`` and SiLU, all in
        ``norm_dtype``:
        :func:`~superdiff_torch.ops.fused_norm.gn_film_silu_policy` (kernel
        B4 on the card when no gradient is wanted)."""
        from superdiff_torch.ops.fused_norm import gn_film_silu_policy

        return gn_film_silu_policy(x, self.weight, self.bias,
                                   self.num_groups, norm_dtype, scale, shift,
                                   self.eps)


class GroupNormSiLU(nn.Module):
    """GroupNorm + optional FiLM + SiLU through
    :func:`~superdiff_torch.ops.fused_norm.fused_groupnorm_silu`: kernel B4
    on a CUDA tensor, the plain version on a CPU tensor. Parameters
    ``weight`` / ``bias`` (Flax ``scale`` / ``bias``); output in ``x``'s
    dtype."""

    def __init__(self, num_groups: int, channels: int, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor,
                film_scale: Optional[torch.Tensor] = None,
                film_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        from superdiff_torch.ops.fused_norm import fused_groupnorm_silu

        # the kernel takes NHWC-contiguous x; a conv's output is already
        # (cuDNN returns channels-last), so this copies nothing on the path
        return fused_groupnorm_silu(
            x.contiguous(), self.weight, self.bias, self.num_groups,
            film_scale, film_shift)


class NormAct(nn.Module):
    """GroupNorm + optional FiLM + SiLU through the plain chain
    :func:`~superdiff_torch.ops.packed_norm.groupnorm_film_silu` (the
    reference's lane-packed variant; the fold does not change the result),
    output in ``dtype``. Parameters ``weight`` / ``bias``."""

    def __init__(self, num_groups: int, channels: int,
                 dtype=torch.float32, eps: float = 1e-5, device=None):
        super().__init__()
        self.num_groups, self.dtype, self.eps = num_groups, dtype, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor,
                film_scale: Optional[torch.Tensor] = None,
                film_shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        from superdiff_torch.ops.packed_norm import groupnorm_film_silu

        return groupnorm_film_silu(
            x, self.weight, self.bias, self.num_groups, eps=self.eps,
            film_scale=film_scale, film_shift=film_shift,
            out_dtype=self.dtype, pack=True)


@torch.no_grad()
def init_flax_defaults(model: nn.Module, seed: int,
                       zero_kernels=()) -> nn.Module:
    """Initialise ``model`` with the Flax modules' distributions: conv and
    dense kernels LeCun-normal (truncated at 2 sigma, variance 1/fan_in),
    embeddings N(0, 1/dim), biases 0, norm scales 1; the kernels of
    submodules whose last name is in ``zero_kernels`` 0. Values are drawn on
    the CPU from ``seed``, in module order, so they do not depend on the
    device."""
    g = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            leaf = name.rsplit(".", 1)[-1]
            w = torch.zeros(m.weight.shape)
            if leaf not in zero_kernels:
                std = (w[0].numel() ** -0.5) / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=g)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            w = torch.randn(m.weight.shape, generator=g)
            m.weight.copy_(w * m.weight.shape[1] ** -0.5)
        elif isinstance(m, (GroupNorm, GroupNormSiLU, NormAct)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


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
    second SiLU and ``conv_1`` in ``train()`` mode only. ``tp`` is None, or
    this rank's ``parallel/tp.py::TPShard`` of a tensor-parallel block:
    ``conv_0`` / ``norm_1`` hold its output channels, ``conv_1`` its input
    channels, and the partial sums of ``conv_1`` are summed over the
    ranks before the bias.
    """

    tp = None

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
        cd, nd, tp = self.compute_dtype, self.norm_dtype, self.tp
        h = self.norm_0.film_silu(x, nd)
        if tp is not None:
            h = tp.enter(h)
        h = conv_nhwc(self.conv_0, h, cd)
        cond = linear(self.emb_proj, F.silu(emb.float()), torch.float32)
        if tp is not None:
            cond = tp.enter(cond)
        scale, shift = cond.chunk(2, dim=-1)                 # (B, C) each
        if tp is not None:
            scale, shift = tp.local(scale), tp.local(shift)
        h = self.norm_1.film_silu(h, nd, scale, shift).to(cd)
        if self.dropout > 0.0:
            h = F.dropout(h, self.dropout, training=self.training)
        if tp is None:
            h = conv_nhwc(self.conv_1, h, cd)
        else:
            h = (tp.reduce(conv_nhwc(self.conv_1, h, cd, bias=False))
                 + self.conv_1.bias.to(cd))
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
