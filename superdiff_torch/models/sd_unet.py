"""Stable Diffusion's text-conditioned latent UNet, as an ``nn.Module``.

The denoiser of the latent diffusion model (arXiv:2112.10752) in the form
Stable Diffusion 2.1-base publishes it (``unet/config.json`` of
``stabilityai/stable-diffusion-2-1-base``), on NHWC tensors like the rest
of the port. Topology: a 3x3 ``conv_in``; per level ``layers_per_block``
ResBlocks, each followed on the cross-attention levels by a transformer
block, and a stride-2 3x3 conv with symmetric padding 1 between levels; a
middle ResBlock -> transformer -> ResBlock; the mirrored up path with
``layers_per_block + 1`` ResBlocks a level, skip concatenation and nearest
2x upsampling + conv; GroupNorm -> SiLU -> a 3x3 ``conv_out`` in float32.

- **Time**: the flipped sinusoidal embedding (``cat(cos, sin)``,
  frequencies ``exp(-log(1e4) * i / (half - freq_shift))``) of the first
  width, then ``time_embedding.linear_1`` -> SiLU -> ``linear_2`` in
  float32. A ResBlock *adds* ``time_emb_proj(SiLU(emb))`` to its first
  conv's output (no FiLM).
- **Transformer block** (``attentions.N``, linear projection):
  GroupNorm (eps 1e-6) -> ``proj_in`` -> [LayerNorm -> self-attention
  (``attn1``) -> residual; LayerNorm -> cross-attention to the text context
  (``attn2``, keys and values from the ``(B, L, cross_attention_dim)``
  context) -> residual; LayerNorm -> GEGLU feed-forward (``ff``: C -> 8C,
  ``value * gelu(gate)``, 4C -> C) -> residual] -> ``proj_out`` ->
  residual. Every head is ``C / heads`` wide (64 at the published widths:
  ``attention_head_dim`` counts heads there). Both attentions run kernel
  B1 (``ops/attention.py``); ``profiling.span`` names ``sd.transformer``
  around the block and ``sd.attn1``, ``sd.attn2``, ``sd.ff`` inside it
  (live only inside ``profiling.trace``; a graph replay shows none).

Submodule names are diffusers' ``UNet2DConditionModel`` state-dict keys
(``down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight``,
``mid_block.resnets.1.conv2.bias``, ``up_blocks.1.upsamplers.0.conv``,
...), so published weights load with ``load_state_dict``.

Numerics follow the CondUNet's policy: convolutions and dense layers in
``compute_dtype``; GroupNorm and LayerNorm statistics in float32 with the
output in ``norm_dtype``; the ResBlocks' and the head's GroupNorm -> SiLU
chains through ``GroupNorm.film_silu`` (kernel B4 on the card when no
gradient is wanted); the time embedding, ``time_emb_proj`` and
``conv_out`` in float32. ``apply_sampling_policy`` makes the norms bfloat16
and keeps those weights float32 (``inference.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from superdiff_torch.models.layers import (
    GroupNorm, Upsample, conv_nhwc, linear)
from superdiff_torch.utils import profiling


def flipped_time_embedding(t: torch.Tensor, dim: int,
                           freq_shift: float = 0.0) -> torch.Tensor:
    """``(B,)`` timesteps -> ``(B, dim)`` float32, ``cat(cos, sin)`` with
    frequencies ``exp(-log(1e4) * i / (half - freq_shift))`` (diffusers'
    ``Timesteps(flip_sin_to_cos=True)``)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - freq_shift)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _layer_norm(m: nn.LayerNorm, x: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last dim in float32, returned in ``out_dtype``."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight.float(),
                        m.bias.float(), m.eps).to(out_dtype)


class TimestepEmbedding(nn.Module):
    """``linear_1`` -> SiLU -> ``linear_2``, float32."""

    def __init__(self, dim: int, out_dim: int, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(dim, out_dim, device=device)
        self.linear_2 = nn.Linear(out_dim, out_dim, device=device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        h = F.silu(linear(self.linear_1, emb, torch.float32))
        return linear(self.linear_2, h, torch.float32)


class ResnetBlock(nn.Module):
    """``norm1`` -> SiLU -> ``conv1``, plus ``time_emb_proj(SiLU(emb))``
    added per channel; ``norm2`` -> SiLU -> ``conv2``; a 1x1
    ``conv_shortcut`` where the width changes."""

    def __init__(self, in_channels: int, out_channels: int, emb_dim: int,
                 groups: int, eps: float, compute_dtype, norm_dtype,
                 device=None):
        super().__init__()
        self.compute_dtype, self.norm_dtype = compute_dtype, norm_dtype
        self.norm1 = GroupNorm(groups, in_channels, eps=eps, device=device)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, device=device)
        self.time_emb_proj = nn.Linear(emb_dim, out_channels, device=device)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps, device=device)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, device=device)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1,
                                        device=device)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        cd, nd = self.compute_dtype, self.norm_dtype
        h = conv_nhwc(self.conv1, self.norm1.film_silu(x, nd), cd)
        e = linear(self.time_emb_proj, F.silu(emb), torch.float32)
        h = h + e.to(cd)[:, None, None, :]
        h = conv_nhwc(self.conv2, self.norm2.film_silu(h, nd), cd)
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x, cd)
        return (x + h).to(cd)


class Attention(nn.Module):
    """Multi-head attention with diffusers' names: ``to_q``, ``to_k``,
    ``to_v`` (no bias) and ``to_out.0``. Keys and values come from
    ``context`` when given (cross-attention), else from ``x``."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int],
                 compute_dtype, device=None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"{dim} channels do not split into {heads} "
                             "heads")
        self.heads, self.compute_dtype = heads, compute_dtype
        kv = context_dim or dim
        self.to_q = nn.Linear(dim, dim, bias=False, device=device)
        self.to_k = nn.Linear(kv, dim, bias=False, device=device)
        self.to_v = nn.Linear(kv, dim, bias=False, device=device)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, device=device)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        from superdiff_torch.ops.attention import multihead_attention

        cd = self.compute_dtype
        B, S, C = x.shape
        src = x if context is None else context.to(cd)
        q = F.linear(x, self.to_q.weight.to(cd))
        k = F.linear(src, self.to_k.weight.to(cd))
        v = F.linear(src, self.to_v.weight.to(cd))
        hd = C // self.heads
        out = multihead_attention(q.view(B, S, self.heads, hd),
                                  k.view(B, -1, self.heads, hd),
                                  v.view(B, -1, self.heads, hd))
        return linear(self.to_out[0], out.reshape(B, S, C), cd)


class GEGLU(nn.Module):
    """``proj`` to twice the inner width, ``value * gelu(gate)``."""

    def __init__(self, dim: int, inner: int, device=None):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        value, gate = linear(self.proj, x, dtype).chunk(2, dim=-1)
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """``net.0`` (GEGLU, C -> 4C), ``net.1`` (dropout, inference: none),
    ``net.2`` (4C -> C)."""

    def __init__(self, dim: int, compute_dtype, mult: int = 4, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.net = nn.ModuleList([GEGLU(dim, mult * dim, device=device),
                                  nn.Identity(),
                                  nn.Linear(mult * dim, dim, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return linear(self.net[2], self.net[0](x, cd), cd)


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attention, LayerNorm -> cross-attention,
    LayerNorm -> GEGLU feed-forward, each added to its input."""

    def __init__(self, dim: int, heads: int, context_dim: int,
                 compute_dtype, norm_dtype, device=None):
        super().__init__()
        self.compute_dtype, self.norm_dtype = compute_dtype, norm_dtype
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn1 = Attention(dim, heads, None, compute_dtype, device)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.attn2 = Attention(dim, heads, context_dim, compute_dtype, device)
        self.norm3 = nn.LayerNorm(dim, device=device)
        self.ff = FeedForward(dim, compute_dtype, device=device)

    def forward(self, h: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cd, nd = self.compute_dtype, self.norm_dtype
        with profiling.span("sd.transformer"):
            with profiling.span("sd.attn1"):
                h = h + self.attn1(_layer_norm(self.norm1, h, nd).to(cd))
            with profiling.span("sd.attn2"):
                h = h + self.attn2(_layer_norm(self.norm2, h, nd).to(cd),
                                   context)
            with profiling.span("sd.ff"):
                h = h + self.ff(_layer_norm(self.norm3, h, nd).to(cd))
        return h


class Transformer2D(nn.Module):
    """GroupNorm -> ``proj_in`` -> one :class:`BasicTransformerBlock`
    (``transformer_blocks.0``) -> ``proj_out``, added to the input."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 groups: int, compute_dtype, norm_dtype, device=None):
        super().__init__()
        self.compute_dtype, self.norm_dtype = compute_dtype, norm_dtype
        self.norm = GroupNorm(groups, channels, eps=1e-6, device=device)
        self.proj_in = nn.Linear(channels, channels, device=device)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, context_dim, compute_dtype, norm_dtype,
            device)])
        self.proj_out = nn.Linear(channels, channels, device=device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        B, H, W, C = x.shape
        h = self.norm(x, self.norm_dtype).to(cd).reshape(B, H * W, C)
        h = linear(self.proj_in, h, cd)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = linear(self.proj_out, h, cd)
        return x + h.reshape(B, H, W, C)


class Downsample(nn.Module):
    """Stride-2 3x3 conv with symmetric padding 1 (not SAME's (0, 1))."""

    def __init__(self, channels: int, compute_dtype, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(channels, channels, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv, x, self.compute_dtype, stride=2,
                         padding=1)


class _Level(nn.Module):
    """One level of the down or up path: ``resnets``, ``attentions`` (on a
    cross-attention level) and ``downsamplers`` / ``upsamplers``."""

    def __init__(self, resnets, attentions, resample, resample_name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        self._resample_name = resample_name if resample is not None else None
        if resample is not None:
            self.add_module(resample_name, nn.ModuleList([resample]))

    @property
    def resample(self) -> Optional[nn.Module]:
        if self._resample_name is None:
            return None
        return getattr(self, self._resample_name)[0]


class SDUNet(nn.Module):
    """The UNet of Stable Diffusion (``UNet2DConditionModel``): ``x (B, H,
    W, in_channels)`` latents, ``t (B,)`` timesteps and ``context (B, L,
    cross_attention_dim)`` -> ``eps (B, H, W, out_channels)`` float32.

    ``cross_attention_levels``: which levels carry transformer blocks
    (``CrossAttnDownBlock2D`` / ``CrossAttnUpBlock2D``); the published
    net has them at all levels but the last (``DownBlock2D``) and its
    mirror (``UpBlock2D``). ``attention_head_dim`` counts heads per level,
    as the published config does."""

    num_classes = 0
    parameterization = "eps"

    def __init__(self, sample_size: int = 64, in_channels: int = 4,
                 out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2,
                 attention_head_dim: Sequence[int] = (5, 10, 20, 20),
                 cross_attention_levels: Sequence[bool] = (True, True, True,
                                                           False),
                 cross_attention_dim: int = 1024,
                 norm_num_groups: int = 32, norm_eps: float = 1e-5,
                 freq_shift: float = 0.0,
                 compute_dtype=torch.float32, norm_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        widths = tuple(block_out_channels)
        heads = tuple(attention_head_dim)
        if len(heads) != len(widths) or len(cross_attention_levels) != len(
                widths):
            raise ValueError("block_out_channels, attention_head_dim and "
                             "cross_attention_levels need one entry a level")
        self.resolution = sample_size
        self.in_channels, self.out_channels = in_channels, out_channels
        self.context_dim = cross_attention_dim
        self.compute_dtype, self.norm_dtype = compute_dtype, norm_dtype
        self.freq_shift = freq_shift
        cd, nd, G = compute_dtype, norm_dtype, norm_num_groups
        emb_dim = 4 * widths[0]
        self.time_dim = widths[0]

        def res(cin, cout):
            return ResnetBlock(cin, cout, emb_dim, G, norm_eps, cd, nd,
                               device)

        def attn(level):
            if not cross_attention_levels[level]:
                return None
            return Transformer2D(widths[level], heads[level],
                                 cross_attention_dim, G, cd, nd, device)

        self.conv_in = nn.Conv2d(in_channels, widths[0], 3, device=device)
        self.time_embedding = TimestepEmbedding(widths[0], emb_dim, device)

        down, skips, cin = [], [widths[0]], widths[0]
        last = len(widths) - 1
        for level, ch in enumerate(widths):
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(res(cin, ch))
                attns.append(attn(level))
                cin = ch
                skips.append(ch)
            ds = None
            if level != last:
                ds = Downsample(ch, cd, device)
                skips.append(ch)
            down.append(_Level(resnets, [a for a in attns if a], ds,
                               "downsamplers"))
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = _Level(
            [res(cin, widths[-1]), res(widths[-1], widths[-1])],
            [Transformer2D(widths[-1], heads[-1], cross_attention_dim, G, cd,
                           nd, device)], None, "")
        cin = widths[-1]

        up = []
        for level in reversed(range(len(widths))):
            ch = widths[level]
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(res(cin + skips.pop(), ch))
                attns.append(attn(level))
                cin = ch
            us = Upsample(ch, cd, device) if level != 0 else None
            up.append(_Level(resnets, [a for a in attns if a], us,
                             "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        assert not skips

        self.conv_norm_out = GroupNorm(G, widths[0], eps=norm_eps,
                                       device=device)
        self.conv_out = nn.Conv2d(widths[0], out_channels, 3, device=device)

    def set_norm_dtype(self, dtype: torch.dtype) -> "SDUNet":
        """Set the norm-pass dtype of every layer (the inference policy)."""
        for m in self.modules():
            if hasattr(m, "norm_dtype"):
                m.norm_dtype = dtype
        return self

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        cd, nd = self.compute_dtype, self.norm_dtype
        if context is None:
            raise ValueError("SDUNet takes a (B, L, cross_attention_dim) "
                             "context; pass the null context for an "
                             "unconditional call")
        emb = self.time_embedding(
            flipped_time_embedding(t, self.time_dim, self.freq_shift))
        h = conv_nhwc(self.conv_in, x, cd)
        skips = [h]
        for level in self.down_blocks:
            attns = getattr(level, "attentions", None)
            for i, block in enumerate(level.resnets):
                h = block(h, emb)
                if attns is not None:
                    h = attns[i](h, context)
                skips.append(h)
            if level.resample is not None:
                h = level.resample(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, emb)
        for level in self.up_blocks:
            attns = getattr(level, "attentions", None)
            for i, block in enumerate(level.resnets):
                h = block(torch.cat([h, skips.pop().to(cd)], dim=-1), emb)
                if attns is not None:
                    h = attns[i](h, context)
            if level.resample is not None:
                h = level.resample(h)
        assert not skips
        h = self.conv_norm_out.film_silu(h, nd)
        return conv_nhwc(self.conv_out, h, torch.float32)
