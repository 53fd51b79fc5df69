"""CondUNet — the flagship class-conditional DDPM UNet, as an ``nn.Module``.

Port of ``superdiff_tpu/models/unet.py`` (``stage="all"``). Topology:
stem conv, ``len(channel_mults)`` levels of FiLM ResBlocks with stride-2
downsampling between them, self-attention at the feature-map sides in
``attn_resolutions``, middle ResBlock -> attention -> ResBlock, a mirrored
up path with skip concatenation, and GroupNorm -> SiLU -> zero-initialised
3x3 output conv in float32. ``pixel_shuffle > 1`` wraps the net in a
space-to-depth / depth-to-space pair.

Submodule names are the Flax names (``time_mlp.dense_0``, ``class_emb``,
``stem``, ``down_{l}_block_{b}.norm_0``, ``down_{l}_attn_{b}.qkv``,
``down_{l}_downsample.conv``, ``mid_block_0``, ``mid_attn``,
``up_{l}_upsample.conv``, ``out_norm``, ``out_conv``), so the weight
bridge is mechanical and a split by top-level name still works.

Unlike the shape-polymorphic Flax module, a torch module creates its
parameters up front, and which levels carry attention depends on the image
side; so the constructor takes ``resolution`` (the input image side).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from superdiff_torch.models.layers import (
    Downsample, GroupNorm, ResBlock, SelfAttention2D, TimeEmbeddingMLP,
    Upsample, conv_nhwc, init_flax_defaults, num_groups_for)


class CondUNet(nn.Module):

    def __init__(self,
                 resolution: int,
                 in_channels: int = 1,
                 out_channels: int = 1,
                 base_channels: int = 64,
                 channel_mults: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: Union[int, Sequence[int]] = 2,
                 attn_resolutions: Sequence[int] = (16, 8),
                 up_attn_resolutions: Optional[Sequence[int]] = None,
                 num_heads: int = 4,
                 num_classes: int = 0,
                 time_emb_dim: int = 256,
                 dropout: float = 0.0,
                 compute_dtype=torch.float32,
                 groups: int = 32,
                 pixel_shuffle: int = 1,
                 norm_dtype=torch.float32,
                 parameterization: str = "eps",
                 remat: bool = False,
                 device="cuda"):
        super().__init__()
        if parameterization not in ("eps", "v", "x0"):
            raise ValueError("parameterization must be eps/v/x0, got "
                             f"{parameterization!r}")
        p = pixel_shuffle
        if resolution % p:
            raise ValueError(f"resolution {resolution} not divisible by {p}")
        self.resolution = resolution
        self.in_channels, self.out_channels = in_channels, out_channels
        self.num_classes = num_classes
        self.pixel_shuffle = p
        self.compute_dtype = compute_dtype
        self.norm_dtype = norm_dtype
        self.parameterization = parameterization
        # Both act only in train() mode: dropout inside each ResBlock, and
        # remat recomputes each ResBlock and attention block in the backward
        # (torch.utils.checkpoint) and keeps only the block's inputs.
        self.dropout, self.remat = dropout, remat

        n_levels = len(channel_mults)
        if isinstance(num_res_blocks, int):
            blocks = (num_res_blocks,) * n_levels
        else:
            blocks = tuple(num_res_blocks)
            if len(blocks) != n_levels:
                raise ValueError(
                    f"num_res_blocks has {len(blocks)} entries for "
                    f"{n_levels} levels (channel_mults="
                    f"{tuple(channel_mults)})")
        cd, nd = compute_dtype, norm_dtype
        emb_dim = time_emb_dim * 4
        res_kw = dict(emb_dim=emb_dim, compute_dtype=cd, groups=groups,
                      norm_dtype=nd, dropout=dropout, device=device)
        attn_kw = dict(num_heads=num_heads, compute_dtype=cd, norm_dtype=nd,
                       device=device)

        self.time_mlp = TimeEmbeddingMLP(time_emb_dim, out_dim=emb_dim,
                                         device=device)
        if num_classes > 0:
            self.class_emb = nn.Embedding(num_classes + 1, emb_dim,
                                          device=device)
        self.stem = nn.Conv2d(in_channels * p * p, base_channels, 3,
                              device=device)

        # Plan of the forward pass: ("res", name, attn_name or None),
        # ("down", name), ("up", name). Built with the Flax module's own
        # resolution and skip bookkeeping.
        self._down, self._up = [], []
        res = resolution // p
        skip_ch = [base_channels]
        ch_in = base_channels
        for level, mult in enumerate(channel_mults):
            ch = base_channels * mult
            for b in range(blocks[level]):
                name = f"down_{level}_block_{b}"
                self.add_module(name, ResBlock(ch_in, ch, **res_kw))
                attn = None
                if res in attn_resolutions:
                    attn = f"down_{level}_attn_{b}"
                    self.add_module(attn, SelfAttention2D(ch, **attn_kw))
                self._down.append(("res", name, attn))
                ch_in = ch
                skip_ch.append(ch)
            if level != n_levels - 1:
                name = f"down_{level}_downsample"
                self.add_module(name, Downsample(ch, cd, device=device))
                self._down.append(("down", name, None))
                res //= 2
                skip_ch.append(ch)

        mid_ch = base_channels * channel_mults[-1]
        self.mid_block_0 = ResBlock(ch_in, mid_ch, **res_kw)
        self.mid_attn = SelfAttention2D(mid_ch, **attn_kw)
        self.mid_block_1 = ResBlock(mid_ch, mid_ch, **res_kw)
        ch_in = mid_ch

        # None mirrors attn_resolutions into the up path (unet.py:211-212)
        up_attn = (attn_resolutions if up_attn_resolutions is None
                   else up_attn_resolutions)
        for level, mult in reversed(list(enumerate(channel_mults))):
            ch = base_channels * mult
            for b in range(blocks[level] + 1):
                name = f"up_{level}_block_{b}"
                self.add_module(name, ResBlock(ch_in + skip_ch.pop(), ch,
                                               **res_kw))
                attn = None
                if res in up_attn:
                    attn = f"up_{level}_attn_{b}"
                    self.add_module(attn, SelfAttention2D(ch, **attn_kw))
                self._up.append(("res", name, attn))
                ch_in = ch
            if level != 0:
                name = f"up_{level}_upsample"
                self.add_module(name, Upsample(ch, cd, device=device))
                self._up.append(("up", name, None))
                res *= 2
        assert not skip_ch

        self.out_norm = GroupNorm(num_groups_for(ch_in, groups), ch_in,
                                  device=device)
        self.out_conv = nn.Conv2d(ch_in, out_channels * p * p, 3,
                                  device=device)
        nn.init.zeros_(self.out_conv.weight)
        nn.init.zeros_(self.out_conv.bias)

    @property
    def null_label(self) -> int:
        """Label index meaning "unconditional" (classifier-free guidance)."""
        return self.num_classes

    def init_parameters(self, seed: int = 0) -> "CondUNet":
        """Initialise for training with the Flax module's distributions
        (:func:`init_flax_defaults`); the ``conv_1`` / ``proj`` /
        ``out_conv`` kernels are 0."""
        return init_flax_defaults(self, seed,
                                  ("conv_1", "proj", "out_conv"))

    def set_norm_dtype(self, dtype: torch.dtype) -> "CondUNet":
        """Set the norm-pass dtype of every layer (the inference policy)."""
        for m in self.modules():
            if hasattr(m, "norm_dtype"):
                m.norm_dtype = dtype
        return self

    def _block(self, name: str, *args) -> torch.Tensor:
        """Run a ResBlock or attention block, rematerialised in training
        when ``remat`` is set (``nn.remat`` in the JAX package). The
        non-reentrant checkpoint replays dropout's generator state."""
        block = getattr(self, name)
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x (B, H, W, C)``, ``t (B,)`` int, ``y (B,)`` int -> ``(B, H, W,
        out_channels)`` float32."""
        cd, nd, p = self.compute_dtype, self.norm_dtype, self.pixel_shuffle
        if x.shape[1] != self.resolution or x.shape[2] != self.resolution:
            raise ValueError(f"model built for {self.resolution}^2 inputs, "
                             f"got {tuple(x.shape)}")
        emb = self.time_mlp(t)
        if self.num_classes > 0:
            if y is None:
                raise ValueError(
                    "CondUNet(num_classes>0) requires labels y; pass "
                    "y=full(null_label) for unconditional use.")
            emb = emb + self.class_emb.weight.float()[y]

        if p > 1:
            x = space_to_depth(x, p)
        h = conv_nhwc(self.stem, x, cd)
        skips = [h]
        for kind, name, attn in self._down:
            if kind == "res":
                h = self._block(name, h, emb)
                if attn is not None:
                    h = self._block(attn, h)
            else:
                h = getattr(self, name)(h)
            skips.append(h)

        h = self._block("mid_block_0", h, emb)
        h = self._block("mid_attn", h)
        h = self._block("mid_block_1", h, emb)

        for kind, name, attn in self._up:
            if kind == "res":
                h = torch.cat([h, skips.pop().to(cd)], dim=-1)
                h = self._block(name, h, emb)
                if attn is not None:
                    h = self._block(attn, h)
            else:
                h = getattr(self, name)(h)
        assert not skips

        h = self.out_norm.film_silu(h, nd)
        h = conv_nhwc(self.out_conv, h, torch.float32)
        if p > 1:
            h = depth_to_space(h, p)
        return h


def space_to_depth(x: torch.Tensor, p: int) -> torch.Tensor:
    """Lossless ``(B, H, W, C) -> (B, H/p, W/p, C*p*p)``; channel index
    ``(ph*p + pw)*C + c`` as in the JAX package (not ``pixel_unshuffle``'s
    ``c*p*p + ph*p + pw``)."""
    B, H, W, C = x.shape
    if H % p or W % p:
        raise ValueError(f"resolution {(H, W)} not divisible by {p}")
    x = x.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // p, W // p, p * p * C)


def depth_to_space(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    B, H, W, PC = x.shape
    C = PC // (p * p)
    x = x.reshape(B, H, W, p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H * p, W * p, C)
