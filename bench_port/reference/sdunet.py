"""Stable Diffusion's UNet written down plainly, as functions of a dict of
float32 parameters, in float32 (from the published description: diffusers'
``UNet2DConditionModel`` at the keys of ``unet/config.json``, and the
latent diffusion model of arXiv:2112.10752; imports nothing of the
program).

Latents are NHWC. Parameter names and shapes are diffusers' state-dict
keys, so one dict of seeded weights feeds both sides. The forward pass:
the flipped sinusoidal embedding of the first width (``cat(cos, sin)``,
frequencies ``exp(-log(1e4) i / (half - freq_shift))``) -> ``linear_1`` ->
SiLU -> ``linear_2``; ``conv_in``; per level ``layers_per_block`` ResBlocks
(GroupNorm -> SiLU -> conv1, plus ``time_emb_proj(SiLU(emb))`` per channel,
GroupNorm -> SiLU -> conv2, a 1x1 ``conv_shortcut`` where the width
changes), each followed on a ``CrossAttnDownBlock2D`` level by a transformer
(GroupNorm eps 1e-6 -> ``proj_in`` -> LayerNorm -> self-attention ->
residual, LayerNorm -> cross-attention to the context -> residual,
LayerNorm -> GEGLU -> residual -> ``proj_out`` -> residual), a stride-2
3x3 conv with padding 1 between levels; the middle ResBlock -> transformer
-> ResBlock; the mirrored up path (``layers_per_block + 1`` ResBlocks a
level, skip concatenation, nearest 2x upsampling + conv); GroupNorm ->
SiLU -> ``conv_out`` in float32. Attention: heads of ``C / heads``
(``attention_head_dim`` counts heads), softmax in float32, over as many
samples at a time as keep the scores within 1 GiB.

``attn`` (a list, optional) collects ``(B, Sq, Skv, H, D)`` of every
attention product in call order: the launches kernel B1 runs.
``forward(..., chains=)`` collects the GroupNorm -> SiLU chains as
``reference/condunet.py`` does: the chains kernel B4 runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference.condunet import group_norm
from bench_port.reference.precision import Precision


def _levels(cfg) -> List[Tuple[int, int, bool]]:
    """``(width, heads, cross-attention)`` per level."""
    return [(c, h, kind.startswith("CrossAttn"))
            for c, h, kind in zip(cfg["block_out_channels"],
                                  cfg["attention_head_dim"],
                                  cfg["down_block_types"])]


def _plan(cfg):
    """``(down, mid, up)``: the blocks in call order, each ``("res", name,
    cin, cout)``, ``("attn", name, width, heads)``, ``("down", name, c)``,
    ``("up", name, c)`` or (up path) ``("skip",)`` before a ResBlock."""
    levels, n = _levels(cfg), cfg["layers_per_block"]
    w0 = cfg["block_out_channels"][0]
    down, skips, cin = [], [w0], w0
    for i, (ch, heads, cross) in enumerate(levels):
        for j in range(n):
            down.append(("res", f"down_blocks.{i}.resnets.{j}", cin, ch))
            if cross:
                down.append(("attn", f"down_blocks.{i}.attentions.{j}", ch,
                             heads))
            down.append(("keep",))
            cin = ch
            skips.append(ch)
        if i != len(levels) - 1:
            down.append(("down", f"down_blocks.{i}.downsamplers.0", ch))
            down.append(("keep",))
            skips.append(ch)
    ch, heads, _ = levels[-1]
    mid = [("res", "mid_block.resnets.0", cin, ch),
           ("attn", "mid_block.attentions.0", ch, heads),
           ("res", "mid_block.resnets.1", ch, ch)]
    cin, up = ch, []
    for u, i in enumerate(reversed(range(len(levels)))):
        ch, heads, cross = levels[i]
        for j in range(n + 1):
            up.append(("skip",))
            up.append(("res", f"up_blocks.{u}.resnets.{j}",
                       cin + skips.pop(), ch))
            if cross:
                up.append(("attn", f"up_blocks.{u}.attentions.{j}", ch,
                           heads))
            cin = ch
        if i != 0:
            up.append(("up", f"up_blocks.{u}.upsamplers.0", ch))
    assert not skips
    return down, mid, up


def param_specs(cfg) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter, in a fixed order. Kinds:
    ``weight`` (fan-in scaled), ``bias``, ``norm_weight``, ``norm_bias``."""
    w0, ctx = cfg["block_out_channels"][0], cfg["cross_attention_dim"]
    emb = 4 * w0
    specs = []

    def dense(name, cin, cout, bias=True):
        specs.append((f"{name}.weight", (cout, cin), "weight"))
        if bias:
            specs.append((f"{name}.bias", (cout,), "bias"))

    def conv(name, cin, cout, k=3):
        specs.extend([(f"{name}.weight", (cout, cin, k, k), "weight"),
                      (f"{name}.bias", (cout,), "bias")])

    def norm(name, c):
        specs.extend([(f"{name}.weight", (c,), "norm_weight"),
                      (f"{name}.bias", (c,), "norm_bias")])

    conv("conv_in", cfg["in_channels"], w0)
    dense("time_embedding.linear_1", w0, emb)
    dense("time_embedding.linear_2", emb, emb)
    down, mid, up = _plan(cfg)
    for item in down + mid + up:
        if item[0] == "res":
            _, name, cin, cout = item
            norm(f"{name}.norm1", cin)
            conv(f"{name}.conv1", cin, cout)
            dense(f"{name}.time_emb_proj", emb, cout)
            norm(f"{name}.norm2", cout)
            conv(f"{name}.conv2", cout, cout)
            if cin != cout:
                conv(f"{name}.conv_shortcut", cin, cout, k=1)
        elif item[0] == "attn":
            _, name, c, _ = item
            b = f"{name}.transformer_blocks.0"
            norm(f"{name}.norm", c)
            dense(f"{name}.proj_in", c, c)
            for a, kv in (("attn1", c), ("attn2", ctx)):
                norm(f"{b}.norm{a[-1]}", c)
                dense(f"{b}.{a}.to_q", c, c, bias=False)
                dense(f"{b}.{a}.to_k", kv, c, bias=False)
                dense(f"{b}.{a}.to_v", kv, c, bias=False)
                dense(f"{b}.{a}.to_out.0", c, c)
            norm(f"{b}.norm3", c)
            dense(f"{b}.ff.net.0.proj", c, 8 * c)
            dense(f"{b}.ff.net.2", 4 * c, c)
            dense(f"{name}.proj_out", c, c)
        elif item[0] in ("down", "up"):
            conv(f"{item[1]}.conv", item[2], item[2])
    norm("conv_norm_out", w0)
    conv("conv_out", w0, cfg["out_channels"])
    return specs


def alpha_bars(cfg) -> np.ndarray:
    """``alpha_bar`` of the configuration's schedule, float64:
    ``scaled_linear`` is ``linspace(sqrt(beta_start), sqrt(beta_end),
    T)**2``."""
    T, b0, b1 = (cfg["num_train_timesteps"], cfg["beta_start"],
                 cfg["beta_end"])
    if cfg["beta_schedule"] != "scaled_linear":
        raise ValueError(f"unknown schedule {cfg['beta_schedule']!r}")
    betas = np.linspace(b0 ** 0.5, b1 ** 0.5, T, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def time_embedding(t: torch.Tensor, dim: int, shift: float) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - shift)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _dense(P, name, x, prec, low=True):
    w = P[f"{name}.weight"]
    b = P.get(f"{name}.bias")
    if b is None:
        return prec.einsum("...i,oi->...o", x, w, low=low)
    return prec.linear(x, w, b, low=low)


def _norm_silu(P, name, x, cfg, chains):
    C = x.shape[-1]
    G = cfg["norm_num_groups"]
    if chains is not None:
        chains.append((*x.shape, G, False))
    return F.silu(group_norm(x, P[f"{name}.weight"], P[f"{name}.bias"], G,
                             cfg["norm_eps"]))


def _res_block(P, name, x, emb, cfg, prec, chains):
    h = _norm_silu(P, f"{name}.norm1", x, cfg, chains)
    h = prec.conv(h, P[f"{name}.conv1.weight"], P[f"{name}.conv1.bias"])
    e = _dense(P, f"{name}.time_emb_proj", F.silu(emb), prec, low=False)
    h = h + e[:, None, None, :]
    h = _norm_silu(P, f"{name}.norm2", h, cfg, chains)
    h = prec.conv(h, P[f"{name}.conv2.weight"], P[f"{name}.conv2.bias"])
    if f"{name}.conv_shortcut.weight" in P:
        x = prec.conv(x, P[f"{name}.conv_shortcut.weight"],
                      P[f"{name}.conv_shortcut.bias"], pad=(0, 0, 0, 0))
    return x + h


def _layer_norm(P, name, x):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"].float(),
                        P[f"{name}.bias"].float(), 1e-5)


def _attention(P, name, x, src, heads, prec, attn):
    B, S, C = x.shape
    D = C // heads
    q = _dense(P, f"{name}.to_q", x, prec).reshape(B, S, heads, D)
    k = _dense(P, f"{name}.to_k", src, prec).reshape(B, -1, heads, D)
    v = _dense(P, f"{name}.to_v", src, prec).reshape(B, -1, heads, D)
    if attn is not None:
        attn.append((B, S, k.shape[1], heads, D))
    step = max(1, (1 << 28) // (heads * S * k.shape[1]))
    out = []
    for b in range(0, B, step):
        s = prec.einsum("bqhd,bkhd->bhqk", q[b:b + step],
                        k[b:b + step]) / math.sqrt(D)
        out.append(prec.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                               v[b:b + step]))
    out = torch.cat(out).reshape(B, S, C)
    return _dense(P, f"{name}.to_out.0", out, prec)


def _transformer(P, name, x, ctx, heads, cfg, prec, attn):
    B, H, W, C = x.shape
    b = f"{name}.transformer_blocks.0"
    h = group_norm(x, P[f"{name}.norm.weight"], P[f"{name}.norm.bias"],
                   cfg["norm_num_groups"], 1e-6).reshape(B, H * W, C)
    h = _dense(P, f"{name}.proj_in", h, prec)
    n = _layer_norm(P, f"{b}.norm1", h)
    h = h + _attention(P, f"{b}.attn1", n, n, heads, prec, attn)
    n = _layer_norm(P, f"{b}.norm2", h)
    h = h + _attention(P, f"{b}.attn2", n, ctx.float(), heads, prec, attn)
    n = _layer_norm(P, f"{b}.norm3", h)
    value, gate = _dense(P, f"{b}.ff.net.0.proj", n, prec).chunk(2, dim=-1)
    h = h + _dense(P, f"{b}.ff.net.2", value * F.gelu(gate), prec)
    h = _dense(P, f"{name}.proj_out", h, prec)
    return x + h.reshape(B, H, W, C)


def forward(P: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            t: torch.Tensor, ctx: torch.Tensor, prec: Precision = None,
            attn: Optional[list] = None, chains: Optional[list] = None
            ) -> torch.Tensor:
    """``x (B, H, W, in)``, ``t (B,)``, ``ctx (B, L, cross_attention_dim)``
    -> ``eps (B, H, W, out)`` float32."""
    prec = prec or Precision()
    w0 = cfg["block_out_channels"][0]
    emb = _dense(P, "time_embedding.linear_1",
                 time_embedding(t, w0, cfg["freq_shift"]), prec, low=False)
    emb = _dense(P, "time_embedding.linear_2", F.silu(emb), prec, low=False)
    h = prec.conv(x.float(), P["conv_in.weight"], P["conv_in.bias"])
    skips = [h]
    down, mid, up = _plan(cfg)
    for item in down + mid + up:
        kind = item[0]
        if kind == "res":
            h = _res_block(P, item[1], h, emb, cfg, prec, chains)
        elif kind == "attn":
            h = _transformer(P, item[1], h, ctx, item[3], cfg, prec, attn)
        elif kind == "keep":
            skips.append(h)
        elif kind == "skip":
            h = torch.cat([h, skips.pop()], dim=-1)
        elif kind == "down":
            h = prec.conv(h, P[f"{item[1]}.conv.weight"],
                          P[f"{item[1]}.conv.bias"], stride=2)
        else:
            h = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                              mode="nearest").permute(0, 2, 3, 1)
            h = prec.conv(h, P[f"{item[1]}.conv.weight"],
                          P[f"{item[1]}.conv.bias"])
    assert not skips
    h = _norm_silu(P, "conv_norm_out", h, cfg, chains)
    return prec.conv(h, P["conv_out.weight"], P["conv_out.bias"], low=False)
