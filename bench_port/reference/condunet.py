"""The CondUNet written down plainly, as functions of a dict of float32
parameters, in float32 (a frozen copy of the graph of
``superdiff_torch/models/unet.py`` and ``models/layers.py``; imports
nothing of the program).

Images are NHWC. Parameter names and shapes are the program's state-dict
names, so one dict of seeded weights feeds both sides. The forward pass:
sinusoidal time embedding -> Dense -> SiLU -> Dense, plus a class
embedding; space-to-depth by ``pixel_shuffle`` (channel index
``(ph*p + pw)*C + c``); a 3x3 stem; per level FiLM ResBlocks
(GroupNorm -> SiLU -> conv, GroupNorm -> ``h*(1+scale)+shift`` -> SiLU ->
conv, a 1x1 skip where the width changes) with self-attention at the sides
in ``attn_resolutions``, a stride-2 3x3 conv with padding (0, 1) between
levels; middle ResBlock -> attention -> ResBlock; the mirrored up path with
skip concatenation, attention at ``up_attn_resolutions``, nearest 2x
upsampling + conv; GroupNorm -> SiLU -> a 3x3 head in float32;
depth-to-space. GroupNorm: float32 statistics, eps 1e-5, the largest group
count <= 32 dividing the width.

``chains`` (a list, optional) collects ``(B, H, W, C, G, film)`` of every
GroupNorm -> (FiLM) -> SiLU chain in call order: the chains kernel B4 runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.precision import Precision


def groups_for(channels: int, max_groups: int = 32) -> int:
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def _plan(cfg) -> Tuple[list, list, int]:
    """``(down, up, width at the head)``: the blocks in call order, each
    ``("res", name, cin, cout, attn_name or None)``, ``("down", name, c)``
    or ``("up", name, c)``."""
    base, mults = cfg["base_channels"], cfg["channel_mults"]
    nrb = cfg["num_res_blocks"]
    blocks = [nrb] * len(mults) if isinstance(nrb, int) else list(nrb)
    attn_res, up_attn = cfg["attn_resolutions"], cfg["up_attn_resolutions"]
    res = cfg["resolution"] // cfg["pixel_shuffle"]
    down, up = [], []
    skip_ch, cin = [base], base
    for level, mult in enumerate(mults):
        ch = base * mult
        for b in range(blocks[level]):
            attn = f"down_{level}_attn_{b}" if res in attn_res else None
            down.append(("res", f"down_{level}_block_{b}", cin, ch, attn))
            cin = ch
            skip_ch.append(ch)
        if level != len(mults) - 1:
            down.append(("down", f"down_{level}_downsample", ch))
            res //= 2
            skip_ch.append(ch)
    mid = base * mults[-1]
    down.append(("res", "mid_block_0", cin, mid, "mid_attn"))
    down.append(("res", "mid_block_1", mid, mid, None))
    cin = mid
    for level, mult in reversed(list(enumerate(mults))):
        ch = base * mult
        for b in range(blocks[level] + 1):
            attn = f"up_{level}_attn_{b}" if res in up_attn else None
            up.append(("res", f"up_{level}_block_{b}", cin + skip_ch.pop(),
                       ch, attn))
            cin = ch
        if level != 0:
            up.append(("up", f"up_{level}_upsample", ch))
            res *= 2
    return down, up, cin


def param_specs(cfg) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter, in a fixed order. Kinds:
    ``weight`` (fan-in scaled), ``bias``, ``norm_weight``, ``norm_bias``,
    ``embedding``."""
    p, E = cfg["pixel_shuffle"], cfg["time_emb_dim"]
    emb = 4 * E
    specs = []

    def dense(name, cin, cout):
        specs.extend([(f"{name}.weight", (cout, cin), "weight"),
                      (f"{name}.bias", (cout,), "bias")])

    def conv(name, cin, cout, k=3):
        specs.extend([(f"{name}.weight", (cout, cin, k, k), "weight"),
                      (f"{name}.bias", (cout,), "bias")])

    def norm(name, c):
        specs.extend([(f"{name}.weight", (c,), "norm_weight"),
                      (f"{name}.bias", (c,), "norm_bias")])

    dense("time_mlp.dense_0", E, 4 * E)
    dense("time_mlp.dense_1", 4 * E, emb)
    if cfg["num_classes"] > 0:
        specs.append(("class_emb.weight", (cfg["num_classes"] + 1, emb),
                      "embedding"))
    conv("stem", cfg["in_channels"] * p * p, cfg["base_channels"])
    down, up, head = _plan(cfg)
    for item in down + up:
        if item[0] == "res":
            _, name, cin, cout, attn = item
            norm(f"{name}.norm_0", cin)
            conv(f"{name}.conv_0", cin, cout)
            dense(f"{name}.emb_proj", emb, 2 * cout)
            norm(f"{name}.norm_1", cout)
            conv(f"{name}.conv_1", cout, cout)
            if cin != cout:
                conv(f"{name}.skip_proj", cin, cout, k=1)
            if attn:
                norm(f"{attn}.norm", cout)
                dense(f"{attn}.qkv", cout, 3 * cout)
                dense(f"{attn}.proj", cout, cout)
        else:
            conv(f"{item[1]}.conv", item[2], item[2])
    norm("out_norm", head)
    conv("out_conv", head, cfg["out_channels"] * p * p)
    return specs


def time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def group_norm(x, w, b, groups: int, eps: float = 1e-5) -> torch.Tensor:
    B, C = x.shape[0], x.shape[-1]
    xg = x.float().reshape(B, -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = (xg - mean) * torch.rsqrt(var + eps)
    return (y.reshape(x.shape) * w.float() + b.float())


def norm_silu(P, name, x, chains, scale=None, shift=None):
    """GroupNorm -> (FiLM) -> SiLU, the chain kernel B4 computes."""
    C = x.shape[-1]
    G = groups_for(C)
    if chains is not None:
        chains.append((*x.shape, G, scale is not None))
    h = group_norm(x, P[f"{name}.weight"], P[f"{name}.bias"], G)
    if scale is not None:
        h = h * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
    return F.silu(h)


def space_to_depth(x, p):
    B, H, W, C = x.shape
    x = x.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // p, W // p, p * p * C)


def depth_to_space(x, p):
    B, H, W, PC = x.shape
    C = PC // (p * p)
    x = x.reshape(B, H, W, p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H * p, W * p, C)


def _res_block(P, name, x, emb, prec, chains):
    h = norm_silu(P, f"{name}.norm_0", x, chains)
    h = prec.conv(h, P[f"{name}.conv_0.weight"], P[f"{name}.conv_0.bias"])
    cond = prec.linear(F.silu(emb), P[f"{name}.emb_proj.weight"],
                       P[f"{name}.emb_proj.bias"], low=False)
    scale, shift = cond.chunk(2, dim=-1)
    h = norm_silu(P, f"{name}.norm_1", h, chains, scale, shift)
    h = prec.conv(h, P[f"{name}.conv_1.weight"], P[f"{name}.conv_1.bias"])
    if f"{name}.skip_proj.weight" in P:
        x = prec.conv(x, P[f"{name}.skip_proj.weight"],
                      P[f"{name}.skip_proj.bias"], pad=(0, 0, 0, 0))
    return x + h


def _attention(P, name, x, heads, prec):
    B, H, W, C = x.shape
    h = group_norm(x, P[f"{name}.norm.weight"], P[f"{name}.norm.bias"],
                   groups_for(C)).reshape(B, H * W, C)
    qkv = prec.linear(h, P[f"{name}.qkv.weight"], P[f"{name}.qkv.bias"])
    q, k, v = (a.reshape(B, H * W, heads, C // heads)
               for a in qkv.split(C, dim=-1))
    scores = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(C // heads)
    out = prec.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    out = prec.linear(out.reshape(B, H * W, C), P[f"{name}.proj.weight"],
                      P[f"{name}.proj.bias"])
    return x + out.reshape(B, H, W, C)


def forward(P: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            t: torch.Tensor, y: Optional[torch.Tensor] = None,
            prec: Precision = None, chains: Optional[list] = None
            ) -> torch.Tensor:
    """``x (B, H, W, in)``, ``t (B,)``, ``y (B,)`` (the null label is
    ``num_classes``) -> ``(B, H, W, out)`` float32."""
    prec = prec or Precision()
    p, heads = cfg["pixel_shuffle"], cfg["num_heads"]
    emb = prec.linear(time_embedding(t, cfg["time_emb_dim"]),
                      P["time_mlp.dense_0.weight"], P["time_mlp.dense_0.bias"],
                      low=False)
    emb = prec.linear(F.silu(emb), P["time_mlp.dense_1.weight"],
                      P["time_mlp.dense_1.bias"], low=False)
    if cfg["num_classes"] > 0:
        emb = emb + P["class_emb.weight"].float()[y]
    h = x.float()
    if p > 1:
        h = space_to_depth(h, p)
    h = prec.conv(h, P["stem.weight"], P["stem.bias"])
    down, up, _ = _plan(cfg)
    skips = [h]
    for item in down:
        if item[0] == "res":
            h = _res_block(P, item[1], h, emb, prec, chains)
            if item[4]:
                h = _attention(P, item[4], h, heads, prec)
            if not item[1].startswith("mid"):
                skips.append(h)
        else:
            h = prec.conv(h, P[f"{item[1]}.conv.weight"],
                          P[f"{item[1]}.conv.bias"], stride=2,
                          pad=(0, 1, 0, 1))
            skips.append(h)
    for item in up:
        if item[0] == "res":
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _res_block(P, item[1], h, emb, prec, chains)
            if item[4]:
                h = _attention(P, item[4], h, heads, prec)
        else:
            h = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                              mode="nearest").permute(0, 2, 3, 1)
            h = prec.conv(h, P[f"{item[1]}.conv.weight"],
                          P[f"{item[1]}.conv.bias"])
    assert not skips
    h = norm_silu(P, "out_norm", h, chains)
    h = prec.conv(h, P["out_conv.weight"], P["out_conv.bias"], low=False)
    return depth_to_space(h, p) if p > 1 else h
