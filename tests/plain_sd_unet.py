"""A plain PyTorch Stable Diffusion UNet and its guided DDIM step, for the
CPU tests of ``superdiff_torch/models/sd_unet.py``. Imports neither JAX nor
anything of the port.

Written from the published description: the latent diffusion model of
arXiv:2112.10752 as diffusers' ``UNet2DConditionModel`` lays it out
(``stabilityai/stable-diffusion-2-1-base``, ``unet/config.json``; the
``scaled_linear`` schedule of ``scheduler/scheduler_config.json``), with
diffusers' parameter names. Everything is float32 (call inside
:func:`no_tf32`). Departures from the published model, all on purpose:

- latents and activations are NHWC (the port's layout), not NCHW; the
  weights keep PyTorch's layouts;
- ``cross_levels`` says which levels carry transformer blocks, where the
  published config names block types (``CrossAttnDownBlock2D`` on all
  levels but the last);
- DDIM runs on the leading grid ``arange(0, T, T // n)`` with no
  ``steps_offset``, and its last step goes to ``alpha_bar = 1``
  (diffusers: ``steps_offset`` 1, ``set_alpha_to_one`` false).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    b = torch.backends
    prev = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = prev


def _blocks(cfg):
    """The call order: ``("res", name, cin, cout)``, ``("attn", name, c,
    heads)``, ``("keep",)``, ``("skip",)``, ``("down" | "up", name, c)``."""
    ws, heads, n = cfg["widths"], cfg["heads"], cfg["layers_per_block"]
    out, skips, cin = [], [ws[0]], ws[0]
    for i, ch in enumerate(ws):
        for j in range(n):
            out.append(("res", f"down_blocks.{i}.resnets.{j}", cin, ch))
            if cfg["cross_levels"][i]:
                out.append(("attn", f"down_blocks.{i}.attentions.{j}", ch,
                            heads[i]))
            out.append(("keep",))
            cin = ch
            skips.append(ch)
        if i != len(ws) - 1:
            out += [("down", f"down_blocks.{i}.downsamplers.0", ch),
                    ("keep",)]
            skips.append(ch)
    out += [("res", "mid_block.resnets.0", cin, ws[-1]),
            ("attn", "mid_block.attentions.0", ws[-1], heads[-1]),
            ("res", "mid_block.resnets.1", ws[-1], ws[-1])]
    cin = ws[-1]
    for u, i in enumerate(reversed(range(len(ws)))):
        for j in range(n + 1):
            out += [("skip",), ("res", f"up_blocks.{u}.resnets.{j}",
                                cin + skips.pop(), ws[i])]
            if cfg["cross_levels"][i]:
                out.append(("attn", f"up_blocks.{u}.attentions.{j}", ws[i],
                            heads[i]))
            cin = ws[i]
        if i != 0:
            out.append(("up", f"up_blocks.{u}.upsamplers.0", ws[i]))
    return out


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape."""
    w0, ctx = cfg["widths"][0], cfg["context_dim"]
    shapes = {}

    def lin(name, i, o, bias=True):
        shapes[f"{name}.weight"] = (o, i)
        if bias:
            shapes[f"{name}.bias"] = (o,)

    def conv(name, i, o, k=3):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (o, i, k, k), (o,)

    def norm(name, c):
        shapes[f"{name}.weight"] = shapes[f"{name}.bias"] = (c,)

    conv("conv_in", cfg["in_channels"], w0)
    lin("time_embedding.linear_1", w0, 4 * w0)
    lin("time_embedding.linear_2", 4 * w0, 4 * w0)
    for item in _blocks(cfg):
        if item[0] == "res":
            _, name, i, o = item
            norm(f"{name}.norm1", i)
            conv(f"{name}.conv1", i, o)
            lin(f"{name}.time_emb_proj", 4 * w0, o)
            norm(f"{name}.norm2", o)
            conv(f"{name}.conv2", o, o)
            if i != o:
                conv(f"{name}.conv_shortcut", i, o, k=1)
        elif item[0] == "attn":
            _, name, c, _ = item
            b = f"{name}.transformer_blocks.0"
            norm(f"{name}.norm", c)
            lin(f"{name}.proj_in", c, c)
            lin(f"{name}.proj_out", c, c)
            for k, src in ((1, c), (2, ctx)):
                norm(f"{b}.norm{k}", c)
                lin(f"{b}.attn{k}.to_q", c, c, bias=False)
                lin(f"{b}.attn{k}.to_k", src, c, bias=False)
                lin(f"{b}.attn{k}.to_v", src, c, bias=False)
                lin(f"{b}.attn{k}.to_out.0", c, c)
            norm(f"{b}.norm3", c)
            lin(f"{b}.ff.net.0.proj", c, 8 * c)
            lin(f"{b}.ff.net.2", 4 * c, c)
        elif item[0] in ("down", "up"):
            conv(f"{item[1]}.conv", item[2], item[2])
    norm("conv_norm_out", w0)
    conv("conv_out", w0, cfg["out_channels"])
    return shapes


def _conv(P, name, x, stride=1):
    w = P[f"{name}.weight"]
    y = F.conv2d(x.permute(0, 3, 1, 2), w, P[f"{name}.bias"], stride=stride,
                 padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _lin(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def _gn(P, name, x, groups, eps):
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, P[f"{name}.weight"],
                     P[f"{name}.bias"], eps)
    return y.permute(0, 2, 3, 1)


def _ln(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], 1e-5)


def _attention(P, name, x, src, heads):
    B, S, C = x.shape
    q = _lin(P, f"{name}.to_q", x).view(B, S, heads, -1).transpose(1, 2)
    k = _lin(P, f"{name}.to_k", src).view(B, -1, heads,
                                            C // heads).transpose(1, 2)
    v = _lin(P, f"{name}.to_v", src).view(B, -1, heads,
                                            C // heads).transpose(1, 2)
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(C // heads), -1)
    out = (w @ v).transpose(1, 2).reshape(B, S, C)
    return _lin(P, f"{name}.to_out.0", out)


def forward(P: Dict[str, torch.Tensor], cfg, x, t, ctx) -> torch.Tensor:
    """``x (B, H, W, in)``, ``t (B,)``, ``ctx (B, L, context_dim)`` ->
    ``eps (B, H, W, out)``, float32."""
    G, eps = cfg["groups"], cfg["norm_eps"]
    half = cfg["widths"][0] // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device)
                      / half)
    a = t.float()[:, None] * freqs[None]
    temb = torch.cat([torch.cos(a), torch.sin(a)], -1)     # flip_sin_to_cos
    temb = _lin(P, "time_embedding.linear_2",
                F.silu(_lin(P, "time_embedding.linear_1", temb)))
    h = _conv(P, "conv_in", x)
    skips: List[torch.Tensor] = [h]
    for item in _blocks(cfg):
        kind = item[0]
        if kind == "res":
            n = item[1]
            r = _conv(P, f"{n}.conv1", F.silu(_gn(P, f"{n}.norm1", h, G, eps)))
            r = r + _lin(P, f"{n}.time_emb_proj", F.silu(temb))[:, None, None]
            r = _conv(P, f"{n}.conv2", F.silu(_gn(P, f"{n}.norm2", r, G, eps)))
            if f"{n}.conv_shortcut.weight" in P:
                h = _conv(P, f"{n}.conv_shortcut", h)
            h = h + r
        elif kind == "attn":
            _, n, C, heads = item
            b = f"{n}.transformer_blocks.0"
            B, H, W, _ = h.shape
            s = _lin(P, f"{n}.proj_in",
                     _gn(P, f"{n}.norm", h, G, 1e-6).reshape(B, H * W, C))
            u = _ln(P, f"{b}.norm1", s)
            s = s + _attention(P, f"{b}.attn1", u, u, heads)
            s = s + _attention(P, f"{b}.attn2", _ln(P, f"{b}.norm2", s), ctx,
                               heads)
            val, gate = _lin(P, f"{b}.ff.net.0.proj",
                             _ln(P, f"{b}.norm3", s)).chunk(2, -1)
            s = s + _lin(P, f"{b}.ff.net.2", val * F.gelu(gate))
            h = h + _lin(P, f"{n}.proj_out", s).reshape(B, H, W, C)
        elif kind == "keep":
            skips.append(h)
        elif kind == "skip":
            h = torch.cat([h, skips.pop()], -1)
        elif kind == "down":
            h = _conv(P, f"{item[1]}.conv", h, stride=2)
        else:
            h = h.repeat_interleave(2, 1).repeat_interleave(2, 2)
            h = _conv(P, f"{item[1]}.conv", h)
    assert not skips
    h = F.silu(_gn(P, "conv_norm_out", h, G, eps))
    return _conv(P, "conv_out", h)


def scaled_linear_alpha_bars(T: int, beta_start: float,
                             beta_end: float) -> np.ndarray:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T) ** 2
    return np.cumprod(1.0 - betas)


def ddim_grid(T: int, n: int) -> np.ndarray:
    return np.arange(0, T, T // n)[:n][::-1].copy()


def ddim_cfg_step(x, eps_cond, eps_null, scale: float, ab_t: float,
                  ab_next: float) -> torch.Tensor:
    """One DDIM step, eta 0, no clipping, on the guided prediction
    ``eps_null + scale * (eps_cond - eps_null)``."""
    e = eps_null + scale * (eps_cond - eps_null)
    x0 = (x - math.sqrt(1.0 - ab_t) * e) / math.sqrt(ab_t)
    return math.sqrt(ab_next) * x0 + math.sqrt(1.0 - ab_next) * e


def superdiff_step(x, logq, eps, z, beta: float, alpha: float, ab: float,
                   t: int, mode: str):
    """One SuperDiff step (arXiv:2412.17762) of two or more models: scores
    ``s_i = -eps_i / sqrt(1 - ab)``; OR mixes them by ``softmax(logq)``,
    AND (two models) by the ``kappa`` that makes the two log-densities
    equal after the step, clipped to [-2, 3]; the ancestral update with the
    mixed score and each model's Itô update ``<s_i, dx> - beta/2 (d +
    <s_i, x> + |s_i|^2)``. Returns ``(x', logq')``."""
    def dot(a, b):
        return (a * b).flatten(-3).sum(-1)

    s = torch.stack([-e for e in eps]) / math.sqrt(1.0 - ab)
    sra = 1.0 / math.sqrt(alpha)
    base = sra * x - x + math.sqrt(beta) * float(t > 0) * z
    if mode == "or":
        kappa = torch.softmax(logq, dim=0)
    else:
        ds = s[0] - s[1]
        const = (dot(ds, base + sra * beta * s[1]) - 0.5 * beta * (
            dot(ds, x) + dot(s[0], s[0]) - dot(s[1], s[1])))
        slope = dot(ds, sra * beta * ds)
        k = ((logq[1] - logq[0] - const) / slope).clamp(-2.0, 3.0)
        kappa = torch.stack([k, 1.0 - k])
    dx = base + sra * beta * (kappa[:, :, None, None, None] * s).sum(0)
    d = x[0].numel()
    dlogq = dot(s, dx[None]) - 0.5 * beta * (d + dot(s, x[None])
                                             + dot(s, s))
    return x + dx, logq + dlogq
