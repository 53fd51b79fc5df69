"""The reference repository's RefUNet (mo-rsa24/super-diff-disease
``src/models/unet.py``) written down plainly, in float32, as functions of a
dict of parameters (a frozen copy of the graph of
``superdiff_torch/models/unet_ref.py``; imports nothing of the program).

Five blocks ``[GroupNorm(min(4, ch)) -> SiLU -> Conv3x3] x 2`` at full
resolution, widths in -> base -> 2 base -> 2 base -> base -> out, each
followed by ``+ Dense(t_emb)``; no skips, no attention, no classes. The
time embedding is sinusoidal -> Dense(4 dim) -> SiLU -> Dense(dim). Every
product runs in float32 (the model's own choice), so a control lowers all
of them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.condunet import group_norm, time_embedding
from bench_port.reference.precision import Precision

_BLOCKS = ("down_0", "down_1", "mid", "up_0", "up_1")


def _widths(cfg):
    bc = cfg["base_channels"]
    chans = [cfg["in_channels"], bc, 2 * bc, 2 * bc, bc, cfg["out_channels"]]
    return list(zip(_BLOCKS, chans[:-1], chans[1:]))


def param_specs(cfg) -> List[Tuple[str, tuple, str]]:
    E = cfg["time_emb_dim"]
    specs = [("time_mlp.dense_0.weight", (4 * E, E), "weight"),
             ("time_mlp.dense_0.bias", (4 * E,), "bias"),
             ("time_mlp.dense_1.weight", (E, 4 * E), "weight"),
             ("time_mlp.dense_1.bias", (E,), "bias")]
    for name, cin, cout in _widths(cfg):
        for i, (a, b) in enumerate(((cin, cout), (cout, cout))):
            specs += [(f"{name}.norm_{i}.weight", (a,), "norm_weight"),
                      (f"{name}.norm_{i}.bias", (a,), "norm_bias"),
                      (f"{name}.conv_{i}.weight", (b, a, 3, 3), "weight"),
                      (f"{name}.conv_{i}.bias", (b,), "bias")]
        specs += [(f"{name}.time_emb.weight", (cout, E), "weight"),
                  (f"{name}.time_emb.bias", (cout,), "bias")]
    return specs


def forward(P: Dict[str, torch.Tensor], cfg, x: torch.Tensor,
            t: torch.Tensor, y: Optional[torch.Tensor] = None,
            prec: Precision = None, chains: Optional[list] = None
            ) -> torch.Tensor:
    prec = prec or Precision()
    emb = prec.linear(time_embedding(t, cfg["time_emb_dim"]),
                      P["time_mlp.dense_0.weight"], P["time_mlp.dense_0.bias"])
    emb = prec.linear(F.silu(emb), P["time_mlp.dense_1.weight"],
                      P["time_mlp.dense_1.bias"])
    h = x.float()
    for name, _, _ in _widths(cfg):
        for i in range(2):
            C = h.shape[-1]
            G = min(4, C)
            if chains is not None:
                chains.append((*h.shape, G, False))
            h = F.silu(group_norm(h, P[f"{name}.norm_{i}.weight"],
                                  P[f"{name}.norm_{i}.bias"], G))
            h = prec.conv(h, P[f"{name}.conv_{i}.weight"],
                          P[f"{name}.conv_{i}.bias"])
        h = h + prec.linear(emb, P[f"{name}.time_emb.weight"],
                            P[f"{name}.time_emb.bias"])[:, None, None, :]
    return h
