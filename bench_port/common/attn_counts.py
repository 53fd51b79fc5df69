"""Operations and bytes of kernel B1 (``csrc/flash_attn_fwd.cu``), counted
from the plain reference's attention products at the cell's shapes, and
the FLOPs and the GroupNorm -> SiLU chains (kernel B4's) of a forward pass
of a text-conditioned reference (whose forward takes a context where
``common/counts.py``'s take labels).

A B1 launch of ``(B, Sq, Skv, H, D)`` computes ``Q K^T`` and ``P V``:
``4 B H Sq Skv D`` FLOPs on the tensor cores, and reads q (``B Sq H D``),
k and v (``B Skv H D`` each) and writes out (``B Sq H D``) once, in the
compute dtype. Its least time is the larger of the FLOPs over the
configuration's peak and the bytes over the memory bandwidth: a
self-attention launch at 4,096 positions is bound by its FLOPs, a
cross-attention launch to 77 keys by its bytes.
"""

from __future__ import annotations

import torch

from bench_port.common.counts import _meta_params


def _inputs(cfg, batch: int):
    R = cfg["sample_size"]
    x = torch.empty((batch, R, R, cfg["in_channels"]), device="meta")
    t = torch.zeros((batch,), dtype=torch.long, device="meta")
    ctx = torch.empty((batch, cfg["context_len"], cfg["cross_attention_dim"]),
                      device="meta")
    return x, t, ctx


def forward_flops(ref, cfg, batch: int) -> float:
    """FLOPs of one reference forward pass at ``batch`` rows under a
    context (``FlopCounterMode`` on the meta device: convolutions and
    matrix products, 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    P = _meta_params(ref.param_specs(cfg))
    with FlopCounterMode(display=False) as fc:
        ref.forward(P, cfg, *_inputs(cfg, batch))
    return float(fc.get_total_flops())


def b1_launches(ref, cfg, batch: int) -> list:
    """``(B, Sq, Skv, H, D)`` of each attention product of one forward
    pass at ``batch`` rows, in call order."""
    attn = []
    ref.forward(_meta_params(ref.param_specs(cfg)), cfg, *_inputs(cfg, batch),
                attn=attn)
    return attn


def b4_chains(ref, cfg, batch: int) -> list:
    """``(B, H, W, C, G, film)`` of each GroupNorm -> SiLU chain of one
    forward pass at ``batch`` rows, as ``common/counts.py::b4_chains``."""
    chains = []
    ref.forward(_meta_params(ref.param_specs(cfg)), cfg, *_inputs(cfg, batch),
                chains=chains)
    return chains


def b1_bound_s(launches, elt_bytes: int, peak_flops: float,
               bytes_per_s: float) -> float:
    """Least seconds of the launches: per launch the larger of its FLOPs
    over ``peak_flops`` and its bytes over ``bytes_per_s``."""
    total = 0.0
    for B, Sq, Skv, H, D in launches:
        flops = 4.0 * B * H * Sq * Skv * D
        nbytes = elt_bytes * B * H * D * (2 * Sq + 2 * Skv)
        total += max(flops / peak_flops, nbytes / bytes_per_s)
    return total
