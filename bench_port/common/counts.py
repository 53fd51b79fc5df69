"""Operations and bytes of the work, counted from the plain reference at the
cell's shapes, so the count is the same whatever kernels the program runs.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the reference's
  forward (and, for training, its loss and backward) on the meta device:
  convolutions and matrix products, 2 per multiply-add; elementwise work is
  not counted.
- Kernel B4's bytes: each GroupNorm -> (FiLM) -> SiLU chain reads its input
  once and writes its output once, in the dtype the program's policy gives
  the chain, and reads gamma and beta (float32, per channel) and FiLM's
  scale and shift (float32, per sample and channel) once. Its operations,
  12 per element (statistics 3, normalise 2, affine 2, FiLM 2, SiLU 3), are
  counted against the float32 peak outside the tensor cores; at 4 or 8
  bytes an element the bytes bound every chain.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

_PEAKS = Path(__file__).resolve().parent / "peaks.json"
B4_FLOPS_PER_ELEMENT = 12


def peaks(device_name: str) -> dict:
    """The published peaks of the card named ``device_name`` (the first
    entry whose key is part of the name)."""
    table = json.loads(_PEAKS.read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no published peaks for {device_name!r} in {_PEAKS}")


def _meta_params(specs):
    return {n: torch.empty(shape, device="meta") for n, shape, _ in specs}


def forward_flops(ref, cfg, batch: int) -> float:
    """FLOPs of one reference forward pass at ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode

    P = _meta_params(ref.param_specs(cfg))
    x, t, y = _inputs(cfg, batch)
    with FlopCounterMode(display=False) as fc:
        ref.forward(P, cfg, x, t, y)
    return float(fc.get_total_flops())


def train_flops(ref, cfg, batch: int) -> float:
    """FLOPs of one training step's loss and backward at ``batch`` (the
    parameters' gradients; none for the input)."""
    from torch.utils.flop_counter import FlopCounterMode

    P = {k: v.requires_grad_(True)
         for k, v in _meta_params(ref.param_specs(cfg)).items()}
    x, t, y = _inputs(cfg, batch)
    with FlopCounterMode(display=False) as fc:
        out = ref.forward(P, cfg, x, t, y)
        loss = (out * out).mean()
        torch.autograd.grad(loss, list(P.values()))
    return float(fc.get_total_flops())


def _inputs(cfg, batch):
    R = cfg["resolution"]
    x = torch.empty((batch, R, R, cfg["in_channels"]), device="meta")
    t = torch.zeros((batch,), dtype=torch.long, device="meta")
    y = (torch.zeros((batch,), dtype=torch.long, device="meta")
         if cfg.get("num_classes", 0) else None)
    return x, t, y


def b4_chains(ref, cfg, batch: int) -> list:
    """``(B, H, W, C, G, film)`` of each chain of one forward pass."""
    chains = []
    P = _meta_params(ref.param_specs(cfg))
    x, t, y = _inputs(cfg, batch)
    ref.forward(P, cfg, x, t, y, chains=chains)
    return chains


def b4_bound_s(chains, elt_bytes: int, pk: dict) -> float:
    """Least seconds of the chains on the card: per chain the larger of its
    bytes over the memory bandwidth and its operations over the float32
    peak."""
    total = 0.0
    for B, H, W, C, G, film in chains:
        n = B * H * W * C
        nbytes = 2 * n * elt_bytes + 2 * C * 4 + (2 * B * C * 4 if film
                                                  else 0)
        total += max(nbytes / pk["hbm_bytes_per_s"],
                     B4_FLOPS_PER_ELEMENT * n / pk["float32"])
    return total
