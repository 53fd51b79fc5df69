"""Seeded weights, made on the device in one draw.

Every parameter of a configuration's reference (``param_specs``) gets a
slice of one normal draw from a ``torch.Generator`` on the device, scaled
by its kind: fan-in scaled weights (std ``fan_in ** -0.5``, so activations
stay of order one through the depth), biases N(0, 0.02^2), norm scales
1 + N(0, 0.1^2), norm shifts N(0, 0.1^2), embeddings N(0, 1/dim). No
kernel is zero, unlike a training initialisation, so every layer moves the
output. The same seed gives the same bits on the same device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for ``tags`` under the run's ``seed`` (any size)."""
    digest = hashlib.sha256(":".join(map(str, (seed,) + tags)).encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


def make(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).normal_(generator=g)
    out, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        w = flat[off:off + n].view(shape)
        off += n
        if kind == "weight":
            w.mul_(math.prod(shape[1:]) ** -0.5)
        elif kind == "bias":
            w.mul_(0.02)
        elif kind == "norm_weight":
            w.mul_(0.1).add_(1.0)
        elif kind == "norm_bias":
            w.mul_(0.1)
        elif kind == "embedding":
            w.mul_(shape[1] ** -0.5)
        else:
            raise ValueError(f"unknown parameter kind {kind!r} of {name}")
        out[name] = w
    return out
