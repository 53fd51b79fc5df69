"""Self-attention op: the hand-written flash kernel, or plain math.

Port of ``superdiff_tpu/ops/attention.py``. One public signature,

    out = multihead_attention(q, k, v)   # (B, S, H, D) each

Dispatch: every call whose head dim and dtype the CUDA kernel takes goes to
:func:`superdiff_torch.ops.flash_attention.flash_attention` (which runs the
kernel on a CUDA tensor and its plain version on a CPU tensor); anything
else runs :func:`_math_attention`. The JAX package's ``S >= 1024``
threshold was a TPU v5e measurement and is not carried over: on the card
the kernel also takes the 16² (S=256) and 8² (S=64) levels.

Numerics: scores accumulate in float32 regardless of input dtype.
"""

from __future__ import annotations

import math

import torch

from superdiff_torch.ops.flash_attention import flash_attention, kernel_supports


def _math_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention (the counterpart of ``_xla_attention``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def multihead_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention, ``(B, S, H, D)`` layout, no masking (images)."""
    if kernel_supports(q):
        return flash_attention(q, k, v)
    return _math_attention(q, k, v)
