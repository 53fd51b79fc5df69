"""GroupNorm + optional FiLM + SiLU as a plain PyTorch chain.

Port of ``superdiff_tpu/ops/packed_norm.py``. The reference folds
``f = 128 / C`` neighbouring W positions into the channels before the chain
so that a C < 128 tensor fills the TPU's 128-lane tiles, and unfolds after.
The fold permutes elements within each (sample, group) reduction set, so it
does not change the function; it is a TPU layout device. The port accepts
``pack`` for the same signature and computes the identical function
unfolded. The reference function reaches no Pallas kernel, and neither does
this one: it is :func:`~superdiff_torch.ops.fused_norm.gn_silu_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from superdiff_torch.ops.fused_norm import gn_silu_plain


def groupnorm_film_silu(x: torch.Tensor,
                        gamma: torch.Tensor,
                        beta: torch.Tensor,
                        num_groups: int,
                        eps: float = 1e-5,
                        film_scale: Optional[torch.Tensor] = None,
                        film_shift: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        pack: Optional[bool] = None) -> torch.Tensor:
    """GroupNorm + optional FiLM + SiLU on NHWC ``x``: Flax's
    ``nn.GroupNorm(num_groups, epsilon=eps, dtype=out_dtype)``, then
    ``h * (1 + film_scale) + film_shift`` per sample, then ``silu``.
    ``pack`` (the reference's W-fold) does not change the result and is
    ignored."""
    del pack
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by groups {num_groups}")
    return gn_silu_plain(x, gamma, beta, num_groups, film_scale, film_shift,
                         eps, out_dtype=out_dtype or x.dtype)
