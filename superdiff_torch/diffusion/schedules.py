"""Diffusion noise schedules as device tensors.

Port of ``superdiff_tpu/diffusion/schedules.py``: linear betas via
``linspace(beta_start, beta_end, T)`` (or Stable Diffusion's
``scaled_linear``, ``linspace(sqrt(beta_start), sqrt(beta_end), T)**2``),
``alphas = 1 - betas``,
``alpha_bars = cumprod(alphas)``. Every derived quantity is computed once in
float64 on the host and stored as a float32 tensor on the target device, so
the samplers index it without host round-trips.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule tensors, each of shape ``(T,)`` (float32)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bars: torch.Tensor            # cumulative product of alphas
    alpha_bars_prev: torch.Tensor       # alpha_bar[t-1], alpha_bar[-1] := 1
    sqrt_alpha_bars: torch.Tensor
    sqrt_one_minus_alpha_bars: torch.Tensor
    sqrt_recip_alphas: torch.Tensor     # 1/sqrt(alpha_t)
    posterior_variance: torch.Tensor    # beta_t * (1-ab_{t-1}) / (1-ab_t)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @property
    def device(self) -> torch.device:
        return self.betas.device


def linear_betas(num_timesteps: int = 1000,
                 beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> np.ndarray:
    """Linear beta schedule (float64, host)."""
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def scaled_linear_betas(num_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """Stable Diffusion's ``scaled_linear`` schedule: linear in
    ``sqrt(beta)``, squared (float64, host)."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                       dtype=np.float64) ** 2


def cosine_betas(num_timesteps: int = 1000, s: float = 0.008,
                 max_beta: float = 0.999) -> np.ndarray:
    """Cosine schedule from Improved DDPM (Nichol & Dhariwal 2021, eq. 17)."""
    steps = np.arange(num_timesteps + 1, dtype=np.float64)
    f = np.cos((steps / num_timesteps + s) / (1 + s) * np.pi / 2) ** 2
    alpha_bars = f / f[0]
    betas = 1.0 - alpha_bars[1:] / alpha_bars[:-1]
    return np.clip(betas, 0.0, max_beta)


_SCHEDULES = {
    "linear": linear_betas,
    "scaled_linear": scaled_linear_betas,
    "cosine": cosine_betas,
}


def make_schedule(num_timesteps: int = 1000,
                  kind: str = "linear",
                  beta_start: float = 1e-4,
                  beta_end: float = 0.02,
                  device="cuda") -> DiffusionSchedule:
    """Build the full precomputed :class:`DiffusionSchedule` on ``device``.

    Derived quantities are computed in float64 on the host, then cast to
    float32 (a float32 cumprod over 1000 terms loses a few ulps).
    """
    if kind in ("linear", "scaled_linear"):
        betas = _SCHEDULES[kind](num_timesteps, beta_start, beta_end)
    elif kind == "cosine":
        betas = cosine_betas(num_timesteps)
    else:
        raise ValueError(f"unknown schedule kind: {kind!r} "
                         f"(have {sorted(_SCHEDULES)})")

    alphas = 1.0 - betas
    alpha_bars = np.cumprod(alphas)
    alpha_bars_prev = np.concatenate([[1.0], alpha_bars[:-1]])
    posterior_variance = betas * (1.0 - alpha_bars_prev) / (1.0 - alpha_bars)

    def as_f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return DiffusionSchedule(
        betas=as_f32(betas),
        alphas=as_f32(alphas),
        alpha_bars=as_f32(alpha_bars),
        alpha_bars_prev=as_f32(alpha_bars_prev),
        sqrt_alpha_bars=as_f32(np.sqrt(alpha_bars)),
        sqrt_one_minus_alpha_bars=as_f32(np.sqrt(1.0 - alpha_bars)),
        sqrt_recip_alphas=as_f32(np.sqrt(1.0 / alphas)),
        posterior_variance=as_f32(posterior_variance),
    )
