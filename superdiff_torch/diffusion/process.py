"""Forward diffusion process and head-parameterization conversions.

Port of ``superdiff_tpu/diffusion/process.py`` (the sampling half; the
training losses come with the training slice). The model is a function
``(x_t, t, *cond) -> prediction``; images are NHWC.
"""

from __future__ import annotations

from typing import Callable

import torch

from superdiff_torch.diffusion.schedules import DiffusionSchedule

# Model apply signature used throughout the framework:
#   eps_hat = model_fn(x_t, t)               (unconditional)
#   eps_hat = model_fn(x_t, t, y)            (class-conditional)
ModelFn = Callable[..., torch.Tensor]

PARAMETERIZATIONS = ("eps", "v", "x0")


def _bcast_to(coeff: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-batch coefficient ``(B,)`` over image dims of ``x``."""
    return coeff.reshape(coeff.shape + (1,) * (x.ndim - 1))


def q_sample(schedule: DiffusionSchedule,
             x_start: torch.Tensor,
             t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Diffuse ``x_start`` to timestep ``t``: ``sqrt(ab) x0 + sqrt(1-ab) eps``."""
    sqrt_ab = _bcast_to(schedule.sqrt_alpha_bars[t], x_start)
    sqrt_1mab = _bcast_to(schedule.sqrt_one_minus_alpha_bars[t], x_start)
    return sqrt_ab * x_start + sqrt_1mab * noise


def predict_x0_from_eps(schedule: DiffusionSchedule,
                        x_t: torch.Tensor,
                        t: torch.Tensor,
                        eps: torch.Tensor) -> torch.Tensor:
    """Invert ``q_sample``: ``x0 = (x_t - sqrt(1-ab) eps) / sqrt(ab)``."""
    sqrt_ab = _bcast_to(schedule.sqrt_alpha_bars[t], x_t)
    sqrt_1mab = _bcast_to(schedule.sqrt_one_minus_alpha_bars[t], x_t)
    return (x_t - sqrt_1mab * eps) / sqrt_ab


# With alpha = sqrt(ab_t), sigma = sqrt(1-ab_t), x_t = alpha x0 + sigma eps
# and v = alpha eps - sigma x0 (arXiv:2202.00512 §2.4):
#   eps = sigma x_t + alpha v          x0 = alpha x_t - sigma v

def pred_target(schedule: DiffusionSchedule,
                x_start: torch.Tensor,
                t: torch.Tensor,
                noise: torch.Tensor,
                parameterization: str = "eps") -> torch.Tensor:
    """The regression target for a head of the given parameterization."""
    if parameterization == "eps":
        return noise
    if parameterization == "x0":
        return x_start
    if parameterization == "v":
        a = _bcast_to(schedule.sqrt_alpha_bars[t], x_start)
        s = _bcast_to(schedule.sqrt_one_minus_alpha_bars[t], x_start)
        return a * noise - s * x_start
    raise ValueError(f"unknown parameterization: {parameterization!r}")


def eps_from_pred(schedule: DiffusionSchedule,
                  x_t: torch.Tensor,
                  t: torch.Tensor,
                  pred: torch.Tensor,
                  parameterization: str = "eps") -> torch.Tensor:
    """Convert a head prediction to the eps the samplers consume."""
    if parameterization == "eps":
        return pred
    a = _bcast_to(schedule.sqrt_alpha_bars[t], x_t)
    s = _bcast_to(schedule.sqrt_one_minus_alpha_bars[t], x_t)
    if parameterization == "v":
        return s * x_t + a * pred
    if parameterization == "x0":
        return (x_t - a * pred) / s
    raise ValueError(f"unknown parameterization: {parameterization!r}")


def x0_from_pred(schedule: DiffusionSchedule,
                 x_t: torch.Tensor,
                 t: torch.Tensor,
                 pred: torch.Tensor,
                 parameterization: str = "eps") -> torch.Tensor:
    """Convert a head prediction to the clean-image estimate."""
    if parameterization == "x0":
        return pred
    a = _bcast_to(schedule.sqrt_alpha_bars[t], x_t)
    s = _bcast_to(schedule.sqrt_one_minus_alpha_bars[t], x_t)
    if parameterization == "v":
        return a * x_t - s * pred
    if parameterization == "eps":
        return (x_t - s * pred) / a
    raise ValueError(f"unknown parameterization: {parameterization!r}")
