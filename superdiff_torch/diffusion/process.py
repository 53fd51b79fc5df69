"""Forward diffusion process and head-parameterization conversions.

Port of ``superdiff_tpu/diffusion/process.py``. The model is a function
``(x_t, t, *cond) -> prediction``; images are NHWC. Where the JAX functions
take a PRNG key, these take a ``torch.Generator`` and, for parity tests,
optional injected draws (``t=``, ``noise=``).
"""

from __future__ import annotations

from typing import Callable, Optional

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


def loss_weights(schedule: DiffusionSchedule,
                 t: torch.Tensor,
                 weighting: str = "none",
                 min_snr_gamma: float = 5.0,
                 parameterization: str = "eps") -> torch.Tensor:
    """Per-timestep loss weights ``(B,)`` float32.

    ``min_snr`` (arXiv:2303.09556 eq. 9): the truncated SNR
    ``min(SNR_t, gamma)`` in x0-units, converted to the head's own MSE space
    (``SNR_t = ab_t / (1 - ab_t)``): eps head ``min(SNR, gamma) / SNR``, v
    head ``min(SNR, gamma) / (SNR + 1)``, x0 head ``min(SNR, gamma)``."""
    if weighting == "none":
        return torch.ones(t.shape, dtype=torch.float32, device=t.device)
    if weighting == "min_snr":
        ab = schedule.alpha_bars[t].float()
        snr = ab / (1.0 - ab)
        trunc = torch.clamp(snr, max=min_snr_gamma)
        if parameterization == "eps":
            return trunc / snr
        if parameterization == "v":
            return trunc / (snr + 1.0)
        if parameterization == "x0":
            return trunc
        raise ValueError(f"unknown parameterization: {parameterization!r}")
    raise ValueError(f"unknown loss weighting: {weighting!r}")


def p_losses(schedule: DiffusionSchedule,
             model_fn: ModelFn,
             x_start: torch.Tensor,
             t: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             y: Optional[torch.Tensor] = None,
             loss_type: str = "mse",
             weighting: str = "none",
             min_snr_gamma: float = 5.0,
             parameterization: str = "eps",
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Denoising loss at given timesteps (scalar, float32); the regression
    target follows the head's ``parameterization`` (:func:`pred_target`).
    ``noise`` is drawn from ``generator`` unless injected."""
    if noise is None:
        noise = torch.randn(x_start.shape, generator=generator,
                            dtype=x_start.dtype, device=x_start.device)
    x_noisy = q_sample(schedule, x_start, t, noise)
    args = (x_noisy, t) if y is None else (x_noisy, t, y)
    pred = model_fn(*args)
    target = pred_target(schedule, x_start, t, noise, parameterization)
    # Loss reduced in float32 even under bf16 compute.
    diff = pred.float() - target.float()
    if loss_type == "mse":
        per_px = diff ** 2
    elif loss_type == "huber":
        per_px = torch.where(diff.abs() < 1.0, 0.5 * diff ** 2,
                             diff.abs() - 0.5)
    else:
        raise ValueError(f"unknown loss_type: {loss_type!r}")
    if weighting == "none":
        return per_px.mean()
    w = loss_weights(schedule, t, weighting, min_snr_gamma, parameterization)
    per_sample = per_px.reshape(per_px.shape[0], -1).mean(dim=1)
    return (w * per_sample).mean()


def training_step(schedule: DiffusionSchedule,
                  model_fn: ModelFn,
                  x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  y: Optional[torch.Tensor] = None,
                  loss_type: str = "mse",
                  weighting: str = "none",
                  min_snr_gamma: float = 5.0,
                  parameterization: str = "eps",
                  t: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One loss evaluation: ``t ~ U[0, T)`` per example, then the noise, both
    from ``generator`` in that order unless injected."""
    if t is None:
        t = torch.randint(0, schedule.num_timesteps, (x.shape[0],),
                          generator=generator, device=x.device)
    return p_losses(schedule, model_fn, x, t, generator, y=y,
                    loss_type=loss_type, weighting=weighting,
                    min_snr_gamma=min_snr_gamma,
                    parameterization=parameterization, noise=noise)
