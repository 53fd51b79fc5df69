"""The samplers' updates written down plainly (DDPM ancestral, DDIM,
SuperDiff with the Itô density estimator), and the linear schedule, worked
out from the configuration's numbers; imports nothing of the program.

Schedule: ``betas = linspace(beta_start, beta_end, T)`` in float64,
``alpha_bar = cumprod(1 - betas)``, every table rounded once to float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Schedule:
    def __init__(self, cfg, device):
        T = cfg["num_timesteps"]
        betas = np.linspace(cfg["beta_start"], cfg["beta_end"], T,
                            dtype=np.float64)
        alphas = 1.0 - betas
        ab = np.cumprod(alphas)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        self.T = T
        self.ab_host = ab
        self.betas, self.alphas, self.alpha_bars = f32(betas), f32(alphas), \
            f32(ab)
        self.sqrt_1mab = f32(np.sqrt(1.0 - ab))
        self.sqrt_ab = f32(np.sqrt(ab))
        self.sqrt_recip_alphas = f32(np.sqrt(1.0 / alphas))


def _b(v, x):
    return v.reshape(-1, *([1] * (x.ndim - 1)))


def ddpm_update(s: Schedule, x, t: int, eps, z):
    """``x_{t-1} = (x - (1-a_t)/sqrt(1-ab_t) eps) / sqrt(a_t) + sqrt(b_t) z``,
    no noise at ``t = 0``."""
    coef = (1.0 - s.alphas[t]) / s.sqrt_1mab[t]
    mean = s.sqrt_recip_alphas[t] * (x - coef * eps)
    return mean + torch.sqrt(s.betas[t]) * float(t > 0) * z


def ddim_grid(T: int, steps: int) -> np.ndarray:
    """Leading spacing: ``arange(0, T, T // steps)[:steps]``, descending."""
    if steps >= T:
        return np.arange(T - 1, -1, -1)
    return np.arange(0, T, T // steps)[:steps][::-1].copy()


def ddim_update(s: Schedule, x, ab_t, ab_next, eps, clip=True):
    """DDIM with eta 0 (arXiv:2010.02502 eq. 12); ``x0`` clipped to
    [-1, 1] and eps recomputed from it when ``clip``."""
    x0 = (x - math.sqrt(1.0 - ab_t) * eps) / math.sqrt(ab_t)
    if clip:
        x0 = x0.clamp(-1.0, 1.0)
        eps = (x - math.sqrt(ab_t) * x0) / math.sqrt(1.0 - ab_t)
    return math.sqrt(ab_next) * x0 + math.sqrt(max(1.0 - ab_next, 0.0)) * eps


def _dot(a, b):
    return (a * b).flatten(start_dim=-3).sum(dim=-1)


def logq_start(x):
    """The standard normal's log-density at ``x`` per row."""
    d = x[0].numel()
    return -0.5 * _dot(x, x) - 0.5 * d * math.log(2.0 * math.pi)


def superdiff_or_update(s: Schedule, x, logq, t: int, eps_list, z,
                        temperature=1.0, kappa=None):
    """One SuperDiff OR step (arXiv:2412.17762): scores
    ``s_i = -eps_i / sqrt(1-ab_t)``, weights ``kappa = softmax(T logq)``
    over the models (given, to plant a fault in them), the ancestral
    update with the mixed score, and each model's Itô update
    ``dL_i = <s_i, dx> - b_t/2 (d + <s_i, x> + |s_i|^2)``.
    Returns ``(x', logq')``; ``logq`` is ``(M, B)``."""
    scores = torch.stack([-e for e in eps_list]) / s.sqrt_1mab[t]
    beta, sra = s.betas[t], s.sqrt_recip_alphas[t]
    noise = torch.sqrt(beta) * float(t > 0) * z
    if kappa is None:
        kappa = torch.softmax(temperature * logq, dim=0)
    mixed = (kappa[:, :, None, None, None] * scores).sum(dim=0)
    dx = sra * x - x + noise + sra * beta * mixed
    d = x[0].numel()
    dlogq = _dot(scores, dx[None]) - 0.5 * beta * (
        d + _dot(scores, x[None]) + _dot(scores, scores))
    return x + dx, logq + dlogq
