"""Reverse-diffusion samplers: DDPM ancestral, DDIM and DPM-Solver++(2M).

Port of ``superdiff_tpu/diffusion/samplers.py``. Each JAX sampler is one
``lax.scan``; here it is a Python loop over host-side step indices whose
body only enqueues device work: the schedule lives on the device, per-step
coefficients are indexed with Python ints, and nothing reads a tensor value
back to the host inside the loop (no ``.item()``, no branch on a tensor).

Everything runs on the schedule's device. Randomness: a ``torch.Generator``
on that device, or injected noise (``x_init=`` and a per-step ``noise=``
sequence). ``jax.random`` and torch
cannot share a stream, so the parity tests rebuild JAX's key chain and
inject its draws here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from superdiff_torch.diffusion.process import ModelFn, _bcast_to
from superdiff_torch.diffusion.schedules import DiffusionSchedule


def _draw(shape, generator, device, dtype):
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def _init_noise(shape, generator, x_init, device, dtype):
    if x_init is not None:
        return x_init.to(device=device, dtype=dtype)
    return _draw(shape, generator, device, dtype)


def _step_noise(noise, i, shape, generator, device, dtype):
    if noise is not None:
        return noise[i].to(device=device, dtype=dtype)
    return _draw(shape, generator, device, dtype)


def _guided_eps(model_fn: ModelFn,
                x: torch.Tensor,
                t: torch.Tensor,
                y: Optional[torch.Tensor],
                guidance_scale: float,
                null_label: int) -> torch.Tensor:
    """Epsilon prediction with optional classifier-free guidance: the
    conditional and unconditional halves go through as one 2B call."""
    if y is None:
        return model_fn(x, t)
    if guidance_scale == 1.0:
        return model_fn(x, t, y)
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    y2 = torch.cat([y, torch.full_like(y, null_label)], dim=0)
    eps_c, eps_u = model_fn(x2, t2, y2).chunk(2, dim=0)
    return eps_u + guidance_scale * (eps_c - eps_u)


def make_frame_recorder(total_steps: int, num_frames: int):
    """Constant-memory trajectory recording: ``(init, record)`` where
    ``record(buf, x, pos)`` writes ``x`` into the ``(num_frames, ...)``
    buffer at ``num_frames`` evenly spaced positions, always including the
    last step. ``num_frames`` is clamped to ``total_steps``. ``pos`` is a
    host int, so the decision is made on the host."""
    num_frames = min(num_frames, total_steps)
    every = max(1, total_steps // num_frames)

    def init(shape, dtype, device):
        return torch.zeros((num_frames,) + tuple(shape), dtype=dtype,
                           device=device)

    def record(buf, x, pos):
        remaining = (total_steps - 1) - pos
        idx = (num_frames - 1) - remaining // every
        if remaining % every == 0 and idx >= 0:
            buf[idx] = x
        return buf

    return init, record


def ddpm_step(schedule: DiffusionSchedule,
              x: torch.Tensor,
              t: torch.Tensor,
              eps_hat: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """One ancestral update:
    ``x' = (1/sqrt(a_t)) (x - ((1-a_t)/sqrt(1-ab_t)) eps_hat) + sqrt(b_t) z``
    with ``z = 0`` at ``t == 0``."""
    coef = _bcast_to(
        (1.0 - schedule.alphas[t]) / schedule.sqrt_one_minus_alpha_bars[t], x)
    mean = _bcast_to(schedule.sqrt_recip_alphas[t], x) * (x - coef * eps_hat)
    sigma = _bcast_to(torch.sqrt(schedule.betas[t]), x)
    keep_noise = _bcast_to((t > 0).to(x.dtype), x)
    return mean + sigma * keep_noise * noise


@torch.no_grad()
def ddpm_sample(schedule: DiffusionSchedule,
                model_fn: ModelFn,
                shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                y: Optional[torch.Tensor] = None,
                guidance_scale: float = 1.0,
                null_label: int = 0,
                num_frames: int = 0,
                dtype=torch.float32,
                x_init: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
    """Full T-step ancestral sampling. Returns ``x0`` of ``shape`` (NHWC),
    or ``(x0, frames)`` when ``num_frames > 0``. ``noise[i]`` is the draw of
    step ``i`` (timestep ``T-1-i``)."""
    T = schedule.num_timesteps
    dev = schedule.device
    x = _init_noise(shape, generator, x_init, dev, dtype)
    recording = num_frames > 0
    if recording:
        init_buf, record = make_frame_recorder(T, num_frames)
        frames = init_buf(shape, dtype, dev)
    for pos, t_i in enumerate(range(T - 1, -1, -1)):
        t = torch.full((shape[0],), t_i, dtype=torch.long, device=dev)
        eps_hat = _guided_eps(model_fn, x, t, y, guidance_scale, null_label)
        z = _step_noise(noise, pos, shape, generator, dev, dtype)
        x = ddpm_step(schedule, x, t, eps_hat.to(dtype), z)
        if recording:
            frames = record(frames, x, pos)
    return (x, frames) if recording else x


def ddim_timesteps(T: int, num_steps: int) -> np.ndarray:
    """Evenly spaced sub-sequence of timesteps, descending, ending at 0."""
    if num_steps >= T:
        return np.arange(T - 1, -1, -1)
    step = T // num_steps
    ts = np.arange(0, T, step)[:num_steps]
    return ts[::-1].copy()


def trailing_timesteps(T: int, num_steps: int) -> np.ndarray:
    """Descending grid with node_0 = T-1: ``t_k = (k+1) * T // num_steps - 1``."""
    if not 1 <= num_steps <= T:
        raise ValueError(f"num_steps must be in [1, {T}], got {num_steps}")
    k = np.arange(num_steps, 0, -1, dtype=np.int64)
    return (k * T // num_steps - 1).astype(np.int64)


@torch.no_grad()
def ddim_sample(schedule: DiffusionSchedule,
                model_fn: ModelFn,
                shape: Tuple[int, ...],
                generator: Optional[torch.Generator] = None,
                num_steps: int = 50,
                eta: float = 0.0,
                y: Optional[torch.Tensor] = None,
                guidance_scale: float = 1.0,
                null_label: int = 0,
                clip_x0: bool = True,
                num_frames: int = 0,
                t_spacing: str = "leading",
                dtype=torch.float32,
                x_init: Optional[torch.Tensor] = None,
                noise: Optional[Sequence[torch.Tensor]] = None):
    """DDIM sampling (arXiv:2010.02502 eq. 12) over ``num_steps`` steps;
    ``eta = 0`` is deterministic given the init noise."""
    if t_spacing == "leading":
        ts_np = ddim_timesteps(schedule.num_timesteps, num_steps)
    elif t_spacing == "trailing":
        ts_np = trailing_timesteps(schedule.num_timesteps, num_steps)
    else:
        raise ValueError(f"unknown t_spacing: {t_spacing!r}")
    dev = schedule.device
    ab_host = schedule.alpha_bars.cpu().numpy()
    ab_next_np = np.concatenate([ab_host[ts_np[1:]], [1.0]]).astype(np.float32)
    ab_next_seq = torch.as_tensor(ab_next_np, device=dev)

    x = _init_noise(shape, generator, x_init, dev, dtype)
    recording = num_frames > 0
    if recording:
        init_buf, record = make_frame_recorder(len(ts_np), num_frames)
        frames = init_buf(shape, dtype, dev)
    for pos, t_i in enumerate(ts_np.tolist()):
        t = torch.full((shape[0],), t_i, dtype=torch.long, device=dev)
        eps_hat = _guided_eps(model_fn, x, t, y, guidance_scale,
                              null_label).to(dtype)
        ab_t = schedule.alpha_bars[t_i]
        ab_next = ab_next_seq[pos]
        x0_pred = (x - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
        if clip_x0:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
            eps_hat = (x - torch.sqrt(ab_t) * x0_pred) / torch.sqrt(1.0 - ab_t)
        sigma = (eta * torch.sqrt((1.0 - ab_next) / (1.0 - ab_t))
                 * torch.sqrt(1.0 - ab_t / ab_next))
        dir_coef = torch.sqrt(torch.clamp(1.0 - ab_next - sigma ** 2, min=0.0))
        z = _step_noise(noise, pos, shape, generator, dev, dtype)
        if ab_next_np[pos] >= 1.0:        # host value: no fresh noise last
            z = torch.zeros_like(z)
        x = torch.sqrt(ab_next) * x0_pred + dir_coef * eps_hat + sigma * z
        if recording:
            frames = record(frames, x, pos)
    return (x, frames) if recording else x


def dpmpp_timesteps(T: int, num_steps: int, alpha_bars,
                    spacing: str = "logsnr") -> np.ndarray:
    """Node sub-sequence for the ODE solver, descending, ending at 0;
    ``logsnr`` places nodes uniformly in ``0.5 log(ab/(1-ab))``."""
    if spacing == "uniform":
        return ddim_timesteps(T, num_steps)
    if spacing != "logsnr":
        raise ValueError(f"unknown t_spacing: {spacing!r}")
    if isinstance(alpha_bars, torch.Tensor):
        alpha_bars = alpha_bars.cpu().numpy()
    ab = np.asarray(alpha_bars, dtype=np.float64)[:T]
    lam = 0.5 * np.log(ab / (1.0 - ab))
    targets = np.linspace(lam[T - 1], lam[0], num_steps)
    idx = np.abs(lam[None, :] - targets[:, None]).argmin(axis=1)
    return np.unique(idx)[::-1].copy()


@torch.no_grad()
def dpmpp_sample(schedule: DiffusionSchedule,
                 model_fn: ModelFn,
                 shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None,
                 num_steps: int = 20,
                 y: Optional[torch.Tensor] = None,
                 guidance_scale: float = 1.0,
                 null_label: int = 0,
                 clip_x0: bool = True,
                 num_frames: int = 0,
                 t_spacing: str = "logsnr",
                 dtype=torch.float32,
                 x_init: Optional[torch.Tensor] = None):
    """DPM-Solver++(2M) (arXiv:2211.01095, data-prediction variant);
    deterministic given the init noise, last transition first-order to the
    clean manifold."""
    ab_host = schedule.alpha_bars.cpu().numpy()
    ts_np = dpmpp_timesteps(schedule.num_timesteps, num_steps, ab_host,
                            t_spacing)
    n = len(ts_np)
    ab = np.asarray(ab_host, dtype=np.float64)[ts_np]
    alpha = np.sqrt(ab)
    sigma = np.sqrt(1.0 - ab)
    lam = np.log(alpha / sigma)
    coef_x = np.concatenate([sigma[1:] / sigma[:-1], [0.0]])
    exp_mh = np.concatenate([np.exp(-(lam[1:] - lam[:-1])), [0.0]])
    coef_d = np.concatenate([alpha[1:], [1.0]]) * (1.0 - exp_mh)
    h = lam[1:] - lam[:-1]
    c2 = np.zeros(n)
    if n >= 3:
        c2[1:n - 1] = h[1:] / (2.0 * h[:-1])

    dev = schedule.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    ab_seq, coef_x, coef_d, c2 = f32(ab), f32(coef_x), f32(coef_d), f32(c2)

    x = _init_noise(shape, generator, x_init, dev, dtype)
    x0_prev = torch.zeros(shape, dtype=dtype, device=dev)
    recording = num_frames > 0
    if recording:
        init_buf, record = make_frame_recorder(n, num_frames)
        frames = init_buf(shape, dtype, dev)
    for pos, t_i in enumerate(ts_np.tolist()):
        t = torch.full((shape[0],), t_i, dtype=torch.long, device=dev)
        eps_hat = _guided_eps(model_fn, x, t, y, guidance_scale,
                              null_label).to(dtype)
        ab_t = ab_seq[pos]
        x0_pred = (x - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
        if clip_x0:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        c = c2[pos]
        d = (1.0 + c) * x0_pred - c * x0_prev
        x = coef_x[pos] * x + coef_d[pos] * d
        x0_prev = x0_pred
        if recording:
            frames = record(frames, x, pos)
    return (x, frames) if recording else x
