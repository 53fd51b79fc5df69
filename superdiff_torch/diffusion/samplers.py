"""Reverse-diffusion samplers: DDPM ancestral, DDIM and DPM-Solver++(2M).

Port of ``superdiff_tpu/diffusion/samplers.py``. Each JAX sampler is one
``lax.scan``; here each is a :class:`SamplerPlan`: per-step tables built once
on the device, state buffers, and one step function that reads the tables
at a device position counter and updates the buffers in place. The eager
samplers below loop over that step on the host; nothing inside it reads a
tensor value back to the host (no ``.item()``, no branch on a tensor), so
``diffusion/graphed.py`` can capture it in a CUDA graph and replay it.

Everything runs on the schedule's device. Randomness: a ``torch.Generator``
on that device (the initial sample first, then one draw per step), or
injected noise (``x_init=`` and a per-step ``noise=`` sequence).
``jax.random`` and torch cannot share a stream, so the parity tests rebuild
JAX's key chain and inject its draws here.
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


def _at(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[pos]`` for a ``(1,)`` long position on the table's device: a
    ``(1,)`` tensor, read by a kernel (no host sync, so a CUDA graph that
    captures it reads the position of each replay)."""
    return table.index_select(0, pos)


def _guided_eps(model_fn: ModelFn,
                x: torch.Tensor,
                t: torch.Tensor,
                y: Optional[torch.Tensor],
                guidance_scale: float,
                null) -> torch.Tensor:
    """Epsilon prediction with optional classifier-free guidance: the
    conditional and unconditional halves go through as one 2B call. ``y``
    is ``(B,)`` labels with ``null`` the null label (an int), or a ``(B, L,
    C)`` float context with ``null`` the null context (``(L, C)`` or ``(1,
    L, C)``, a tensor)."""
    if y is None:
        return model_fn(x, t)
    if guidance_scale == 1.0:
        return model_fn(x, t, y)
    x2 = torch.cat([x, x], dim=0)
    t2 = torch.cat([t, t], dim=0)
    if y.is_floating_point():
        y2 = torch.cat([y, null.expand(y.shape)], dim=0)
    else:
        y2 = torch.cat([y, torch.full_like(y, null)], dim=0)
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


class SamplerPlan:
    """One sampler as device tables, state buffers and one step function.

    Built once per spec (method, step grid, shape, labels) on the schedule's
    device. The timestep of each step (``t``) and the method's per-step
    coefficients are tables of length :attr:`num_steps`; the sample ``x``,
    the step's noise draw ``z``, the step index ``pos`` (a ``(1,)`` long
    tensor), the conditioning ``y`` and the method's own state are buffers.
    ``y`` is ``(B,)`` class labels (guidance pairs them with
    ``null_label``), or a ``(B, L, C)`` float text context (guidance pairs
    it with ``null_context``, ``(L, C)``, held in a buffer too): one
    captured step serves every chain's contexts, copied in by
    :meth:`start`.
    :meth:`step` reads the tables at ``pos`` on the device, updates the
    buffers in place and advances ``pos``: it never reads a value back to
    the host, so the eager samplers loop over it and
    ``diffusion/graphed.py`` captures one call of it in a CUDA graph and
    replays that, with the same arithmetic.

    A run is :meth:`start` (initial sample, labels), then per step
    :meth:`draw` (when :attr:`draws_noise`) and :meth:`step`.

    ``rows`` (data parallelism, ``parallel/mesh.py::local_rows``): the plan
    holds only these rows of the batch of ``shape``, but draws the whole
    batch's noise (the initial sample and every step's) and keeps its rows,
    so its rows get the bits a single process would give them; labels,
    ``x_init`` and ``noise`` are then the whole batch's too."""

    draws_noise = True

    def __init__(self, schedule: DiffusionSchedule, model_fn: ModelFn,
                 shape: Tuple[int, ...], t: torch.Tensor,
                 y: Optional[torch.Tensor] = None,
                 guidance_scale: float = 1.0, null_label: int = 0,
                 null_context: Optional[torch.Tensor] = None,
                 dtype=torch.float32, rows: Optional[slice] = None):
        dev = schedule.device
        self.schedule, self.model_fn = schedule, model_fn
        self.draw_shape, self.rows = tuple(shape), rows
        if rows is not None:
            shape = (len(range(shape[0])[rows]),) + tuple(shape[1:])
            self._z_all = torch.zeros(self.draw_shape, dtype=dtype,
                                      device=dev)
        self.shape, self.dtype = tuple(shape), dtype
        self.guidance_scale, self.null_label = guidance_scale, null_label
        self.t = t.to(device=dev, dtype=torch.long)
        self.num_steps = int(self.t.shape[0])
        self.x = torch.zeros(self.shape, dtype=dtype, device=dev)
        self.z = (torch.zeros(self.shape, dtype=dtype, device=dev)
                  if self.draws_noise else None)
        self.pos = torch.zeros((1,), dtype=torch.long, device=dev)
        self.null_context = None
        if y is not None and y.is_floating_point():
            if null_context is None and guidance_scale != 1.0:
                raise ValueError("guidance over a context needs "
                                 "null_context=")
            self.y = self._mine(y.to(dev)).clone()
            if null_context is not None:
                self.null_context = null_context.to(dev, y.dtype).clone()
        else:
            self.y = (None if y is None else
                      self._mine(y.to(device=dev, dtype=torch.long)).clone())

    def _mine(self, a: torch.Tensor) -> torch.Tensor:
        """This plan's rows of a whole-batch tensor."""
        return a if self.rows is None else a[self.rows]

    def start(self, x_init: torch.Tensor,
              y: Optional[torch.Tensor] = None) -> None:
        """Reset the state for a new run from ``x_init`` (and new labels or
        contexts, copied into the plan's buffer)."""
        self.x.copy_(self._mine(x_init))
        self.pos.zero_()
        if y is not None:
            if self.y is None:
                raise ValueError("this sampler was built without labels")
            self.y.copy_(self._mine(y))
        self._reset()

    def draw(self, generator: Optional[torch.Generator],
             injected: Optional[torch.Tensor] = None) -> None:
        """The step's N(0, I) draw into ``z``: from ``generator`` (the bits
        ``torch.randn`` would give), or an injected tensor."""
        if injected is not None:
            self.z.copy_(self._mine(injected))
        elif self.rows is None:
            self.z.normal_(generator=generator)
        else:
            self._z_all.normal_(generator=generator)
            self.z.copy_(self._z_all[self.rows])

    def step(self) -> None:
        self._update(_at(self.t, self.pos))
        self.pos.add_(1)

    def result(self):
        return self.x

    def _eps(self, t: torch.Tensor) -> torch.Tensor:
        null = (self.null_label if self.null_context is None
                else self.null_context)
        return _guided_eps(self.model_fn, self.x, t.expand(self.shape[0]),
                           self.y, self.guidance_scale, null).to(self.dtype)

    def _reset(self) -> None:
        pass

    def _update(self, t: torch.Tensor) -> None:
        raise NotImplementedError


class DDPMPlan(SamplerPlan):
    """Full T-step ancestral sampling (:func:`ddpm_step`)."""

    def __init__(self, schedule, model_fn, shape, **kw):
        T = schedule.num_timesteps
        super().__init__(schedule, model_fn, shape,
                         torch.arange(T - 1, -1, -1), **kw)

    def _update(self, t):
        tb = t.expand(self.shape[0])
        self.x.copy_(ddpm_step(self.schedule, self.x, tb, self._eps(t),
                               self.z))


def _run_plan(plan: SamplerPlan, generator, x_init, noise, num_frames=0,
              y=None, step=None):
    """One run of ``plan``: the initial sample (drawn or ``x_init``) and
    labels ``y``, then per step the draw (or ``noise[i]``) and ``step``
    (default :meth:`SamplerPlan.step`; a graph's replay in
    ``diffusion/graphed.py``). Returns ``(plan.result(), frames)``, with
    ``frames`` None unless ``num_frames > 0``."""
    dev = plan.schedule.device
    plan.start(_init_noise(plan.draw_shape, generator, x_init, dev,
                           plan.dtype), y)
    step = step or plan.step
    frames = None
    if num_frames > 0:
        init_buf, record = make_frame_recorder(plan.num_steps, num_frames)
        frames = init_buf(plan.shape, plan.dtype, dev)
    for pos in range(plan.num_steps):
        if plan.draws_noise:
            plan.draw(generator, None if noise is None else noise[pos])
        step()
        if frames is not None:
            frames = record(frames, plan.x, pos)
    return plan.result(), frames


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
    plan = DDPMPlan(schedule, model_fn, shape, y=y,
                    guidance_scale=guidance_scale, null_label=null_label,
                    dtype=dtype)
    x, frames = _run_plan(plan, generator, x_init, noise, num_frames)
    return (x, frames) if num_frames > 0 else x


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


class DDIMPlan(SamplerPlan):
    """DDIM (arXiv:2010.02502 eq. 12). Tables: ``ab`` (alpha_bar at the
    step's timestep) and ``ab_next`` (at the next node, 1 after the last);
    the last step, where ``ab_next`` is 1, takes no noise."""

    def __init__(self, schedule, model_fn, shape, num_steps: int = 50,
                 eta: float = 0.0, clip_x0: bool = True,
                 t_spacing: str = "leading", **kw):
        if t_spacing == "leading":
            ts_np = ddim_timesteps(schedule.num_timesteps, num_steps)
        elif t_spacing == "trailing":
            ts_np = trailing_timesteps(schedule.num_timesteps, num_steps)
        else:
            raise ValueError(f"unknown t_spacing: {t_spacing!r}")
        super().__init__(schedule, model_fn, shape, torch.as_tensor(ts_np),
                         **kw)
        ab_host = schedule.alpha_bars.cpu().numpy()
        ab_next = np.concatenate([ab_host[ts_np[1:]], [1.0]]).astype(
            np.float32)
        self.ab = schedule.alpha_bars.index_select(0, self.t)
        self.ab_next = torch.as_tensor(ab_next, device=schedule.device)
        self.eta, self.clip_x0 = eta, clip_x0

    def _update(self, t):
        x, eps_hat = self.x, self._eps(t)
        ab_t, ab_next = _at(self.ab, self.pos), _at(self.ab_next, self.pos)
        x0_pred = (x - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
        if self.clip_x0:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
            eps_hat = (x - torch.sqrt(ab_t) * x0_pred) / torch.sqrt(1.0 - ab_t)
        sigma = (self.eta * torch.sqrt((1.0 - ab_next) / (1.0 - ab_t))
                 * torch.sqrt(1.0 - ab_t / ab_next))
        dir_coef = torch.sqrt(torch.clamp(1.0 - ab_next - sigma ** 2, min=0.0))
        z = torch.where(ab_next < 1.0, self.z, 0.0)   # no fresh noise last
        self.x.copy_(torch.sqrt(ab_next) * x0_pred + dir_coef * eps_hat
                     + sigma * z)


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
    plan = DDIMPlan(schedule, model_fn, shape, num_steps=num_steps, eta=eta,
                    clip_x0=clip_x0, t_spacing=t_spacing, y=y,
                    guidance_scale=guidance_scale, null_label=null_label,
                    dtype=dtype)
    x, frames = _run_plan(plan, generator, x_init, noise, num_frames)
    return (x, frames) if num_frames > 0 else x


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


class DPMppPlan(SamplerPlan):
    """DPM-Solver++(2M), data-prediction variant (arXiv:2211.01095). Tables
    (float64 on the host, stored float32): ``ab``, the second-order weight
    ``c2`` and the update's ``coef_x`` / ``coef_d``; state: the previous x0
    prediction. Deterministic: no per-step draw."""

    draws_noise = False

    def __init__(self, schedule, model_fn, shape, num_steps: int = 20,
                 clip_x0: bool = True, t_spacing: str = "logsnr", **kw):
        ab_host = schedule.alpha_bars.cpu().numpy()
        ts_np = dpmpp_timesteps(schedule.num_timesteps, num_steps, ab_host,
                                t_spacing)
        super().__init__(schedule, model_fn, shape, torch.as_tensor(ts_np),
                         **kw)
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
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=schedule.device)
        self.ab, self.coef_x, self.coef_d, self.c2 = (
            f32(ab), f32(coef_x), f32(coef_d), f32(c2))
        self.clip_x0 = clip_x0
        self.x0_prev = torch.zeros_like(self.x)

    def _reset(self):
        self.x0_prev.zero_()

    def _update(self, t):
        x, eps_hat, pos = self.x, self._eps(t), self.pos
        ab_t = _at(self.ab, pos)
        x0_pred = (x - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
        if self.clip_x0:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        c = _at(self.c2, pos)
        d = (1.0 + c) * x0_pred - c * self.x0_prev
        self.x.copy_(_at(self.coef_x, pos) * x + _at(self.coef_d, pos) * d)
        self.x0_prev.copy_(x0_pred)


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
    plan = DPMppPlan(schedule, model_fn, shape, num_steps=num_steps,
                     clip_x0=clip_x0, t_spacing=t_spacing, y=y,
                     guidance_scale=guidance_scale, null_label=null_label,
                     dtype=dtype)
    x, frames = _run_plan(plan, generator, x_init, None, num_frames)
    return (x, frames) if num_frames > 0 else x
