"""SuperDiff: score superposition with the Itô density estimator.

Port of ``superdiff_tpu/diffusion/superdiff.py`` (Skreta et al.,
arXiv:2412.17762). Along the simulated reverse trajectory each model's
log-density is tracked with the analytic Itô update

    dL_i = <s_i, dx> - beta_t/2 * ( d + <s_i, x> + ||s_i||^2 )

with ``s_i = -eps_i / sqrt(1 - alpha_bar_t)``. Mixing modes each step:
``"or"`` (kappa = softmax(T*(L + bias)) over models), ``"and"`` (two
models, kappa solved in closed form so the cumulative densities meet,
clipped to [-2, 3]) and ``"fixed"`` (constant weights).

The sampler is a ``SamplerPlan`` (:class:`SuperDiffPlan`): one step function
over device buffers (``x``, ``logq``, the step's draw) that reads the step's
timestep at a device position counter, with no host sync, so the eager loop
runs it and ``diffusion/graphed.py`` captures it. Noise comes from a
``torch.Generator`` or is injected (``x_init=``, ``noise=``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from superdiff_torch.diffusion.samplers import SamplerPlan, _at, _run_plan
from superdiff_torch.diffusion.schedules import DiffusionSchedule

MIX_MODES = ("or", "and", "fixed")


def stack_eps_fns(apply_fn: Callable, models: Sequence) -> Callable:
    """Fuse M same-architecture models into ONE batched call.

    Stacks the M modules' parameters and buffers on a leading axis
    (``torch.func.stack_module_state``) and maps ``apply_fn(module, x, t)``
    over it with ``torch.func.vmap`` (``functional_call`` on one copy of
    the architecture), so each sampler step issues one call with an
    M-major output. Returns ``fn(x, t) -> (M, B, ...)`` for
    ``superdiff_sample(..., model_fns=fn, num_models=M)``. The stacked
    parameters are a copy, taken now.

    Inside the map, the convolutions see per-model weights (cuDNN's
    grouped path), attention goes through kernel B1 once for all M models
    (its vmap rule folds M into the batch) and the GroupNorm chains
    through kernel B4 once per model. The CLIs keep sequential per-model
    calls, as the JAX package does (``PERF.md`` has the two measured on
    the card)."""
    import copy

    from torch.func import functional_call, stack_module_state, vmap

    params, buffers = stack_module_state(list(models))
    base = copy.deepcopy(models[0]).to("meta")

    class _Apply(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = base

        def forward(self, x, t):
            return apply_fn(self.m, x, t)

    wrapper = _Apply()
    prefixed = ({f"m.{k}": v for k, v in params.items()},
                {f"m.{k}": v for k, v in buffers.items()})

    def one(p, b, x, t):
        return functional_call(wrapper, (p, b), (x, t))

    mapped = vmap(one, in_dims=(0, 0, None, None))

    def fn(x, t):
        return mapped(*prefixed, x, t)

    return fn


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-example inner product over all non-batch dims -> (B,) float32,
    for ``a``/``b`` of shape (B, ...) or (M, B, ...) -> (M, B)."""
    return (a * b).float().flatten(start_dim=-3).sum(dim=-1)


def ito_logdensity_step(schedule: DiffusionSchedule,
                        t_scalar,
                        x: torch.Tensor,
                        scores: torch.Tensor,
                        dx: torch.Tensor) -> torch.Tensor:
    """One Itô update of ``log q_i`` for every model. ``scores``: (M, B, H,
    W, C); ``dx``: the realized update ``x_next - x``; returns (M, B).
    ``t_scalar``: an int, or a ``(1,)`` long tensor on the schedule's
    device."""
    beta = schedule.betas[t_scalar]
    d = float(math.prod(x.shape[1:]))
    return (_dot(scores, dx[None]) - 0.5 * beta * (
        d + _dot(scores, x[None]) + _dot(scores, scores)))


def _mix_kappa_or(logq: torch.Tensor, temperature: float,
                  bias: torch.Tensor) -> torch.Tensor:
    """(M, B) log-densities -> (M, B) softmax weights over models."""
    return torch.softmax(temperature * (logq + bias[:, None]), dim=0)


def _mix_kappa_and(schedule: DiffusionSchedule,
                   t_scalar,
                   x: torch.Tensor,
                   scores: torch.Tensor,
                   dx_base: torch.Tensor,
                   dx_coef: torch.Tensor,
                   bias: torch.Tensor,
                   logq: torch.Tensor) -> torch.Tensor:
    """Closed-form kappa for the two-model AND mode: the kappa that closes
    the cumulative density gap this step, clipped to [-2, 3]."""
    assert scores.shape[0] == 2, "AND mode supports exactly two models"
    beta = schedule.betas[t_scalar]
    s1, s2 = scores[0], scores[1]
    ds = s1 - s2
    const = (_dot(ds, dx_base)
             - 0.5 * beta * (_dot(ds, x) + _dot(s1, s1) - _dot(s2, s2)))
    slope = _dot(ds, dx_coef)
    target = (bias[0] - bias[1]) + (logq[1] - logq[0])
    tiny = torch.where(slope < 0, torch.full_like(slope, -1e-8),
                       torch.full_like(slope, 1e-8))
    safe_slope = torch.where(slope.abs() < 1e-8, tiny, slope)
    kappa1 = torch.clamp((target - const) / safe_slope, -2.0, 3.0)
    return torch.stack([kappa1, 1.0 - kappa1], dim=0)           # (2, B)


class SuperDiffPlan(SamplerPlan):
    """Superposed DDPM ancestral sampling across M models, as a plan:
    state ``x`` and ``logq`` (M, B), one draw per step. ``model_fns`` are
    per-model ``(x, t) -> eps_i`` (``(x, t, y) -> eps_i`` when the plan
    holds labels ``y``), or one stacked ``(x, t[, y]) -> (M, B, ...)``
    callable (:func:`stack_eps_fns`, ``parallel/ep.py``) with
    ``num_models=M``. ``rows``: see :class:`SamplerPlan`."""

    def __init__(self, schedule, model_fns, shape, mode: str = "or",
                 kappa: Optional[Sequence[float]] = None,
                 temperature: float = 1.0,
                 bias: Optional[Sequence[float]] = None,
                 y: Optional[torch.Tensor] = None, dtype=torch.float32,
                 num_models: Optional[int] = None,
                 rows: Optional[slice] = None):
        if mode not in MIX_MODES:
            raise ValueError(f"unknown mode {mode!r} (have {MIX_MODES})")
        if callable(model_fns):
            if not num_models:
                raise ValueError("num_models is required with a stacked "
                                 "model_fns callable")
            M = num_models
        else:
            M = len(model_fns)
        if M < 2:
            raise ValueError("superposition needs >= 2 models")
        if mode == "and" and M != 2:
            raise ValueError("AND mode supports exactly two models")
        dev = schedule.device
        if mode == "fixed":
            if kappa is None or len(kappa) != M:
                raise ValueError("fixed mode requires kappa of length M")
            self.kappa_fixed = torch.as_tensor(kappa, dtype=torch.float32,
                                               device=dev)[:, None]
        T = schedule.num_timesteps
        super().__init__(schedule, None, shape, torch.arange(T - 1, -1, -1),
                         y=y, dtype=dtype, rows=rows)
        self.model_fns, self.mode, self.temperature = model_fns, mode, temperature
        self.bias = (torch.as_tensor(bias, dtype=torch.float32, device=dev)
                     if bias is not None
                     else torch.zeros((M,), dtype=torch.float32, device=dev))
        self.d = float(math.prod(shape[1:]))
        self.logq = torch.zeros((M, self.shape[0]), dtype=torch.float32,
                                device=dev)

    def _reset(self):
        x = self.x
        logq0 = -0.5 * _dot(x, x) - 0.5 * self.d * math.log(2.0 * math.pi)
        self.logq.copy_(logq0[None, :].expand_as(self.logq))

    def _update(self, t):
        s, x, dtype = self.schedule, self.x, self.dtype
        M, B = self.logq.shape
        tb = t.expand(B)
        ys = () if self.y is None else (self.y,)
        if callable(self.model_fns):
            eps = self.model_fns(x, tb, *ys).to(dtype)
        else:
            eps = torch.stack([fn(x, tb, *ys)
                               for fn in self.model_fns]).to(dtype)
        scores = -eps / _at(s.sqrt_one_minus_alpha_bars, t)
        beta = _at(s.betas, t)
        sqrt_recip_alpha = _at(s.sqrt_recip_alphas, t)
        keep = (t > 0).to(beta.dtype)
        noise_term = torch.sqrt(beta) * keep * self.z
        dx_base_nos = sqrt_recip_alpha * x - x + noise_term

        if self.mode == "and":
            dx_base = dx_base_nos + sqrt_recip_alpha * beta * scores[1]
            dx_coef = sqrt_recip_alpha * beta * (scores[0] - scores[1])
            kap = _mix_kappa_and(s, t, x, scores, dx_base, dx_coef,
                                 self.bias, self.logq)
        elif self.mode == "or":
            kap = _mix_kappa_or(self.logq, self.temperature, self.bias)
        else:
            kap = self.kappa_fixed.expand(M, B)

        kap_b = kap.to(dtype).reshape((M, B) + (1,) * (x.ndim - 1))
        s_mix = (kap_b * scores).sum(dim=0)
        dx = dx_base_nos + sqrt_recip_alpha * beta * s_mix
        self.logq.add_(ito_logdensity_step(s, t, x, scores, dx))
        self.x.add_(dx)

    def result(self):
        return self.x, self.logq


@torch.no_grad()
def superdiff_sample(
        schedule: DiffusionSchedule,
        model_fns,
        shape: Tuple[int, ...],
        generator: Optional[torch.Generator] = None,
        mode: str = "or",
        kappa: Optional[Sequence[float]] = None,
        temperature: float = 1.0,
        bias: Optional[Sequence[float]] = None,
        num_models: Optional[int] = None,
        num_frames: int = 0,
        dtype=torch.float32,
        x_init: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None):
    """Superposed DDPM ancestral sampling across M models.

    ``model_fns`` is a sequence of per-model ``(x, t) -> eps_i`` functions
    (bind labels and weights with closures), or ONE stacked function ``(x,
    t) -> (M, B, ...)`` built by :func:`stack_eps_fns` (pass
    ``num_models=M`` then). Returns ``(samples, logq)`` with ``logq`` (M, B)
    the Itô log-density estimate of each model at the final sample
    (including the shared Gaussian-prior constant), plus ``(num_frames, B,
    ...)`` frames when ``num_frames > 0``.
    """
    plan = SuperDiffPlan(schedule, model_fns, shape, mode=mode, kappa=kappa,
                         temperature=temperature, bias=bias, dtype=dtype,
                         num_models=num_models)
    (x, logq), frames = _run_plan(plan, generator, x_init, noise, num_frames)
    if num_frames > 0:
        return x, logq, frames
    return x, logq
