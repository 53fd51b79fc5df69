"""Progressive distillation: halve sampler steps, keep quality.

Port of ``superdiff_tpu/diffusion/distill.py`` (Salimans & Ho 2022,
arXiv:2202.00512): a *student* denoiser is trained so that
ONE of its DDIM steps reproduces TWO consecutive DDIM steps of a frozen
*teacher* on the trailing-spaced grid of twice its step count; repeating the
procedure halves the sampler length each phase. The loss is the paper's
truncated-SNR-weighted x0-MSE, independent of the student head's
parameterization (its output is converted to x0 first); use ``v`` below ~8
steps.

One step is: the teacher's two-step rollout under ``torch.no_grad()`` (no
input requires grad, so its GroupNorm->FiLM->SiLU chains run through kernel
B4 and its attention through B1 on the card), the target solve, the
student's forward and backward under autograd (its chains on the plain
chain, its attention through B1/B2/B3), Adam and the EMA update, in place
on the state. Per-example transitions are gathered from device tables, so
every batch element trains its own transition.

Random draws. The JAX step derives its draws from a key chain torch cannot
reproduce, so the step takes optional injected draws (a dict with any of
``drop``, ``i``, ``noise``) and otherwise draws from ``state.generator`` in
this fixed order: the null-label mask ``(B,)`` (conditional and
``null_prob > 0``), the transition index ``i`` ``(B,)``, the noise (the
batch's shape).

With a ``mesh`` the step is data-parallel as the train step is
(``training/steps.py``): each rank's batch is its rows, the draws are the
global batch's (every rank makes them and keeps its rows), and the
gradients and the loss are averaged over ``data``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from superdiff_torch.data.transforms import prepare_batch
from superdiff_torch.diffusion.process import _bcast_to, x0_from_pred
from superdiff_torch.diffusion.samplers import trailing_timesteps
from superdiff_torch.diffusion.schedules import DiffusionSchedule
from superdiff_torch.parallel.mesh import (
    all_reduce_mean, gather_rows, local_rows)
from superdiff_torch.training.state import TrainState, ema_update


def _alpha_sigma(schedule: DiffusionSchedule, t: np.ndarray):
    ab = schedule.alpha_bars.detach().cpu().numpy().astype(np.float64)[t]
    return np.sqrt(ab), np.sqrt(1.0 - ab)


def phase_tables(schedule: DiffusionSchedule,
                 num_student_steps: int) -> Dict[str, torch.Tensor]:
    """Per-transition constants of one distillation phase, as ``(N,)``
    device tensors indexed by the student transition ``i``: the student
    start node ``t_s`` with its (alpha, sigma), the teacher midpoint ``t_m``
    with (alpha, sigma), and the endpoint (alpha, sigma), where the endpoint
    of the LAST transition is the clean manifold (alpha=1, sigma=0), as the
    DDIM sampler's last step. Computed in float64 on the host, stored
    float32 (timesteps int64)."""
    N = num_student_steps
    teacher = trailing_timesteps(schedule.num_timesteps, 2 * N)
    t_s, t_m = teacher[0::2], teacher[1::2]
    a_s, s_s = _alpha_sigma(schedule, t_s)
    a_m, s_m = _alpha_sigma(schedule, t_m)
    a_e = np.concatenate([a_s[1:], [1.0]])
    s_e = np.concatenate([s_s[1:], [0.0]])
    dev = schedule.alpha_bars.device

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    return {"t_s": torch.as_tensor(t_s, dtype=torch.int64, device=dev),
            "t_m": torch.as_tensor(t_m, dtype=torch.int64, device=dev),
            "a_s": f32(a_s), "s_s": f32(s_s), "a_m": f32(a_m),
            "s_m": f32(s_m), "a_e": f32(a_e), "s_e": f32(s_e)}


def _ddim_to(x, a_from, s_from, a_to, s_to, eps, clip_x0: bool = True):
    """One deterministic DDIM (eta=0) transition given the eps prediction:
    ``x0 = (x - s_f eps) / a_f``; ``x' = a_to x0 + s_to eps``. ``clip_x0``
    clamps the x0 estimate to [-1, 1] and re-derives a consistent eps, as
    the DDIM sampler does, so the distilled trajectory is the one the
    teacher's own sampler produces."""
    x0 = (x - s_from * eps) / a_from
    if clip_x0:
        x0 = x0.clamp(-1.0, 1.0)
        eps = (x - a_from * x0) / s_from.clamp_min(1e-12)
    return a_to * x0 + s_to * eps


def distill_targets(x_s, a_s, s_s, a_e, s_e, x_pp):
    """The x0 the student must predict so that ONE DDIM step from
    ``(x_s, a_s, s_s)`` to ``(a_e, s_e)`` lands on the teacher's two-step
    result ``x_pp`` (arXiv:2202.00512, Algorithm 2):
    ``x0 = (x_pp - (s_e / s_s) x_s) / (a_e - s_e a_s / s_s)``; for the clean
    endpoint (``s_e = 0``) it is ``x_pp``."""
    denom = a_e - s_e * a_s / s_s
    return (x_pp - (s_e / s_s) * x_s) / denom


def make_distill_step(schedule: DiffusionSchedule,
                      teacher_eps_fn: Callable,
                      num_student_steps: int,
                      mesh=None,
                      conditional: bool = False,
                      parameterization: str = "v",
                      null_prob: float = 0.0,
                      null_label: int = 0,
                      normalization: str = "tanh",
                      clip_x0: bool = True) -> Callable:
    """Build the distillation step of one phase:
    ``step_fn(state, teacher, batch, draws=None) -> (state, metrics)``.

    ``teacher_eps_fn(teacher, x, t[, y]) -> eps`` is the frozen teacher in
    sampler form (:func:`superdiff_torch.inference.make_eps_fn_p` with its
    own parameterization and the schedule), ``teacher`` its module (keep its
    parameters ``requires_grad_(False)`` and never alias the student's:
    the update is in place). ``parameterization`` is the student head's
    (``state.model``); the student runs deterministically (eval mode: no
    dropout), as the JAX step applies it. ``batch["image"]`` may be raw
    uint8, normalized inside the step with no augmentation. ``null_prob``
    replaces each label with ``null_label`` with that probability, the same
    label feeding teacher and student. ``clip_x0`` rolls the teacher with
    the clipped DDIM transition. ``metrics`` holds ``loss`` (the
    max(SNR, 1)-weighted x0-MSE, float32) and ``grad_norm``."""
    tab = phase_tables(schedule, num_student_steps)
    N = num_student_steps

    def step_fn(state: TrainState, teacher, batch, draws=None):
        draws = draws or {}
        g = state.generator
        if mesh is not None:          # the global batch, every rank
            batch = {k: gather_rows(v, mesh) for k, v in batch.items()}
        x0 = batch["image"]
        if x0.dtype == torch.uint8:
            x0 = prepare_batch(x0, None, augmentation="none",
                               normalization=normalization)
        B, dev = x0.shape[0], x0.device
        cond = ()
        if conditional:
            y = batch["label"]
            if null_prob > 0.0:
                drop = draws.get("drop")
                if drop is None:
                    drop = torch.rand((B,), generator=g, device=dev) \
                        < null_prob
                y = torch.where(drop.to(dev), torch.full_like(y, null_label),
                                y)
            cond = (y,)
        i = draws.get("i")
        if i is None:
            i = torch.randint(0, N, (B,), generator=g, device=dev)
        noise = draws.get("noise")
        if noise is None:
            noise = torch.randn(x0.shape, generator=g, device=dev,
                                dtype=x0.dtype)
        i, noise = i.to(dev), noise.to(dev)
        if mesh is not None:          # this rank's rows
            rows = local_rows(B, mesh)
            x0, i, noise = x0[rows], i[rows], noise[rows]
            cond = tuple(c[rows] for c in cond)
            B = x0.shape[0]
        a_s, s_s, a_m, s_m, a_e, s_e = (
            _bcast_to(tab[k][i], x0)
            for k in ("a_s", "s_s", "a_m", "s_m", "a_e", "s_e"))
        t_s, t_m = tab["t_s"][i], tab["t_m"][i]
        x_s = a_s * x0 + s_s * noise

        # the frozen teacher: two DDIM transitions, no gradient
        with torch.no_grad():
            eps1 = teacher_eps_fn(teacher, x_s, t_s, *cond)
            x_m = _ddim_to(x_s, a_s, s_s, a_m, s_m, eps1, clip_x0=clip_x0)
            eps2 = teacher_eps_fn(teacher, x_m, t_m, *cond)
            x_pp = _ddim_to(x_m, a_m, s_m, a_e, s_e, eps2, clip_x0=clip_x0)
            x0_target = distill_targets(x_s, a_s, s_s, a_e, s_e, x_pp)

        params = state.params
        for p in params:
            p.grad = None
        state.model.eval()
        pred = state.model(x_s, t_s, *cond)
        x0_student = x0_from_pred(schedule, x_s, t_s, pred, parameterization)
        # truncated-SNR weighting w(t) = max(ab / (1 - ab), 1)
        snr = a_s[:, 0, 0, 0] ** 2 / s_s[:, 0, 0, 0] ** 2
        w = snr.clamp_min(1.0)
        diff = x0_student.float() - x0_target.float()
        loss = (w * diff.reshape(B, -1).square().mean(dim=1)).mean()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        loss = loss.detach()
        if mesh is not None:
            all_reduce_mean(grads, mesh)
            all_reduce_mean([loss], mesh)
        grad_norm = state.tx.update(params, grads, state.opt_state)
        ema_update(state.ema_params, params, state.ema_decay, state.step)
        state.step += 1
        for p in params:
            p.grad = None
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step_fn
