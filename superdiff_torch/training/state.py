"""Training state: model, EMA copy, optimizer state, step and generator.

Port of ``superdiff_tpu/training/state.py``. Where the JAX package keeps one
immutable pytree that a jitted step replaces, the port keeps one mutable
:class:`TrainState` that the step updates in place: float32 parameters in
``model``, their EMA shadow in ``ema_model`` (a separate module, never an
alias), the Adam moments, the step counter and the ``torch.Generator`` the
step draws from. Everything in it is checkpointed, so resume is bit-exact
(dropout alone draws from the device's default generator, whose state the
checkpoint keeps as well).

:class:`Optimizer` follows the optax chain that ``make_optimizer`` builds in
the reference, rule for rule (the update at count ``c`` uses ``lr(c)``, so
under warmup the first update has rate 0):

- ``clip_by_global_norm(m)``: gradients are scaled by ``m / norm`` only when
  ``norm >= m`` (no epsilon in the divisor);
- Adam: ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``, bias
  correction by ``1 - b^(c+1)``, ``u = mu_hat / (sqrt(nu_hat) + 1e-8)``;
- AdamW only when ``weight_decay > 0``, decoupled:
  ``p <- p - lr (u + wd p)``;
- schedules: ``constant``; ``constant`` with ``warmup_steps > 0`` is a linear
  ramp ``lr c / warmup`` that then stays at ``lr``; ``cosine`` is a linear
  warmup over ``warm = min(max(warmup, 1), max(total - 1, 0))`` steps
  followed by a cosine decay to 0 at ``total_steps``.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch
from torch import nn


def make_lr_schedule(learning_rate: float = 2e-4, warmup_steps: int = 0,
                     total_steps: Optional[int] = None,
                     schedule: str = "constant") -> Callable[[int], float]:
    """``count -> learning rate`` with the reference's rules."""
    if schedule == "constant":
        if warmup_steps > 0:
            return lambda c: learning_rate * min(max(c, 0), warmup_steps) \
                / warmup_steps
        return lambda c: learning_rate
    if schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule requires total_steps")
        warm = min(max(warmup_steps, 1), max(total_steps - 1, 0))
        decay_steps = total_steps - warm
        if decay_steps <= 0:
            raise ValueError("cosine schedule requires total_steps > warmup")

        def lr(c: int) -> float:
            if c < warm:
                return learning_rate * c / warm
            d = min(c - warm, decay_steps)
            return learning_rate * 0.5 * (1.0 + math.cos(
                math.pi * d / decay_steps))

        return lr
    raise ValueError(f"unknown lr schedule: {schedule!r}")


class Optimizer:
    """Adam / AdamW with optional global-norm clipping and an lr schedule,
    on lists of tensors with ``torch._foreach`` ops (no host sync)."""

    b1, b2, eps = 0.9, 0.999, 1e-8          # optax.adam's defaults

    def __init__(self, lr: Callable[[int], float], weight_decay: float = 0.0,
                 grad_clip_norm: Optional[float] = None):
        self.lr, self.weight_decay = lr, weight_decay
        self.grad_clip_norm = grad_clip_norm

    def init(self, params: List[torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def step_scalars(self, count: int) -> List[float]:
        """The numbers of the update at ``count`` that change from step to
        step, in double: the bias corrections ``1 - b1^(c+1)`` and ``1 -
        b2^(c+1)``, their reciprocals (what a CUDA kernel multiplies by
        where it divides by a Python number) and ``-lr(c)``."""
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        return [bc1, bc2, 1.0 / bc1, 1.0 / bc2, -self.lr(count)]

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               opt_state: dict,
               grad_norm: Optional[torch.Tensor] = None,
               scalars: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update in place (``params``, ``opt_state``; ``grads``
        are scaled in place when clipped). Returns the global norm of the
        gradients as they came in (float32 scalar tensor): ``grad_norm``
        when given (the norm over every rank's shards, where the lists hold
        one rank's shards), else the norm of ``grads``.

        ``scalars``, a float32 device tensor holding
        :meth:`step_scalars` of the count, stands in for those Python
        numbers, so that a captured update reads them anew at each replay;
        the count is then the caller's to advance. Both forms give the
        same bits."""
        if grad_norm is None:
            grad_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip_norm is not None:
            m = self.grad_clip_norm
            factor = torch.where(grad_norm < m, torch.ones_like(grad_norm),
                                 m / grad_norm)
            torch._foreach_mul_(grads, factor)
        mu, nu, count = opt_state["mu"], opt_state["nu"], opt_state["count"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        bc1, bc2, inv1, inv2, neg_lr = (
            self.step_scalars(count) if scalars is None
            else scalars.unbind())
        denom = _div_scalar(nu, bc2, inv2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = _div_scalar(mu, bc1, inv1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay > 0:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        _add_scaled(params, upd, neg_lr)
        if scalars is None:
            opt_state["count"] = count + 1
        return grad_norm


def make_optimizer(learning_rate: float = 2e-4,
                   weight_decay: float = 0.0,
                   grad_clip_norm: Optional[float] = None,
                   warmup_steps: int = 0,
                   total_steps: Optional[int] = None,
                   schedule: str = "constant") -> Optimizer:
    """Adam(lr=2e-4) by default; clip / warmup / cosine decay / AdamW as in
    the reference's ``make_optimizer``."""
    return Optimizer(make_lr_schedule(learning_rate, warmup_steps,
                                      total_steps, schedule),
                     weight_decay=weight_decay, grad_clip_norm=grad_clip_norm)


@dataclass
class TrainState:
    step: int
    model: nn.Module                  # float32 parameters, trained in place
    ema_model: nn.Module              # EMA shadow of the parameters
    opt_state: dict                   # {"count", "mu", "nu"}
    generator: torch.Generator        # every random draw of the step
    tx: Optimizer
    ema_decay: float = 0.995
    # the two modules' parameters as lists in one order (what the foreach
    # ops take), filled in once
    params: List[torch.Tensor] = field(init=False, repr=False)
    ema_params: List[torch.Tensor] = field(init=False, repr=False)

    def __post_init__(self):
        self.params = list(self.model.parameters())
        self.ema_params = list(self.ema_model.parameters())


def create_train_state(model: nn.Module, generator: torch.Generator,
                       tx: Optional[Optimizer] = None,
                       ema_decay: float = 0.995) -> TrainState:
    """Wrap ``model`` (already initialised, float32) into a TrainState with a
    deep-copied EMA model in eval mode and zero Adam moments."""
    tx = tx if tx is not None else make_optimizer()
    ema_model = copy.deepcopy(model).eval().requires_grad_(False)
    return TrainState(step=0, model=model, ema_model=ema_model,
                      opt_state=tx.init(list(model.parameters())),
                      generator=generator, tx=tx, ema_decay=ema_decay)


def ema_scalars(decay: float, step: int) -> List[float]:
    """The EMA's numbers at ``step``, in double: the effective decay ``eff
    = min(decay, (1 + step) / (10 + step))`` and ``1 - eff``."""
    eff = min(decay, (1.0 + step) / (10.0 + step))
    return [eff, 1.0 - eff]


@torch.no_grad()
def ema_update(ema_params: List[torch.Tensor],
               new_params: List[torch.Tensor], decay: float,
               step: int, scalars: Optional[torch.Tensor] = None) -> None:
    """In-place EMA with warmup: the effective decay ramps in as
    ``min(decay, (1 + step) / (10 + step))``, ``step`` being the count
    *before* this update, so early steps track the raw parameters.
    ``scalars``, a float32 device tensor holding :func:`ema_scalars`,
    stands in for ``decay`` and ``step`` (the same bits)."""
    eff, rest = (ema_scalars(decay, step) if scalars is None
                 else scalars.unbind())
    torch._foreach_mul_(ema_params, eff)
    _add_scaled(ema_params, new_params, rest)


def _div_scalar(xs: List[torch.Tensor], s, inv) -> List[torch.Tensor]:
    """``xs / s`` as new tensors. ``s`` and its reciprocal ``inv`` are
    Python numbers or 0-d device tensors of them, and the tensor form
    rounds as PyTorch divides by a Python number on the tensors' device:
    a CUDA kernel multiplies by the reciprocal taken in double, the CPU
    divides."""
    if isinstance(s, torch.Tensor) and s.device.type == "cuda":
        return torch._foreach_mul(xs, inv)
    return torch._foreach_div(xs, s)


def _add_scaled(acc: List[torch.Tensor], xs: List[torch.Tensor],
                scale) -> None:
    """``acc += scale * xs`` in place, as one multiply-add per element:
    ``scale`` a Python number (``alpha``) or a 0-d device tensor (the same
    rounding through ``addcmul``)."""
    if isinstance(scale, torch.Tensor):
        torch._foreach_addcmul_(acc, xs, [scale] * len(xs))
    else:
        torch._foreach_add_(acc, xs, alpha=scale)
