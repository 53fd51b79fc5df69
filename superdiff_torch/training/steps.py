"""Train and eval steps.

Port of ``superdiff_tpu/training/steps.py`` without the mesh arguments (the
parallel modes are not ported yet). One call of the train step is: loss and
gradients (k microbatches in sequence when ``grad_accum=k``), one optimizer
update on the mean gradient, one EMA update. The state is updated in place
and returned; the metrics stay device tensors, so a loop that does not read
them never waits for the device.

Random draws. The JAX step derives every draw from a key chain that torch
cannot reproduce, so the step takes optional injected draws and otherwise
draws from ``state.generator`` in this fixed order, per microbatch:

1. (uint8 batches only) the augmentation draws, in the order documented in
   ``data/transforms.py``;
2. (conditional and ``cfg_drop_prob > 0``) the label-drop mask, ``(B,)``;
3. the timesteps ``t``, ``(B,)``;
4. the diffusion noise, the batch's shape.

``draws`` is a dict with any of ``aug`` (a dict for ``augment``), ``drop``,
``t`` and ``noise``; with ``grad_accum > 1`` it is a list of such dicts, one
per microbatch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from superdiff_torch.data.transforms import prepare_batch
from superdiff_torch.diffusion.process import training_step as loss_fn_impl
from superdiff_torch.diffusion.schedules import DiffusionSchedule
from superdiff_torch.training.state import TrainState, ema_update


def make_train_step(schedule: DiffusionSchedule,
                    conditional: bool = False,
                    cfg_drop_prob: float = 0.0,
                    null_label: int = 0,
                    loss_type: str = "mse",
                    weighting: str = "none",
                    min_snr_gamma: float = 5.0,
                    parameterization: str = "eps",
                    augmentation: str = "none",
                    normalization: str = "tanh",
                    grad_accum: int = 1) -> Callable:
    """Build ``step_fn(state, batch, draws=None) -> (state, metrics)``.

    ``batch`` is ``{"image": (B, H, W, C)}`` plus ``{"label": (B,)}`` when
    conditional. A **uint8** image batch is augmented and normalized inside
    the step (``prepare_batch``); float batches are taken as prepared.
    ``cfg_drop_prob`` replaces each label with ``null_label`` with that
    probability (classifier-free guidance training). ``grad_accum=k`` splits
    the batch into k microbatches run in sequence, each with its own draws,
    and applies one update on the mean gradient; ``B % k`` must be 0.
    ``metrics`` holds ``loss`` and ``grad_norm`` (the norm of the unclipped
    mean gradient, float32)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_of(state: TrainState, batch, draws) -> torch.Tensor:
        g = state.generator
        x = batch["image"]
        if x.dtype == torch.uint8:
            x = prepare_batch(x, g, augmentation=augmentation,
                              normalization=normalization,
                              draws=draws.get("aug"))
        y = None
        if conditional:
            y = batch["label"]
            if cfg_drop_prob > 0.0:
                drop = draws.get("drop")
                if drop is None:
                    drop = torch.rand((x.shape[0],), generator=g,
                                      device=x.device) < cfg_drop_prob
                y = torch.where(drop.to(x.device),
                                torch.full_like(y, null_label), y)
        return loss_fn_impl(schedule, state.model, x, g, y=y,
                            loss_type=loss_type, weighting=weighting,
                            min_snr_gamma=min_snr_gamma,
                            parameterization=parameterization,
                            t=draws.get("t"), noise=draws.get("noise"))

    def step_fn(state: TrainState, batch, draws=None) -> tuple:
        B = batch["image"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch size {B} not divisible by "
                             f"grad_accum {grad_accum}")
        if draws is None:
            draws = [{}] * grad_accum
        elif grad_accum == 1 and isinstance(draws, dict):
            draws = [draws]
        if len(draws) != grad_accum:
            raise ValueError(f"draws must hold {grad_accum} entries")
        params = state.params
        for p in params:
            p.grad = None
        state.model.train()
        mb = B // grad_accum
        loss_sum = None
        for i in range(grad_accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = loss_of(state, micro, draws[i])
            # p.grad accumulates the sum of the microbatch gradients
            (loss / grad_accum).backward()
            loss_sum = loss.detach() if loss_sum is None else (
                loss_sum + loss.detach())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        grad_norm = state.tx.update(params, grads, state.opt_state)
        ema_update(state.ema_params, params, state.ema_decay, state.step)
        state.step += 1
        for p in params:
            p.grad = None
        return state, {"loss": loss_sum / grad_accum, "grad_norm": grad_norm}

    return step_fn


def make_eval_step(schedule: DiffusionSchedule,
                   conditional: bool = False,
                   loss_type: str = "mse",
                   weighting: str = "none",
                   min_snr_gamma: float = 5.0,
                   parameterization: str = "eps",
                   normalization: str = "tanh") -> Callable:
    """Validation loss on the EMA parameters: no gradients, and draws from a
    generator seeded with the step (so it neither consumes nor depends on the
    training generator). A **uint8** batch is normalized inside the step and
    never augmented."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch) -> torch.Tensor:
        x = batch["image"]
        g = torch.Generator(device=x.device).manual_seed(state.step)
        if x.dtype == torch.uint8:
            x = prepare_batch(x, None, augmentation="none",
                              normalization=normalization)
        return loss_fn_impl(schedule, state.ema_model, x, g,
                            y=batch["label"] if conditional else None,
                            loss_type=loss_type, weighting=weighting,
                            min_snr_gamma=min_snr_gamma,
                            parameterization=parameterization)

    return eval_fn
