"""Train and eval steps.

Port of ``superdiff_tpu/training/steps.py``. One call of the train step is:
loss and gradients (k microbatches in sequence when ``grad_accum=k``), one
optimizer update on the mean gradient, one EMA update. The state is updated
in place and returned; the metrics stay device tensors, so a loop that does
not read them never waits for the device.

With a ``mesh`` (``parallel/mesh.py``) the step is data-parallel: each rank
gets its rows of the global batch, gathers the microbatch's inputs over the
``data`` axis, makes the *global* microbatch's draws (the single-process
draws) and keeps its rows, and the gradients are averaged over ``data``
once per optimizer step, after the k microbatches. ``state_shardings``
(``parallel/tp.py`` / ``parallel/fsdp.py``) says how the state is split:
over ``model`` (tensor parallelism, the ResBlocks call their own
collectives) and over ``data`` (FSDP2, whose reduce-scatter then replaces
the average); the clip and the ``grad_norm`` metric use the global norm,
each split leaf summed over its axes and a replicated one counted once.

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
from superdiff_torch.parallel.mesh import (
    all_reduce_mean, gather_rows, local_rows)
from superdiff_torch.training.state import TrainState, ema_update


def make_train_step(schedule: DiffusionSchedule,
                    mesh=None,
                    conditional: bool = False,
                    cfg_drop_prob: float = 0.0,
                    null_label: int = 0,
                    loss_type: str = "mse",
                    weighting: str = "none",
                    min_snr_gamma: float = 5.0,
                    parameterization: str = "eps",
                    augmentation: str = "none",
                    normalization: str = "tanh",
                    state_shardings=None,
                    grad_accum: int = 1) -> Callable:
    """Build ``step_fn(state, batch, draws=None) -> (state, metrics)``.

    ``batch`` is ``{"image": (B, H, W, C)}`` plus ``{"label": (B,)}`` when
    conditional (with a ``mesh``: this rank's rows, ``shard_batch``). A
    **uint8** image batch is augmented and normalized inside the step
    (``prepare_batch``); float batches are taken as prepared.
    ``cfg_drop_prob`` replaces each label with ``null_label`` with that
    probability (classifier-free guidance training). ``grad_accum=k`` splits
    the batch into k microbatches run in sequence, each with its own draws,
    and applies one update on the mean gradient; ``B % k`` must be 0.
    ``metrics`` holds ``loss`` and ``grad_norm`` (the norm of the unclipped
    mean gradient, float32). Injected ``draws`` are the global batch's."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    fsdp = state_shardings is not None and state_shardings.fsdp

    def loss_of(state: TrainState, batch, draws) -> torch.Tensor:
        g = state.generator
        if mesh is not None:          # the global microbatch, every rank
            batch = {k: gather_rows(v, mesh) for k, v in batch.items()}
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
        t, noise = _loss_draws(schedule, x, g, draws)
        if mesh is not None:          # this rank's rows
            rows = local_rows(x.shape[0], mesh)
            x, t, noise = x[rows], t[rows], noise[rows]
            y = None if y is None else y[rows]
        return loss_fn_impl(schedule, state.model, x, g, y=y,
                            loss_type=loss_type, weighting=weighting,
                            min_snr_gamma=min_snr_gamma,
                            parameterization=parameterization,
                            t=t, noise=noise)

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
            if fsdp:                  # reduce-scatter after the last only
                state.model.set_requires_gradient_sync(i == grad_accum - 1)
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = loss_of(state, micro, draws[i])
            # p.grad accumulates the sum of the microbatch gradients
            (loss / grad_accum).backward()
            loss_sum = loss.detach() if loss_sum is None else (
                loss_sum + loss.detach())
        grads = _local([p.grad if p.grad is not None else torch.zeros_like(p)
                        for p in params])
        loss = loss_sum / grad_accum
        grad_norm = None
        if mesh is not None:
            if not fsdp:
                all_reduce_mean(grads, mesh)
            all_reduce_mean([loss], mesh)
            if state_shardings is not None:
                grad_norm = _global_norm(state, grads, state_shardings)
        opt = state.opt_state
        if fsdp:                      # the moments' local shards
            opt = dict(opt, mu=_local(opt["mu"]), nu=_local(opt["nu"]))
        kw = {} if grad_norm is None else {"grad_norm": grad_norm}
        grad_norm = state.tx.update(_local(params), grads, opt, **kw)
        state.opt_state["count"] = opt["count"]
        ema_update(_local(state.ema_params), _local(params), state.ema_decay,
                   state.step)
        state.step += 1
        for p in params:
            p.grad = None
        return state, {"loss": loss, "grad_norm": grad_norm}

    return step_fn


def _loss_draws(schedule, x, g, draws):
    """The timesteps, then the noise, of a loss on ``x`` (the draws of
    ``diffusion/process.py::training_step``, in its order), unless
    injected."""
    t = draws.get("t")
    if t is None:
        t = torch.randint(0, schedule.num_timesteps, (x.shape[0],),
                          generator=g, device=x.device)
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(x.shape, generator=g, dtype=x.dtype,
                            device=x.device)
    return t.to(x.device), noise.to(x.device)


def _local(tensors):
    """This rank's shards of FSDP's DTensors (views: updating them updates
    the DTensors), other tensors as they are."""
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


def _global_norm(state, grads, shardings) -> torch.Tensor:
    """The norm of the whole gradient from each rank's shards: the squares
    of a split leaf summed over the axes it is split over, a replicated
    leaf counted once."""
    import torch.distributed as dist

    names = [n for n, _ in state.model.named_parameters()]
    buckets = {}
    for n, gl in zip(names, grads):
        buckets.setdefault(shardings.axes(n), []).append(gl)
    norms = []
    for axes, gs in buckets.items():
        # the optimizer's own expression; a sum of squares only across
        # ranks (sqrt of a rounded square gives the norm back exactly, so
        # on one rank the result is the unsharded step's bits)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
        if axes:
            sq = norm.square()
            for axis in axes:
                dist.all_reduce(sq, group=shardings.mesh.group(axis))
            norm = sq.sqrt()
        norms.append(norm)
    return torch.linalg.vector_norm(torch.stack(norms))


def make_eval_step(schedule: DiffusionSchedule,
                   mesh=None,
                   conditional: bool = False,
                   loss_type: str = "mse",
                   weighting: str = "none",
                   min_snr_gamma: float = 5.0,
                   parameterization: str = "eps",
                   normalization: str = "tanh") -> Callable:
    """Validation loss on the EMA parameters: no gradients, and draws from a
    generator seeded with the step (so it neither consumes nor depends on the
    training generator). A **uint8** batch is normalized inside the step and
    never augmented. With a ``mesh``, ``batch`` is this rank's rows, the
    draws are the global batch's, and the loss is averaged over ``data``."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch) -> torch.Tensor:
        x = batch["image"]
        g = torch.Generator(device=x.device).manual_seed(state.step)
        if x.dtype == torch.uint8:
            x = prepare_batch(x, None, augmentation="none",
                              normalization=normalization)
        y = batch["label"] if conditional else None
        t = noise = None
        if mesh is not None:
            n = mesh.shape["data"]
            shape = (x.shape[0] * n,) + tuple(x.shape[1:])
            rows = local_rows(shape[0], mesh)
            t, noise = _loss_draws(schedule, x.new_empty(shape), g, {})
            t, noise = t[rows], noise[rows]
        loss = loss_fn_impl(schedule, state.ema_model, x, g, y=y,
                            loss_type=loss_type, weighting=weighting,
                            min_snr_gamma=min_snr_gamma,
                            parameterization=parameterization,
                            t=t, noise=noise)
        if mesh is not None:
            all_reduce_mean([loss], mesh)
        return loss

    return eval_fn
