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

Launching. Without a ``mesh`` and injected ``draws``, a step is split in
two, the counterpart of the JAX package's one jitted step:

1. on the host, eagerly: the batch is copied into static buffers, the
   step's draws are drawn from ``state.generator`` in the order above, all
   microbatches first, into static buffers (the same calls, so the same
   bits), and the numbers that change from step to step
   (``Optimizer.step_scalars`` of the count and ``ema_scalars`` of the
   step, taken on the host in double) are written into a static float32
   tensor by a fresh pinned copy;
2. the body: the loss of every microbatch on those draws, the backward,
   the clip, Adam and the EMA, reading the numbers from that tensor.

On a CUDA device the body is captured as one CUDA graph and each step
replays it: the first call with a new key runs the body eagerly on a side
stream (a real step, which also builds the kernels and picks cuDNN's
plans), the second captures it and replays it. The key is the device, the
batch's shapes and dtypes and the addresses of the parameters, the
moments and the EMA, so a checkpoint restore (which copies in place)
keeps the graph; a new key takes a new warm-up step and capture. On the
CPU the same split runs the body eagerly. A ``mesh`` (collectives) or
injected ``draws`` take the eager step, which draws as it goes and passes
the per-step numbers as Python floats; both forms give the same bits
(``Optimizer.update``). ``state.step`` and the Adam count advance on the
host. The metrics are copies of the graph's outputs, so they never alias
the next step's.

Counts: ``captures`` (graphs captured), ``replays`` and ``eager_steps``
(steps run without a graph, the warm-up steps among them) since
:func:`reset_counts`.

Spans (``utils/profiling.py``, on while a ``profiling.trace`` is open, as
``logging.profile_steps`` opens one): ``train.step`` around the call;
inside it a replay is one ``train.replay`` range, and an eager body shows
``train.forward`` and ``train.backward`` per microbatch, ``train.optimizer``
(the clip and the Adam update) and ``train.ema``; host ranges, as the step
never waits for the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from superdiff_torch.data.transforms import augment_draws, prepare_batch
from superdiff_torch.diffusion.process import training_step as loss_fn_impl
from superdiff_torch.diffusion.schedules import DiffusionSchedule
from superdiff_torch.parallel.mesh import (
    all_reduce_mean, gather_rows, local_rows)
from superdiff_torch.training.state import (
    TrainState, ema_scalars, ema_update)
from superdiff_torch.utils import profiling

captures = 0                  # train-step graphs captured since the reset
replays = 0                   # their replays
eager_steps = 0               # steps run without a graph


def reset_counts() -> None:
    global captures, replays, eager_steps
    captures = replays = eager_steps = 0


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

    def fill_draws(x: torch.Tensor, g, given: dict) -> dict:
        """Every draw of a loss on the microbatch ``x``: those in ``given``
        as they are, the rest from ``g`` in the module docstring's
        order."""
        d = dict(given)
        B, dev = x.shape[0], x.device
        if x.dtype == torch.uint8 and augmentation != "none":
            d["aug"] = augment_draws(x.shape, g, augmentation, dev,
                                     given.get("aug"))
        if conditional and cfg_drop_prob > 0.0 and "drop" not in d:
            d["drop"] = torch.rand((B,), generator=g,
                                   device=dev) < cfg_drop_prob
        dtype = torch.float32 if x.dtype == torch.uint8 else x.dtype
        d["t"], d["noise"] = _loss_draws(schedule, x.shape, dtype, dev, g, d)
        return d

    def loss_of(state: TrainState, batch, draws) -> torch.Tensor:
        g = state.generator
        if mesh is not None:          # the global microbatch, every rank
            batch = {k: gather_rows(v, mesh) for k, v in batch.items()}
        x = batch["image"]
        draws = fill_draws(x, g, draws)
        if x.dtype == torch.uint8:
            x = prepare_batch(x, g, augmentation=augmentation,
                              normalization=normalization,
                              draws=draws.get("aug"))
        y = None
        if conditional:
            y = batch["label"]
            if cfg_drop_prob > 0.0:
                y = torch.where(draws["drop"].to(x.device),
                                torch.full_like(y, null_label), y)
        t, noise = draws["t"], draws["noise"]
        if mesh is not None:          # this rank's rows
            rows = local_rows(x.shape[0], mesh)
            x, t, noise = x[rows], t[rows], noise[rows]
            y = None if y is None else y[rows]
        return loss_fn_impl(schedule, state.model, x, g, y=y,
                            loss_type=loss_type, weighting=weighting,
                            min_snr_gamma=min_snr_gamma,
                            parameterization=parameterization,
                            t=t, noise=noise)

    def body(state: TrainState, batch, draws, scalars=None) -> tuple:
        """Loss, backward, clip, Adam and EMA on ``draws`` (one dict per
        microbatch): ``(loss, grad_norm)``. ``scalars``: the split step's
        tensor of the per-step numbers; None takes them from the state as
        Python floats and lets the optimizer advance the count."""
        params = state.params
        for p in params:
            p.grad = None
        state.model.train()
        mb = batch["image"].shape[0] // grad_accum
        loss_sum = None
        for i in range(grad_accum):
            if fsdp:                  # reduce-scatter after the last only
                state.model.set_requires_gradient_sync(i == grad_accum - 1)
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            with profiling.span("train.forward"):
                loss = loss_of(state, micro, draws[i])
            # p.grad accumulates the sum of the microbatch gradients
            with profiling.span("train.backward"):
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
        kw, ema_kw = {}, {}
        if grad_norm is not None:
            kw["grad_norm"] = grad_norm
        if scalars is not None:       # Adam's numbers, then the EMA's two
            kw["scalars"], ema_kw["scalars"] = scalars[:-2], scalars[-2:]
        with profiling.span("train.optimizer"):
            grad_norm = state.tx.update(_local(params), grads, opt, **kw)
        state.opt_state["count"] = opt["count"]
        with profiling.span("train.ema"):
            ema_update(_local(state.ema_params), _local(params),
                       state.ema_decay, state.step, **ema_kw)
        for p in params:
            p.grad = None
        return loss, grad_norm

    def step_fn(state: TrainState, batch, draws=None) -> tuple:
        with profiling.span("train.step"):
            return _step(state, batch, draws)

    # the split step's static buffers and graph (``batch``, ``draws``,
    # ``scalars``, ``graph``), for inspection
    step_fn.split = split = _Split(body)

    def _step(state: TrainState, batch, draws) -> tuple:
        global eager_steps
        B = batch["image"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch size {B} not divisible by "
                             f"grad_accum {grad_accum}")
        if mesh is None and draws is None:
            g, mb = state.generator, B // grad_accum
            draws = [fill_draws(batch["image"][i * mb:(i + 1) * mb], g, {})
                     for i in range(grad_accum)]
            numbers = (state.tx.step_scalars(state.opt_state["count"])
                       + ema_scalars(state.ema_decay, state.step))
            loss, grad_norm = split(state, batch, draws, numbers)
            state.opt_state["count"] += 1
            metrics = {"loss": loss.clone(), "grad_norm": grad_norm.clone()}
        else:
            if draws is None:
                draws = [{}] * grad_accum
            elif grad_accum == 1 and isinstance(draws, dict):
                draws = [draws]
            if len(draws) != grad_accum:
                raise ValueError(f"draws must hold {grad_accum} entries")
            loss, grad_norm = body(state, batch, draws)
            eager_steps += 1
            metrics = {"loss": loss, "grad_norm": grad_norm}
        state.step += 1
        return state, metrics

    return step_fn


class _Split:
    """The body of the split step on static buffers: captured as one CUDA
    graph on a CUDA device (after one eager warm-up step), run eagerly on
    the CPU. One key at a time (module docstring)."""

    def __init__(self, body: Callable):
        self.body = body
        self.key = None
        self.warm = False             # the key's warm-up step is done
        self.graph = self.out = None  # the graph and its outputs

    @staticmethod
    def _key(state: TrainState, batch) -> tuple:
        dev = batch["image"].device
        leaves = (state.params + state.opt_state["mu"]
                  + state.opt_state["nu"] + state.ema_params)
        return (dev, tuple((k, v.shape, v.dtype)
                           for k, v in sorted(batch.items())),
                tuple(map(torch.Tensor.data_ptr, leaves)))

    def __call__(self, state: TrainState, batch, draws,
                 numbers) -> tuple:
        """One step's body on ``batch``, ``draws`` and the per-step
        ``numbers`` (Python floats): ``(loss, grad_norm)``, the graph's own
        outputs on the card."""
        global captures, replays, eager_steps
        key = self._key(state, batch)
        dev = key[0]
        vals = torch.tensor(numbers, dtype=torch.float32,
                            pin_memory=dev.type == "cuda")
        if key != self.key:           # new static buffers, no graph
            self.key, self.warm, self.graph, self.out = key, False, None, None
            self.batch = {k: v.clone() for k, v in batch.items()}
            self.draws = draws        # fresh tensors, the step's own
            self.scalars = vals.to(dev, non_blocking=True)
        else:
            for k, v in batch.items():
                self.batch[k].copy_(v)
            _copy(self.draws, draws)
            self.scalars.copy_(vals, non_blocking=True)
        if dev.type != "cuda":
            eager_steps += 1
            return self.body(state, self.batch, self.draws, self.scalars)
        if not self.warm:             # a real step, eagerly on a side stream
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = self.body(state, self.batch, self.draws, self.scalars)
            cur.wait_stream(side)
            for t in out:             # read on this stream, made on the side
                t.record_stream(cur)
            self.warm = True
            eager_steps += 1
            return out
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self.body(state, self.batch, self.draws,
                                     self.scalars)
            self.graph = graph
            captures += 1
        with profiling.span("train.replay"):
            self.graph.replay()
        replays += 1
        return self.out


def _copy(dst, src) -> None:
    """Copy the tensors of ``src`` into those of ``dst``, a tree of the
    same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _copy(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            _copy(a, b)
    else:
        dst.copy_(src)


def _loss_draws(schedule, shape, dtype, device, g, draws):
    """The timesteps, then the noise, of a loss on a batch of ``shape`` and
    ``dtype`` on ``device`` (the draws of
    ``diffusion/process.py::training_step``, in its order), unless
    injected."""
    t = draws.get("t")
    if t is None:
        t = torch.randint(0, schedule.num_timesteps, (shape[0],),
                          generator=g, device=device)
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(shape, generator=g, dtype=dtype, device=device)
    return t.to(device), noise.to(device)


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
            t, noise = _loss_draws(schedule, shape, x.dtype, x.device, g, {})
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
