"""A sampler run as one CUDA graph of one step, replayed once per step.

The counterpart of the JAX package's one compiled ``lax.scan`` per sampler
spec. The eager samplers enqueue ~4,300 aten ops per ``wide256`` denoiser
call from Python, and the host, not the card, sets the pace (``PERF.md``
§5). Here a :class:`~superdiff_torch.diffusion.samplers.SamplerPlan` (device
tables, state buffers and one step function that reads the step index from
a device counter) is captured once, and each step of a run is one
``graph.replay()``.

- **Noise** is drawn eagerly before each replay, from the caller's
  ``torch.Generator``, into the plan's static buffer: the initial sample
  first, then one draw per step, in the eager samplers' order. A graphed
  run and an eager run with the same seed draw the same bits.
- **Capture**: the plan runs a few steps eagerly on a side stream first (so
  the kernels' lazy build and load, ``ops/_build.py``, and cuDNN's plan
  selection happen outside the graph), then one step is captured with
  ``capture_error_mode="thread_local"``. A failed capture raises; there is
  no eager fallback on the card.
- **Memory**: the plan's buffers are ordinary allocations made before the
  capture; the step's intermediates live in the graph's private pool, which
  the graphs of one service share (``pool=``, from
  ``torch.cuda.graph_pool_handle()``): they replay one at a time on one
  stream, and nothing a graph leaves in the pool is read after its replay.
- **CPU**: the same object runs the step eagerly, with no capture; that is
  what the CPU tests reach.
- **Counts**: ``captures`` and ``replays`` count the graphs captured and
  the replays launched since :func:`reset_counts`. A replay launches every
  kernel of the captured step again without Python; the kernels' wrappers
  count the launches they recorded into a graph (``captured_by_shape`` in
  ``ops/``), so a run's launches are its wrapper launches made outside a
  capture plus the captured ones times ``replays``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from superdiff_torch.diffusion.samplers import SamplerPlan, _run_plan

WARMUP_STEPS = 2

captures = 0                  # graphs captured since the last reset
replays = 0                   # graph replays since the last reset


def reset_counts() -> None:
    global captures, replays
    captures = replays = 0


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the graph memory pool ``pool``
    (``torch.cuda.graph_pool_handle()``), from its memory snapshot."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class GraphedSampler:
    """Run ``plan``: captured as one CUDA graph of one step on a CUDA
    device (``capture=False`` runs the step eagerly there), eagerly on the
    CPU.

    ``__call__`` runs one batch; :meth:`step` is one step on the plan's
    buffers (after ``plan.start`` and, when it draws noise, ``plan.draw``).
    """

    def __init__(self, plan: SamplerPlan, capture: Optional[bool] = None,
                 pool=None):
        self.plan = plan
        self.device = plan.x.device
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not "
                             f"{self.device}")
        self.graph = self._capture(pool) if capture else None

    @property
    def num_steps(self) -> int:
        return self.plan.num_steps

    @torch.no_grad()
    def _capture(self, pool) -> "torch.cuda.CUDAGraph":
        global captures
        plan, dev = self.plan, self.device
        blank = torch.zeros_like(plan.x)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                plan.start(blank)
                plan.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        plan.start(blank)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            plan.step()
        captures += 1
        return graph

    @torch.no_grad()
    def step(self) -> None:
        """One step on the plan's buffers: the replay, or the eager step."""
        global replays
        if self.graph is None:
            self.plan.step()
        else:
            self.graph.replay()
            replays += 1

    @torch.no_grad()
    def __call__(self, generator: Optional[torch.Generator] = None,
                 y: Optional[torch.Tensor] = None,
                 x_init: Optional[torch.Tensor] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None,
                 num_frames: int = 0):
        """One batch: the initial sample (from ``generator`` or ``x_init``)
        and labels ``y``, then per step the draw (or ``noise[i]``) and
        :meth:`step`. Returns a copy of the output: ``x``, or ``(x, logq)``
        for SuperDiff; with ``num_frames > 0`` also the ``(num_frames,
        ...)`` trajectory, ``x`` copied into a frames buffer between
        replays at ``samplers.make_frame_recorder``'s positions (outside
        the captured step, so the graph stays one step)."""
        out, frames = _run_plan(self.plan, generator, x_init, noise,
                                num_frames, y=y, step=self.step)
        out = (tuple(o.clone() for o in out) if isinstance(out, tuple)
               else out.clone())
        return (out, frames) if num_frames > 0 else out
