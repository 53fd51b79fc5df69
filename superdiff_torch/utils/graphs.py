"""Warm-up and capture of a CUDA graph, for the port's three graph sites:
the train step (``training/steps.py``), the samplers
(``diffusion/graphed.py``) and the graph timer (``tools/timing.py``).

A callable is run once eagerly on a side stream first (:func:`warm_up`:
the kernels' lazy build and load and cuDNN's plan selection happen outside
the graph, and the warm-up's allocations stay out of the capture's pool),
then captured (:func:`capture`) with ``capture_error_mode="thread_local"``:
a CUDA call of this thread that is not allowed during a capture raises, as
it would under the global mode, while other threads may go on."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def warm_up(fn: Callable[[], Any], device=None) -> Any:
    """``fn()`` on a new side stream of ``device`` that waits for the
    current stream, which then waits for it; the tensors ``fn`` returns
    (one, or a tuple or list of them) are marked as used on the current
    stream, which reads them."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            t.record_stream(cur)
    return out


def capture(fn: Callable[[], Any],
            pool=None) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``fn()`` captured into a new CUDA graph, its intermediates in the
    memory pool ``pool`` (``torch.cuda.graph_pool_handle()``; None: the
    graph's own): ``(graph, what fn returned)``, the graph's static
    outputs."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = fn()
    return graph, out
