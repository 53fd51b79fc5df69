"""Profiling and debug toggles.

Port of ``superdiff_tpu/utils/profiling.py``:

- :func:`trace`: a ``torch.profiler`` context that writes a Chrome /
  Perfetto trace (``trace.json``) into ``log_dir``;
- :func:`timed`: wall-clock seconds per call with the device synchronised
  before and after the timed calls (CUDA launches return before the card
  has finished);
- :func:`enable_debug_checks`: the counterpart of ``jax_debug_nans`` /
  ``jax_debug_infs``: a global module forward hook that raises on a
  non-finite output, and autograd's anomaly mode for the backward;
- :func:`set_deterministic`: deterministic kernels (cuBLAS workspace,
  cuDNN, ``torch.use_deterministic_algorithms``);
- :func:`span`: a named range at a layer boundary of the program (a train
  step and its phases), which stands in :func:`trace`'s Chrome trace as a
  ``record_function`` range beside the ops and kernels it encloses. Spans
  are on only while a :func:`trace` is open; otherwise :func:`span`
  returns one shared no-op and costs a read of a module counter, and a
  ``torch.profiler`` window that is not :func:`trace`'s sees none of
  them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Tuple

import torch

_traces_open = 0                  # :func:`trace` windows open: spans are on
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile everything inside the context (host ops, and the card's
    kernels when CUDA is available) into ``log_dir/trace.json``, with the
    program's :func:`span` ranges on while it is open."""
    global _traces_open
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    _traces_open += 1
    try:
        yield
    finally:
        _traces_open -= 1
        try:
            _sync()
        finally:                  # the profiler stops even if the card faulted
            prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A range named ``name`` around a ``with`` block: a
    ``torch.profiler.record_function`` range while a :func:`trace` is
    open, else one shared no-op."""
    if _traces_open:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 1, iters: int = 3,
          **kwargs) -> Tuple[float, object]:
    """Run ``fn`` ``warmup`` times, then time ``iters`` calls with the
    device synchronised before and after; returns ``(seconds_per_call,
    last_result)``."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _sync()
    tic = time.perf_counter()
    for _ in range(iters):
        result = fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - tic) / iters, result


def _non_finite_hook(nans: bool, infs: bool):
    def check(module, inputs, output):
        outs = output if isinstance(output, (tuple, list)) else (output,)
        for o in outs:
            if not (isinstance(o, torch.Tensor) and o.is_floating_point()):
                continue
            if nans and bool(torch.isnan(o).any()):
                raise FloatingPointError(
                    f"NaN in the output of {type(module).__name__}")
            if infs and bool(torch.isinf(o).any()):
                raise FloatingPointError(
                    f"Inf in the output of {type(module).__name__}")
    return check


def enable_debug_checks(nans: bool = True, infs: bool = False):
    """Raise ``FloatingPointError`` at the first module whose forward output
    holds a NaN (``nans``) or an Inf (``infs``), and turn on autograd's
    anomaly detection, which names the backward op that made one.
    Expensive (every check reads a value back to the host); for debugging
    runs only. Returns the hook's handle: ``handle.remove()`` takes the
    forward check off again (``torch.autograd.set_detect_anomaly(False)``
    the backward one)."""
    from torch.nn.modules.module import register_module_forward_hook

    torch.autograd.set_detect_anomaly(True)
    return register_module_forward_hook(_non_finite_hook(nans, infs))


def set_deterministic(enabled: bool = True) -> None:
    """Bit-determinism from run to run: deterministic cuBLAS workspaces
    (``CUBLAS_WORKSPACE_CONFIG``, read when cuBLAS starts, so call this
    before the first matrix product), cuDNN's deterministic algorithms
    without autotuning, and ``torch.use_deterministic_algorithms``
    (an op without a deterministic version then raises)."""
    if enabled:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = enabled
    torch.backends.cudnn.benchmark = False if enabled else \
        torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(enabled)
