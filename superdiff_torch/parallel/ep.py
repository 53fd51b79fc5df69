"""Ensemble parallelism for SuperDiff: one model per rank of the ``model``
axis.

Port of ``superdiff_tpu/parallel/ep.py``. The superposition sampler needs M
denoiser calls per step; here rank ``m`` of the ``model`` axis runs model
``m`` alone on its ``data`` rows (a plain single-model call: the fast
convolution path and kernels B1 and B4 as in one model's sampling), and one
all-gather over ``model`` assembles the ``(M, B_local, ...)`` stack that the
mixing math consumes. The mixing (softmax / kappa, the Itô density) is per
sample, so it stays local to the ``data`` rows.
"""

from __future__ import annotations

from typing import Callable, Sequence

from superdiff_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, gather_rows, local_rows)


def make_ep_eps_fn(apply_fn: Callable, models: Sequence, mesh: Mesh,
                   y=None, data_axis: str = DATA_AXIS,
                   model_axis: str = MODEL_AXIS) -> Callable:
    """Build ``eps_fn(x, t) -> (M, B_local, ...)`` with model ``m``
    evaluated on the ranks of ``model`` coordinate ``m``.

    ``apply_fn(model, x, t) -> eps``, or ``apply_fn(model, x, t, y)`` when
    ``y`` (the whole batch's ``(B,)`` labels) is given; ``x`` and ``t`` are
    this rank's rows (a plan built with ``rows=local_rows(B, mesh)``).
    ``models[m]`` need only be real on the ranks of coordinate ``m``.
    Requires ``len(models) == mesh.shape[model_axis]``. Pass the result to
    ``superdiff_sample(..., model_fns=eps_fn, num_models=M)``."""
    M = len(models)
    n_model = mesh.shape[model_axis]
    if M != n_model:
        raise ValueError(
            f"{M} models need mesh {model_axis}={M}, have {n_model}")
    mine = models[mesh.rank(model_axis)]
    ys = () if y is None else (y[local_rows(len(y), mesh)],)

    def eps_fn(x, t, *_):
        out = apply_fn(mine, x, t, *ys)[None]
        return gather_rows(out, mesh, axis=model_axis)

    return eps_fn
