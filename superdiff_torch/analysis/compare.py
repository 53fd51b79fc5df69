"""Cross-model comparison: model A vs model B vs their superposition.

Port of ``superdiff_tpu/analysis/compare.py``: matched batches from two
trained runs (DDPM, full T) and their SuperDiff superposition, a three-row
panel (``comparison.png``, drawn by ``utils/raster.py``) and the Itô
log-densities of the superposed samples under both models.

Each of the three runs is one :class:`~superdiff_torch.diffusion.graphed.
GraphedSampler` (one CUDA graph of one step on the card, replayed per
step; eager on the CPU) over the float32 models as ``load_run`` gives them,
as the JAX function samples its float32 parameters. Where the JAX function
feeds one key to all three runs, here each run draws from a fresh
``torch.Generator`` seeded with ``seed``, so A and B start from the same
noise (and so does the superposition).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


def _run(plan, seed: int, draws=None):
    from superdiff_torch.diffusion.graphed import GraphedSampler

    sampler = GraphedSampler(plan)
    if draws is not None:
        return sampler(x_init=draws[0], noise=draws[1])
    dev = plan.schedule.device
    return sampler(torch.Generator(device=dev).manual_seed(seed))


def compare_runs(run_dir_a: str, run_dir_b: str, out_dir: str,
                 num_samples: int = 4, seed: int = 0, mode: str = "or",
                 labels=("model A", "model B", "superposed"),
                 device="cuda", draws: Optional[Dict] = None) -> Dict:
    """Sample A, B and A+B superposed (``mode``); write the panel; return
    ``panel``, ``logq_model_a``, ``logq_model_b`` and ``mean_logq_gap``.
    ``draws``: per run (``"a"``, ``"b"``, ``"superposed"``) an ``(x_init,
    noise)`` pair that replaces the generator's draws (the parity tests
    replay the JAX package's key chain)."""
    from superdiff_torch.diffusion.samplers import DDPMPlan
    from superdiff_torch.diffusion.superdiff import SuperDiffPlan
    from superdiff_torch.inference import (check_superpose_compat, load_run,
                                           make_eps_fn_p)
    from superdiff_torch.utils import raster
    from superdiff_torch.utils.visualization import _gray_u8

    cfg_a, model_a, schedule = load_run(run_dir_a, device=device)
    cfg_b, model_b, _ = load_run(run_dir_b, device=device)
    check_superpose_compat(cfg_a, cfg_b)
    R = cfg_a.training.resolution
    shape = (num_samples, R, R, 1)
    apply_a = make_eps_fn_p(model_a, schedule=schedule)
    apply_b = make_eps_fn_p(model_b, schedule=schedule)
    fn_a = lambda x, t: apply_a(model_a, x, t)
    fn_b = lambda x, t: apply_b(model_b, x, t)
    draws = draws or {}

    xa = _run(DDPMPlan(schedule, fn_a, shape), seed, draws.get("a"))
    xb = _run(DDPMPlan(schedule, fn_b, shape), seed, draws.get("b"))
    xs, logq = _run(SuperDiffPlan(schedule, [fn_a, fn_b], shape, mode=mode),
                    seed, draws.get("superposed"))

    rows = [[_gray_u8(img) for img in x.float().cpu().numpy()]
            for x in (xa, xb, xs)]
    os.makedirs(out_dir, exist_ok=True)
    panel = raster.write_png(
        os.path.join(out_dir, "comparison.png"),
        raster.tile_rows(rows, gap=4),
        {"Title": f"rows: {' | '.join(labels)}", "Comment": f"mode {mode}"})
    logq = logq.float().cpu().numpy()
    return {
        "panel": panel,
        "logq_model_a": logq[0].tolist(),
        "logq_model_b": logq[1].tolist(),
        "mean_logq_gap": float(np.mean(logq[0] - logq[1])),
    }
