"""Environment detection, seeding, and run-path resolution.

Port of ``superdiff_tpu/utils/env.py``: cluster detection, global seeding,
and experiment/run/task-keyed path resolution under a cluster-vs-local base.

Unlike the reference, the cluster base is chosen only by the explicit
``IS_CLUSTER=1`` switch, never by the host's name: where a run writes must
not depend on what the machine happens to be called.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np
import torch

from superdiff_torch.config import Config


def is_cluster() -> bool:
    """True on the HPC side: only when ``IS_CLUSTER=1`` is set."""
    return os.environ.get("IS_CLUSTER") == "1"


def set_global_seeds(seed: int, device="cuda") -> torch.Generator:
    """Seed python, numpy and torch's global generators, and return the
    seeded ``torch.Generator`` on ``device`` that explicit consumers (the
    train step, the samplers) draw from."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


@dataclass
class RunPaths:
    base: str
    dataset_dir: str
    output_dir: str
    checkpoint_dir: str
    tensorboard_dir: str
    wandb_dir: str
    log_dir: str

    def make_all(self) -> "RunPaths":
        for p in (self.output_dir, self.checkpoint_dir,
                  self.tensorboard_dir, self.wandb_dir, self.log_dir):
            os.makedirs(p, exist_ok=True)
        return self


def resolve_paths(cfg: Config) -> RunPaths:
    """Per-run directories keyed by experiment/run/task:
    ``<base>/<output_dir>/<task>/experiment_<E>_run_<R>/...`` with the base
    ``cfg.paths.cluster_base`` when ``IS_CLUSTER=1``, else
    ``cfg.paths.local_base``."""
    base = cfg.paths.cluster_base if is_cluster() else cfg.paths.local_base
    run_key = f"experiment_{cfg.experiment_id}_run_{cfg.run_id}"
    out = os.path.join(base, cfg.paths.output_dir, cfg.task, run_key)
    return RunPaths(
        base=base,
        dataset_dir=os.path.join(base, cfg.paths.dataset_subdir),
        output_dir=out,
        checkpoint_dir=os.path.join(out, cfg.paths.checkpoint_dir),
        tensorboard_dir=os.path.join(out, cfg.paths.tensorboard_dir),
        wandb_dir=os.path.join(out, cfg.paths.wandb_dir),
        log_dir=out,
    )
