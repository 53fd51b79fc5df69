"""One metrics interface fanning out to jsonl / TensorBoard / wandb.

Port of ``superdiff_tpu/utils/metrics.py``: a single ``log(step, values)``
reaches every enabled sink. jsonl needs nothing; tensorboard and wandb are
imported only when asked for, and a missing package degrades to a warning.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("superdiff_torch")


class MetricsLogger:
    def __init__(self,
                 jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None,
                 wandb_dir: Optional[str] = None):
        self._jsonl = None
        self._tb = None
        self._wandb = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a", buffering=1)
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # pragma: no cover - env dependent
                logger.warning("tensorboard unavailable: %s", e)
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project,
                                         name=wandb_run_name,
                                         dir=wandb_dir)
            except Exception as e:  # pragma: no cover - env dependent
                logger.warning("wandb unavailable: %s", e)

    def log(self, step: int, values: Dict[str, float]) -> None:
        values = {k: float(v) for k, v in values.items()}
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": int(step), "time": time.time(), **values}) + "\n")
        if self._tb:
            for k, v in values.items():
                self._tb.add_scalar(k, v, int(step))
        if self._wandb:
            self._wandb.log(values, step=int(step))

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
        if self._wandb:
            self._wandb.finish()
