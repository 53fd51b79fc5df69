"""File + stdout logging (port of ``superdiff_tpu/utils/logger.py``)."""

from __future__ import annotations

import logging
import os
from typing import Optional

LOGGER_NAME = "superdiff_torch"


def init_logger(log_dir: Optional[str] = None,
                stdout: bool = True,
                level: int = logging.DEBUG) -> logging.Logger:
    """DEBUG file handler (``training.log``) + optional INFO stdout handler;
    handlers are reset on re-init so repeated calls don't duplicate lines."""
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "training.log"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if stdout:
        sh = logging.StreamHandler()
        sh.setLevel(logging.INFO)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.propagate = False
    return logger
