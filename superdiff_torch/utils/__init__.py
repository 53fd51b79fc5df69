from superdiff_torch.utils.env import (
    RunPaths, is_cluster, resolve_paths, set_global_seeds)
from superdiff_torch.utils.logger import init_logger
from superdiff_torch.utils.metrics import MetricsLogger

__all__ = ["is_cluster", "set_global_seeds", "resolve_paths", "RunPaths",
           "init_logger", "MetricsLogger"]
