"""Parallel modes on ``torch.distributed``: data parallelism (``mesh``),
tensor parallelism (``tp``), FSDP (``fsdp``), ring attention (``cp``),
ensemble parallelism for SuperDiff (``ep``) and the two-stage pipeline
(``pp``). Port of ``superdiff_tpu/parallel/``."""

from superdiff_torch.parallel.mesh import (
    make_mesh, batch_sharding, replicated_sharding, shard_batch,
    shard_sample, maybe_init_distributed, DATA_AXIS, MODEL_AXIS)
from superdiff_torch.parallel.tp import (
    param_shardings, shard_params, state_shardings, shard_state)
from superdiff_torch.parallel import fsdp
from superdiff_torch.parallel import cp
from superdiff_torch.parallel import ep
from superdiff_torch.parallel import pp

__all__ = ["make_mesh", "batch_sharding", "replicated_sharding",
           "shard_batch", "shard_sample", "maybe_init_distributed",
           "DATA_AXIS", "MODEL_AXIS",
           "param_shardings", "shard_params", "state_shardings",
           "shard_state", "fsdp", "cp", "ep", "pp"]
