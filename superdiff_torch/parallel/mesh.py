"""Process group, device mesh and the data-parallel helpers.

Port of ``superdiff_tpu/parallel/mesh.py`` onto ``torch.distributed``: one
process per card (``nccl``) or per CPU worker (``gloo``), a ``(data,
model)`` :class:`Mesh` over the group's ranks, and explicit collectives
where the JAX package lets GSPMD insert them.

Data parallelism here keeps the JAX package's semantics, where one key
draws a global array: every rank draws the *global* batch's random numbers
(initial and per-step sampler noise, the train step's draws) from the same
generator and keeps its own rows, so a data-parallel run equals the
single-process run row for row, whatever the world size.

Launch: ``SUPERDIFF_TPU_MULTIHOST=1`` plus either the explicit triple
``SUPERDIFF_TPU_COORDINATOR`` (``host:port``), ``SUPERDIFF_TPU_NUM_PROCESSES``
and ``SUPERDIFF_TPU_PROCESS_ID``, or torchrun's ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``. Each process binds the card of its
``LOCAL_RANK`` (else its rank modulo the cards of the host).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def maybe_init_distributed(device="cuda", timeout_s: float = 600.0) -> bool:
    """Join the process group when ``SUPERDIFF_TPU_MULTIHOST=1`` (no-op
    otherwise, or when a group already exists); safe to call at every CLI
    entry. The backend follows ``device``: ``nccl`` for a CUDA device,
    ``gloo`` for the CPU. ``timeout_s`` bounds every collective. Returns
    whether this call joined (the caller then leaves with
    :func:`leave_distributed`)."""
    if os.environ.get("SUPERDIFF_TPU_MULTIHOST") != "1":
        return False
    if dist.is_initialized():
        return False
    coord = os.environ.get("SUPERDIFF_TPU_COORDINATOR")
    if coord:
        nproc = os.environ.get("SUPERDIFF_TPU_NUM_PROCESSES")
        pid = os.environ.get("SUPERDIFF_TPU_PROCESS_ID")
        if nproc is None or pid is None:
            raise ValueError(
                "SUPERDIFF_TPU_COORDINATOR requires SUPERDIFF_TPU_NUM_"
                "PROCESSES and SUPERDIFF_TPU_PROCESS_ID to be set too")
        init, world, rank = f"tcp://{coord}", int(nproc), int(pid)
    else:
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    elif dev.type != "cpu":
        raise ValueError(f"distributed runs on cuda or cpu, not {dev}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def leave_distributed(joined: bool) -> None:
    """Leave the process group if :func:`maybe_init_distributed` joined it
    (``joined``); a group the caller's caller made stays."""
    if joined and dist.is_initialized():
        dist.destroy_process_group()


class Mesh:
    """A ``(data, model)`` grid of processes: ``shape`` maps each axis to
    its size, ``device`` is this process's device. ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh``, None for a single process without
    a group (then every collective below is a no-op)."""

    def __init__(self, device_mesh, shape: Dict[str, int], device):
        self.device_mesh = device_mesh
        self.shape = dict(shape)
        self.device = torch.device(device)

    def group(self, axis: str):
        """The process group along ``axis`` (None without a group)."""
        return None if self.device_mesh is None \
            else self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        """This process's coordinate along ``axis``."""
        return 0 if self.device_mesh is None \
            else self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(num_devices: Optional[int] = None,
              model_parallelism: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the process group
    (``num_devices``, when given, must be its size), or the one device of a
    process without a group. ``device`` defaults to the card this process
    bound (``nccl``) or the CPU (``gloo``, no group)."""
    if not dist.is_initialized():
        n = 1 if num_devices is None else num_devices
        if n != 1 or model_parallelism != 1:
            raise ValueError(f"a mesh of {n} devices (model_parallelism="
                             f"{model_parallelism}) needs a process group; "
                             "launch with SUPERDIFF_TPU_MULTIHOST=1")
        return Mesh(None, {DATA_AXIS: 1, MODEL_AXIS: 1},
                    device or ("cuda" if torch.cuda.is_available()
                               else "cpu"))
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = world if num_devices is None else num_devices
    if n != world:
        raise ValueError(f"the mesh spans the whole process group ({world} "
                         f"processes), not {n}")
    if n % model_parallelism:
        raise ValueError(f"{n} devices not divisible by model_parallelism="
                         f"{model_parallelism}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if kind == "cuda" else "cpu")
    shape = (n // model_parallelism, model_parallelism)
    dm = init_device_mesh(kind, shape, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(dm, dict(zip((DATA_AXIS, MODEL_AXIS), shape)), device)


def batch_sharding(mesh: Mesh):
    """DTensor placements of a batch: the leading dim sharded over ``data``,
    replicated over ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated_sharding(mesh: Mesh):
    """DTensor placements of a replicated tensor."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def local_rows(batch_size: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch: a contiguous ``1/data`` slice by
    its ``data`` coordinate (ranks along ``model`` share them)."""
    n = mesh.shape[DATA_AXIS]
    if batch_size % n:
        raise ValueError(f"batch {batch_size} not divisible by {n} "
                         f"data-parallel ranks")
    per = batch_size // n
    r = mesh.rank(DATA_AXIS)
    return slice(r * per, (r + 1) * per)


def shard_batch(batch, mesh: Mesh, local: bool = False):
    """Each rank's rows of a global batch (a dict of tensors, or a tensor),
    on the mesh's device. ``local=True``: ``batch`` is already this rank's
    rows (the ``DataModule`` shards by rank) and only moves to the
    device."""
    def one(a):
        a = torch.as_tensor(a)
        if not local:
            a = a[local_rows(a.shape[0], mesh)]
        return a.to(mesh.device)

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in ``axis`` order (the
    inverse of :func:`local_rows` on ``dim``)."""
    if mesh.device_mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def all_reduce_mean(tensors: List[torch.Tensor], mesh: Mesh,
                    axis: str = DATA_AXIS) -> None:
    """Average ``tensors`` in place over ``axis``, as one flat collective
    (a sum, then a division: ``gloo`` has no average)."""
    if mesh.device_mesh is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group(axis))
    flat /= mesh.shape[axis]
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def shard_sample(sample_fn, mesh: Mesh, with_logq: bool = False):
    """Wrap a sampler whose plan draws the global batch and keeps this
    rank's rows (``rows=local_rows(B, mesh)``): ``fn(*args) -> x`` (or
    ``(x, logq)`` with ``logq (models, batch)`` when ``with_logq``),
    gathered over the ``data`` axis so the result is the global batch
    (rank 0 writes it; every rank receives it)."""
    def fn(*args, **kwargs):
        out = sample_fn(*args, **kwargs)
        if with_logq:
            x, logq = out
            return gather_rows(x, mesh), gather_rows(logq, mesh, dim=1)
        return gather_rows(out, mesh)

    return fn


def is_main_process() -> bool:
    """Rank 0 of the group, or a process without a group: the one that
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0
