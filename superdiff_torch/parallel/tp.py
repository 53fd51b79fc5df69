"""Tensor parallelism for the CondUNet: Megatron's conv pair, with explicit
collectives over the ``model`` axis.

Port of ``superdiff_tpu/parallel/tp.py``. The JAX package annotates
shardings and lets GSPMD insert the collectives; here each rank holds its
slices as plain tensors and the ResBlock calls the collectives itself
(``models/layers.py::ResBlock`` with ``tp`` set to a :class:`TPShard`):

- ``conv_0`` is split by output channel (column-parallel), ``norm_1`` by
  channel (its ``G/m`` groups are whole groups, so the statistics stay
  local), ``conv_1`` by input channel (row-parallel): its partial sums are
  closed by one all-reduce, and its bias is added once, after it;
- the FiLM scale/shift from the replicated ``emb_proj`` are sliced to the
  local channels;
- everything else is replicated. Where activations enter the split part
  (the input of ``conv_0`` and the FiLM vector) the backward sums the
  gradient over the axis (Megatron's "copy to the parallel region"), so
  every replicated parameter gets its whole gradient on every rank.

Guard: a ResBlock is split only when its output channels and its
``norm_1`` group count both divide by the axis size; otherwise its
GroupNorm statistics would span shards, and the block stays replicated
(JAX drops a leaf's split when its axis does not divide, ``_guarded``).

The rules key on module names (``conv_0`` / ``norm_1`` / ``conv_1`` exist
only inside ResBlocks), so one function slices the parameters, the EMA
copy and Adam's ``mu`` / ``nu``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from superdiff_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

# the split dim (PyTorch layouts: conv OIHW, vectors) of each split leaf
_SPLIT = {("conv_0", "weight"): 0, ("conv_0", "bias"): 0,
          ("norm_1", "weight"): 0, ("norm_1", "bias"): 0,
          ("conv_1", "weight"): 1}


class _CopyToParallel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromParallel(torch.autograd.Function):
    """Sum over the axis forward; identity backward (the output, and so its
    gradient, is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class TPShard:
    """One rank's part of a split ResBlock: channels ``[lo, hi)`` of
    ``size`` equal parts, collectives over ``group`` (None: no collective,
    for running the parts one after another in one process)."""

    def __init__(self, rank: int, size: int, channels: int, group=None):
        self.rank, self.size, self.group = rank, size, group
        per = channels // size
        self.lo, self.hi = rank * per, (rank + 1) * per

    def local(self, a: torch.Tensor) -> torch.Tensor:
        """The local channels of a ``(..., C)`` tensor."""
        return a[..., self.lo:self.hi]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None or not torch.is_grad_enabled():
            return x
        return _CopyToParallel.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's partial ``x``."""
        if self.group is None:
            return x
        return _ReduceFromParallel.apply(x, self.group)


def _leaf_split(name: str) -> Optional[int]:
    parts = name.split(".")
    return _SPLIT.get(tuple(parts[-2:])) if len(parts) >= 2 else None


def split_blocks(model, m: int) -> Dict[str, bool]:
    """``{ResBlock name: split}`` for every ResBlock of ``model``: split
    when its output channels and its ``norm_1`` group count divide by
    ``m`` (the guard)."""
    from superdiff_torch.models.layers import ResBlock

    return {name: (m > 1 and mod.conv_0.out_channels % m == 0
                   and mod.norm_1.num_groups % m == 0)
            for name, mod in model.named_modules()
            if isinstance(mod, ResBlock)}


def param_shardings(model, mesh: Mesh) -> Dict[str, Optional[int]]:
    """``{parameter name: dim split over model, or None}`` of an unsplit
    ``model`` (or any mirror of it with the same names)."""
    m = mesh.shape[MODEL_AXIS]
    blocks = split_blocks(model, m)
    out = {}
    for name, _ in model.named_parameters():
        block = name.rsplit(".", 2)[0]
        out[name] = _leaf_split(name) if blocks.get(block) else None
    return out


def _slice(a: torch.Tensor, dim: int, shard: TPShard) -> torch.Tensor:
    per = a.shape[dim] // shard.size
    return a.narrow(dim, shard.rank * per, per).clone()


@torch.no_grad()
def shard_params(model, mesh: Mesh, rank: Optional[int] = None,
                 group=None):
    """Split ``model``'s ResBlocks in place for this rank (``rank`` /
    ``group`` override the mesh's, to build every rank's part in one
    process); returns ``model``."""
    from superdiff_torch.models.layers import ResBlock

    m = mesh.shape[MODEL_AXIS]
    rank = mesh.rank(MODEL_AXIS) if rank is None else rank
    group = mesh.group(MODEL_AXIS) if group is None else group
    for name, split in split_blocks(model, m).items():
        if not split:
            continue
        block: ResBlock = model.get_submodule(name)
        shard = TPShard(rank, m, block.conv_0.out_channels, group)
        for (mod, leaf), dim in _SPLIT.items():
            owner = getattr(block, mod)
            p = getattr(owner, leaf)
            setattr(owner, leaf, torch.nn.Parameter(
                _slice(p.data, dim, shard), requires_grad=p.requires_grad))
        block.norm_1.num_groups //= m
        block.conv_0.out_channels //= m
        block.conv_1.in_channels //= m
        block.tp = shard
    return model


def _names(model):
    return [n for n, _ in model.named_parameters()]


@dataclass
class StateShardings:
    """How a TrainState is laid out over a mesh, for
    ``training/steps.py::make_train_step(state_shardings=)``: per parameter
    name, the dim split over ``model`` (tensor parallelism) and the dim
    sharded over ``data`` (FSDP), or None."""
    mesh: Mesh
    model_dims: Dict[str, Optional[int]]
    data_dims: Dict[str, Optional[int]] = field(default_factory=dict)

    @property
    def fsdp(self) -> bool:
        return any(d is not None for d in self.data_dims.values())

    def axes(self, name: str):
        """The axes ``name``'s leaf is split over (its gradient norm sums
        over them)."""
        return tuple(a for a, dims in ((DATA_AXIS, self.data_dims),
                                       (MODEL_AXIS, self.model_dims))
                     if dims.get(name) is not None)


def state_shardings(state, mesh: Mesh) -> StateShardings:
    """The tensor-parallel layout of ``state`` (taken before
    :func:`shard_state`). Pass it to ``make_train_step``."""
    return StateShardings(mesh, param_shardings(state.model, mesh))


@torch.no_grad()
def shard_state(state, mesh: Mesh):
    """Split ``state`` in place for this rank: the model, its EMA copy and
    Adam's ``mu`` / ``nu`` keep this rank's slices. Returns ``state``."""
    dims = param_shardings(state.model, mesh)
    m, r = mesh.shape[MODEL_AXIS], mesh.rank(MODEL_AXIS)
    names = _names(state.model)
    for key in ("mu", "nu"):
        state.opt_state[key] = [
            a if dims[n] is None else
            a.narrow(dims[n], r * (a.shape[dims[n]] // m),
                     a.shape[dims[n]] // m).clone()
            for n, a in zip(names, state.opt_state[key])]
    shard_params(state.model, mesh)
    shard_params(state.ema_model, mesh)
    state.params = list(state.model.parameters())
    state.ema_params = list(state.ema_model.parameters())
    return state


def gather_leaf(a: torch.Tensor, dim: Optional[int], mesh: Mesh):
    """The whole leaf from every rank's slice along ``model``."""
    if dim is None or mesh.device_mesh is None:
        return a
    from superdiff_torch.parallel.mesh import gather_rows

    return gather_rows(a, mesh, axis=MODEL_AXIS, dim=dim)


@torch.no_grad()
def gather_state(state, mesh: Mesh, shardings: StateShardings):
    """The whole state from the ranks' slices: ``{"params", "ema_params",
    "mu", "nu"}``, each ``{name: tensor}`` (for comparison and
    checkpoints)."""
    from torch.distributed.tensor import DTensor

    names = _names(state.model)
    lists = {"params": state.params, "ema_params": state.ema_params,
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    out = {}
    for key, leaves in lists.items():
        out[key] = {}
        for n, a in zip(names, leaves):
            if isinstance(a, DTensor):          # FSDP's shards over data
                a = a.full_tensor()
            out[key][n] = gather_leaf(a, shardings.model_dims.get(n), mesh)
    return out
