"""Fully-sharded data parallelism: FSDP2 over the ``data`` axis.

Port of ``superdiff_tpu/parallel/fsdp.py``. The JAX package annotates each
TrainState leaf with a sharding over ``data`` and lets GSPMD insert the
all-gathers and reduce-scatters; here ``fully_shard`` (FSDP2) does that for
the model and for its EMA copy, one unit per ResBlock, attention block,
resampler and the time MLP, the rest in the root unit. Adam's ``mu`` and
``nu`` take their parameter's placement, so every mirror keeps ``1/n`` of
its bytes per rank.

Which dim each leaf shards on follows the JAX rule (``spec_for_leaf``):
the last dim, in the JAX layout, that the axis size divides and that the
tensor-parallel split left free, mapped to the PyTorch layout: JAX's HWIO
``Cout`` is dim 0 of OIHW, a Dense ``(in, out)`` is ``nn.Linear``'s dim 0,
``class_emb`` ``(N, dim)`` keeps dim 1.

Difference by design: where JAX replicates a leaf that no dim divides,
FSDP2 shards every leaf it manages; such a leaf takes dim 0 in unequal
chunks (:func:`padded_leaves` lists them).

With ``tensor_parallel=True`` the ``(data, model)`` mesh carries both: the
ResBlocks are first split over ``model`` (``parallel/tp.py``), then each
rank's slices are sharded over ``data`` on a dim the split left free.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from superdiff_torch.parallel import tp as _tp
from superdiff_torch.parallel.mesh import DATA_AXIS, Mesh

# PyTorch dim of each JAX dim, by module type: conv HWIO -> OIHW, Dense
# (in, out) -> Linear (out, in); others keep their layout
_JAX_TO_TORCH = {nn.Conv2d: (2, 3, 1, 0), nn.Linear: (1, 0)}


def spec_for_leaf(shape, jax_to_torch, n: int,
                  taken: Optional[int] = None) -> Optional[int]:
    """The PyTorch dim the JAX rule shards a leaf of ``shape`` (PyTorch
    layout) on over ``n`` ranks: the last JAX dim that ``n`` divides and
    that is not ``taken`` (the tensor-parallel dim); None when none does
    (or ``n`` is 1)."""
    if n <= 1 or not shape:
        return None
    order = jax_to_torch or tuple(range(len(shape)))
    for jdim in range(len(shape) - 1, -1, -1):
        d = order[jdim]
        if d != taken and shape[d] % n == 0 and shape[d] >= n:
            return d
    return None


def _kinds(model) -> Dict[str, tuple]:
    out = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            out[full] = (_JAX_TO_TORCH.get(type(mod))
                         if pname == "weight" else None)
    return out


def param_shardings(model, mesh: Mesh, tensor_parallel: bool = False
                    ) -> Dict[str, Optional[int]]:
    """``{parameter name: dim sharded over data, or None}`` for the unsplit
    ``model`` (JAX's rule, composed with the tensor-parallel split when
    ``tensor_parallel``)."""
    n = mesh.shape[DATA_AXIS]
    taken = (_tp.param_shardings(model, mesh) if tensor_parallel else {})
    kinds = _kinds(model)
    return {name: spec_for_leaf(tuple(p.shape), kinds[name], n,
                                taken.get(name))
            for name, p in model.named_parameters()}


def padded_leaves(model, mesh: Mesh, tensor_parallel: bool = False
                  ) -> List[str]:
    """The leaves JAX replicates (no dim divides) and FSDP2 shards on dim 0
    in unequal chunks here."""
    if mesh.shape[DATA_AXIS] <= 1:
        return []
    return [n for n, d in param_shardings(model, mesh,
                                          tensor_parallel).items()
            if d is None]


def state_shardings(state, mesh: Mesh, tensor_parallel: bool = False):
    """The layout of ``state`` (taken before :func:`shard_state`) for
    ``make_train_step(state_shardings=)``."""
    dims = param_shardings(state.model, mesh, tensor_parallel)
    model_dims = (_tp.param_shardings(state.model, mesh) if tensor_parallel
                  else {n: None for n in dims})
    return _tp.StateShardings(mesh, model_dims,
                              {n: (0 if d is None else d)
                               for n, d in dims.items()})


_UNITS = ("ResBlock", "SelfAttention2D", "Downsample", "Upsample",
          "TimeEmbeddingMLP")


def _fully_shard(model, mesh: Mesh, dims: Dict[str, int]):
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = {id(p): n for n, p in model.named_parameters()}
    dm = mesh.device_mesh[DATA_AXIS]

    def place(p):
        return Shard(dims[names[id(p)]])

    for mod in model.children():
        if type(mod).__name__ in _UNITS:
            fully_shard(mod, mesh=dm, shard_placement_fn=place)
    fully_shard(model, mesh=dm, shard_placement_fn=place)


@torch.no_grad()
def shard_state(state, mesh: Mesh, tensor_parallel: bool = False):
    """Shard ``state`` in place over ``data`` (after the tensor-parallel
    split over ``model`` when ``tensor_parallel``): the model and its EMA
    copy under FSDP2, ``mu`` / ``nu`` as DTensors of their parameter's
    placement. Returns ``state``."""
    from torch.distributed.tensor import Shard, distribute_tensor

    if mesh.device_mesh is None:
        raise ValueError("FSDP needs a process group (make_mesh under "
                         "SUPERDIFF_TPU_MULTIHOST=1)")
    sh = state_shardings(state, mesh, tensor_parallel)
    if tensor_parallel:
        _tp.shard_state(state, mesh)
    names = [n for n, _ in state.model.named_parameters()]
    _fully_shard(state.model, mesh, sh.data_dims)
    _fully_shard(state.ema_model, mesh, sh.data_dims)
    dm = mesh.device_mesh[DATA_AXIS]
    for key in ("mu", "nu"):
        state.opt_state[key] = [
            distribute_tensor(a, dm, [Shard(sh.data_dims[n])])
            for n, a in zip(names, state.opt_state[key])]
    state.params = list(state.model.parameters())
    state.ema_params = list(state.ema_model.parameters())
    return state


def gather_state(state, mesh: Mesh, shardings):
    """The whole state, ``{"params", "ema_params", "mu", "nu"}`` of ``{name:
    tensor}`` (``shardings`` from :func:`state_shardings`)."""
    return _tp.gather_state(state, mesh, shardings)
