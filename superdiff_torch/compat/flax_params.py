"""Weight bridge between Flax parameter trees and torch ``state_dict``s.

Layout rules (the inverse of ``superdiff_tpu/compat/torch_import.py``):

- Conv ``kernel (kh, kw, I, O)``  <->  ``weight (O, I, kh, kw)``
- Dense ``kernel (in, out)``      <->  ``weight (out, in)``
- GroupNorm ``scale``             <->  ``weight``
- Embed ``embedding``             <->  ``weight``
- every ``bias`` carries over.

Module paths map one to one (``down_0_block_0/conv_0`` <->
``down_0_block_0.conv_0``) because the port's submodules carry the Flax
names. Also a numpy-only reader and writer for the ``ema_params.npz``
export format of ``superdiff_tpu/cli/export.py``: flattened ``a/b/c`` keys,
with bfloat16 arrays stored as their uint16 bit pattern under a
``bf16:``-prefixed key; and the two-way bridge between a JAX ``TrainState``
given as numpy arrays and the port's ``TrainState``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

EXPORT_FILE = "ema_params.npz"
BF16_PREFIX = "bf16:"


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _unflatten(flat: Mapping[tuple, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.array(a))     # a writable copy


def torch_key(path: tuple, ndim: int):
    """Flax leaf path + ndim -> (torch state_dict key, permutation that
    takes the Flax array to the torch layout, or None)."""
    mod, name = ".".join(path[:-1]), path[-1]
    if name == "kernel" and ndim == 4:
        return f"{mod}.weight", (3, 2, 0, 1)
    if name == "kernel" and ndim == 2:
        return f"{mod}.weight", (1, 0)
    if name in ("scale", "embedding"):
        return f"{mod}.weight", None
    if name == "bias":
        return f"{mod}.bias", None
    raise KeyError(f"no torch counterpart for Flax leaf {'/'.join(path)} "
                   f"(ndim {ndim})")


def _strip_params(tree: Mapping) -> Mapping:
    return tree["params"] if set(tree.keys()) == {"params"} else tree


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy arrays or torch tensors, with or without the
    top ``"params"`` level) -> torch ``state_dict`` (CPU tensors)."""
    sd = {}
    for path, leaf in _flatten(_strip_params(params)).items():
        a = _as_tensor(leaf)
        key, perm = torch_key(path, a.ndim)
        sd[key] = (a.permute(*perm) if perm else a).contiguous()
    return sd


def random_params(shapes: Mapping, seed: int = 0) -> Dict[str, Any]:
    """Seeded float32 numpy values for every leaf of a Flax-layout tree of
    anything with a ``.shape`` (``jax.eval_shape`` output, or
    :func:`flax_shapes` of a model): kernels N(0, 1/fan_in),
    embeddings N(0, 1), norm scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1).
    Leaves are drawn in sorted path order, so the same tree gives the same
    values whichever package described it. No layer is left at its zero
    initialisation, so every layer reaches the output."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in sorted(_flatten(_strip_params(shapes)).items()):
        shape = tuple(leaf.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if path[-1] == "kernel":
            z /= np.sqrt(np.prod(shape[:-1]))
        elif path[-1] == "scale":
            z = 1.0 + 0.1 * z
        elif path[-1] == "bias":
            z *= 0.1
        flat[path] = z.astype(np.float32)
    return _unflatten(flat)


def flax_path(key: str, ndim: int, embeds=frozenset()):
    """torch state_dict key + ndim -> (Flax leaf path, permutation that
    takes the torch shape to the Flax one, or None). A 1-D ``weight`` is a
    GroupNorm ``scale`` unless its module is in ``embeds``."""
    mod, name = key.rsplit(".", 1)
    prefix = tuple(mod.split("."))
    if name == "bias":
        return prefix + ("bias",), None
    if ndim == 4:
        return prefix + ("kernel",), (2, 3, 1, 0)
    if mod in embeds:
        return prefix + ("embedding",), None
    if ndim == 2:
        return prefix + ("kernel",), (1, 0)
    if ndim == 1:
        return prefix + ("scale",), None
    raise KeyError(f"no Flax counterpart for {key} (ndim {ndim})")


def flax_shapes(model: torch.nn.Module) -> Dict[str, Any]:
    """The Flax parameter tree of ``model`` as shape-only leaves (works on
    the ``meta`` device): feed it to :func:`random_params`."""
    embeds = frozenset(n for n, m in model.named_modules()
                       if isinstance(m, torch.nn.Embedding))
    flat = {}
    for key, t in model.state_dict().items():
        path, perm = flax_path(key, t.ndim, embeds)
        shape = tuple(t.shape[i] for i in perm) if perm else tuple(t.shape)
        flat[path] = _Shape(shape)
    return _unflatten(flat)


class _Shape:
    """A shape-only leaf (what :func:`random_params` reads)."""

    def __init__(self, shape):
        self.shape = shape


def load_state_dict(model: torch.nn.Module, params: Mapping) -> None:
    """Load a Flax tree into ``model``, strictly: every key and every shape
    must match, or this raises."""
    sd = from_flax(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    bad = sorted(k for k in set(own) & set(sd)
                 if tuple(own[k].shape) != tuple(sd[k].shape))
    if missing or extra or bad:
        raise ValueError(
            f"parameter tree does not match the model: missing {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}, unexpected {extra[:8]}"
            f"{'...' if len(extra) > 8 else ''}, shape mismatch "
            + ", ".join(f"{k} {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
                        for k in bad[:8]))
    model.load_state_dict(sd, strict=True)


def to_flax(model: torch.nn.Module,
            state_dict: Mapping = None) -> Dict[str, Any]:
    """``model``'s parameters (or another ``state_dict`` with its keys) as a
    Flax-layout tree of float32 numpy arrays: the inverse of
    :func:`from_flax`."""
    embeds = frozenset(n for n, m in model.named_modules()
                       if isinstance(m, torch.nn.Embedding))
    flat = {}
    for key, t in (state_dict or model.state_dict()).items():
        path, perm = flax_path(key, t.ndim, embeds)
        a = t.detach().float().cpu()
        flat[path] = (a.permute(*perm) if perm else a).contiguous().numpy()
    return _unflatten(flat)


def _leaf_list(model: torch.nn.Module, tree: Mapping) -> list:
    """A Flax-layout tree as tensors in ``model.parameters()`` order and the
    torch layout."""
    sd = from_flax(tree)
    return [sd[name] for name, _ in model.named_parameters()]


def _leaf_tree(model: torch.nn.Module, tensors) -> Dict[str, Any]:
    return to_flax(model, {name: t for (name, _), t in
                           zip(model.named_parameters(), tensors)})


def train_state_from_numpy(state, arrays: Mapping) -> None:
    """Load a JAX ``TrainState`` given as numpy arrays into the port's
    ``TrainState`` ``state``, in place: ``params`` and ``ema_params`` (Flax
    trees), the Adam part of the optax state as ``mu`` / ``nu`` (Flax trees)
    and ``count``, and ``step``. For ``chain(clip_by_global_norm, adam)`` the
    optax state is a tuple: pass its Adam element's fields. The generator
    has no counterpart across frameworks and is left alone."""
    load_state_dict(state.model, arrays["params"])
    load_state_dict(state.ema_model, arrays["ema_params"])
    with torch.no_grad():
        for name in ("mu", "nu"):
            for dst, src in zip(state.opt_state[name],
                                _leaf_list(state.model, arrays[name])):
                dst.copy_(src)
    state.opt_state["count"] = int(arrays["count"])
    state.step = int(arrays["step"])


def train_state_to_numpy(state) -> Dict[str, Any]:
    """The inverse of :func:`train_state_from_numpy`."""
    return {"params": to_flax(state.model),
            "ema_params": to_flax(state.ema_model),
            "mu": _leaf_tree(state.model, state.opt_state["mu"]),
            "nu": _leaf_tree(state.model, state.opt_state["nu"]),
            "count": int(state.opt_state["count"]),
            "step": int(state.step)}


# ----------------------------------------------------------------- npz I/O

def export_params(params: Mapping, path: str, dtype: str = "float32") -> int:
    """Flatten a Flax param tree into one compressed npz (the
    ``cli/export.py`` format); returns the number of arrays. bfloat16 is
    stored as the uint16 bit pattern under a ``bf16:`` key."""
    arrays = {}
    for p, v in _flatten(params).items():
        k = "/".join(p)
        if dtype == "bfloat16":
            bits = _as_tensor(v).to(torch.bfloat16).view(torch.int16)
            arrays[BF16_PREFIX + k] = bits.numpy().view(np.uint16)
        elif isinstance(v, torch.Tensor):
            arrays[k] = v.detach().float().cpu().numpy().astype(dtype)
        else:
            arrays[k] = np.asarray(v).astype(dtype)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)
    return len(arrays)


def load_exported_params(path: str) -> Dict[str, Any]:
    """npz -> nested param tree (inverse of :func:`export_params`). bf16
    leaves come back as ``torch.bfloat16`` tensors (numpy has no bfloat16),
    the rest as numpy arrays."""
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            if k.startswith(BF16_PREFIX):
                k = k[len(BF16_PREFIX):]
                a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            flat[tuple(k.split("/"))] = a
    return _unflatten(flat)
