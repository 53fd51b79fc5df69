"""Fused GroupNorm(+FiLM)+SiLU: the hand-written CUDA kernel (B4) and its
plain version.

Port of ``superdiff_tpu/ops/fused_norm.py``: the TPU kernel
``_gn_silu_kernel`` becomes ``csrc/group_norm_silu.cu`` (CUDA C++ for
``sm_90a``, built and bound by ``ops/_build.py``), tied to the plain
version's autograd by :class:`GroupNormSiLUFn` as the reference ties its
kernel to ``_xla_gn_silu`` with ``jax.custom_vjp``: the TPU kernel has no
backward kernel, so neither has the port.

Contract of :func:`fused_groupnorm_silu`: ``x (B, H, W, C)`` NHWC, float32 or
bfloat16 (contiguous on the card); ``gamma``, ``beta`` ``(C,)``; ``scale``,
``shift`` ``(B, C)`` or both ``None``; the small vectors are used in
float32. Output in ``x``'s dtype. Statistics are float32 (``E[x^2] -
E[x]^2`` clamped at 0), the FMA and the SiLU float32 too.

A CUDA tensor launches the kernel or raises; a CPU tensor takes
:func:`gn_silu_plain`. There is no switch that sends a CUDA tensor to the
plain version (the reference's ``SUPERDIFF_TPU_DISABLE_PALLAS`` and its
``H*W >= 256`` rule were TPU heuristics). ``launches`` counts kernel
launches (one per call: the three passes of the kernel are one launch of
B4 here), ``launches_by_shape`` by ``(H, W, C, G, film, dtype name)``, and
``captured_by_shape`` those of them recorded into a CUDA graph (made under
stream capture), which the graph's replays launch again unseen here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from superdiff_torch.ops import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_ELEMS_PER_STEP = 4096     # one block iteration's shared-memory slots
_TARGET_BLOCKS = 1024          # ~8 blocks per SM of the 132

launches = 0                   # kernel launches since the last reset
launches_by_shape = {}         # (H, W, C, G, film, dtype name) -> launches
captured_by_shape = {}         # the same, of launches made under capture


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()
    captured_by_shape.clear()


def _geometry(B: int, hw: int, C: int, elem_size: int, aligned: bool):
    """Launch geometry of the kernel: ``(vec, threads, iters, tiles)``.

    ``vec`` elements per load (16 bytes when the flat per-sample length
    ``hw*C`` and the address allow it, else 1); ``threads * vec`` is
    ``C * 2^p`` so that each thread owns fixed channels and the block's
    shared-memory tree folds a power of two of slots per channel;
    ``tiles`` blocks per sample, ``iters`` block iterations each."""
    n = hw * C
    vec = 16 // elem_size
    if n % vec or not aligned:
        vec = 1
    step = C                    # elements per block step: C * 2^p
    while step % vec:
        step *= 2
    while step // vec < 256 and step * 2 <= _MAX_ELEMS_PER_STEP:
        step *= 2
    threads = step // vec
    if step > _MAX_ELEMS_PER_STEP or threads > 1024:
        raise ValueError(f"group norm kernel takes at most "
                         f"{_MAX_ELEMS_PER_STEP} elements per block step; "
                         f"C={C} needs {step}")
    steps = -(-n // step)
    tiles = max(1, min(steps, -(-_TARGET_BLOCKS // B)))
    iters = -(-steps // tiles)
    tiles = -(-steps // iters)
    return vec, threads, iters, tiles


def _validate(x, gamma, beta, num_groups, scale, shift):
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    B, _, _, C = x.shape
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f"C={C} not divisible by num_groups={num_groups}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"gamma and beta must be ({C},), got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    if scale is not None and (scale.shape != (B, C) or shift.shape != (B, C)):
        raise ValueError(f"scale and shift must be ({B}, {C}), got "
                         f"{tuple(scale.shape)}, {tuple(shift.shape)}")


def gn_silu_plain(x, gamma, beta, num_groups: int, scale=None, shift=None,
                  eps: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version (the counterpart of ``_xla_gn_silu``):
    float32 statistics, GroupNorm affine and FiLM folded into one multiplier
    and offset per (sample, channel), ``y * sigmoid(y)``, cast to
    ``out_dtype`` (default ``x``'s dtype)."""
    B, H, W, C = x.shape
    gw = C // num_groups
    x32 = x.float()
    xg = x32.reshape(B, H * W, num_groups, gw)
    mean = xg.mean(dim=(1, 3))                                  # (B, G)
    mean2 = (xg * xg).mean(dim=(1, 3))
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mean_c = mean.repeat_interleave(gw, dim=-1)                 # (B, C)
    inv_c = torch.rsqrt(var + eps).repeat_interleave(gw, dim=-1)
    mul = inv_c * gamma.float()
    off = beta.float() - mean_c * mul
    if scale is not None:
        fs = 1.0 + scale.float()
        mul = mul * fs
        off = off * fs + shift.float()
    y = x32 * mul[:, None, None, :] + off[:, None, None, :]
    return (y * torch.sigmoid(y)).to(out_dtype or x.dtype)


def _load():
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.load("gn", {"superdiff_gn_silu": (
        [ptr] * 7 + [i32, ctypes.c_longlong] + [i32] * 7
        + [ctypes.c_float, ptr])})


def _f32(a):
    return None if a is None else a.detach().float().contiguous()


def _gn_silu_cuda(x, gamma, beta, num_groups, scale, shift, eps):
    B, H, W, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group norm kernel takes bfloat16/float32, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group norm kernel needs a contiguous NHWC x")
    vec, threads, iters, tiles = _geometry(
        B, H * W, C, x.element_size(), x.data_ptr() % 16 == 0)
    gamma, beta, scale, shift = map(_f32, (gamma, beta, scale, shift))
    y = torch.empty_like(x)
    work = torch.empty(2 * B * C * (tiles + 1), dtype=torch.float32,
                       device=x.device)
    opt = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(x.device):
        err = _load().superdiff_gn_silu(
            x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            opt(scale), opt(shift), work.data_ptr(), B, H * W, C,
            num_groups, _DTYPE_CODE[x.dtype], vec, threads, iters, tiles,
            eps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_silu launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, G={num_groups}, "
                           f"{x.dtype})")
    global launches
    launches += 1
    key = (H, W, C, num_groups, scale is not None,
           str(x.dtype).replace("torch.", ""))
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    if torch.cuda.is_current_stream_capturing():
        captured_by_shape[key] = captured_by_shape.get(key, 0) + 1
    return y


def _gn_silu(x, gamma, beta, num_groups, scale, shift, eps):
    """The kernel on CUDA, the plain version on CPU."""
    if x.is_cuda:
        return _gn_silu_cuda(x, gamma, beta, num_groups, scale, shift, eps)
    if x.device.type != "cpu":
        raise ValueError(f"group norm runs on cuda or cpu, not {x.device}")
    return gn_silu_plain(x, gamma, beta, num_groups, scale, shift, eps)


class GroupNormSiLUFn(torch.autograd.Function):
    """The kernel's forward with autograd of :func:`gn_silu_plain` as the
    backward (``_fused_vjp`` / ``_fused_bwd`` of the reference)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, num_groups, eps):
        ctx.save_for_backward(x, gamma, beta, scale, shift)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _gn_silu(x, gamma, beta, num_groups, scale, shift, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if a is None else a.detach().requires_grad_(need)
                      for a, need in zip(inputs, ctx.needs_input_grad)]
            y = gn_silu_plain(*leaves[:3], ctx.num_groups, *leaves[3:],
                              eps=ctx.eps)
            wanted = [a for a in leaves if a is not None and a.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g))
        return (*(next(grads) if a is not None and a.requires_grad else None
                  for a in leaves), None, None)


def fused_groupnorm_silu(x: torch.Tensor,
                         gamma: torch.Tensor,
                         beta: torch.Tensor,
                         num_groups: int,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """``SiLU(FiLM(GroupNorm(x)))`` in one pass, differentiable: the kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    _validate(x, gamma, beta, num_groups, scale, shift)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, gamma, beta, scale, shift)):
        return GroupNormSiLUFn.apply(x, gamma, beta, scale, shift,
                                     num_groups, eps)
    return _gn_silu(x, gamma, beta, num_groups, scale, shift, eps)
