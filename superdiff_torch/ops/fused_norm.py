"""Fused GroupNorm(+FiLM)+SiLU: the hand-written CUDA kernel (B4) and its
plain versions.

Port of ``superdiff_tpu/ops/fused_norm.py``: the TPU kernel
``_gn_silu_kernel`` becomes ``csrc/group_norm_silu.cu`` (CUDA C++ for
``sm_90a``, built and bound by ``ops/_build.py``). B4 computes the chain in
one of two numerics modes, each with its own plain version:

- :func:`fused_groupnorm_silu` (the RefUNet's ``GroupNormSiLU``): GroupNorm
  affine and FiLM folded into one float32 multiplier and offset per (sample,
  channel), SiLU in float32, one cast to ``x``'s dtype; plain version
  :func:`gn_silu_plain`. Under autograd the forward is the kernel and the
  backward autograd of the plain version (:class:`GroupNormSiLUFn`), as the
  reference ties its kernel to ``_xla_gn_silu`` with ``jax.custom_vjp``.
- :func:`gn_film_silu_policy` (the CondUNet's ResBlock ``norm_0`` /
  ``norm_1`` + FiLM and its ``out_norm``): the chain as the CondUNet's
  eager ops compute it under its ``norm_dtype``, with the same rounding
  points (:func:`gn_film_silu_policy_plain`). The kernel runs when no
  gradient is wanted (sampling, serving, validation); with a gradient
  wanted the plain chain runs under autograd, as it did before the model
  called B4 (the TPU kernel has no backward kernel).

Contract: ``x (B, H, W, C)`` NHWC, float32 or bfloat16 (contiguous on the
card); ``gamma``, ``beta`` ``(C,)``; ``scale``, ``shift`` ``(B, C)`` or
both ``None``; the small vectors are used in float32. Statistics are
float32 (``E[x^2] - E[x]^2`` clamped at 0).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. There is no switch that sends a CUDA tensor without a gradient to
the plain version (the reference's ``SUPERDIFF_TPU_DISABLE_PALLAS`` and its
``H*W >= 256`` rule were TPU heuristics). :func:`launch_geometry` picks the
kernel's regime per shape (one cluster launch, or the three-pass design
for batches of x above 32 MB). ``launches`` counts B4
calls (one per call, whatever the regime), ``launches_by_shape`` by ``(H,
W, C, G, film, x's dtype name)``, and ``captured_by_shape`` those of them
recorded into a CUDA graph (made under stream capture), which the graph's
replays launch again unseen here. Under ``torch.func.vmap`` (stacked
models) the policy mode goes through the registered op
``superdiff::gn_film_silu``, whose vmap rule launches B4 once per mapped
model.
"""

from __future__ import annotations

import ctypes
import functools
from collections import namedtuple
from typing import Optional

import torch
import torch.nn.functional as F

from superdiff_torch.ops import _build

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_ELEM_SIZE = {torch.bfloat16: 2, torch.float32: 4}
_MAX_ELEMS_PER_STEP = 4096     # one block iteration's shared-memory slots
_TARGET_BLOCKS = 1024          # ~8 blocks per SM of the 132
# the cluster regime (csrc/group_norm_silu.cu::gn_cluster) on the H100
_CLUSTER_SMEM = 57856          # shared memory of a block: a quarter of an SM's
_CLUSTER_THREADS = 256         # threads of a block, at most
# batches above this take the three-pass regime: the cluster regime's
# second read of x then misses L2 (measured: PERF.md)
_CLUSTER_MAX_BATCH_BYTES = 32 << 20

launches = 0                   # kernel launches since the last reset
launches_by_shape = {}         # (H, W, C, G, film, dtype name) -> launches
captured_by_shape = {}         # the same, of launches made under capture


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()
    captured_by_shape.clear()


def _geometry(B: int, hw: int, C: int, elem_size: int, aligned: bool):
    """The three-pass regime's geometry: ``(vec, threads, iters, tiles)``.

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


Geometry = namedtuple(
    "Geometry", "regime vec threads cluster iters resident tiles smem")
Geometry.__doc__ = """B4's launch: ``regime`` ``"cluster"`` or
``"three_pass"``; ``vec`` elements per load; ``threads`` per block;
``cluster`` blocks per sample (cluster regime); ``iters`` block steps per
block; ``resident`` of them held in shared memory (cluster regime); ``tiles``
blocks per sample (three-pass regime); ``smem`` dynamic shared-memory bytes
of a cluster block."""


def _cluster_fixed_bytes(step: int, C: int, G: int) -> int:
    """Shared memory of a cluster block before its resident x (the fold,
    the channel totals and the group sums, float32, 16-byte aligned; the
    copy's mbarrier), as ``cluster_fixed_bytes`` in the kernel source."""
    return -(-(2 * step + 2 * C + 2 * G) * 4 // 16) * 16 + 16


@functools.lru_cache(maxsize=1024)
def launch_geometry(B: int, hw: int, C: int, G: int, in_dtype: torch.dtype,
                    out_dtype: torch.dtype, aligned: bool,
                    regime: Optional[str] = None, *,
                    cluster: Optional[int] = None,
                    threads: Optional[int] = None,
                    smem_cap: Optional[int] = None) -> Geometry:
    """B4's regime and launch geometry for ``B`` samples of ``hw`` positions
    by ``C`` channels in ``G`` groups, ``x`` in ``in_dtype``, ``y`` in
    ``out_dtype``; ``aligned``: both addresses are 16-byte aligned.

    ``regime`` ``None`` picks by the batch's x: the cluster regime up to
    ``_CLUSTER_MAX_BATCH_BYTES`` (:func:`_cluster_geometry`), else the
    three-pass one (:func:`_geometry`). The keywords override the cluster
    regime's choices (for sweeps). Raises on a dtype, a ``C % G`` or a
    channel count the kernel does not take."""
    for dt in (in_dtype, out_dtype):
        if dt not in _DTYPE_CODE:
            raise ValueError(f"group norm kernel takes bfloat16/float32, got "
                             f"{dt}")
    if G <= 0 or C % G:
        raise ValueError(f"C={C} not divisible by num_groups={G}")
    elem = _ELEM_SIZE[in_dtype]
    if regime is None:
        regime = "three_pass"
        if B * hw * C * elem <= _CLUSTER_MAX_BATCH_BYTES:
            try:
                return _cluster_geometry(B, hw * C, C, G, elem, aligned)
            except ValueError:       # channels beyond a cluster block step
                pass
    if regime == "three_pass":
        vec, threads, iters, tiles = _geometry(B, hw, C, elem, aligned)
        return Geometry(regime, vec, threads, 1, iters, 0, tiles, 0)
    if regime != "cluster":
        raise ValueError(f"unknown group norm regime {regime!r}")
    return _cluster_geometry(B, hw * C, C, G, elem, aligned, cluster,
                             threads, smem_cap)


def _cluster_geometry(B, n, C, G, elem, aligned, cluster=None,
                      threads=None, smem_cap=None) -> Geometry:
    """The cluster regime's geometry for ``B`` samples of ``n`` elements of
    ``elem`` bytes. The rules were fitted to a sweep on the H100 at the
    wide256 chain shapes (``tools/tune_group_norm.py --sweep``; ``PERF.md``).

    16-byte vectors (or scalars where the length or an address does not
    allow them). ``cluster``: blocks per sample, 4 up to 512 KB per sample,
    8 up to 2 MB, else 16. ``threads``: at most 256. A block step of ``C *
    2^p`` elements (at most 4096, the threads and the block's share); as
    many steps resident as ``smem_cap`` holds (``_CLUSTER_SMEM``, a quarter
    of an SM's shared memory): the rest are read from global memory, their
    loads overlapping the resident part's bulk copy, and read again (mostly
    from L2) for the output. The keywords override the rules (for
    sweeps)."""
    vec = 16 // elem
    if n % vec or not aligned:
        vec = 1
    if cluster is None:
        sample = n * elem
        cluster = 4 if sample <= 512 << 10 else 8 if sample <= 2 << 20 else 16
    smem_cap = smem_cap or _CLUSTER_SMEM
    tmax = min(threads or _CLUSTER_THREADS, _CLUSTER_THREADS)
    base = C
    while base % vec:
        base *= 2
    if base > _MAX_ELEMS_PER_STEP or base // vec > tmax:
        raise ValueError(f"group norm cluster kernel takes at most "
                         f"{_MAX_ELEMS_PER_STEP} elements and {tmax} threads "
                         f"per block step; C={C} needs {base} elements")
    share = -(-n // cluster)
    step = base
    while (2 * step <= min(_MAX_ELEMS_PER_STEP, share)
           and 2 * step // vec <= tmax):
        step *= 2
    iters = -(-share // step)
    fixed = _cluster_fixed_bytes(step, C, G)
    resident = max(0, min(iters, (smem_cap - fixed) // (step * elem)))
    return Geometry("cluster", vec, step // vec, cluster, iters, resident, 0,
                    fixed + resident * step * elem)


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


def group_norm_plain(x, gamma, beta, num_groups: int, eps: float,
                     out_dtype) -> torch.Tensor:
    """Flax ``nn.GroupNorm(dtype=out_dtype)`` on NHWC ``x``: float32
    statistics (variance ``E[x^2] - E[x]^2`` clipped at 0), ``(x - mean) *
    (rsqrt(var + eps) * gamma) + beta`` as separate float32 ops, one cast to
    ``out_dtype``."""
    B, C, G = x.shape[0], x.shape[-1], num_groups
    xg = x.float().reshape(B, -1, G, C // G)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    mu2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * gamma.float().view(1, 1, G, C // G)
    y = (xg - mu) * mul + beta.float().view(1, 1, G, C // G)
    return y.reshape(x.shape).to(out_dtype)


def gn_film_silu_policy_plain(x, gamma, beta, num_groups: int, norm_dtype,
                              scale=None, shift=None,
                              eps: float = 1e-5) -> torch.Tensor:
    """The CondUNet's chain in plain PyTorch (the ResBlock's ``norm_0`` and
    ``norm_1`` + FiLM, the ``out_norm``): :func:`group_norm_plain` to
    ``norm_dtype``, then FiLM in ``norm_dtype`` as ``h * (1 + scale) +
    shift`` (each op rounded), then ``F.silu`` in ``norm_dtype``. Output in
    ``norm_dtype``."""
    nd = norm_dtype
    h = group_norm_plain(x, gamma, beta, num_groups, eps, nd)
    if scale is not None:
        h = (h * (1.0 + scale.to(nd)[:, None, None, :])
             + shift.to(nd)[:, None, None, :])
    return F.silu(h)


_ready = set()                 # (device, defines) whose kernels are set up
_DEFINES = ()                  # macros of the build the wrapper launches


def _load(defines=None):
    """The library (built with ``defines``, default ``_DEFINES``), with
    each cluster kernel's shared-memory and cluster size attributes set
    once on the current device."""
    defines = _DEFINES if defines is None else tuple(defines)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    argtypes = {
        "superdiff_gn_silu": ([ptr] * 6 + [ctypes.c_longlong, ptr, i32,
                                           ctypes.c_longlong] + [i32] * 13
                              + [ctypes.c_float, ptr]),
        "superdiff_gn_init": [],
        "superdiff_gn_max_clusters": [i32] * 6 + [ptr]}
    if "SUPERDIFF_GN_TRACE" in defines:
        argtypes["superdiff_gn_trace"] = [ptr, i32]
    lib = _build.load("gn", argtypes, defines=defines)
    key = (torch.cuda.current_device(), defines)
    if key not in _ready:
        err = lib.superdiff_gn_init()
        if err != 0:
            raise RuntimeError(f"group_norm_silu set-up failed: CUDA error "
                               f"{err}")
        _ready.add(key)
    return lib


def max_active_clusters(geo: Geometry, in_dtype, out_dtype) -> int:
    """How many clusters of a cluster-regime geometry the current card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    out = ctypes.c_int(0)
    err = _load().superdiff_gn_max_clusters(
        _DTYPE_CODE[in_dtype], _DTYPE_CODE[out_dtype], geo.vec, geo.threads,
        geo.cluster, geo.smem, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error {err}")
    return out.value


def _f32(a):
    return None if a is None else a.detach().float().contiguous()


def _film(scale, shift):
    """float32 FiLM operands with unit channel stride and one row stride:
    the ResBlock's ``cond.chunk(2)`` views go in as they are."""
    if scale is None:
        return None, None, 0
    scale, shift = scale.detach().float(), shift.detach().float()
    if not (scale.stride(1) == shift.stride(1) == 1
            and scale.stride(0) == shift.stride(0)):
        scale, shift = scale.contiguous(), shift.contiguous()
    return scale, shift, scale.stride(0)


def _launch(x, gamma, beta, num_groups, scale, shift, eps, out_dtype,
            policy, regime=None, geo=None):
    """One B4 call on the card: ``policy`` the CondUNet's rounding
    sequence, else the folded float32 chain; ``regime`` ``None`` as
    :func:`launch_geometry` picks (a name forces one, to time both;
    ``geo`` gives the whole geometry, for sweeps)."""
    B, H, W, C = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group norm kernel takes bfloat16/float32, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group norm kernel needs a contiguous NHWC x")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if geo is None:
        geo = launch_geometry(
            B, H * W, C, num_groups, x.dtype, out_dtype,
            x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0, regime)
    gamma, beta = _f32(gamma), _f32(beta)
    scale, shift, film_ld = _film(scale, shift)
    work = None
    if geo.regime == "three_pass":
        work = torch.empty(2 * B * C * geo.tiles + 5 * B * C,
                           dtype=torch.float32, device=x.device)
    opt = lambda a: None if a is None else a.data_ptr()
    with torch.cuda.device(x.device):
        err = _load().superdiff_gn_silu(
            x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            opt(scale), opt(shift), film_ld, opt(work), B, H * W, C,
            num_groups, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
            int(policy), int(geo.regime == "cluster"), geo.vec, geo.threads,
            geo.cluster, geo.iters, geo.resident, geo.tiles, geo.smem, eps,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_silu launch failed: CUDA error {err} "
                           f"(shape {tuple(x.shape)}, G={num_groups}, "
                           f"{x.dtype} -> {out_dtype}, {geo})")
    global launches
    launches += 1
    key = (H, W, C, num_groups, scale is not None,
           str(x.dtype).replace("torch.", ""))
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    if torch.cuda.is_current_stream_capturing():
        captured_by_shape[key] = captured_by_shape.get(key, 0) + 1
    return y


def _gn_silu_cuda(x, gamma, beta, num_groups, scale, shift, eps):
    return _launch(x, gamma, beta, num_groups, scale, shift, eps, x.dtype,
                   policy=False)


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
    """``SiLU(FiLM(GroupNorm(x)))``, FiLM folded into the affine, float32
    math, differentiable: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    _validate(x, gamma, beta, num_groups, scale, shift)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, gamma, beta, scale, shift)):
        return GroupNormSiLUFn.apply(x, gamma, beta, scale, shift,
                                     num_groups, eps)
    return _gn_silu(x, gamma, beta, num_groups, scale, shift, eps)


def gn_film_silu_policy(x: torch.Tensor,
                        gamma: torch.Tensor,
                        beta: torch.Tensor,
                        num_groups: int,
                        norm_dtype: torch.dtype,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """The CondUNet's GroupNorm -> (FiLM) -> SiLU in ``norm_dtype``, with
    :func:`gn_film_silu_policy_plain`'s rounding points: B4 on a CUDA tensor
    when no gradient is wanted (grad mode off, or no input that requires
    grad); otherwise, and on the CPU, the plain chain (under autograd when
    a gradient is wanted)."""
    _validate(x, gamma, beta, num_groups, scale, shift)
    wants_grad = torch.is_grad_enabled() and any(
        a is not None and a.requires_grad
        for a in (x, gamma, beta, scale, shift))
    if wants_grad:
        return gn_film_silu_policy_plain(x, gamma, beta, num_groups,
                                         norm_dtype, scale, shift, eps)
    if any(a is not None and torch._C._functorch.is_batchedtensor(a)
           for a in (x, gamma, beta, scale, shift)):
        return torch.ops.superdiff.gn_film_silu(x, gamma, beta, scale, shift,
                                                num_groups, norm_dtype, eps)
    return _gn_film_silu_policy_impl(x, gamma, beta, scale, shift,
                                     num_groups, norm_dtype, eps)


def _gn_film_silu_policy_impl(x, gamma, beta, scale, shift, num_groups,
                              norm_dtype, eps):
    if x.is_cuda:
        return _launch(x.contiguous(), gamma, beta, num_groups, scale, shift,
                       eps, norm_dtype, policy=True)
    return gn_film_silu_policy_plain(x, gamma, beta, num_groups, norm_dtype,
                                     scale, shift, eps)


@torch.library.custom_op("superdiff::gn_film_silu", mutates_args=())
def _gn_film_silu_op(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, scale: Optional[torch.Tensor],
                     shift: Optional[torch.Tensor], num_groups: int,
                     norm_dtype: torch.dtype, eps: float) -> torch.Tensor:
    """Policy-mode B4 (or its plain chain on the CPU) as a registered op, so
    that it runs under ``torch.func.vmap`` (stacked models)."""
    return _gn_film_silu_policy_impl(x, gamma, beta, scale, shift,
                                     num_groups, norm_dtype, eps)


@_gn_film_silu_op.register_fake
def _(x, gamma, beta, scale, shift, num_groups, norm_dtype, eps):
    return x.new_empty(x.shape, dtype=norm_dtype)


def _gn_film_silu_vmap(info, in_dims, x, gamma, beta, scale, shift,
                       num_groups, norm_dtype, eps):
    """One launch per mapped model: its gamma / beta (and FiLM) differ, and
    each model's output keeps the bits of its own unmapped call."""
    def pick(a, d, m):
        return a if a is None or d is None else a.select(d, m)

    outs = [_gn_film_silu_op(*(pick(a, d, m) for a, d in zip(
                (x, gamma, beta, scale, shift), in_dims[:5])),
             num_groups, norm_dtype, eps)
            for m in range(info.batch_size)]
    return torch.stack(outs), 0


torch.library.register_vmap("superdiff::gn_film_silu", _gn_film_silu_vmap)
