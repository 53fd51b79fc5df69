"""Flash attention: the hand-written CUDA kernels and their plain versions.

Port of ``superdiff_tpu/ops/flash_attention.py``: the forward
(``_flash_kernel`` -> ``csrc/flash_attn_fwd.cu``) and the two backward kernels
(``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel`` ->
``csrc/flash_attn_bwd.cu``), tied together by :class:`FlashAttentionFn` as the
reference ties them with ``jax.custom_vjp``. The sources are CUDA C++ for
``sm_90a`` with a plain C interface, built and bound by ``ops/_build.py``.

Contracts:

- ``q, k, v``: ``(B, S, H, D)``, any strides with a contiguous last dim,
  bfloat16 or float32, ``D`` in {32, 64, 128}, any ``S``;
- :func:`_flash_forward` returns ``(out (B, S, H, D) in the input dtype,
  lse (B*H, S) float32)``;
- :func:`_flash_backward` ``(q, k, v, out, lse, g) -> (dq, dk, dv)`` in the
  input dtype. ``g`` goes in through its strides; when its last dim is not
  contiguous or it is not 16-byte aligned the wrapper makes one explicit
  contiguous copy. ``delta = rowsum(g * out)`` is a short torch expression
  here, as it is an XLA expression in the reference.

Each kernel's launch geometry (warps per block, the tile it loops over,
m-tiles per warp) is a Python function of the shape,
:func:`_fwd_geometry` and :func:`_bwd_geometry`, over the tiles the kernels
are built with (``_FWD_TILE``, ``_BWD_TILE``), as measured by
``tools/tune_flash_fwd.py`` and ``tools/tune_flash_bwd.py``.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (:func:`_flash_forward_plain`, :func:`_flash_backward_plain`), the
same functions in plain PyTorch with the kernels' roundings. Under
``torch.func.vmap`` (stacked models) the forward goes through the
registered op ``superdiff::flash_attn_fwd``, whose vmap rule folds the
mapped axis into the batch: one launch for all mapped calls. ``launches``,
``bwd_dq_launches`` and ``bwd_dkv_launches`` count kernel launches;
``captured_by_shape`` counts the forward launches among them that were
recorded into a CUDA graph (made under stream capture), which the graph's
replays launch again without this module seeing them. There is
no other backward: the reference's ``SUPERDIFF_TPU_FLASH_BWD=xla`` opt-out has
no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from superdiff_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

launches = 0                 # forward kernel launches since the last reset
launches_by_shape = {}       # (S, D, dtype name) -> launches, same events
captured_by_shape = {}       # the same, of launches made under capture
bwd_dq_launches = 0          # dQ kernel launches since the last reset
bwd_dq_launches_by_shape = {}
bwd_dkv_launches = 0         # dK/dV kernel launches since the last reset
bwd_dkv_launches_by_shape = {}


def reset_launches() -> None:
    global launches, bwd_dq_launches, bwd_dkv_launches
    launches = bwd_dq_launches = bwd_dkv_launches = 0
    launches_by_shape.clear()
    captured_by_shape.clear()
    bwd_dq_launches_by_shape.clear()
    bwd_dkv_launches_by_shape.clear()


def _shape_key(q) -> tuple:
    return (q.shape[1], q.shape[3], str(q.dtype).replace("torch.", ""))


def _load(which: str, defines=()):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32] * 5 + [ctypes.c_float, ptr] + [i32] * 3 + [ptr]
    if which == "fwd":
        return _build.load("fwd", {
            "superdiff_flash_attn_fwd": [ptr] * 5 + tail,
            "superdiff_flash_attn_fwd_info": [i32] * 5 + [ptr]}, defines)
    return _build.load("bwd", {
        "superdiff_flash_attn_bwd_dq": [ptr] * 7 + tail,
        "superdiff_flash_attn_bwd_dkv": [ptr] * 8 + tail,
        "superdiff_flash_attn_bwd_info": [i32] * 6 + [ptr]}, defines)


def _check(q, k, v):
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def kernel_supports(q: torch.Tensor) -> bool:
    """Whether the CUDA kernel takes this head dim and dtype."""
    return q.shape[-1] in SUPPORTED_HEAD_DIMS and q.dtype in _DTYPE_CODE


def _kernel_layout_ok(a) -> bool:
    vec = 16 // a.element_size()
    return (a.stride(3) == 1 and a.data_ptr() % 16 == 0
            and not any(s % vec for s in a.stride()[:3]))


def _check_kernel_layout(**tensors):
    for name, a in tensors.items():
        if a.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim")
        if not _kernel_layout_ok(a):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"divisible by {16 // a.element_size()} elements")


# ------------------------------------------------------------ launch geometry

NUM_SMS = 132                # H100 SXM
MAX_SMEM = 232448            # shared memory one block may use (227 KB)
_MAX_GRID_Y = 65535
_MAX_GRID_X = 2 ** 31 - 1
_MAX_WARPS = 8               # warps per block, every kernel
_FWD_STAGES = 2              # K/V ring depth of the forward kernel
_MIN_BLOCKS = 64             # about half the SMs
# (keys per K/V tile, 16-row m-tiles per warp) by (dtype code, D): the
# instantiations the forward kernel is built with (csrc/flash_attn_fwd.cu,
# SUPERDIFF_FWD_TILES), the fastest of tools/tune_flash_fwd.py --sweep at
# the wide256 path shapes (PERF.md)
_FWD_TILE = {(0, 32): (32, 2), (0, 64): (64, 1), (0, 128): (64, 1),
             (1, 32): (64, 1), (1, 64): (64, 1), (1, 128): (32, 1)}


def _row_bytes(D: int, elem_size: int) -> int:
    """Shared-memory row stride of the flash kernels' Q, K, V and dO tiles:
    one row padded by 16 bytes."""
    return D * elem_size + 16


def _fwd_smem_bytes(D: int, elem_size: int, warps: int, bk: int,
                    mt: int) -> int:
    """Dynamic shared memory of the forward kernel (its ``Layout``): the Q
    tile (16 * mt rows per warp), two stages of K and V tiles, and for
    float32 a per-warp P buffer of 16 x (bk + 4) floats."""
    row = _row_bytes(D, elem_size)
    p_warp = 16 * (bk + 4) * 4 if elem_size == 4 else 0
    return 16 * mt * warps * row + _FWD_STAGES * 2 * bk * row + warps * p_warp


def _fwd_geometry(B: int, S: int, H: int, D: int, elem_size: int):
    """Launch geometry of the forward kernel: ``(warps, bk, mt, grid,
    smem)``.

    Each warp owns ``16 * mt`` query rows; ``bk`` keys per K/V tile and
    ``mt`` by dtype and D (``_FWD_TILE``). The block takes as many warps (a
    power of two up to 8) as its query tile can have without growing past
    S or leaving fewer than half the SMs a block: a taller tile reads K and
    V from L2 fewer times, and at the short path shapes the fewer, fuller
    blocks measured faster than a grid cut to more blocks than SMs
    (PERF.md). ``grid = (B*H, query tiles)``."""
    code = 0 if elem_size == 2 else 1
    bk, mt = _FWD_TILE[(code, D)]
    warps, grid = _row_tiles(B, S, H, mt, "flash kernel")
    return warps, bk, mt, grid, _fwd_smem_bytes(D, elem_size, warps, bk, mt)


def _row_tiles(B: int, S: int, H: int, mt: int, what: str):
    """Warps per block and grid of a kernel whose warps own ``16 * mt``
    rows each: as many warps (a power of two up to 8) as the row tile can
    have without growing past S or leaving fewer than ``_MIN_BLOCKS``
    blocks; ``grid = (B*H, row tiles)``, checked against the card's
    limits."""
    warps = 1
    while (2 * warps <= _MAX_WARPS and 32 * mt * warps <= S
           and B * H * -(-S // (32 * mt * warps)) >= _MIN_BLOCKS):
        warps *= 2
    grid = (B * H, -(-S // (16 * mt * warps)))
    if grid[0] > _MAX_GRID_X or grid[1] > _MAX_GRID_Y:
        raise ValueError(f"{what} grid {grid} out of range for "
                         f"B*H={B * H}, S={S}")
    return warps, grid


def _launch_fwd(q, k, v, warps: int, bk: int, mt: int, defines=()):
    """One launch of the forward kernel at the given geometry, from the
    library built with ``defines``; inputs already checked by the
    caller."""
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _load("fwd", defines).superdiff_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, D, _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(D), strides, warps, bk, mt, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err} "
                           f"(shape {tuple(q.shape)}, {q.dtype}, warps "
                           f"{warps}, bk {bk}, mt {mt})")
    global launches
    launches += 1
    key = _shape_key(q)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    if torch.cuda.is_current_stream_capturing():
        captured_by_shape[key] = captured_by_shape.get(key, 0) + 1
    return out, lse


def fwd_kernel_info(D: int, dtype: torch.dtype, warps: int, bk: int,
                    mt: int, defines=()) -> dict:
    """What the compiler and the occupancy calculator say of one forward
    instantiation (needs the card): dynamic shared bytes, registers and
    spill (local) bytes per thread, resident blocks per SM."""
    res = (ctypes.c_int * 4)()
    err = _load("fwd", defines).superdiff_flash_attn_fwd_info(
        D, _DTYPE_CODE[dtype], warps, bk, mt, res)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd_info failed: CUDA error {err}")
    return dict(smem_bytes=res[0], registers=res[1], spill_bytes=res[2],
                blocks_per_sm=res[3], warps_per_sm=res[3] * warps)


def _flash_forward_cuda(q, k, v):
    B, S, H, D = q.shape
    if not kernel_supports(q):
        raise ValueError(f"flash kernel takes D in {SUPPORTED_HEAD_DIMS} and "
                         f"bfloat16/float32, got D={D} {q.dtype}")
    _check_kernel_layout(q=q, k=k, v=v)
    warps, bk, mt, _, _ = _fwd_geometry(B, S, H, D, q.element_size())
    return _launch_fwd(q, k, v, warps, bk, mt)


def _flash_forward_plain(q, k, v):
    """Plain PyTorch version: f32 scores, full softmax, logsumexp.

    ``P`` is rounded to the input dtype before ``P.V`` as in the kernel."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(scores, dim=-1)                       # (B,H,S)
    p = torch.exp(scores - lse[..., None]).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(q.dtype), lse.reshape(B * H, S)


def _flash_forward_impl(q, k, v):
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_forward_plain(q, k, v)


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(out (B,S,H,D), lse (B*H, S) f32)``; kernel on CUDA, plain on CPU.
    Inside ``torch.func.vmap`` the call goes through the registered op
    ``superdiff::flash_attn_fwd``, whose vmap rule folds the mapped axis
    into the batch."""
    _check(q, k, v)
    if any(map(_batched, (q, k, v))):
        return torch.ops.superdiff.flash_attn_fwd(q, k, v)
    return _flash_forward_impl(q, k, v)


def _batched(a) -> bool:
    """Whether ``a`` is a tensor mapped by ``torch.func.vmap``."""
    return torch._C._functorch.is_batchedtensor(a)


@torch.library.custom_op("superdiff::flash_attn_fwd", mutates_args=())
def _flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B1 (or its plain version on the CPU) as a registered op, so that it
    runs under ``torch.func.vmap`` (stacked models)."""
    out, lse = _flash_forward_impl(q, k, v)
    return out, lse


@_flash_attn_fwd_op.register_fake
def _(q, k, v):
    B, S, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B * H, S), dtype=torch.float32))


def _flash_attn_fwd_vmap(info, in_dims, q, k, v):
    """Fold the mapped axis into the batch: ``(M, B, S, H, D) -> (M*B, S, H,
    D)``, one launch for the M mapped calls. Exact: attention has no
    weights, and each (batch, head) row is computed alone."""
    M = info.batch_size

    def fold(a, d):
        a = a.expand(M, *a.shape) if d is None else a.movedim(d, 0)
        return a.reshape(M * a.shape[1], *a.shape[2:])

    out, lse = _flash_attn_fwd_op(*(fold(a, d)
                                    for a, d in zip((q, k, v), in_dims)))
    return (out.view(M, -1, *out.shape[1:]),
            lse.view(M, -1, lse.shape[-1])), (0, 0)


torch.library.register_vmap("superdiff::flash_attn_fwd",
                            _flash_attn_fwd_vmap)


# ---------------------------------------------------------------- backward

def _bwd_strides(*tensors):
    flat = [x for a in tensors for x in a.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


# ---------------------------------------------------- backward launch geometry

_BWD_KERNELS = ("dq", "dkv")
_BWD_STAGES = 2              # looped-tile ring depth of both backward kernels
# The (looped rows per tile, 16-row m-tiles per warp) built by (dtype code,
# D, kernel), shortest tile first: the instantiations of
# csrc/flash_attn_bwd.cu (SUPERDIFF_BWD_TILES), the fastest of
# tools/tune_flash_bwd.py --sweep at the wide256 path shapes (PERF.md). The
# looped tile is keys for dQ and queries for dK/dV.
_BWD_TILE = {(0, 32, "dq"): ((128, 2),), (0, 64, "dq"): ((64, 1), (128, 1)),
             (0, 128, "dq"): ((64, 1),),
             (1, 32, "dq"): ((64, 1),), (1, 64, "dq"): ((64, 1),),
             (1, 128, "dq"): ((32, 1),),
             (0, 32, "dkv"): ((128, 2),),
             (0, 64, "dkv"): ((64, 1), (128, 1)),
             (0, 128, "dkv"): ((64, 1),),
             (1, 32, "dkv"): ((64, 1),), (1, 64, "dkv"): ((64, 1),),
             (1, 128, "dkv"): ((32, 1),)}


def _bwd_smem_bytes(kernel: str, D: int, elem_size: int, warps: int,
                    bt: int, mt: int) -> int:
    """Dynamic shared memory of a backward kernel (its ``Layout``): the
    block's two owned tiles (Q and dO for dQ, K and V for dK/dV; 16 * mt
    rows per warp each), two stages of the two looped tiles (bt rows each),
    for dK/dV also the looped queries' lse and delta (bt floats each) per
    stage, and for float32 a per-warp P / dS buffer of 16 x 20 floats.
    Rows are padded by 16 bytes, as in the forward kernel."""
    row = _row_bytes(D, elem_size)
    stage = 2 * bt * row + (2 * bt * 4 if kernel == "dkv" else 0)
    p_warp = 16 * 20 * 4 if elem_size == 4 else 0
    return (2 * 16 * mt * warps * row + _BWD_STAGES * stage
            + warps * p_warp)


def _bwd_geometry(kernel: str, B: int, S: int, H: int, D: int,
                  elem_size: int):
    """Launch geometry of a backward kernel (``"dq"`` or ``"dkv"``):
    ``(warps, bt, mt, grid, smem)``.

    Each warp owns ``16 * mt`` rows (queries for dQ, keys for dK/dV) and
    loops over the other side in tiles of ``bt`` rows. ``(bt, mt)`` is the
    tallest tile built for the dtype, D and kernel (``_BWD_TILE``) that S
    fills, else the shortest: a taller looped tile only loads rows past S
    (bf16 D=64: 64 rows at S=64, 128 at S=256). Warps and grid as for the
    forward kernel (``_row_tiles``)."""
    if kernel not in _BWD_KERNELS:
        raise ValueError(f"backward kernel is one of {_BWD_KERNELS}, got "
                         f"{kernel!r}")
    code = 0 if elem_size == 2 else 1
    tiles = _BWD_TILE[(code, D, kernel)]
    bt, mt = ([t for t in tiles if t[0] <= S] or tiles[:1])[-1]
    warps, grid = _row_tiles(B, S, H, mt, "flash backward")
    return (warps, bt, mt, grid,
            _bwd_smem_bytes(kernel, D, elem_size, warps, bt, mt))


def _launch_bwd(kernel: str, q, k, v, g, lse, delta, warps: int, bt: int,
                mt: int, defines=()):
    """One launch of the dQ kernel (``kernel="dq"``, returns ``dq``) or the
    dK/dV kernel (``"dkv"``, returns ``(dk, dv)``) at the given geometry,
    from the library built with ``defines``; inputs already checked by the
    caller."""
    global bwd_dq_launches, bwd_dkv_launches
    B, S, H, D = q.shape
    outs = [torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
            for _ in range(1 if kernel == "dq" else 2)]
    fn = getattr(_load("bwd", defines),
                 f"superdiff_flash_attn_bwd_{kernel}")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(o.data_ptr() for o in outs), B, S, H, D,
                 _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D),
                 _bwd_strides(q, k, v, g, *outs), warps, bt, mt,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_{kernel} launch failed: CUDA "
                           f"error {err} (shape {tuple(q.shape)}, {q.dtype}, "
                           f"warps {warps}, bt {bt}, mt {mt})")
    key = _shape_key(q)
    if kernel == "dq":
        bwd_dq_launches += 1
        counts = bwd_dq_launches_by_shape
    else:
        bwd_dkv_launches += 1
        counts = bwd_dkv_launches_by_shape
    counts[key] = counts.get(key, 0) + 1
    return outs[0] if kernel == "dq" else tuple(outs)


def bwd_kernel_info(kernel: str, D: int, dtype: torch.dtype, warps: int,
                    bt: int, mt: int, defines=()) -> dict:
    """What the compiler and the occupancy calculator say of one backward
    instantiation (needs the card): dynamic shared bytes, registers and
    spill (local) bytes per thread, resident blocks per SM."""
    res = (ctypes.c_int * 4)()
    err = _load("bwd", defines).superdiff_flash_attn_bwd_info(
        _BWD_KERNELS.index(kernel), D, _DTYPE_CODE[dtype], warps, bt, mt, res)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_info failed: CUDA error {err}")
    return dict(smem_bytes=res[0], registers=res[1], spill_bytes=res[2],
                blocks_per_sm=res[3], warps_per_sm=res[3] * warps)


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta):
    """Launch the dQ kernel; inputs already checked by the caller."""
    B, S, H, D = q.shape
    warps, bt, mt, _, _ = _bwd_geometry("dq", B, S, H, D, q.element_size())
    return _launch_bwd("dq", q, k, v, g, lse, delta, warps, bt, mt)


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta):
    """Launch the dK/dV kernel; inputs already checked by the caller."""
    B, S, H, D = q.shape
    warps, bt, mt, _, _ = _bwd_geometry("dkv", B, S, H, D, q.element_size())
    return _launch_bwd("dkv", q, k, v, g, lse, delta, warps, bt, mt)


def _bwd_delta(o, g):
    """``delta = rowsum(dO * O)`` in float32, in lse's ``(B*H, S)`` layout."""
    B, S, H, _ = o.shape
    delta = (g.float() * o.float()).sum(-1)                    # (B, S, H)
    return delta.permute(0, 2, 1).contiguous().view(B * H, S)


def _flash_backward_cuda(q, k, v, o, lse, g):
    return _bwd_cuda(q, k, v, g, lse, _bwd_delta(o, g))


def _bwd_cuda(q, k, v, g, lse, delta):
    """The dQ and dK/dV kernels on given ``lse`` and ``delta``."""
    if not kernel_supports(q):
        raise ValueError(f"flash kernel takes D in {SUPPORTED_HEAD_DIMS} and "
                         f"bfloat16/float32, got D={q.shape[-1]} {q.dtype}")
    _check_kernel_layout(q=q, k=k, v=v)
    if not _kernel_layout_ok(g):
        g = g.contiguous()                   # the one explicit copy
    lse, delta = lse.contiguous(), delta.contiguous()
    return (_flash_bwd_dq_cuda(q, k, v, g, lse, delta),
            *_flash_bwd_dkv_cuda(q, k, v, g, lse, delta))


def _bwd_p_ds(q, k, v, g, lse, delta):
    """``P`` and ``dS`` (both float32, ``(B, H, Sq, Sk)``), recomputed from
    ``lse`` as the kernels do."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.view(B, H, S, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    return p, p * (dp - delta.view(B, H, S, 1)) * scale


def _flash_bwd_dq_plain(q, k, v, g, lse, delta):
    """Plain PyTorch version of the dQ kernel: ``dS`` rounded to the input
    dtype before ``dS.K``, float32 sums."""
    _, ds = _bwd_p_ds(q, k, v, g, lse, delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), k.float())
    return dq.to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, g, lse, delta):
    """Plain PyTorch version of the dK/dV kernel: ``P`` rounded to the input
    dtype before ``P^T.dO`` and ``dS`` before ``dS^T.Q``, float32 sums."""
    p, ds = _bwd_p_ds(q, k, v, g, lse, delta)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_backward_plain(q, k, v, o, lse, g):
    """Plain PyTorch version of the whole backward, ``(dq, dk, dv)``."""
    delta = _bwd_delta(o, g)
    return (_flash_bwd_dq_plain(q, k, v, g, lse, delta),
            *_flash_bwd_dkv_plain(q, k, v, g, lse, delta))


def flash_backward_hop(q, k, v, g, lse, delta):
    """``(dq, dk, dv)`` of one block of the attention matrix: the queries
    ``q`` against the keys and values ``k``, ``v`` (the same shape), with
    the softmax's row ``lse`` and ``delta = rowsum(dO * O)`` (both ``(B*H,
    S)`` float32) taken from the whole row, which may span other blocks:
    the two backward kernels on CUDA, their plain versions on the CPU
    (context parallelism's backward hop, ``parallel/cp.py``)."""
    _check(q, k, v)
    if q.is_cuda:
        return _bwd_cuda(q, k, v, g, lse, delta)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return (_flash_bwd_dq_plain(q, k, v, g, lse, delta),
            *_flash_bwd_dkv_plain(q, k, v, g, lse, delta))


def _flash_backward(q, k, v, o, lse, g):
    """``(dq, dk, dv)``; the two kernels on CUDA, the plain version on CPU."""
    _check(q, k, v)
    B, S, H, D = q.shape
    if o.shape != q.shape or g.shape != q.shape or lse.shape != (B * H, S):
        raise ValueError(f"out / grad must be {tuple(q.shape)} and lse "
                         f"{(B * H, S)}, got {tuple(o.shape)}, "
                         f"{tuple(g.shape)}, {tuple(lse.shape)}")
    if g.dtype != q.dtype or g.device != q.device:
        raise ValueError("the output gradient must share q's dtype and device")
    if q.is_cuda:
        return _flash_backward_cuda(q, k, v, o, lse, g)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_backward_plain(q, k, v, o, lse, g)


class FlashAttentionFn(torch.autograd.Function):
    """Forward kernel + the two backward kernels as one differentiable op.

    ``out`` and ``lse`` are saved for the backward kernels;
    :func:`flash_attention` comes here only when a backward will run (the
    rule of the reference's ``_flash_fwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _flash_forward(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return _flash_backward(*ctx.saved_tensors, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Flash attention, ``(B, S, H, D)`` -> ``(B, S, H, D)``, no mask.

    Differentiable: when autograd is recording and an input needs a gradient
    the call goes through :class:`FlashAttentionFn`; otherwise only the
    forward runs and nothing is kept."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v)
    return _flash_forward(q, k, v)[0]
