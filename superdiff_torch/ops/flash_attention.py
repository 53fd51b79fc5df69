"""Flash attention: the hand-written CUDA kernels and their plain versions.

Port of ``superdiff_tpu/ops/flash_attention.py``: the forward
(``_flash_kernel`` -> ``csrc/flash_attn_fwd.cu``) and the two backward kernels
(``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel`` ->
``csrc/flash_attn_bwd.cu``), tied together by :class:`FlashAttentionFn` as the
reference ties them with ``jax.custom_vjp``. The sources are CUDA C++ for
``sm_90a`` with a plain C interface, compiled with ``nvcc`` at first use into
``build/superdiff_torch/`` (keyed by a hash of the source) and bound with
``ctypes``.

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

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions (:func:`_flash_forward_plain`, :func:`_flash_backward_plain`), the
same functions in plain PyTorch with the kernels' roundings. ``launches``,
``bwd_dq_launches`` and ``bwd_dkv_launches`` count kernel launches. There is
no other backward: the reference's ``SUPERDIFF_TPU_FLASH_BWD=xla`` opt-out has
no counterpart here.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"fwd": _CSRC / "flash_attn_fwd.cu", "bwd": _CSRC / "flash_attn_bwd.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "superdiff_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches = 0                 # forward kernel launches since the last reset
launches_by_shape = {}       # (S, D, dtype name) -> launches, same events
bwd_dq_launches = 0          # dQ kernel launches since the last reset
bwd_dq_launches_by_shape = {}
bwd_dkv_launches = 0         # dK/dV kernel launches since the last reset
bwd_dkv_launches_by_shape = {}
_libs = {}


def reset_launches() -> None:
    global launches, bwd_dq_launches, bwd_dkv_launches
    launches = bwd_dq_launches = bwd_dkv_launches = 0
    launches_by_shape.clear()
    bwd_dq_launches_by_shape.clear()
    bwd_dkv_launches_by_shape.clear()


def _shape_key(q) -> tuple:
    return (q.shape[1], q.shape[3], str(q.dtype).replace("torch.", ""))


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the flash-attention "
                       "kernel is compiled at first use")


def build(which: str = "fwd", verbose: bool = False) -> Path:
    """Compile one kernel source (``"fwd"`` or ``"bwd"``; once per source
    hash) and return the .so path.

    ``verbose=True`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per instantiation)."""
    source = SOURCES[which]
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"{source.stem}_{tag}.so"
    if so.exists() and not verbose:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def build_all(verbose: bool = False) -> dict:
    """Compile every source, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {w: pool.submit(build, w, verbose) for w in SOURCES}
        return {w: f.result() for w, f in futures.items()}


def _load(which: str):
    if which not in _libs:
        lib = ctypes.CDLL(str(build(which)))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 5 + [ctypes.c_float, ptr, ptr]
        if which == "fwd":
            lib.superdiff_flash_attn_fwd.argtypes = [ptr] * 5 + tail
            lib.superdiff_flash_attn_fwd.restype = i32
        else:
            lib.superdiff_flash_attn_bwd_dq.argtypes = [ptr] * 7 + tail
            lib.superdiff_flash_attn_bwd_dq.restype = i32
            lib.superdiff_flash_attn_bwd_dkv.argtypes = [ptr] * 8 + tail
            lib.superdiff_flash_attn_bwd_dkv.restype = i32
        _libs[which] = lib
    return _libs[which]


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


def _flash_forward_cuda(q, k, v):
    B, S, H, D = q.shape
    if not kernel_supports(q):
        raise ValueError(f"flash kernel takes D in {SUPPORTED_HEAD_DIMS} and "
                         f"bfloat16/float32, got D={D} {q.dtype}")
    _check_kernel_layout(q=q, k=k, v=v)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _load("fwd").superdiff_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, D, _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(D), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err} "
                           f"(shape {tuple(q.shape)}, {q.dtype})")
    global launches
    launches += 1
    key = _shape_key(q)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out, lse


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


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(out (B,S,H,D), lse (B*H, S) f32)``; kernel on CUDA, plain on CPU."""
    _check(q, k, v)
    if q.is_cuda:
        return _flash_forward_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_forward_plain(q, k, v)


# ---------------------------------------------------------------- backward

def _bwd_strides(*tensors):
    flat = [x for a in tensors for x in a.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _flash_bwd_dq_cuda(q, k, v, g, lse, delta):
    """Launch the dQ kernel; inputs already checked by the caller."""
    B, S, H, D = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _load("bwd").superdiff_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H, D,
            _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D),
            _bwd_strides(q, k, v, g, dq),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed: CUDA error "
                           f"{err} (shape {tuple(q.shape)}, {q.dtype})")
    global bwd_dq_launches
    bwd_dq_launches += 1
    key = _shape_key(q)
    bwd_dq_launches_by_shape[key] = bwd_dq_launches_by_shape.get(key, 0) + 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, g, lse, delta):
    """Launch the dK/dV kernel; inputs already checked by the caller."""
    B, S, H, D = q.shape
    dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
              for _ in range(2))
    with torch.cuda.device(q.device):
        err = _load("bwd").superdiff_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, D, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D),
            _bwd_strides(q, k, v, g, dk, dv),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed: CUDA error "
                           f"{err} (shape {tuple(q.shape)}, {q.dtype})")
    global bwd_dkv_launches
    bwd_dkv_launches += 1
    key = _shape_key(q)
    bwd_dkv_launches_by_shape[key] = bwd_dkv_launches_by_shape.get(key, 0) + 1
    return dk, dv


def _bwd_delta(o, g):
    """``delta = rowsum(dO * O)`` in float32, in lse's ``(B*H, S)`` layout."""
    B, S, H, _ = o.shape
    delta = (g.float() * o.float()).sum(-1)                    # (B, S, H)
    return delta.permute(0, 2, 1).contiguous().view(B * H, S)


def _flash_backward_cuda(q, k, v, o, lse, g):
    if not kernel_supports(q):
        raise ValueError(f"flash kernel takes D in {SUPPORTED_HEAD_DIMS} and "
                         f"bfloat16/float32, got D={q.shape[-1]} {q.dtype}")
    _check_kernel_layout(q=q, k=k, v=v)
    if not _kernel_layout_ok(g):
        g = g.contiguous()                   # the one explicit copy
    delta, lse = _bwd_delta(o, g), lse.contiguous()
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
