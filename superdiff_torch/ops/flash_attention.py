"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Port of ``superdiff_tpu/ops/flash_attention.py::_flash_forward`` (the TPU
kernel ``_flash_kernel``). The kernel is ``csrc/flash_attn_fwd.cu``: CUDA
C++ for ``sm_90a`` with a plain C interface, compiled with ``nvcc`` at first
use into ``build/superdiff_torch/`` (keyed by a hash of the source) and
bound with ``ctypes``.

Contract of :func:`_flash_forward`:

- ``q, k, v``: ``(B, S, H, D)``, any strides with a contiguous last dim,
  bfloat16 or float32, ``D`` in {32, 64, 128}, any ``S``;
- returns ``(out (B, S, H, D) in the input dtype, lse (B*H, S) float32)``.

A CUDA tensor launches the kernel or raises; a CPU tensor takes
:func:`_flash_forward_plain`, the same function in plain PyTorch (full f32
softmax plus logsumexp). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_attn_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "superdiff_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches = 0                 # kernel launches since the last reset
launches_by_shape = {}       # (S, D, dtype name) -> launches, same events
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_shape.clear()


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


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source hash) and return the .so path.

    ``verbose=True`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per instantiation)."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"flash_attn_fwd_{tag}.so"
    if so.exists() and not verbose:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.superdiff_flash_attn_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _flash_forward_cuda(q, k, v):
    B, S, H, D = q.shape
    if not kernel_supports(q):
        raise ValueError(f"flash kernel takes D in {SUPPORTED_HEAD_DIMS} and "
                         f"bfloat16/float32, got D={D} {q.dtype}")
    vec = 16 // q.element_size()
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim")
        if a.data_ptr() % 16 or any(s % vec for s in a.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"divisible by {vec} elements")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _load().superdiff_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, D, _DTYPE_CODE[q.dtype],
            1.0 / math.sqrt(D), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: CUDA error {err} "
                           f"(shape {tuple(q.shape)}, {q.dtype})")
    global launches
    launches += 1
    key = (S, D, str(q.dtype).replace("torch.", ""))
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


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Flash attention, ``(B, S, H, D)`` -> ``(B, S, H, D)``, no mask."""
    return _flash_forward(q, k, v)[0]
