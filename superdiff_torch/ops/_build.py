"""Build and load the port's hand-written CUDA kernels.

Every source under ``csrc/`` is CUDA C++ for ``sm_90a`` with a plain C
interface. It is compiled with ``nvcc`` at first use into
``build/superdiff_torch/`` (one ``.so`` per source, keyed by a hash of the
source and the flags) and bound with ``ctypes``. Each exported C function
returns the CUDA error code of its launches (0 on success).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"fwd": _CSRC / "flash_attn_fwd.cu",
           "bwd": _CSRC / "flash_attn_bwd.cu",
           "gn": _CSRC / "group_norm_silu.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "superdiff_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are compiled at first use")


def build(which: str, verbose: bool = False, defines=()) -> Path:
    """Compile one kernel source (a key of ``SOURCES``; once per source
    hash and flags) and return the .so path.

    ``verbose=True`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per instantiation). ``defines`` are
    extra preprocessor macros (``-D``), for a variant build of a tool."""
    source = SOURCES[which]
    src = source.read_bytes()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"{source.stem}_{tag}.so"
    if so.exists() and not verbose:
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []),
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


def source_tiles(which: str, macro: str) -> list:
    """The ``X(...)`` entries of the first ``#define macro(X)`` of one
    kernel source (a key of ``SOURCES``), as tuples of their integer
    arguments (type arguments dropped): the instantiations a build makes."""
    src = SOURCES[which].read_text()
    body = re.search(rf"#define {macro}\(X\)(.*?)(?:\n#|\Z)", src, re.S)
    if body is None:
        raise ValueError(f"{SOURCES[which].name} defines no {macro}(X)")
    return [tuple(int(a) for a in args.split(",") if a.strip().isdigit())
            for args in re.findall(r"X\(([^)]*)\)", body.group(1))]


def build_all(verbose: bool = False) -> dict:
    """Compile every source, one ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {w: pool.submit(build, w, verbose) for w in SOURCES}
        return {w: f.result() for w, f in futures.items()}


def load(which: str, argtypes: dict, defines=()):
    """The ``ctypes`` library of one source (built with ``defines``), built
    at first use. ``argtypes`` maps each C function to its argument types;
    every one returns an ``int`` (a CUDA error code)."""
    key = (which, tuple(defines))
    if key not in _libs:
        lib = ctypes.CDLL(str(build(which, defines=defines)))
        for name, types in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _libs[key] = lib
    return _libs[key]
