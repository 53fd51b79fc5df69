"""ctypes bindings for the native shard-cache loader (``native/xraycache.cpp``,
shared with the JAX package).

The first pass over a split decodes and host-preprocesses every image once
into one contiguous shard (:func:`build_shard_from_index`, through the
port's decode, resize and CLAHE); every later epoch streams shuffled uint8
batches out of the C++ mmap + prefetch ring (:class:`NativeBatchIterator`).
The shard format (magic ``XRC1``, ``int32 n, h, w, c``, the uint8 images,
the int32 labels) is the JAX package's, so a shard either package wrote is
read by the other and gives the same batches.

The library is compiled from ``native/xraycache.cpp`` with ``g++`` at first
use into ``build/superdiff_torch/`` (``ops/_build.py::build_host``), never
into ``native/``. Where it cannot be built, ``NativeBatchIterator.available()``
is False and the datamodule falls back to ``BatchIterator`` with a warning.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
from typing import Dict, Iterator, Optional

import numpy as np

MAGIC = b"XRC1"

logger = logging.getLogger("superdiff_torch")
_lib = None


def _load_lib() -> Optional[ctypes.CDLL]:
    from superdiff_torch.ops import _build

    try:
        lib = ctypes.CDLL(str(_build.build_host("xraycache")))
    except (RuntimeError, OSError) as e:
        logger.warning("native shard loader unavailable: %s", e)
        return None
    lib.xc_open.restype = ctypes.c_void_p
    lib.xc_open.argtypes = [ctypes.c_char_p]
    lib.xc_info.restype = ctypes.c_int
    lib.xc_info.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int32)]
    lib.xc_start_epoch.restype = ctypes.c_int
    lib.xc_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.xc_next_batch.restype = ctypes.c_int
    lib.xc_next_batch.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_int32)]
    lib.xc_close.restype = None
    lib.xc_close.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loader library, built and bound once per process (``None`` when
    it cannot be built)."""
    global _lib
    if _lib is None:
        _lib = _load_lib() or False
    return _lib or None


def write_shard(path: str, images: np.ndarray, labels: np.ndarray) -> str:
    """Write ``(N, H, W, C) uint8`` images + int32 labels as one shard
    (through a pid-unique temporary file renamed into place, so concurrent
    writers of one shard never leave a partial file)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    n, h, w, c = images.shape
    if labels.shape != (n,):
        raise ValueError(f"labels {labels.shape} for {n} images")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<4i", n, h, w, c))
        f.write(images.tobytes())
        f.write(labels.tobytes())
    os.replace(tmp, path)
    return path


def build_shard_from_index(index, path: str, resolution: int,
                           resize_strategy: str = "pad",
                           histogram_equalization: bool = False) -> str:
    """Decode every image of a ``ChestXrayIndex`` once into a shard."""
    from superdiff_torch.data.image_io import read_gray
    from superdiff_torch.data.transforms import clahe, host_resize

    n = len(index)
    images = np.empty((n, resolution, resolution, 1), dtype=np.uint8)
    labels = np.empty((n,), dtype=np.int32)
    for i, (img_path, label) in enumerate(index.samples):
        arr = host_resize(read_gray(img_path), resolution, resize_strategy)
        if histogram_equalization:
            arr = clahe(arr)
        images[i, :, :, 0] = arr
        labels[i] = label
    return write_shard(path, images, labels)


class NativeBatchIterator:
    """Epoch iterator over a shard via the C++ prefetch ring. Epoch ``e``
    (counted per instance) shuffles with seed ``seed + e + 1`` in the C++
    generator; ``shard=(pid, nproc)`` as ``BatchIterator``'s."""

    def __init__(self, shard_path: str, batch_size: int, seed: int = 0,
                 drop_last: bool = True,
                 shard: Optional[tuple] = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (build failed)")
        if shard is not None:
            pid, nproc = shard
            if not (0 <= pid < nproc):
                raise ValueError(f"bad shard {shard}: need 0 <= id < count")
        self._lib = lib
        self._h = lib.xc_open(shard_path.encode())
        if not self._h:
            raise FileNotFoundError(f"bad shard: {shard_path}")
        info = (ctypes.c_int32 * 4)()
        lib.xc_info(self._h, info)
        self.n, self.height, self.width, self.channels = (
            info[0], info[1], info[2], info[3])
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self._epoch = 0

    @staticmethod
    def available() -> bool:
        return get_lib() is not None

    def __len__(self) -> int:
        n = self.n if self.shard is None else self.n // self.shard[1]
        q, r = divmod(n, self.batch_size)
        return q if (self.drop_last or r == 0) else q + 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pid, nproc = self.shard if self.shard is not None else (0, 1)
        rc = self._lib.xc_start_epoch(
            self._h, ctypes.c_uint64(self.seed + self._epoch + 1),
            self.batch_size, 1 if self.drop_last else 0, pid, nproc)
        if rc != 0:
            raise RuntimeError("xc_start_epoch failed")
        self._epoch += 1
        B, H, W, C = self.batch_size, self.height, self.width, self.channels
        while True:
            imgs = np.empty((B, H, W, C), dtype=np.uint8)
            labels = np.empty((B,), dtype=np.int32)
            count = self._lib.xc_next_batch(
                self._h,
                imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if count < 0:
                raise RuntimeError("xc_next_batch failed")
            if count == 0:
                break
            yield {"image": imgs[:count], "label": labels[:count]}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.xc_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
