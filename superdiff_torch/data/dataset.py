"""Folder-tree chest X-ray dataset index and batch iterator.

Port of ``superdiff_tpu/data/dataset.py``. Layout:
``root/TASK/split/CLASS_NAME/*.{jpg,jpeg,png,bmp}``, classes sorted
alphabetically -> indices, optional ``class_filter`` keeping one class.

The host decodes (``data/image_io.py``: PNG, BMP and JPEG without PIL),
applies the resize strategy and optional CLAHE (``data/transforms.py``) and
stacks uint8 batches; normalization and augmentation run on the device
(``prepare_batch``). The batches equal the JAX package's bit for bit, in
the same order.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from superdiff_torch.data.image_io import read_gray, resize_u8

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


class ChestXrayIndex:
    """Index of (path, class) pairs for one task/split."""

    def __init__(self, root_dir: str,
                 task: Optional[str] = None,
                 split: Optional[str] = None,
                 class_filter: Optional[int] = None):
        base = root_dir
        if task:
            base = os.path.join(base, task)
        if split:
            base = os.path.join(base, split)
        if not os.path.isdir(base):
            raise FileNotFoundError(f"dataset directory not found: {base}")
        self.base = base
        self.classes: List[str] = sorted(
            d for d in os.listdir(base)
            if os.path.isdir(os.path.join(base, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class subdirectories in {base}")
        self.class_to_idx: Dict[str, int] = {
            c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            idx = self.class_to_idx[cls]
            if class_filter is not None and idx != class_filter:
                continue
            cdir = os.path.join(base, cls)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(IMAGE_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, name), idx))
        if not self.samples:
            raise FileNotFoundError(
                f"no images found under {base} "
                f"(class_filter={class_filter})")

    def __len__(self) -> int:
        return len(self.samples)

    def class_counts(self) -> Dict[str, int]:
        counts = {c: 0 for c in self.classes}
        for _, idx in self.samples:
            counts[self.classes[idx]] += 1
        return counts


def decode_image(path: str, size: int) -> np.ndarray:
    """Grayscale uint8 at the raw size, shrunk (PIL's default bicubic
    resize, sizes truncated) when its long side exceeds ``2 * size``."""
    img = read_gray(path)
    h, w = img.shape
    if max(w, h) > 2 * size:
        scale = (2 * size) / max(w, h)
        img = resize_u8(img, (max(1, int(w * scale)), max(1, int(h * scale))),
                        "bicubic")
    return img


class BatchIterator:
    """Shuffled epoch iterator yielding ``{"image": (B, R, R, 1) uint8,
    "label": (B,) int32}`` host batches.

    Epoch ``e`` (counted per instance) permutes with
    ``np.random.default_rng(seed + e)``. ``shard=(pid, nproc)`` keeps this
    process's strided slice of the global permutation, truncated to a
    multiple of ``nproc`` so every process sees the same number of batches;
    ``batch_size`` is then the per-process batch. ``cache``: ``True`` for a
    private decode cache, a dict to share one between iterators, ``False``
    for none.
    """

    def __init__(self, index: ChestXrayIndex, batch_size: int,
                 resolution: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, resize_strategy: str = "pad",
                 histogram_equalization: bool = False,
                 cache=True, shard: Optional[Tuple[int, int]] = None):
        self.index = index
        self.batch_size = batch_size
        self.resolution = resolution
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.resize_strategy = resize_strategy
        self.histogram_equalization = histogram_equalization
        if shard is not None:
            pid, nproc = shard
            if not (0 <= pid < nproc):
                raise ValueError(f"bad shard {shard}: need 0 <= id < count")
        self.shard = shard
        self._epoch = 0
        self._cache: Optional[Dict[str, np.ndarray]] = (
            cache if isinstance(cache, dict) else ({} if cache else None))

    def _load(self, path: str) -> np.ndarray:
        from superdiff_torch.data.transforms import clahe, host_resize

        img = self._cache.get(path) if self._cache is not None else None
        if img is None:
            img = host_resize(read_gray(path), self.resolution,
                              self.resize_strategy)
            if self.histogram_equalization:
                img = clahe(img)
            if self._cache is not None:
                self._cache[path] = img
        return img

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.index))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        if self.shard is not None:
            pid, nproc = self.shard
            order = order[:len(order) - len(order) % nproc][pid::nproc]
        self._epoch += 1
        bs = self.batch_size
        end = len(order) - (len(order) % bs if self.drop_last else 0)
        for start in range(0, end, bs):
            sel = order[start:start + bs]
            imgs = np.stack([
                self._load(self.index.samples[i][0]) for i in sel])
            labels = np.asarray(
                [self.index.samples[i][1] for i in sel], dtype=np.int32)
            yield {"image": imgs[..., None], "label": labels}

    def __len__(self) -> int:
        n_samples = len(self.index)
        if self.shard is not None:
            n_samples //= self.shard[1]
        n = n_samples // self.batch_size
        if not self.drop_last and n_samples % self.batch_size:
            n += 1
        return n
