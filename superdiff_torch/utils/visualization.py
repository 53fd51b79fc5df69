"""Image artifacts: sample grids, real-vs-generated rows and the loss curve.

Port of ``save_image_grid``, ``save_real_vs_generated`` and
``save_loss_curve`` of ``superdiff_tpu/utils/visualization.py``; the
trajectory strips come with the analysis slice. Functions take NHWC float
arrays of any normalization (they rescale for display).

``save_image_grid`` (what ``cli/sample.py`` writes per batch) and
``png_bytes`` (also ``serve.encode_images``'s encoder) write 8-bit
grayscale PNGs with the standard library alone (``zlib``, ``struct``), so
they work on a machine without matplotlib or PIL. The two training plots
use matplotlib's Agg backend, imported inside the functions: a machine
without it can still train with ``training.vis_every = 0``.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRID_GAP = 2                 # white pixels between grid tiles


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _to_display(img: np.ndarray) -> np.ndarray:
    """(H, W, 1|3) any-range float -> [0,1] for imshow."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / max(hi - lo, 1e-6)


def png_bytes(gray: np.ndarray, text: Optional[dict] = None) -> bytes:
    """An 8-bit grayscale PNG of a ``(H, W)`` uint8 array, each row with
    filter 0, one zlib stream; ``text`` entries become ``tEXt`` chunks."""
    img = np.ascontiguousarray(gray, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"png_bytes takes a (H, W) array, got {img.shape}")
    h, w = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    out = [_PNG_SIGNATURE,
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(chunk(b"tEXt", key.encode("latin-1") + b"\0"
                         + str(value).encode("latin-1", "replace")))
    out += [chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
            chunk(b"IEND", b"")]
    return b"".join(out)


def save_image_grid(images, path: str, ncols: int = 4,
                    titles: Optional[Sequence[str]] = None,
                    suptitle: Optional[str] = None) -> str:
    """NHWC batch -> grid PNG, ``ncols`` images per row, each min-max
    scaled to 8-bit gray (``_to_display``; 3-channel images averaged),
    2-pixel white gaps. With no font renderer, ``titles`` and ``suptitle``
    go into the PNG's text chunks ("Title", "Comment")."""
    images = np.asarray(images)
    n = images.shape[0]
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    h, w = images.shape[1:3]
    gap = _GRID_GAP
    grid = np.full((nrows * (h + gap) - gap, ncols * (w + gap) - gap), 255,
                   dtype=np.uint8)
    for i in range(n):
        img = _to_display(images[i])
        if img.ndim == 3:
            img = img.mean(axis=-1)
        r, c = divmod(i, ncols)
        grid[r * (h + gap):r * (h + gap) + h,
             c * (w + gap):c * (w + gap) + w] = np.round(img * 255.0)
    text = {}
    if suptitle:
        text["Title"] = suptitle
    if titles is not None:
        text["Comment"] = " | ".join(str(t) for t in titles)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(grid, text))
    return path


def save_real_vs_generated(real, generated, path: str) -> str:
    """Side-by-side real/generated rows (at most 8 columns)."""
    plt = _mpl()
    real, generated = np.asarray(real), np.asarray(generated)
    n = min(real.shape[0], generated.shape[0], 8)
    fig, axes = plt.subplots(2, n, figsize=(2.0 * n, 4.2), squeeze=False)
    for i in range(n):
        axes[0][i].imshow(_to_display(real[i]), cmap="gray")
        axes[0][i].axis("off")
        axes[1][i].imshow(_to_display(generated[i]), cmap="gray")
        axes[1][i].axis("off")
    axes[0][0].set_ylabel("real")
    axes[1][0].set_ylabel("generated")
    fig.suptitle("top: real   bottom: generated")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return path


def save_loss_curve(losses: Sequence[float], path: str,
                    ylabel: str = "loss") -> str:
    """Loss-curve PNG."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(np.asarray(losses))
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return path
