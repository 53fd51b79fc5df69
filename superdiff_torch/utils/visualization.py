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


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int, kinds) -> np.ndarray:
    """PNG row filters (specification, section 9.2) of ``(H, rowbytes)``
    bytes, row ``r`` with filter ``kinds[r]``; the filter byte leads each
    row."""
    x = raw.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = (0, a, b, (a + b) >> 1, _paeth(a, b, c))
    kinds = np.asarray(kinds)
    out = np.empty((x.shape[0], x.shape[1] + 1), dtype=np.uint8)
    out[:, 0] = kinds
    for k in range(5):
        rows = kinds == k
        out[rows, 1:] = (x[rows] - (preds[k][rows] if k else 0)) & 0xFF
    return out


def png_bytes(img: np.ndarray, text: Optional[dict] = None,
              filter=0) -> bytes:
    """A PNG of a ``(H, W)`` uint8 (8-bit grayscale) or uint16 (16-bit
    grayscale) array or a ``(H, W, 3)`` uint8 array (RGB), one zlib
    stream; ``text`` entries become ``tEXt`` chunks. ``filter``: the PNG
    row filter of every row (0-4: None, Sub, Up, Average, Paeth), or
    ``"cycle"`` for row ``r`` filtered with ``r % 5`` (the decoder's tests
    and the chip smoke's trees)."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype == np.uint16:
        depth, ctype, raw = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3):
        img = np.ascontiguousarray(img, dtype=np.uint8)
        depth, ctype = 8, 0 if img.ndim == 2 else 2
        raw = img
    else:
        raise ValueError(f"png_bytes takes a (H, W) or (H, W, 3) array, got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    raw = raw.reshape(h, -1)
    kinds = (np.arange(h) % 5 if filter == "cycle"
             else np.full(h, int(filter)))
    if kinds.max(initial=0) > 4 or kinds.min(initial=0) < 0:
        raise ValueError(f"PNG filter types are 0-4, got {filter!r}")
    rows = _filter_rows(raw, raw.shape[1] // w, kinds)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    out = [_PNG_SIGNATURE,
           chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      0))]
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
