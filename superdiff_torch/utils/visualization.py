"""Image artifacts: sample grids, real-vs-generated rows, diffusion strips,
the loss curve, the pixel histogram and ``show_image``.

Port of ``superdiff_tpu/utils/visualization.py``. Functions take NHWC float
arrays (numpy or torch) of any normalization and rescale for display.

Everything is drawn by the port's own renderer (``utils/raster.py``) and
written by :func:`png_bytes`, a PNG encoder on the standard library alone
(``zlib``, ``struct``; also ``serve.encode_images``'s), so the same code
runs on a machine without matplotlib or PIL, the card's included. With no
font renderer, titles and labels go into the PNG's ``tEXt`` chunks.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRID_GAP = 2                 # white pixels between grid tiles


def _host(img) -> np.ndarray:
    if hasattr(img, "detach"):                       # a torch tensor
        img = img.detach().float().cpu().numpy()
    return np.asarray(img)


def _to_display(img: np.ndarray) -> np.ndarray:
    """(H, W, 1|3) any-range float -> [0,1] for display."""
    img = np.asarray(_host(img), dtype=np.float32)
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
    images = _host(images)
    n = images.shape[0]
    ncols = min(ncols, n)
    nrows = (n + ncols - 1) // ncols
    h, w = images.shape[1:3]
    gap = _GRID_GAP
    grid = np.full((nrows * (h + gap) - gap, ncols * (w + gap) - gap), 255,
                   dtype=np.uint8)
    for i in range(n):
        r, c = divmod(i, ncols)
        grid[r * (h + gap):r * (h + gap) + h,
             c * (w + gap):c * (w + gap) + w] = _gray_u8(images[i])
    text = {}
    if suptitle:
        text["Title"] = suptitle
    if titles is not None:
        text["Comment"] = " | ".join(str(t) for t in titles)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(grid, text))
    return path


def _gray_u8(img) -> np.ndarray:
    """One image as an 8-bit gray tile: :func:`_to_display`, RGB averaged,
    ``round(x * 255)`` (``save_image_grid``'s tiles)."""
    img = _to_display(img)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return np.round(img * 255.0).astype(np.uint8)


def to_display_array(img) -> np.ndarray:
    """Coerce any common image container to a displayable ``(H, W[, 3])``
    float array in [0, 1]: objects with PIL's ``convert`` (taken as
    ``convert("L")``, no PIL import), torch tensors, numpy arrays in HW,
    HWC or CHW (a leading batch of one included), any value range, gray or
    RGB."""
    if hasattr(img, "convert") and hasattr(img, "size"):   # PIL duck-type
        img = np.asarray(img.convert("L"), dtype=np.float32)
    img = np.asarray(_host(img), dtype=np.float32)
    if img.ndim == 4 and img.shape[0] == 1:    # (1, ., ., .) batch-of-1
        img = img[0]
    if img.ndim == 3:
        if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
            img = np.moveaxis(img, 0, -1)       # CHW -> HWC
        if img.shape[-1] == 1:
            img = img[..., 0]
    if img.ndim not in (2, 3):
        raise ValueError(f"cannot display image of shape {img.shape}")
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / max(hi - lo, 1e-6)


def show_image(img, path: Optional[str] = None,
               title: Optional[str] = None, cmap: str = "gray") -> str:
    """Write one image from any container or layout as a PNG (default
    ``show_image.png`` in the working directory) and return the path: gray
    through ``cmap`` (``"gray"`` or ``"jet"``), RGB as it is."""
    from superdiff_torch.utils import raster

    arr = to_display_array(img)
    if arr.ndim == 2 and cmap == "jet":
        arr = raster.jet(arr)
    elif arr.ndim == 2 and cmap != "gray":
        raise ValueError(f"show_image draws cmap 'gray' or 'jet', not "
                         f"{cmap!r}")
    return raster.write_png(path or "show_image.png", raster.to_u8(arr),
                            {"Title": title})


def _strip(tiles, path: str, labels: Sequence[str],
           title: Optional[str] = None) -> str:
    from superdiff_torch.utils import raster

    return raster.write_png(path, raster.tile_rows([tiles], gap=_GRID_GAP),
                            {"Title": title,
                             "Comment": " | ".join(labels)})


def save_real_vs_generated(real, generated, path: str) -> str:
    """Side-by-side real/generated rows (at most 8 columns), gray tiles as
    in ``save_image_grid``."""
    from superdiff_torch.utils import raster

    real, generated = _host(real), _host(generated)
    n = min(real.shape[0], generated.shape[0], 8)
    rows = [[_gray_u8(real[i]) for i in range(n)],
            [_gray_u8(generated[i]) for i in range(n)]]
    return raster.write_png(path, raster.tile_rows(rows, gap=_GRID_GAP),
                            {"Title": "top: real   bottom: generated",
                             "Comment": "rows: real | generated"})


def forward_diffusion_frames(schedule, x0, timesteps,
                             generator: Optional[torch.Generator] = None,
                             noise=None) -> np.ndarray:
    """``[x0] + [q_sample(x0, t, noise) for t in timesteps]`` of the first
    image of ``x0``, as ``(1 + len(timesteps), H, W, C)`` numpy; ``noise``
    (the shape of ``x0[:1]``) defaults to a draw from ``generator`` on the
    schedule's device."""
    from superdiff_torch.diffusion.process import q_sample

    dev = schedule.device
    x = torch.as_tensor(_host(x0)[:1], dtype=torch.float32, device=dev)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=dev)
    elif not isinstance(noise, torch.Tensor):
        noise = torch.from_numpy(np.array(noise, dtype=np.float32))
    noise = noise.to(device=dev, dtype=torch.float32)
    frames = [x[0]] + [q_sample(schedule, x, torch.tensor([int(t)],
                                                          device=dev),
                                noise)[0] for t in timesteps]
    return torch.stack(frames).cpu().numpy()


def save_forward_diffusion_strip(schedule, x0, timesteps,
                                 generator: Optional[torch.Generator],
                                 path: str, noise=None) -> str:
    """Forward ``q_sample`` corruption strip of the first image of ``x0``
    (:func:`forward_diffusion_frames`), labelled ``x0, t=...``."""
    frames = forward_diffusion_frames(schedule, x0, timesteps, generator,
                                      noise)
    return _strip([_gray_u8(f) for f in frames], path,
                  ["x0"] + [f"t={t}" for t in timesteps])


def save_reverse_trajectory_strip(frames, path: str) -> str:
    """Reverse-sampling trajectory strip of the first sample of ``frames``
    ``(K, B, H, W, C)`` (``ddpm_sample(num_frames=K)``)."""
    frames = _host(frames)
    return _strip([_gray_u8(frames[k, 0]) for k in range(frames.shape[0])],
                  path, [f"frame {k}" for k in range(frames.shape[0])])


def save_loss_curve(losses: Sequence[float], path: str,
                    ylabel: str = "loss") -> str:
    """Loss-curve PNG: the losses against the step, in a framed box."""
    from superdiff_torch.utils import raster

    losses = np.asarray([float(v) for v in losses], dtype=np.float64)
    return raster.write_png(path, raster.curve(losses),
                            {"XLabel": "step", "YLabel": ylabel,
                             "Comment": f"{len(losses)} steps, last "
                                        f"{losses[-1]:.6g}" if len(losses)
                             else "no steps"})


def save_pixel_histogram(images, path: str, bins: int = 50) -> str:
    """Pixel-intensity histogram, binned by ``np.histogram(..., bins)``;
    the counts and bin edges go into the PNG's text."""
    from superdiff_torch.utils import raster

    counts, edges = np.histogram(_host(images).ravel(), bins=bins)
    return raster.write_png(path, raster.bars(counts, edges),
                            {"XLabel": "pixel value", "YLabel": "count",
                             "Counts": " ".join(map(str, counts)),
                             "Edges": " ".join(f"{e:.9g}" for e in edges)})
