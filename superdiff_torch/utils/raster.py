"""The port's own raster renderer: figures drawn into uint8 canvases.

The JAX package draws every figure with matplotlib (scatter plots, curves,
histograms, Grad-CAM overlays, 3D views and their rotation GIF) and its
thumbnails with PIL. The machine with the card has neither, so the port
draws with numpy alone, the same code on every machine:

- a canvas is a ``(H, W, 3)`` uint8 RGB array (white by default); images
  are pasted as tiles, gray or RGB, already scaled to [0, 1] or uint8;
- figures: filled disc markers in a fixed class palette (the five colour
  names of ``analysis/plotly3d.py``'s ``DEFAULT_CLASS_COLORS``, as their CSS
  RGB values), polylines and bars inside a framed plot box, thumbnails at
  embedding positions, and an orthographic 3D view;
- matplotlib's ``jet`` colormap as its 256-entry lookup table, built from
  its segment data as ``LinearSegmentedColormap`` builds it, indexed as
  ``Colormap.__call__`` indexes it;
- :func:`write_png` writes a canvas through ``utils/visualization.py``'s
  ``png_bytes`` (stdlib ``zlib``), :func:`gif_bytes` encodes frames as a
  GIF89a with the standard library and numpy.

There is no font renderer: titles, axis labels, legends and class names go
into the PNG's ``tEXt`` chunks (``write_png(..., text=)``), as
``save_image_grid`` already does.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

WHITE = (255, 255, 255)
BLACK = (0, 0, 0)
EDGE_GRAY = (170, 170, 170)

# analysis/plotly3d.py's DEFAULT_CLASS_COLORS, as CSS defines them
CLASS_COLOR_NAMES = ("green", "red", "royalblue", "orange", "purple")
CSS_RGB = {"green": (0, 128, 0), "red": (255, 0, 0),
           "royalblue": (65, 105, 225), "orange": (255, 165, 0),
           "purple": (128, 0, 128)}
CLASS_COLORS = tuple(CSS_RGB[n] for n in CLASS_COLOR_NAMES)

# matplotlib's _cm._jet_data: (x, y0, y1) break points per channel
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
JET_N = 256


def _segment_lut(data, n: int) -> np.ndarray:
    """``matplotlib.colors._create_lookup_table(n, data)`` (gamma 1)."""
    adata = np.array(data, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_lut(n: int = JET_N) -> np.ndarray:
    """matplotlib's ``jet`` lookup table: ``(n, 3)`` float64 RGB."""
    return np.stack([_segment_lut(_JET_DATA[c], n)
                     for c in ("red", "green", "blue")], axis=-1)


def jet(values) -> np.ndarray:
    """``matplotlib.cm.jet(values)[..., :3]`` for float values: the index is
    ``values * 256`` in the input's dtype, truncated, with 1.0 mapped to the
    last entry, values below 0 to the first and above 1 to the last; NaN
    gives black. Returns float64 ``values.shape + (3,)``."""
    xa = np.array(values, copy=True)
    if xa.dtype.kind != "f":
        raise TypeError(f"jet takes float values, got {xa.dtype}")
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    under, over, bad = xa < 0, xa >= JET_N, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = JET_N - 1
    lut = jet_lut()
    out = lut.take(np.clip(idx, 0, JET_N - 1), axis=0)
    out[bad] = 0.0
    return out


# ---------------------------------------------------------------- canvas ---

def canvas(height: int, width: int, color=WHITE) -> np.ndarray:
    """A ``(height, width, 3)`` uint8 canvas filled with ``color``."""
    out = np.empty((height, width, 3), dtype=np.uint8)
    out[:] = color
    return out


def to_u8(img) -> np.ndarray:
    """A display array in [0, 1] (gray ``(H, W)`` or RGB ``(H, W, 3)``) ->
    uint8 by ``round(x * 255)``; uint8 input passes through."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def paste(dst: np.ndarray, tile, top: int, left: int) -> None:
    """Paste ``tile`` (gray or RGB, [0, 1] or uint8) with its top-left
    corner at ``(top, left)``, clipped to ``dst``."""
    t = to_u8(tile)
    if t.ndim == 2 and dst.ndim == 3:
        t = np.repeat(t[..., None], 3, axis=-1)
    h, w = t.shape[:2]
    r0, c0 = max(top, 0), max(left, 0)
    r1, c1 = min(top + h, dst.shape[0]), min(left + w, dst.shape[1])
    if r1 > r0 and c1 > c0:
        dst[r0:r1, c0:c1] = t[r0 - top:r1 - top, c0 - left:c1 - left]


def tile_rows(rows: Sequence[Sequence], gap: int = 2,
              color=WHITE) -> np.ndarray:
    """Tiles laid out row by row (each row left-aligned), ``gap`` pixels
    of ``color`` between them; tiles of one row share their height."""
    heights = [max(np.asarray(t).shape[0] for t in row) for row in rows]
    widths = [sum(np.asarray(t).shape[1] for t in row) + gap * (len(row) - 1)
              for row in rows]
    out = canvas(sum(heights) + gap * (len(rows) - 1), max(widths), color)
    top = 0
    for row, h in zip(rows, heights):
        left = 0
        for t in row:
            paste(out, t, top, left)
            left += np.asarray(t).shape[1] + gap
        top += h + gap
    return out


def fill_rect(dst, top, left, bottom, right, color) -> None:
    """Fill rows ``top..bottom-1`` and columns ``left..right-1``."""
    top, left = max(int(top), 0), max(int(left), 0)
    dst[top:max(int(bottom), top), left:max(int(right), left)] = color


def frame(dst, top, left, bottom, right, color=BLACK) -> None:
    """A one-pixel rectangle on rows ``top``/``bottom`` and columns
    ``left``/``right`` (inclusive)."""
    fill_rect(dst, top, left, top + 1, right + 1, color)
    fill_rect(dst, bottom, left, bottom + 1, right + 1, color)
    fill_rect(dst, top, left, bottom + 1, left + 1, color)
    fill_rect(dst, top, right, bottom + 1, right + 1, color)


def fill_disc(dst, row: float, col: float, radius: float, color) -> None:
    """A filled disc of ``radius`` pixels centred at ``(row, col)``."""
    r = int(math.ceil(radius))
    r0, c0 = int(round(row)) - r, int(round(col)) - r
    yy, xx = np.mgrid[r0:r0 + 2 * r + 1, c0:c0 + 2 * r + 1]
    inside = ((yy - row) ** 2 + (xx - col) ** 2 <= radius * radius + 0.25)
    inside &= (yy >= 0) & (yy < dst.shape[0]) & (xx >= 0) & (xx < dst.shape[1])
    dst[yy[inside], xx[inside]] = color


def line(dst, r0: float, c0: float, r1: float, c1: float, color) -> None:
    """A one-pixel line from ``(r0, c0)`` to ``(r1, c1)``: one sample per
    pixel step along the longer axis, rounded."""
    n = int(max(abs(r1 - r0), abs(c1 - c0))) + 1
    rr = np.round(np.linspace(r0, r1, n + 1)).astype(int)
    cc = np.round(np.linspace(c0, c1, n + 1)).astype(int)
    keep = (rr >= 0) & (rr < dst.shape[0]) & (cc >= 0) & (cc < dst.shape[1])
    dst[rr[keep], cc[keep]] = color


def limits(values, margin: float = 0.05) -> Tuple[float, float]:
    """Axis limits as matplotlib autoscales them: the data range widened
    by ``margin`` of it on each side (a flat range by 0.5 each way)."""
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return -0.5, 0.5
    lo, hi = float(v.min()), float(v.max())
    if hi == lo:
        return lo - 0.5, hi + 0.5
    pad = margin * (hi - lo)
    return lo - pad, hi + pad


class PlotBox:
    """A framed plot area of ``dst`` (rows ``top..bottom``, columns
    ``left..right``) mapping data ``xlim`` / ``ylim`` onto it, y upwards."""

    def __init__(self, dst, top, left, bottom, right, xlim, ylim):
        self.dst = dst
        self.top, self.left, self.bottom, self.right = top, left, bottom, right
        self.xlim, self.ylim = xlim, ylim
        frame(dst, top, left, bottom, right)

    def px(self, x, y):
        """Data coordinates -> (row, col) float pixel coordinates."""
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        col = self.left + 1 + (np.asarray(x, np.float64) - x0) / (x1 - x0) \
            * (self.right - self.left - 2)
        row = self.bottom - 1 - (np.asarray(y, np.float64) - y0) / (y1 - y0) \
            * (self.bottom - self.top - 2)
        return row, col


def _plot_box(dst, xlim, ylim, margin: int = 24) -> PlotBox:
    h, w = dst.shape[:2]
    return PlotBox(dst, margin, margin, h - margin, w - margin, xlim, ylim)


# --------------------------------------------------------------- figures ---

def class_color(cls: int):
    return CLASS_COLORS[int(cls) % len(CLASS_COLORS)]


def legend_text(labels, class_names=None) -> str:
    """``"green: TB | red: NORMAL"``: each class present, its marker colour
    and name (``class {c}`` past the names given)."""
    parts = []
    for cls in np.unique(np.asarray(labels)):
        name = (class_names[cls] if class_names is not None
                and cls < len(class_names) else f"class {cls}")
        parts.append(f"{CLASS_COLOR_NAMES[int(cls) % len(CLASS_COLORS)]}: "
                     f"{name}")
    return " | ".join(parts)


def scatter(emb, labels, size=(500, 600), radius: float = 3.0) -> np.ndarray:
    """2D scatter of ``emb (N, 2)``, one marker colour per class, in a
    framed box of a ``size = (height, width)`` canvas."""
    emb, labels = np.asarray(emb, np.float64), np.asarray(labels)
    out = canvas(*size)
    box = _plot_box(out, limits(emb[:, 0]), limits(emb[:, 1]))
    rows, cols = box.px(emb[:, 0], emb[:, 1])
    for i in range(len(emb)):
        fill_disc(out, rows[i], cols[i], radius, class_color(labels[i]))
    return out


def thumbnail(image, side: int) -> np.ndarray:
    """One image min-max scaled to uint8 gray and resized to ``side``²
    with PIL's bicubic resampling (``data/image_io.py::resize_u8``)."""
    from superdiff_torch.data.image_io import resize_u8

    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    lo, hi = float(img.min()), float(img.max())
    u8 = to_u8((img - lo) / max(hi - lo, 1e-6))
    return resize_u8(u8, (side, side), "bicubic")


def thumbnail_scatter(emb, images, size=(700, 800),
                      side: int = 38) -> np.ndarray:
    """Each image's thumbnail (``side`` pixels) centred at its 2D
    embedding position inside a framed box, drawn in input order."""
    emb = np.asarray(emb, np.float64)
    out = canvas(*size)
    box = _plot_box(out, limits(emb[:, 0]), limits(emb[:, 1]),
                    margin=24 + side // 2)
    rows, cols = box.px(emb[:, 0], emb[:, 1])
    for i in range(len(emb)):
        paste(out, thumbnail(images[i], side), int(round(rows[i])) - side // 2,
              int(round(cols[i])) - side // 2)
    return out


def curve(values, size=(350, 600), color=(31, 119, 180)) -> np.ndarray:
    """A polyline of ``values`` against their index in a framed box."""
    y = np.asarray(values, np.float64).ravel()
    out = canvas(*size)
    x = np.arange(len(y), dtype=np.float64)
    box = _plot_box(out, limits(x), limits(y))
    rows, cols = box.px(x, y)
    if len(y) == 1:
        fill_disc(out, rows[0], cols[0], 1.5, color)
    for i in range(len(y) - 1):
        line(out, rows[i], cols[i], rows[i + 1], cols[i + 1], color)
    return out


def bars(counts, edges, size=(350, 500), color=(31, 119, 180)) -> np.ndarray:
    """Histogram bars: bin ``i`` spans ``edges[i]..edges[i+1]`` with height
    ``counts[i]``, from zero, in a framed box."""
    counts = np.asarray(counts, np.float64)
    edges = np.asarray(edges, np.float64)
    out = canvas(*size)
    box = _plot_box(out, limits(edges), (0.0, max(counts.max(), 1.0) * 1.05))
    top, left = box.px(edges[:-1], counts)
    base, right = box.px(edges[1:], np.zeros_like(counts))
    for i in range(len(counts)):
        fill_rect(out, round(top[i]), round(left[i]), round(base[i]) + 1,
                  max(round(right[i]), round(left[i]) + 1), color)
    return out


def project_3d(points, elev: float = 30.0, azim: float = -60.0):
    """Orthographic view of ``points (N, 3)`` from matplotlib's camera
    angles (degrees): ``(screen_x, screen_y, depth)``, depth growing toward
    the viewer."""
    p = np.asarray(points, np.float64)
    e, a = math.radians(elev), math.radians(azim)
    eye = np.array([math.cos(e) * math.cos(a), math.cos(e) * math.sin(a),
                    math.sin(e)])
    right = np.array([-math.sin(a), math.cos(a), 0.0])
    up = np.cross(eye, right)
    return p @ right, p @ up, p @ eye


_CUBE_EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8)
               if bin(a ^ b).count("1") == 1]


def scatter_3d(emb, labels, size=(600, 700), elev: float = 30.0,
               azim: float = -60.0, radius: float = 3.0) -> np.ndarray:
    """3D scatter of ``emb (N, 3)``: each axis scaled to [-1, 1] over its
    limits, the unit box's edges in gray, the points orthographically
    projected from ``(elev, azim)`` and drawn back to front."""
    emb, labels = np.asarray(emb, np.float64), np.asarray(labels)
    lims = [limits(emb[:, i]) for i in range(3)]
    unit = np.stack([2.0 * (emb[:, i] - lo) / (hi - lo) - 1.0
                     for i, (lo, hi) in enumerate(lims)], axis=1)
    corners = np.array([[(k >> 2) & 1, (k >> 1) & 1, k & 1]
                        for k in range(8)], np.float64) * 2.0 - 1.0
    h, w = size
    out = canvas(h, w)
    cx, cy, _ = project_3d(corners, elev, azim)
    scale = 0.45 * min(h, w) / max(np.abs(cx).max(), np.abs(cy).max())

    def to_px(sx, sy):
        return h / 2 - sy * scale, w / 2 + sx * scale

    crow, ccol = to_px(cx, cy)
    for a, b in _CUBE_EDGES:
        line(out, crow[a], ccol[a], crow[b], ccol[b], EDGE_GRAY)
    sx, sy, depth = project_3d(unit, elev, azim)
    rows, cols = to_px(sx, sy)
    for i in np.argsort(depth, kind="stable"):
        fill_disc(out, rows[i], cols[i], radius, class_color(labels[i]))
    return out


# ---------------------------------------------------------------- output ---

def write_png(path: str, img: np.ndarray,
              text: Optional[Dict[str, str]] = None) -> str:
    """Write a canvas (RGB or gray uint8) as a PNG, ``text`` as ``tEXt``
    chunks; the directory is created."""
    from superdiff_torch.utils.visualization import png_bytes

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img, {k: v for k, v in (text or {}).items()
                                if v is not None}))
    return path


_GIF_CHUNK = 254          # literal codes between clear codes


def _palette(frames: np.ndarray):
    """Each pixel's palette index and the palette (at most 256 RGB
    colours): the frames' own colours when they are few enough, else each
    channel quantised to 6 levels."""
    rgb = frames.reshape(-1, 3).astype(np.int64)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    colours = np.unique(packed)
    if len(colours) > 256:
        q = (rgb * 5 + 127) // 255
        packed = q[:, 0] * 36 + q[:, 1] * 6 + q[:, 2]
        lv = np.arange(6) * 51
        pal = np.stack(np.meshgrid(lv, lv, lv, indexing="ij"), -1).reshape(-1, 3)
        return packed.astype(np.uint8), pal.astype(np.uint8)
    idx = np.searchsorted(colours, packed).astype(np.uint8)
    pal = np.stack([(colours >> 16) & 255, (colours >> 8) & 255,
                    colours & 255], -1).astype(np.uint8)
    return idx, pal


def _lzw_literal(indices: np.ndarray) -> bytes:
    """GIF LZW data (minimum code size 8) that encodes every pixel as its
    own 9-bit literal code, with a clear code before each run of 254 so the
    decoder's code size never grows past 9 bits; packed LSB first and cut
    into sub-blocks of at most 255 bytes."""
    n = len(indices)
    runs = -(-n // _GIF_CHUNK)
    codes = np.empty(n + runs + 1, dtype=np.int64)
    pos = np.arange(n)
    codes[pos + pos // _GIF_CHUNK + 1] = indices
    codes[np.arange(runs) * (_GIF_CHUNK + 1)] = 256          # clear
    codes[-1] = 257                                          # end
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).ravel()
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
              for i in range(0, len(data), 255)]
    return b"".join(blocks) + b"\x00"


def gif_bytes(frames, delay_cs: int = 7, loop: int = 0) -> bytes:
    """A looping GIF89a of ``frames`` ``(K, H, W, 3)`` uint8, ``delay_cs``
    hundredths of a second per frame (7 for matplotlib's 15 fps), one
    global palette, every frame whole."""
    frames = np.asarray(frames, dtype=np.uint8)
    k, h, w = frames.shape[:3]
    idx, pal = _palette(frames)
    table = np.zeros((256, 3), np.uint8)
    table[:len(pal)] = pal
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
           table.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop)
           + b"\x00"]
    per = h * w
    for i in range(k):
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs)
                + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0), b"\x08",
                _lzw_literal(idx[i * per:(i + 1) * per])]
    out.append(b"\x3b")
    return b"".join(out)
