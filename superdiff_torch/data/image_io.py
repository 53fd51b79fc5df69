"""Host image decode and resampling without PIL: what ``superdiff_tpu``
borrows from PIL, reproduced bit for bit.

The JAX package decodes with ``PIL.Image.open(path).convert("L")`` and
resizes and crops with PIL (``superdiff_tpu/data/dataset.py``,
``transforms.py``). The machine with the card has no PIL, so the port keeps
its own copy of those operations, held against PIL by the CPU tests:

- :func:`read_gray`: PNG (``zlib`` + numpy; grayscale at 1-16 bits, RGB,
  RGBA, gray+alpha and palette, all five row filters, not interlaced) and
  BMP (8-bit palette, 24-bit) decode, then ``convert("L")`` as PIL does it:
  RGB through the fixed-point luma ``(19595 R + 38470 G + 7471 B + 0x8000)
  >> 16``, a palette through the luma of its entries, alpha dropped, 16-bit
  samples of colour images by their high byte and 16-bit grayscale
  **clipped at 255** (PIL's ``I;16`` -> ``L``). JPEG (baseline, extended
  sequential and progressive Huffman at 8 bits, gray, 3 or 4 components,
  chroma subsampled up to 2:1 each way, restart intervals) is decoded by
  ``csrc/jpeg_decode.cpp`` to the samples PIL's libjpeg-turbo gives (ISLOW
  IDCT, fancy upsampling, fixed-point YCbCr->RGB, YCCK->CMYK), then the same
  luma (CMYK inverted and through PIL's ``cmyk2rgb`` first); other JPEG
  forms raise ``ValueError`` naming the form. PIL is never imported.
- :func:`resize_u8`: ``Image.resize`` of a mode ``L`` image with the
  ``BILINEAR`` or ``BICUBIC`` filter: PIL's separable resampling with
  coefficients normalised in double and rounded to 22-bit fixed point,
  horizontal pass then vertical pass.
- :func:`crop_u8`: ``Image.crop``, zeros past the image's edge.

The Average and Paeth row filters are sequential along a row; the row
unfilter runs in ``csrc/png_unfilter.cpp`` (built by ``g++`` at first use,
``ops/_build.py::build_host``), with :func:`unfilter_plain` as its plain
version, used where the library cannot be built. The JPEG decoder has no
such fallback: where it cannot be built, decoding a JPEG raises.
"""

from __future__ import annotations

import ctypes
import logging
import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PRECISION_BITS = 32 - 8 - 2            # PIL's 8-bit resampling fixed point
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}                        # the bit depths each allows

logger = logging.getLogger("superdiff_torch")


# ---------------------------------------------------------------- PNG ------

def unfilter_plain(raw: np.ndarray, height: int, rowbytes: int,
                   bpp: int) -> np.ndarray:
    """Reconstruct ``height`` filtered rows (each a filter-type byte and
    ``rowbytes`` bytes, ``bpp`` bytes per pixel, at least 1) into a
    ``(height, rowbytes)`` uint8 array, in numpy: the plain version of
    ``csrc/png_unfilter.cpp``."""
    rows = raw.reshape(height, rowbytes + 1)
    out = np.empty((height, rowbytes), dtype=np.uint8)
    prev = np.zeros(rowbytes, dtype=np.uint8)
    for r in range(height):
        kind, f = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            x = f.copy()
        elif kind == 1:
            x = np.cumsum(np.pad(f, (0, -rowbytes % bpp)).reshape(-1, bpp),
                          axis=0, dtype=np.uint8).reshape(-1)[:rowbytes]
        elif kind == 2:
            x = f + prev
        elif kind in (3, 4):
            x = np.zeros(rowbytes, dtype=np.uint8)
            b = prev.astype(np.int32)
            for i in range(rowbytes):
                a = int(x[i - bpp]) if i >= bpp else 0
                if kind == 3:
                    pred = (a + int(b[i])) >> 1
                else:
                    c = int(b[i - bpp]) if i >= bpp else 0
                    p = a + int(b[i]) - c
                    pa, pb, pc = abs(p - a), abs(p - int(b[i])), abs(p - c)
                    pred = (a if pa <= pb and pa <= pc
                            else int(b[i]) if pb <= pc else c)
                x[i] = (int(f[i]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {kind}")
        out[r] = x
        prev = x
    return out


_png_lib = None


def _unfilter_lib():
    """The native row unfilter, built at first use; ``None`` (with a
    warning, once) where it cannot be built."""
    global _png_lib
    if _png_lib is None:
        from superdiff_torch.ops import _build

        u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
        try:
            _png_lib = _build.load("png", {"superdiff_png_unfilter": [
                u8p, u8p, i64, i64, ctypes.c_int]})
        except (RuntimeError, OSError) as e:
            logger.warning("PNG row unfilter library unavailable (%s); "
                           "using the numpy version", e)
            _png_lib = False
    return _png_lib or None


def unfilter_backend() -> str:
    """``"native"`` when PNG rows are unfiltered by the C++ library, else
    ``"numpy"``."""
    return "native" if _unfilter_lib() is not None else "numpy"


def unfilter(raw: np.ndarray, height: int, rowbytes: int,
             bpp: int) -> np.ndarray:
    """:func:`unfilter_plain` through the native library when it builds."""
    lib = _unfilter_lib()
    if lib is None:
        return unfilter_plain(raw, height, rowbytes, bpp)
    if raw.size != height * (rowbytes + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * (rowbytes + 1)}")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty((height, rowbytes), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.superdiff_png_unfilter(raw.ctypes.data_as(u8p),
                                     out.ctypes.data_as(u8p), height,
                                     rowbytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type "
                         f"{raw[(bad - 1) * (rowbytes + 1)]}")
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's ``L24``: ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> its ``convert("L")`` as a ``(H, W)`` uint8
    array (see the module docstring)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, palette, header = len(PNG_SIGNATURE), [], None, None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not "
                         "defined")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported: "
                         "re-save the image without interlacing")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    rowbytes = (w * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    rows = unfilter(raw[:h * (rowbytes + 1)], h, rowbytes,
                    max(1, bits // 8))
    if depth < 8:                       # packed samples, 1 channel
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        px = px.reshape(h, -1)[:, :w]
        if ctype == 3:
            return _luma(palette[px])
        return (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if depth == 16:
        samples = rows.reshape(h, w, ch, 2)
        if ctype == 0:                  # PIL's I;16 -> L clips
            v = samples[..., 0, 0].astype(np.uint16) << 8 | samples[..., 0, 1]
            return np.minimum(v, 255).astype(np.uint8)
        px = samples[..., 0]            # colour at 16 bits: the high byte
    else:
        px = rows.reshape(h, w, ch)
    if ctype == 3:
        return _luma(palette[px[..., 0]])
    if ctype in (0, 4):
        return np.ascontiguousarray(px[..., 0])
    return _luma(px[..., :3])


# ---------------------------------------------------------------- BMP ------

def decode_bmp(data: bytes) -> np.ndarray:
    """An uncompressed 8-bit (palette) or 24-bit BMP -> ``convert("L")``."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize < 40:
        raise ValueError("BMP with an OS/2 header is not supported")
    w, h, _, bpp, comp, _, _, _, ncolors = struct.unpack(
        "<iiHHIIiiI", data[18:50])
    if comp != 0 or bpp not in (8, 24):
        raise ValueError(f"BMP of {bpp} bits, compression {comp}: only "
                         "uncompressed 8- and 24-bit files are supported")
    stride = (w * bpp // 8 + 3) & ~3
    rows = np.frombuffer(data, dtype=np.uint8, count=stride * abs(h),
                         offset=offset).reshape(abs(h), stride)
    if h > 0:                           # bottom-up
        rows = rows[::-1]
    if bpp == 24:
        return _luma(rows[:, :w * 3].reshape(abs(h), w, 3)[..., ::-1])
    n = ncolors or 256
    pal = np.frombuffer(data, dtype=np.uint8, count=4 * n,
                        offset=14 + hsize).reshape(n, 4)[:, 2::-1]
    return _luma(pal[rows[:, :w]])


# --------------------------------------------------------------- JPEG ------

JPEG_SOI = b"\xff\xd8"
_ERRLEN = 256


def _jpeg_lib():
    """The JPEG decoder library, built at first use (raises when g++
    cannot build it)."""
    from superdiff_torch.ops import _build

    u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    return _build.load("jpeg", {
        "superdiff_jpeg_header": [u8p, i64, ctypes.POINTER(i64),
                                  ctypes.c_char_p, i64],
        "superdiff_jpeg_decode": [u8p, i64, u8p, i64, ctypes.c_char_p,
                                  i64]})


def decode_jpeg_samples(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> libjpeg's output samples: ``(H, W)`` for a
    gray file, ``(H, W, 3)`` RGB for a colour one, ``(H, W, 4)`` CMYK as
    stored for a 4-component one (YCCK converted). Raises ``ValueError``
    naming the form for files outside the forms listed in the module
    docstring, and for truncated or corrupt data."""
    lib = _jpeg_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    ptr = src.ctypes.data_as(u8p)
    err = ctypes.create_string_buffer(_ERRLEN)
    dims = (ctypes.c_int64 * 3)()
    if lib.superdiff_jpeg_header(ptr, src.size, dims, err, _ERRLEN):
        raise ValueError(f"JPEG: {err.value.decode()}")
    h, w, c = dims
    out = np.empty((h, w, c), dtype=np.uint8)
    if lib.superdiff_jpeg_decode(ptr, src.size, out.ctypes.data_as(u8p),
                                 out.size, err, _ERRLEN):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out[..., 0] if c == 1 else out


def _cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's ``cmyk2rgb``: ``CLIP8(nk - MULDIV255(c, nk))`` per channel with
    ``nk = 255 - k``, ``MULDIV255(a, b) = ((t >> 8) + t) >> 8`` for ``t = a
    b + 128``."""
    x = cmyk.astype(np.int32)
    nk = 255 - x[..., 3:]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG file's bytes -> its ``convert("L")`` as a ``(H, W)`` uint8
    array: the decoded gray samples, or PIL's luma of the RGB ones; CMYK
    samples are inverted first (PIL reads every 4-component JPEG as
    ``CMYK;I``, Adobe's polarity) and go through ``cmyk2rgb``."""
    px = decode_jpeg_samples(data)
    if px.ndim == 2:
        return px
    if px.shape[-1] == 4:
        px = _cmyk_rgb(255 - px)
    return _luma(px)


# -------------------------------------------------------------- reading ----

def read_gray(path: str) -> np.ndarray:
    """Decode an image file (PNG, BMP or JPEG) to grayscale uint8 ``(H,
    W)``, as ``PIL.Image.open(path).convert("L")`` does."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data.startswith(JPEG_SOI):
        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: not a PNG, BMP or JPEG file")


# ----------------------------------------------------------- resampling ----

def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per output
    index the first input index and ``ksize`` fixed-point weights (zero
    past the filter's reach), as ``(xmin (out,), idx (out, k), w (out,
    k))``."""
    filt, support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    k = np.arange(ksize)
    live = k[None, :] < xmax[:, None]
    w = filt((k[None, :] + xmin[:, None] - center[:, None] + 0.5)
             * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = w * (1 << PRECISION_BITS)
    fixed = np.where(w < 0, -0.5 + fixed, 0.5 + fixed).astype(np.int64)
    idx = np.minimum(xmin[:, None] + k[None, :], in_size - 1)
    return xmin, xmax, idx, fixed


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_u8(img: np.ndarray, size, kind: str = "bilinear") -> np.ndarray:
    """``Image.fromarray(img, "L").resize(size, BILINEAR or BICUBIC)`` for a
    ``(H, W)`` uint8 array; ``size`` is PIL's ``(width, height)``."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    out_w, out_h = int(size[0]), int(size[1])
    if (out_w, out_h) == (w, h):
        return img.copy()
    half = 1 << (PRECISION_BITS - 1)
    if out_h != h:
        ymin, ymax, yidx, yk = _coeffs(h, out_h, kind)
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
    else:
        first, last = 0, h
    if out_w != w:
        _, _, xidx, xk = _coeffs(w, out_w, kind)
        src = img[first:last].astype(np.int64)
        acc = np.full((last - first, out_w), half, dtype=np.int64)
        for j in range(xidx.shape[1]):
            acc += src[:, xidx[:, j]] * xk[None, :, j]
        img = _clip8(acc)
        first_row = first
    else:
        first_row = 0
    if out_h != h:
        src = img.astype(np.int64)
        acc = np.full((out_h, img.shape[1]), half, dtype=np.int64)
        rows = np.minimum(yidx - first_row, src.shape[0] - 1)
        for j in range(yidx.shape[1]):
            acc += src[rows[:, j]] * yk[:, j, None]
        img = _clip8(acc)
    return img


def resize_bilinear_u8(img: np.ndarray, size) -> np.ndarray:
    """PIL's ``resize(size, Image.BILINEAR)`` of a mode ``L`` image."""
    return resize_u8(img, size, "bilinear")


def crop_u8(img: np.ndarray, box) -> np.ndarray:
    """PIL's ``crop((left, top, right, bottom))``: zeros where the box
    reaches past the image."""
    left, top, right, bottom = (int(v) for v in box)
    h, w = img.shape
    out = np.zeros((max(bottom - top, 0), max(right - left, 0)),
                   dtype=np.uint8)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out

