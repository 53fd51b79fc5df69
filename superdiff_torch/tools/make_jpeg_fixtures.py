"""Write the committed JPEG fixtures of the port's decoder and their manifest.

The machine with the card has no PIL and cannot write JPEG, so a few small
files are committed under ``tests/torch_jpeg/``: X-ray-like images at
512-1024 px a side, one per form the decoder must cover (gray baseline at
1024² and at an odd size; YCbCr 4:2:0, 4:2:2 and 4:4:4; progressive gray
and colour; optimised Huffman tables with restart markers; CMYK with
PIL's Adobe marker, baseline and progressive; YCCK, a PIL-written CMYK file
whose Adobe transform byte is set to 2, since PIL writes no YCCK).
``manifest.json``
records each file's form and the shape and SHA-256 of
``PIL.Image.open(path).convert("L")``'s bytes, which the CPU tests and
``chip_smoke.py`` hold ``data/image_io.py::read_gray`` to.

Needs PIL (it is the encoder and the reference), so it runs where PIL is
installed, not on the card's machine:

    python superdiff_torch/tools/make_jpeg_fixtures.py [--out tests/torch_jpeg]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# name, (height, width), kind (gray, rgb, cmyk or ycck), PIL save options,
# form
FIXTURES = (
    ("gray_1024_baseline.jpg", (1024, 1024), "gray", {"quality": 80},
     "gray baseline 1024²"),
    ("gray_613x739_baseline.jpg", (613, 739), "gray", {"quality": 75},
     "gray baseline, odd size"),
    ("ycc420_750x1000.jpg", (750, 1000), "rgb",
     {"quality": 75, "subsampling": 2}, "YCbCr 4:2:0, not a multiple of 16"),
    ("ycc422_600x800.jpg", (600, 800), "rgb",
     {"quality": 75, "subsampling": 1}, "YCbCr 4:2:2"),
    ("ycc444_512x640.jpg", (512, 640), "rgb",
     {"quality": 75, "subsampling": 0}, "YCbCr 4:4:4"),
    ("gray_700x900_progressive.jpg", (700, 900), "gray",
     {"quality": 75, "progressive": True}, "gray progressive"),
    ("ycc420_640x768_progressive.jpg", (640, 768), "rgb",
     {"quality": 75, "subsampling": 2, "progressive": True},
     "YCbCr 4:2:0 progressive"),
    ("gray_800x1024_optimized_restart.jpg", (800, 1024), "gray",
     {"quality": 75, "optimize": True, "restart_marker_rows": 2},
     "gray, optimised Huffman tables, restart markers"),
    ("cmyk_512x640.jpg", (512, 640), "cmyk", {"quality": 75},
     "CMYK, Adobe marker (transform 0)"),
    ("cmyk_520x600_progressive.jpg", (520, 600), "cmyk",
     {"quality": 75, "subsampling": 2, "progressive": True},
     "CMYK progressive, first plane 2x2"),
    ("ycck_512x576.jpg", (512, 576), "ycck",
     {"quality": 75, "subsampling": 2}, "YCCK (Adobe transform 2)"),
)


def xray_like(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth chest-X-ray-like uint8 image: a vertical gradient, two
    bright elliptical lung fields, rib-like bands and fine noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    img = 40 + 60 * yy
    for cx in (0.3, 0.7):
        r2 = ((xx - cx) / 0.17) ** 2 + ((yy - 0.5) / 0.3) ** 2
        img += 110 * np.exp(-r2 * rng.uniform(1.5, 3.0))
    img += 12 * np.sin(yy * rng.uniform(40, 60)) * (np.abs(xx - 0.5) > 0.08)
    img += rng.normal(0, 3, (h, w)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def tint(rng: np.random.Generator, gray: np.ndarray) -> np.ndarray:
    """An RGB image from a gray one: per-channel gains and a slow colour
    gradient, so that both chroma planes carry detail."""
    h, w = gray.shape
    ramp = np.linspace(-20, 20, w, dtype=np.float32)[None, :]
    chans = [gray * rng.uniform(0.8, 1.1) + s * ramp for s in (1, 0, -1)]
    return np.clip(np.dstack(chans), 0, 255).astype(np.uint8)


def cmyk(rng: np.random.Generator, gray: np.ndarray) -> np.ndarray:
    """A CMYK image from a gray one: the inks of a tinted copy, with a
    black plane that carries the image's dark structure."""
    inks = 255 - tint(rng, gray).astype(np.float32) * 0.85
    k = (255 - gray.astype(np.float32)) * 0.4
    return np.clip(np.dstack([inks, k]), 0, 255).astype(np.uint8)


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    """``data`` with the transform byte of its Adobe APP14 marker set."""
    i = data.find(b"\xff\xee")
    if i < 0 or data[i + 4:i + 9] != b"Adobe":
        raise ValueError("no Adobe marker")
    return data[:i + 15] + bytes([transform]) + data[i + 16:]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(_REPO, "tests", "torch_jpeg"))
    p.add_argument("--seed", type=int, default=9)
    args = p.parse_args(argv)
    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    files, total = [], 0
    for name, (h, w), kind, opts, form in FIXTURES:
        img = xray_like(rng, h, w)
        if kind == "rgb":
            img = tint(rng, img)
        elif kind in ("cmyk", "ycck"):
            img = cmyk(rng, img)
        path = os.path.join(args.out, name)
        pil = Image.fromarray(img, "CMYK" if img.ndim == 3 and
                              img.shape[-1] == 4 else None)
        pil.save(path, format="JPEG", **opts)
        if kind == "ycck":
            with open(path, "rb") as f:
                data = set_adobe_transform(f.read(), 2)
            with open(path, "wb") as f:
                f.write(data)
        with Image.open(path) as im:
            gray = np.asarray(im.convert("L"), dtype=np.uint8)
        total += os.path.getsize(path)
        files.append({"name": name, "form": form, "shape": list(gray.shape),
                      "sha256": hashlib.sha256(gray.tobytes()).hexdigest()})
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"decoder_reference": "PIL.Image.open(path).convert('L')",
                   "files": files}, f, indent=1)
        f.write("\n")
    print(f"{len(files)} fixtures, {total} bytes -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
