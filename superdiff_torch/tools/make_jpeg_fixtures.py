"""Write the committed JPEG fixtures of the port's decoder and their manifest.

The machine with the card has no PIL and cannot write JPEG, so a few small
files are committed under ``tests/torch_jpeg/``: X-ray-like images at
512-1024 px a side, one per form the decoder must cover (gray baseline at
1024² and at an odd size; YCbCr 4:2:0, 4:2:2 and 4:4:4; progressive gray
and colour; optimised Huffman tables with restart markers). ``manifest.json``
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

# name, (height, width), colour, PIL save options, form
FIXTURES = (
    ("gray_1024_baseline.jpg", (1024, 1024), False, {"quality": 80},
     "gray baseline 1024²"),
    ("gray_613x739_baseline.jpg", (613, 739), False, {"quality": 75},
     "gray baseline, odd size"),
    ("ycc420_750x1000.jpg", (750, 1000), True,
     {"quality": 75, "subsampling": 2}, "YCbCr 4:2:0, not a multiple of 16"),
    ("ycc422_600x800.jpg", (600, 800), True,
     {"quality": 75, "subsampling": 1}, "YCbCr 4:2:2"),
    ("ycc444_512x640.jpg", (512, 640), True,
     {"quality": 75, "subsampling": 0}, "YCbCr 4:4:4"),
    ("gray_700x900_progressive.jpg", (700, 900), False,
     {"quality": 75, "progressive": True}, "gray progressive"),
    ("ycc420_640x768_progressive.jpg", (640, 768), True,
     {"quality": 75, "subsampling": 2, "progressive": True},
     "YCbCr 4:2:0 progressive"),
    ("gray_800x1024_optimized_restart.jpg", (800, 1024), False,
     {"quality": 75, "optimize": True, "restart_marker_rows": 2},
     "gray, optimised Huffman tables, restart markers"),
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(_REPO, "tests", "torch_jpeg"))
    p.add_argument("--seed", type=int, default=9)
    args = p.parse_args(argv)
    from PIL import Image

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    files, total = [], 0
    for name, (h, w), colour, opts, form in FIXTURES:
        img = xray_like(rng, h, w)
        if colour:
            img = tint(rng, img)
        path = os.path.join(args.out, name)
        Image.fromarray(img).save(path, format="JPEG", **opts)
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
