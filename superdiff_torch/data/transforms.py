"""X-ray preprocessing: host resize and CLAHE, device normalization and
augmentation.

Port of ``superdiff_tpu/data/transforms.py``. The host side works on uint8
numpy arrays and equals the JAX package's PIL and OpenCV calls bit for bit
without either library: :func:`host_resize` (the resize strategies ``pad``,
``center_crop``, ``resize`` through ``data/image_io.py``) and :func:`clahe`
(OpenCV's CLAHE for 8-bit images in numpy). The device side: the
normalization modes ``minmax`` / ``zscore`` / ``tanh`` / ``none`` and the
risk-tiered augmentation ``none`` / ``low`` / ``medium`` (``high`` raises),
vectorised over an NHWC batch.

The rotation keeps the reference's arithmetic, three 1-D bilinear shears
(Paeth), so results match it; ``F.grid_sample`` would be a different
resampling. Each shear is a sum over the static range of integer shifts of
the edge-padded image times a 2-hot hat weight, accumulated slice by slice.

Random draws come from a ``torch.Generator`` in a fixed order (flip mask,
angles, rotate mask, brightness/contrast mask, brightness and contrast, then
for ``low`` the noise mask, sigma and noise); ``draws=`` injects any of them
by name for parity tests.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from superdiff_torch.data.image_io import crop_u8, resize_bilinear_u8

RISK_TIERS = ("none", "low", "medium")
NORMALIZATIONS = ("minmax", "zscore", "tanh", "none")
RESIZE_STRATEGIES = ("pad", "center_crop", "resize")


# --------------------------------------------------------------- host side --

def host_resize(img: np.ndarray, resolution: int,
                strategy: str = "pad") -> np.ndarray:
    """Apply the resize strategy to a ``(H, W)`` uint8 image -> ``(R, R)``
    uint8: ``resize`` stretches (PIL bilinear); ``pad`` scales the short
    side to R (sizes by Python's ``round``, half to even) and centre-crops;
    ``center_crop`` crops only, so an image smaller than R comes out padded
    with black on the right and bottom."""
    if strategy not in RESIZE_STRATEGIES:
        raise ValueError(f"unknown resize strategy {strategy!r} "
                         f"(have {RESIZE_STRATEGIES})")
    R = resolution
    h, w = img.shape
    if strategy == "resize":
        return resize_bilinear_u8(img, (R, R))
    if strategy == "pad":
        scale = R / min(w, h)
        img = resize_bilinear_u8(img, (max(R, round(w * scale)),
                                       max(R, round(h * scale))))
        h, w = img.shape
    left = max(0, (w - R) // 2)
    top = max(0, (h - R) // 2)
    return crop_u8(img, (left, top, left + R, top + R))


def _clahe_luts(src: np.ndarray, tiles: int, th: int, tw: int,
                clip: int) -> np.ndarray:
    """Per-tile lookup tables ``(tiles*tiles, 256)`` uint8: clipped,
    redistributed histogram, ``saturate_cast<uchar>(cumsum * (255 /
    area))`` in float32 (round half to even)."""
    t = src[:tiles * th, :tiles * tw].reshape(tiles, th, tiles, tw)
    ids = np.arange(tiles * tiles).reshape(tiles, 1, tiles, 1)
    hist = np.bincount((ids * 256 + t).reshape(-1),
                       minlength=tiles * tiles * 256).reshape(-1, 256)
    if clip > 0:
        excess = np.maximum(hist - clip, 0).sum(axis=1)
        hist = np.minimum(hist, clip) + (excess // 256)[:, None]
        for k, residual in enumerate(excess % 256):
            if residual:
                step = max(256 // int(residual), 1)
                hist[k, np.arange(0, 256, step)[:residual]] += 1
    scale = np.float32(255.0) / np.float32(th * tw)
    lut = np.cumsum(hist, axis=1).astype(np.float32) * scale
    return np.clip(np.rint(lut), 0, 255).astype(np.uint8)


def clahe(img_uint8: np.ndarray, clip_limit: float = 2.0,
          tile_grid: int = 8) -> np.ndarray:
    """OpenCV's ``createCLAHE(clip_limit, (tile_grid, tile_grid)).apply``
    for a ``(H, W)`` uint8 image, in numpy: the image padded by
    ``BORDER_REFLECT_101`` to whole tiles (on both sides' far edges when
    either size is not a multiple of the grid), clip limit ``max(int(
    clip_limit * area / 256), 1)``, the excess spread as ``excess // 256``
    per bin and the rest one by one at stride ``max(256 // rest, 1)``, and
    the four nearest tiles' tables blended in float32 in OpenCV's order."""
    src = np.asarray(img_uint8, dtype=np.uint8)
    h, w = src.shape
    n = tile_grid
    ext = src
    if h % n or w % n:
        ext = np.pad(src, ((0, n - h % n), (0, n - w % n)), mode="reflect")
    th, tw = ext.shape[0] // n, ext.shape[1] // n
    clip = 0
    if clip_limit > 0:
        clip = max(int(clip_limit * (th * tw) / 256), 1)
    luts = _clahe_luts(ext, n, th, tw, clip).astype(np.float32)

    def axis(size, tile):
        f = (np.arange(size, dtype=np.float32)
             * (np.float32(1.0) / np.float32(tile)) - np.float32(0.5))
        lo = np.floor(f).astype(np.int64)
        a = (f - lo.astype(np.float32)).astype(np.float32)
        return (np.maximum(lo, 0), np.minimum(lo + 1, n - 1), a,
                (np.float32(1.0) - a).astype(np.float32))

    ty1, ty2, ya, ya1 = axis(h, th)
    tx1, tx2, xa, xa1 = axis(w, tw)
    v = src.astype(np.int64)

    def lut(ty, tx):
        return luts[(ty[:, None] * n + tx[None, :]), v]

    res = ((lut(ty1, tx1) * xa1 + lut(ty1, tx2) * xa) * ya1[:, None]
           + (lut(ty2, tx1) * xa1 + lut(ty2, tx2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- device side --


def normalize(batch: torch.Tensor, mode: str = "tanh") -> torch.Tensor:
    """Normalize a float [0,1] NHWC batch per the named mode."""
    if mode == "minmax":
        lo = batch.amin(dim=(1, 2, 3), keepdim=True)
        hi = batch.amax(dim=(1, 2, 3), keepdim=True)
        return (batch - lo) / torch.clamp(hi - lo, min=1e-6)
    if mode == "zscore":
        return (batch - 0.5) / 0.25
    if mode == "tanh":
        return batch * 2.0 - 1.0
    if mode == "none":
        return batch
    raise ValueError(f"unknown normalization {mode!r} "
                     f"(have {NORMALIZATIONS})")


def denormalize(batch: torch.Tensor, mode: str = "tanh") -> torch.Tensor:
    """Inverse of :func:`normalize` back to [0,1] (minmax is lossy; clip)."""
    if mode == "zscore":
        return torch.clamp(batch * 0.25 + 0.5, 0.0, 1.0)
    if mode == "tanh":
        return torch.clamp((batch + 1.0) * 0.5, 0.0, 1.0)
    return torch.clamp(batch, 0.0, 1.0)


def _shift1d(img: torch.Tensor, off: torch.Tensor, axis: int,
             max_shift: int) -> torch.Tensor:
    """Fractional per-row shift along ``axis`` (edge-clamped, bilinear).

    ``img``: (B, H, W, C); ``off``: the per-(batch, row) sample offset,
    (B, H) for ``axis=2`` and (B, W) for ``axis=1``: output[x] samples
    input[x - off]. ``|off|`` must be <= ``max_shift`` (a static tier bound).
    """
    B, H, W, C = img.shape
    nchw = img.permute(0, 3, 1, 2)
    pad = ((max_shift, max_shift, 0, 0) if axis == 2
           else (0, 0, max_shift, max_shift))
    padded = F.pad(nchw, pad, mode="replicate").permute(0, 2, 3, 1)
    size = img.shape[axis]
    out = torch.zeros_like(img)
    for d in range(2 * max_shift + 1):
        w = torch.clamp(1.0 - (off + float(d - max_shift)).abs(), min=0.0)
        if axis == 2:
            out += padded[:, :, d:d + size, :] * w[:, :, None, None]
        else:
            out += padded[:, d:d + size, :, :] * w[:, None, :, None]
    return out


def _rotate_shear3(batch: torch.Tensor, angles: torch.Tensor,
                   max_deg: float) -> torch.Tensor:
    """Batched center rotation as three 1-D shears (Paeth): x, y, x.
    ``max_deg`` is the static tier bound that sizes the shift ranges."""
    H, W = batch.shape[1], batch.shape[2]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ty = torch.tan(angles / 2.0)
    sn = torch.sin(angles)
    ybar = torch.arange(H, dtype=torch.float32, device=batch.device) - cy
    xbar = torch.arange(W, dtype=torch.float32, device=batch.device) - cx
    maxr = math.radians(max_deg)
    Dx = int(math.ceil(math.tan(maxr / 2.0) * max(cy, cx))) + 1
    Dy = int(math.ceil(math.sin(maxr) * max(cy, cx))) + 1
    offx = -ty[:, None] * ybar[None, :]                  # (B, H)
    out = _shift1d(batch, offx, axis=2, max_shift=Dx)
    out = _shift1d(out, sn[:, None] * xbar[None, :], axis=1, max_shift=Dy)
    return _shift1d(out, offx, axis=2, max_shift=Dx)


def augment_draws(shape, generator: Optional[torch.Generator] = None,
                  risk: str = "low", device=None,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Every random draw of :func:`augment` on a batch of ``shape`` (``B,
    H, W, C``): those in ``draws`` as given, the rest from ``generator``
    in the module docstring's order, as :func:`augment` takes them (the
    uniform ones already scaled to their ranges). They depend on nothing
    but the shape, so a caller may draw them ahead of the batch."""
    if risk == "high":
        raise ValueError("Avoid high-risk medical augmentations")
    if risk not in RISK_TIERS:
        raise ValueError(f"unknown augmentation risk {risk!r} "
                         f"(have {RISK_TIERS + ('high',)})")
    out = dict(draws or {})
    if risk == "none":
        return out
    B = shape[0]

    def uniform(name, lo, hi):
        if name not in out:
            u = torch.rand((B,), generator=generator, device=device)
            out[name] = lo + (hi - lo) * u

    def bernoulli(name, p):
        if name not in out:
            out[name] = torch.rand((B,), generator=generator,
                                   device=device) < p

    maxr = (5.0 if risk == "low" else 15.0) * (math.pi / 180.0)
    bernoulli("flip", 0.5)
    uniform("angles", -maxr, maxr)
    bernoulli("rot", 0.5 if risk == "low" else 1.0)
    bernoulli("bc", 0.3 if risk == "low" else 0.4)
    uniform("bright", -0.2, 0.2)
    uniform("contrast", -0.2, 0.2)
    if risk == "low":
        bernoulli("noise_mask", 0.2)
        uniform("sigma", 0.01, 0.05)
        if "noise" not in out:
            out["noise"] = torch.randn(tuple(shape), generator=generator,
                                       device=device)
    return out


def augment(batch: torch.Tensor, generator: Optional[torch.Generator] = None,
            risk: str = "low",
            draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Risk-tiered stochastic augmentation of a float [0,1] NHWC batch,
    independent per example.

    ``draws`` may hold ``flip`` (B,) bool, ``angles`` (B,) radians in
    ``[-max, max]``, ``rot`` (B,) bool, ``bc`` (B,) bool, ``bright`` and
    ``contrast`` (B,) in ``[-0.2, 0.2]``, ``noise_mask`` (B,) bool, ``sigma``
    (B,) in ``[0.01, 0.05]`` and ``noise`` (B, H, W, C) standard normal; what
    is absent is drawn from ``generator`` (:func:`augment_draws`)."""
    d = augment_draws(batch.shape, generator, risk, batch.device, draws)
    if risk == "none":
        return batch
    B, dev = batch.shape[0], batch.device

    def per_image(name):
        return d[name].to(dev).reshape(B, 1, 1, 1)

    # horizontal flip, p=0.5 (both tiers)
    batch = torch.where(per_image("flip"), batch.flip(dims=(2,)), batch)

    # rotation: low = +-5 deg p=0.5 ; medium = +-15 deg p=1.0
    angles = d["angles"].to(dev)
    angles = torch.where(d["rot"].to(dev), angles, torch.zeros_like(angles))
    batch = _rotate_shear3(batch, angles, 5.0 if risk == "low" else 15.0)

    # brightness/contrast: low p=0.3, medium p=0.4; +-0.2 each
    adjusted = torch.clamp(
        (batch - 0.5) * (1.0 + per_image("contrast")) + 0.5
        + per_image("bright"), 0.0, 1.0)
    batch = torch.where(per_image("bc"), adjusted, batch)

    if risk == "low":
        # gaussian noise p=0.2, sigma ~ U[0.01, 0.05]
        batch = torch.where(per_image("noise_mask"),
                            torch.clamp(batch + d["noise"].to(dev)
                                        * per_image("sigma"), 0.0, 1.0),
                            batch)
    return batch


def prepare_batch(images_uint8: torch.Tensor,
                  generator: Optional[torch.Generator],
                  augmentation: str = "low",
                  normalization: str = "tanh",
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """uint8 NHWC batch -> augmented, normalized float32 batch on the same
    device. No augmentation when both ``generator`` and ``draws`` are None
    (validation sees clean data)."""
    x = images_uint8.float() / 255.0
    if augmentation != "none" and (generator is not None
                                   or draws is not None):
        x = augment(x, generator, risk=augmentation, draws=draws)
    return normalize(x, normalization)
