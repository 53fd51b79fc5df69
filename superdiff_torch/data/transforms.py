"""X-ray normalization and augmentation on the device.

Port of the device side of ``superdiff_tpu/data/transforms.py``: the
normalization modes ``minmax`` / ``zscore`` / ``tanh`` / ``none`` and the
risk-tiered augmentation ``none`` / ``low`` / ``medium`` (``high`` raises),
vectorised over an NHWC batch. The host side (``host_resize``, ``clahe``)
comes with the data layer.

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

import torch
import torch.nn.functional as F

RISK_TIERS = ("none", "low", "medium")
NORMALIZATIONS = ("minmax", "zscore", "tanh", "none")


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


def augment(batch: torch.Tensor, generator: Optional[torch.Generator] = None,
            risk: str = "low",
            draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Risk-tiered stochastic augmentation of a float [0,1] NHWC batch,
    independent per example.

    ``draws`` may hold ``flip`` (B,) bool, ``angles`` (B,) radians in
    ``[-max, max]``, ``rot`` (B,) bool, ``bc`` (B,) bool, ``bright`` and
    ``contrast`` (B,) in ``[-0.2, 0.2]``, ``noise_mask`` (B,) bool, ``sigma``
    (B,) in ``[0.01, 0.05]`` and ``noise`` (B, H, W, C) standard normal; what
    is absent is drawn from ``generator``."""
    if risk == "high":
        raise ValueError("Avoid high-risk medical augmentations")
    if risk not in RISK_TIERS:
        raise ValueError(f"unknown augmentation risk {risk!r} "
                         f"(have {RISK_TIERS + ('high',)})")
    if risk == "none":
        return batch
    draws = draws or {}
    B, dev = batch.shape[0], batch.device

    def uniform(name, lo, hi):
        if name in draws:
            return draws[name].to(dev)
        u = torch.rand((B,), generator=generator, device=dev)
        return lo + (hi - lo) * u

    def bernoulli(name, p):
        if name in draws:
            return draws[name].to(dev)
        return torch.rand((B,), generator=generator, device=dev) < p

    def per_image(a):
        return a.reshape(B, 1, 1, 1)

    # horizontal flip, p=0.5 (both tiers)
    batch = torch.where(per_image(bernoulli("flip", 0.5)),
                        batch.flip(dims=(2,)), batch)

    # rotation: low = +-5 deg p=0.5 ; medium = +-15 deg p=1.0
    max_deg = 5.0 if risk == "low" else 15.0
    rot_p = 0.5 if risk == "low" else 1.0
    maxr = max_deg * (math.pi / 180.0)
    angles = uniform("angles", -maxr, maxr)
    angles = torch.where(bernoulli("rot", rot_p), angles,
                         torch.zeros_like(angles))
    batch = _rotate_shear3(batch, angles, max_deg)

    # brightness/contrast: low p=0.3, medium p=0.4; +-0.2 each
    do_bc = bernoulli("bc", 0.3 if risk == "low" else 0.4)
    bright = uniform("bright", -0.2, 0.2)
    contrast = uniform("contrast", -0.2, 0.2)
    adjusted = torch.clamp(
        (batch - 0.5) * (1.0 + per_image(contrast)) + 0.5 + per_image(bright),
        0.0, 1.0)
    batch = torch.where(per_image(do_bc), adjusted, batch)

    if risk == "low":
        # gaussian noise p=0.2, sigma ~ U[0.01, 0.05]
        do_noise = bernoulli("noise_mask", 0.2)
        sigma = uniform("sigma", 0.01, 0.05)
        noise = (draws["noise"].to(dev) if "noise" in draws else
                 torch.randn(batch.shape, generator=generator, device=dev))
        batch = torch.where(per_image(do_noise),
                            torch.clamp(batch + noise * per_image(sigma),
                                        0.0, 1.0), batch)
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
