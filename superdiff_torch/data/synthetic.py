"""Synthetic chest-X-ray-like data for tests, smoke training and benches.

The reference has no synthetic data path (tests require the real TB/
PNEUMONIA folder trees); this generator produces structured grayscale
images — a bright elliptical "ribcage" on smooth low-frequency background,
class-dependent ellipse eccentricity — so overfit/smoke tests have actual
signal to learn, without shipping medical data.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def synthetic_xray_batch(batch_size: int,
                         resolution: int = 64,
                         num_classes: int = 2,
                         seed: int = 0,
                         normalization: str = "tanh",
                         labels: Optional[np.ndarray] = None):
    """Return ``(images, labels)``: images ``(B, R, R, 1)`` float32 in
    [-1, 1] (``tanh`` norm) or [0, 1] (``minmax``), labels ``(B,)`` int32.

    ``labels`` forces the per-image class/style index (values in
    ``[0, num_classes)``); default draws them uniformly. The dataset-tree
    generator uses forced labels to give each disease folder a distinct
    visual signature.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:resolution, 0:resolution].astype(np.float32)
    yy = (yy - resolution / 2) / (resolution / 2)
    xx = (xx - resolution / 2) / (resolution / 2)

    if labels is None:
        labels = rng.integers(0, max(num_classes, 1), size=batch_size)
    else:
        labels = np.asarray(labels)
        assert labels.shape == (batch_size,)
    images = np.empty((batch_size, resolution, resolution, 1),
                      dtype=np.float32)
    for i in range(batch_size):
        cls = labels[i]
        # class controls ellipse eccentricity; instance noise varies pose
        a = 0.55 + 0.25 * (cls / max(num_classes - 1, 1)) \
            + 0.05 * rng.standard_normal()
        b = 0.75 - 0.20 * (cls / max(num_classes - 1, 1)) \
            + 0.05 * rng.standard_normal()
        cy, cx = 0.08 * rng.standard_normal(2)
        body = np.exp(-(((xx - cx) / max(a, 0.1)) ** 2
                        + ((yy - cy) / max(b, 0.1)) ** 2) ** 2)
        # low-frequency background via smoothed noise
        coarse = rng.standard_normal((8, 8)).astype(np.float32)
        bg = np.kron(coarse, np.ones((resolution // 8, resolution // 8),
                                     dtype=np.float32))
        # "rib" bands
        ribs = 0.15 * np.sin(yy * 9.0 * np.pi) * body
        img = 0.75 * body + 0.1 * bg + ribs
        img += 0.02 * rng.standard_normal(img.shape).astype(np.float32)
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-6)
        images[i, :, :, 0] = img

    if normalization == "tanh":
        images = images * 2.0 - 1.0
    elif normalization != "minmax":
        raise ValueError(f"unknown normalization: {normalization!r}")
    return images, labels.astype(np.int32)
