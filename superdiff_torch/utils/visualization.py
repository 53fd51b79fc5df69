"""Image artifacts the training loop writes: real-vs-generated rows and the
loss curve.

Port of ``save_real_vs_generated`` and ``save_loss_curve`` of
``superdiff_tpu/utils/visualization.py``; the grids and trajectory strips
come with the analysis slice. Functions take NHWC float arrays of any
normalization (they rescale for display) and write PNGs with matplotlib's
Agg backend. matplotlib is imported inside the functions: a machine without
it can still train with ``training.vis_every = 0``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


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
