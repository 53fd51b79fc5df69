"""Latent projections: t-SNE, UMAP and PCA, in 2D and 3D, with thumbnails.

Port of ``superdiff_tpu/analysis/projection.py`` without sklearn or
matplotlib (the card's machine has neither):

- **PCA** (:func:`pca`): a full SVD of the centred features in float64,
  signs fixed as sklearn 1.9's ``svd_flip(u_based_decision=False)`` fixes
  them, the projection ``U * S``: what ``PCA(n).fit_transform`` gives with
  its full solver.
- **t-SNE** (:func:`tsne`): sklearn 1.9's ``TSNE`` with the defaults the
  JAX package uses (``init="pca"``, ``learning_rate="auto"``,
  ``max_iter=1000``, early exaggeration 12 for 250 iterations at momentum
  0.5, then momentum 0.8, gains with ``min_gain=0.01``, the progress and
  ``min_grad_norm`` checks every 50 iterations), the conditional P by
  sklearn's per-point binary search on the perplexity, with its dtypes
  (float32 distances into the search and float32 parameters, float64 P, Q
  and KL). The gradient is **exact**, not Barnes-Hut (sklearn's default,
  which the JAX package runs): the projections here hold a few hundred
  points, so the O(N^2) gradient is cheap, and it runs as torch tensors on
  ``device``, the card by default.
- **UMAP**: ``analysis/umap_np.py``, the port's copy of the JAX package's
  NumPy UMAP (umap-learn is not a dependency of the port).

Figures are drawn by ``utils/raster.py`` (titles and legends in the PNG's
text); :func:`run_projection_3d` draws an orthographic view at matplotlib's
default 3D camera (elevation 30, azimuth -60) and can write the camera's
rotation as a GIF. Seeds are fixed at 42 as in the JAX package.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

PROJECTION_METHODS = ("tsne", "umap", "pca")

_EPS = float(np.finfo(np.double).eps)       # sklearn's MACHINE_EPSILON
_EXAGGERATION = 12.0
_EXPLORATION_ITERS = 250
_MAX_ITER = 1000
_CHECK_EVERY = 50
_NO_PROGRESS_ITERS = 300
_MIN_GRAD_NORM = 1e-7
_MIN_GAIN = 0.01
_PERPLEXITY_TOL = 1e-5                     # sklearn _utils.pyx
_SEARCH_STEPS = 100


def _standardize(features: np.ndarray) -> np.ndarray:
    """Per-feature zero-mean / unit-variance scaling (StandardScaler's:
    constant features get std 1), in float64."""
    f = np.asarray(features, dtype=np.float64)
    mean = f.mean(axis=0, keepdims=True)
    std = f.std(axis=0, keepdims=True)
    std[std == 0.0] = 1.0
    return (f - mean) / std


def pca(features, n_components: int, device="cuda") -> torch.Tensor:
    """``PCA(n_components).fit_transform`` with the full solver: float64
    ``(N, n_components)`` on ``device``."""
    x = torch.as_tensor(np.asarray(features, dtype=np.float64),
                        device=device)
    xc = x - x.mean(dim=0)
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    rows = torch.arange(vt.shape[0], device=vt.device)
    signs = torch.sign(vt[rows, vt.abs().argmax(dim=1)])
    return u[:, :n_components] * (signs * s)[:n_components]


def perplexity_for(n: int) -> float:
    """The JAX package's perplexity rule: ``min(30, max(2, n / 4 - 1))``."""
    return min(30.0, max(2.0, n / 4 - 1))


def _sq_distances(x: torch.Tensor) -> torch.Tensor:
    """sklearn's ``euclidean_distances(X, squared=True)``: ``|x|^2 + |y|^2
    - 2 x.y``, clipped at 0, zero diagonal."""
    sq = (x * x).sum(dim=1)
    d = (-2.0 * (x @ x.T) + sq[:, None]) + sq[None, :]
    d = torch.clamp(d, min=0.0)
    d.fill_diagonal_(0.0)
    return d


def conditional_p(sq_dist: torch.Tensor, perplexity: float) -> torch.Tensor:
    """sklearn's ``_binary_search_perplexity`` on a full float32 distance
    matrix, every row at once: per row, ``beta`` from 1 is doubled / halved
    until bracketed, then bisected, at most 100 steps, until the entropy of
    ``P_i = exp(-d_i beta) / sum`` is within 1e-5 of ``log(perplexity)``.
    Returns the float64 conditional P (zero diagonal)."""
    d = sq_dist.to(torch.float32).to(torch.float64)
    n = d.shape[0]
    dev = d.device
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    p = torch.zeros_like(d)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    target = math.log(perplexity)
    for _ in range(_SEARCH_STEPS):
        pi = torch.exp(-d * beta[:, None]).masked_fill(eye, 0.0)
        total = pi.sum(dim=1)
        total = torch.where(total == 0.0, torch.full_like(total, 1e-8), total)
        pi = pi / total[:, None]
        entropy = torch.log(total) + beta * (d * pi).sum(dim=1)
        diff = entropy - target
        p = torch.where(done[:, None], p, pi)
        done = done | (diff.abs() <= _PERPLEXITY_TOL)
        up = ~done & (diff > 0.0)
        down = ~done & (diff <= 0.0)
        new_beta = torch.where(
            up, torch.where(hi == math.inf, beta * 2.0, (beta + hi) / 2.0),
            torch.where(down, torch.where(lo == -math.inf, beta / 2.0,
                                          (beta + lo) / 2.0), beta))
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = new_beta
        if bool(done.all()):
            break
    return p


def joint_p(features, perplexity: float, device="cuda") -> torch.Tensor:
    """sklearn's exact ``_joint_probabilities``: symmetrised, normalised
    and floored at machine epsilon, as a full float64 matrix whose diagonal
    is 0 (sklearn's condensed form leaves it out)."""
    x = torch.as_tensor(np.asarray(features, dtype=np.float64),
                        device=device)
    cond = conditional_p(_sq_distances(x), perplexity)
    p = cond + cond.T
    p = torch.clamp(p / torch.clamp(p.sum(), min=_EPS), min=_EPS)
    return p.fill_diagonal_(0.0)


def _kl_and_grad(y: torch.Tensor, p: torch.Tensor, dof: float,
                 off: torch.Tensor, with_error: bool):
    """sklearn's exact ``_kl_divergence``: float64 Student-t Q from the
    float32 embedding (``pdist`` works in float64), the KL (when asked) and
    the gradient ``c sum_j (p_ij - q_ij) w_ij (y_i - y_j)``, with ``y_i -
    y_j`` taken in float32 as sklearn takes it, stored as float32."""
    y64 = y.to(torch.float64)
    d = ((y64[:, None, :] - y64[None, :, :]) ** 2).sum(dim=-1)
    diff = y[:, None, :] - y[None, :, :]                    # float32
    w = (d / dof + 1.0) ** ((dof + 1.0) / -2.0)
    w = torch.where(off, w, torch.zeros_like(w))
    q = torch.clamp(w / w.sum(), min=_EPS)
    error = None
    if with_error:
        error = (p * torch.log(torch.clamp(p, min=_EPS) / q))[off].sum()
    pqd = torch.where(off, (p - q) * w, torch.zeros_like(w))
    grad = torch.einsum("ij,ijk->ik", pqd, diff.to(torch.float64))
    grad = grad.to(torch.float32) * float(2.0 * (dof + 1.0) / dof)
    return error, grad


def _descend(y, p, dof, off, it: int, max_iter: int, momentum: float,
             learning_rate: float, no_progress: int):
    """sklearn's ``_gradient_descent``: momentum with per-parameter gains,
    the error and gradient norm checked every 50 iterations (and at the
    last). Returns ``(y, error, last iteration)``."""
    update = torch.zeros_like(y, dtype=torch.float64)
    gains = torch.ones_like(y)
    error = best_error = math.inf
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % _CHECK_EVERY == 0
        err, grad = _kl_and_grad(y, p, dof, off,
                                 check or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8),
                            min=_MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.to(torch.float64)
        y = (y.to(torch.float64) + update).to(torch.float32)
        if err is not None:
            error = float(err)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > no_progress:
                break
            if grad_norm <= _MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(features, n_components: int = 2, init=None,
         device="cuda") -> np.ndarray:
    """Exact t-SNE of ``features (N, D)`` (already standardized, float64)
    with sklearn 1.9's ``TSNE(init="pca")`` schedule and the JAX package's
    perplexity (:func:`perplexity_for`). ``init``: a ``(N, n_components)``
    starting embedding in place of the PCA one (taken as float32). Returns
    the float32 ``(N, n_components)`` embedding as numpy."""
    x = np.asarray(features, dtype=np.float64)
    n = len(x)
    perplexity = perplexity_for(n)
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than the "
                         f"number of samples ({n})")
    p = joint_p(x, perplexity, device)
    if init is None:
        y = pca(x, n_components, device).to(torch.float32)
        y = y / torch.std(y[:, 0], correction=0) * 1e-4
    else:
        y = torch.as_tensor(np.asarray(init, dtype=np.float32),
                            device=p.device).clone()
    dof = float(max(n_components - 1, 1))
    off = ~torch.eye(n, dtype=torch.bool, device=p.device)
    lr = max(n / _EXAGGERATION / 4.0, 50.0)
    y, _, it = _descend(y, p * _EXAGGERATION, dof, off, 0,
                        _EXPLORATION_ITERS, 0.5, lr, _EXPLORATION_ITERS)
    y, _, _ = _descend(y, p, dof, off, it + 1, _MAX_ITER, 0.8, lr,
                       _NO_PROGRESS_ITERS)
    return y.cpu().numpy()


def _project(features: np.ndarray, method: str, n_components: int,
             seed: int = 42, device="cuda") -> np.ndarray:
    """Standardize, then project with ``method``: float32 (t-SNE) or
    float64 ``(N, n_components)`` numpy."""
    if method not in PROJECTION_METHODS:
        raise ValueError(f"unknown projection method {method!r} "
                         f"(have {PROJECTION_METHODS})")
    features = _standardize(features)
    if method == "tsne":
        return tsne(features, n_components, device=device)
    if method == "pca":
        return pca(features, n_components, device).cpu().numpy()
    from superdiff_torch.analysis.umap_np import umap_embed

    return umap_embed(features, n_components=n_components, seed=seed)


def run_projection(features: np.ndarray, labels: np.ndarray,
                   method: str = "tsne", path: str = "projection.png",
                   class_names: Optional[Sequence[str]] = None,
                   title: Optional[str] = None, device="cuda") -> str:
    """2D scatter of the projected features, one colour per class."""
    from superdiff_torch.utils import raster

    emb = _project(features, method, 2, device=device)
    return raster.write_png(path, raster.scatter(emb, labels),
                            {"Title": title or f"{method} projection",
                             "Legend": raster.legend_text(labels,
                                                          class_names)})


def _thumb_side(zoom: float) -> int:
    return max(4, int(round(zoom * 64)))


def run_projection_with_thumbnails(features, labels, images,
                                   method: str = "tsne",
                                   path: str = "projection_thumbs.png",
                                   title: Optional[str] = None,
                                   zoom: float = 0.6, device="cuda") -> str:
    """2D projection with each image's thumbnail (``zoom`` x 64 pixels a
    side) at its embedding position."""
    from superdiff_torch.utils import raster

    emb = _project(features, method, 2, device=device)
    return raster.write_png(
        path, raster.thumbnail_scatter(emb, images, side=_thumb_side(zoom)),
        {"Title": title or f"{method} with thumbnails"})


def compare_tsne_umap_thumbnails(features, labels, images,
                                 path: str = "tsne_vs_umap.png",
                                 zoom: float = 0.5, device="cuda") -> str:
    """t-SNE and UMAP thumbnail panels side by side (t-SNE left)."""
    from superdiff_torch.utils import raster

    panels = [raster.thumbnail_scatter(
        _project(features, m, 2, device=device), images, size=(700, 700),
        side=_thumb_side(zoom)) for m in ("tsne", "umap")]
    return raster.write_png(path, raster.tile_rows([panels], gap=8),
                            {"Title": "left: tsne   right: umap"})


def run_projection_3d(features, labels, method: str = "tsne",
                      path: str = "projection3d.png",
                      class_names: Optional[Sequence[str]] = None,
                      interactive_html: Optional[str] = None,
                      animate_path: Optional[str] = None,
                      animate_frames: int = 36, device="cuda") -> str:
    """3D projection scatter at matplotlib's default camera (elevation 30,
    azimuth -60). ``animate_path``: also a GIF of the camera's full
    azimuth sweep at elevation 20 (``animate_frames`` frames at 15 fps).
    ``interactive_html``: also plotly's HTML when plotly is installed
    (a warning otherwise)."""
    from superdiff_torch.utils import raster

    emb = _project(features, method, 3, device=device)
    raster.write_png(path, raster.scatter_3d(emb, labels),
                     {"Title": f"{method} 3D",
                      "Legend": raster.legend_text(labels, class_names)})
    if animate_path:
        frames = [raster.scatter_3d(emb, labels, size=(480, 560), elev=20.0,
                                    azim=float(a))
                  for a in np.linspace(0, 360, animate_frames,
                                       endpoint=False)]
        os.makedirs(os.path.dirname(animate_path) or ".", exist_ok=True)
        with open(animate_path, "wb") as f:
            f.write(raster.gif_bytes(np.stack(frames)))
    if interactive_html:
        from superdiff_torch.analysis.plotly3d import (
            run_plotly_projection_3d_with_thumbnails)

        try:
            run_plotly_projection_3d_with_thumbnails(
                features, labels, images=None, path=interactive_html,
                method=method, class_names=class_names, emb=emb)
        except ImportError:
            logging.getLogger("superdiff_torch").warning(
                "plotly not installed; skipped interactive HTML export")
    return path
