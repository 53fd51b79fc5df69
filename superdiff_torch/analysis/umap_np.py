"""Minimal UMAP in pure NumPy: the port's own copy of
``superdiff_tpu/analysis/umap_np.py``, line for line, so that the port
imports nothing of the JAX package and gives the same bits.

umap-learn is not a dependency of the port, so ``analysis/projection.py``
always takes this implementation (the JAX package falls back to its copy
when umap-learn is missing). The core pipeline of UMAP (McInnes et al.,
2018): exact kNN graph -> smooth-kNN calibration (per-point rho/sigma,
bisection to hit log2(k)) -> fuzzy simplicial set symmetrisation -> PCA
init -> SGD over attractive/repulsive cross-entropy forces with negative
sampling and the (a, b) low-dimensional similarity curve. Deterministic for
a fixed seed; sized for the projection suite's few hundred points.
"""

from __future__ import annotations

import numpy as np

# Curve y = 1 / (1 + a x^(2b)) fitted to min_dist=0.1, spread=1.0 — the
# umap-learn defaults (values from its published curve fit).
_A, _B = 1.577, 0.8951


def _knn(x: np.ndarray, k: int):
    """Exact kNN by full pairwise distances (fine at projection-suite scale)."""
    d2 = np.sum(x * x, axis=1)[:, None] + np.sum(x * x, axis=1)[None, :] \
        - 2.0 * (x @ x.T)
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    dist = np.sqrt(np.maximum(np.take_along_axis(d2, idx, axis=1), 0.0))
    return idx, dist


def _smooth_knn(dist: np.ndarray, n_iter: int = 64):
    """Per-point (rho, sigma): rho = nearest-neighbor distance; sigma solves
    sum_j exp(-max(d_ij - rho, 0)/sigma) = log2(k) by bisection."""
    n, k = dist.shape
    rho = dist[:, 0]
    target = np.log2(k)
    lo = np.full(n, 1e-8)
    hi = np.full(n, 1e4)
    sigma = np.ones(n)
    for _ in range(n_iter):
        val = np.exp(-np.maximum(dist - rho[:, None], 0.0)
                     / sigma[:, None]).sum(axis=1)
        high = val > target
        hi = np.where(high, sigma, hi)
        lo = np.where(high, lo, sigma)
        sigma = np.where(hi >= 1e4, lo * 2, (lo + hi) / 2)
    return rho, np.maximum(sigma, 1e-8)


def fuzzy_simplicial_set(x: np.ndarray, k: int):
    """Symmetrized fuzzy graph as (rows, cols, weights) of its nonzeros."""
    idx, dist = _knn(x, k)
    rho, sigma = _smooth_knn(dist)
    w = np.exp(-np.maximum(dist - rho[:, None], 0.0) / sigma[:, None])
    n = len(x)
    p = np.zeros((n, n))
    rows = np.repeat(np.arange(n), k)
    p[rows, idx.ravel()] = w.ravel()
    p = p + p.T - p * p.T            # probabilistic t-conorm (fuzzy union)
    r, c = np.nonzero(np.triu(p, 1))
    return r, c, p[r, c]


def umap_embed(features: np.ndarray, n_components: int = 2,
               n_neighbors: int = 15, n_epochs: int = 500,
               learning_rate: float = 0.02, negative_rate: int = 3,
               seed: int = 42) -> np.ndarray:
    """Embed ``features`` (N, D) into ``n_components`` dims, UMAP-style.

    Defaults tuned for the vectorized batch updates (all fired edges apply
    simultaneously per epoch, so the learning rate sits well below
    umap-learn's sequential-SGD 1.0): two/three Gaussian blobs embed with
    centroid-gap/within-spread > 3 and 100% nearest-centroid accuracy."""
    x = np.asarray(features, dtype=np.float64)
    n = len(x)
    if n < 3:
        return np.zeros((n, n_components))
    k = int(min(n_neighbors, n - 1))
    rng = np.random.default_rng(seed)
    rows, cols, w = fuzzy_simplicial_set(x, k)

    # PCA init scaled to ~1e-2 extent (umap-learn spectral-init scale)
    xc = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    emb = xc @ vt[:n_components].T
    emb = 10.0 * emb / max(np.abs(emb).max(), 1e-12) * 1e-2 \
        + rng.normal(scale=1e-4, size=(n, n_components))

    # Edge sampling schedule: edge e fires every n_epochs/(w_e/w_max) epochs
    w = w / w.max()
    next_fire = np.zeros(len(w))
    period = 1.0 / np.maximum(w, 1e-12)

    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        fire = next_fire <= epoch
        if not fire.any():
            continue
        next_fire[fire] += period[fire]
        i, j = rows[fire], cols[fire]

        # Attractive forces along fired edges (vectorized mini-batch SGD:
        # within-epoch updates use the epoch-start positions).
        d = emb[i] - emb[j]
        d2 = np.maximum(np.sum(d * d, axis=1), 1e-12)
        g = -2.0 * _A * _B * d2 ** (_B - 1.0) / (1.0 + _A * d2 ** _B)
        grad = np.clip(g[:, None] * d, -4.0, 4.0)
        np.add.at(emb, i, alpha * grad)
        np.add.at(emb, j, -alpha * grad)

        # Repulsive forces against sampled negatives
        src = np.repeat(i, negative_rate)
        neg = rng.integers(n, size=len(src))
        keep = neg != src
        src, neg = src[keep], neg[keep]
        d = emb[src] - emb[neg]
        d2 = np.maximum(np.sum(d * d, axis=1), 1e-12)
        g = 2.0 * _B / ((0.001 + d2) * (1.0 + _A * d2 ** _B))
        np.add.at(emb, src, alpha * np.clip(g[:, None] * d, -4.0, 4.0))
    return emb
