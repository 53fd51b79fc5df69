"""Fréchet distance between image sets over any feature extractor.

Port of ``superdiff_tpu/analysis/fid.py`` (numpy): ``||mu1 - mu2||^2 +
Tr(S1 + S2 - 2 (S1 S2)^(1/2))`` with the cross term through the symmetric
product ``S1^(1/2) S2 S1^(1/2)`` and an eigendecomposition-based PSD square
root. The features come off the device (``analysis/features.py``); the
statistics and the eigendecompositions run on the host.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from superdiff_torch.analysis.features import (FeatureExtractor,
                                               extract_features)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a symmetric PSD matrix via ``eigh`` (negative
    eigenvalues from rounding clipped to 0)."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """``||mu1-mu2||^2 + Tr(S1) + Tr(S2) - 2 Tr((S1^(1/2) S2
    S1^(1/2))^(1/2))``."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(inner))


def _stats(feats: np.ndarray):
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def compute_fid(extractor: FeatureExtractor,
                real_batches: Iterable,
                generated_batches: Iterable,
                max_samples: int = 300) -> float:
    """Fréchet distance between real and generated image sets under
    ``extractor`` (at most ``max_samples`` of each)."""
    real_f, _ = extract_features(extractor, real_batches, max_samples)
    gen_f, _ = extract_features(extractor, generated_batches, max_samples)
    if len(real_f) < 2 or len(gen_f) < 2:
        raise ValueError("need >= 2 samples per set for covariance")
    return frechet_distance(*_stats(real_f), *_stats(gen_f))
