"""Pareto-smoothed importance weights (PSIS), the part of Pathfinder that
PSIS-LOO needs.

Counterpart of ``psis_smooth`` and ``_gpd_fit`` in the JAX package's
``inference/pathfinder.py``: host numpy code, copied with its edge cases
(fewer than 5 finite weights or a tail spread above 700 give k̂ = ∞, the
``1e-300`` floors, Vehtari's regularisation of k̂).  The Pathfinder
sampler itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


def psis_smooth(log_w: np.ndarray) -> tuple[np.ndarray, float]:
    """Pareto-smoothed importance weights (Vehtari et al. 2024).

    Fits a generalized Pareto distribution to the largest
    ``M = min(0.2 R, 3 sqrt(R))`` raw weights (Zhang & Stephens 2009
    profile-posterior estimator) and replaces them by the fitted
    quantiles.  Returns ``(smoothed log weights, k_hat)``; ``k_hat > 0.7``
    flags an unreliable proposal (the standard PSIS diagnostic).
    """
    lw = np.asarray(log_w, dtype=np.float64).copy()
    r = lw.shape[0]
    finite = np.isfinite(lw)
    if finite.sum() < 5:
        return lw, np.inf
    m = int(min(np.ceil(0.2 * r), np.ceil(3.0 * np.sqrt(r))))
    if m < 5:
        return lw, 0.0
    order = np.argsort(lw)
    tail_idx = order[-m:]
    cutoff = lw[order[-m - 1]] if r > m else lw[order[0]]
    if lw[order[-1]] - cutoff > 700.0:
        # tail spread overflows exp in weight space: the proposal is
        # degenerate (one draw dominates by >e^700); smoothing can't help
        return lw, np.inf
    # exceedances over the cutoff, in weight space
    exc = np.exp(lw[tail_idx] - cutoff) - 1.0
    exc = np.maximum(exc, 1e-300)
    k_hat, sigma = _gpd_fit(np.sort(exc))
    if not np.isfinite(k_hat):
        return lw, np.inf
    # replace tail by fitted quantiles at the expected order statistics
    q = (np.arange(1, m + 1) - 0.5) / m
    if abs(k_hat) < 1e-12:
        smoothed = -sigma * np.log1p(-q)
    else:
        smoothed = sigma / k_hat * (np.power(1.0 - q, -k_hat) - 1.0)
    ranks = np.argsort(np.argsort(lw[tail_idx]))
    lw[tail_idx] = cutoff + np.log1p(smoothed[ranks])
    # never let smoothing raise a weight above the observed max
    lw[tail_idx] = np.minimum(lw[tail_idx], np.max(log_w))
    return lw, float(k_hat)


def _gpd_fit(x: np.ndarray) -> tuple[float, float]:
    """Zhang & Stephens (2009) GPD fit on sorted exceedances ``x``."""
    n = x.shape[0]
    if n < 5 or x[-1] <= 0:
        return np.inf, np.nan
    prior_bs = 3.0
    m_grid = 30 + int(np.floor(np.sqrt(n)))
    jj = np.arange(1, m_grid + 1, dtype=np.float64)
    x_star = x[max(int(np.floor(n / 4.0 + 0.5)) - 1, 0)]
    theta = 1.0 / x[-1] + (1.0 - np.sqrt(m_grid / (jj - 0.5))) / (
        prior_bs * max(x_star, 1e-300)
    )
    # profile likelihood over theta with k(theta) = E log1p(-theta x)
    # (the usual Pareto shape xi; heavy tail <=> theta < 0 <=> k > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        k_of = np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
        # Z&S's shape is -k_of; their profile l(theta) = n(log(theta/k_zs)
        # + k_zs - 1) becomes, in the usual-xi convention:
        l_prof = n * (np.log(-theta / k_of) - k_of - 1.0)
    l_prof = np.where(np.isfinite(l_prof), l_prof, -np.inf)
    if not np.any(np.isfinite(l_prof)):
        return np.inf, np.nan
    w = np.exp(l_prof - l_prof.max())
    w = w / w.sum()
    theta_hat = float(np.sum(theta * w))
    k_hat = float(np.mean(np.log1p(-theta_hat * x)))
    sigma = -k_hat / theta_hat if theta_hat != 0 else np.nan
    # Vehtari et al.'s weakly-informative regularization of k
    k_hat = (n * k_hat + 5.0) / (n + 10.0)
    return k_hat, float(sigma)
