"""Empirical (variogram-based) initializer for the latent processes.

Counterpart of the JAX package's ``inference/empirical.py`` (reference
``Utility/empirical_estimation.py:71-133``), host numpy code: per input
point, fit a Gaussian variogram ``γ(s) = σ²(1 − exp(−0.5 s²/ℓ²))`` to the
empirical semivariogram of a ±window segment, estimate the local task
covariance from the windowed second-moment matrix, and smooth the
lengthscale estimates.  ``method``: ``"auto"`` (the native C++/OpenMP kernel
when it builds and loads, else the numpy profile fit), ``"native"`` (raises
when the build fails), ``"profile"`` or ``"curve_fit"`` (the reference's
scipy optimizer).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import native, settings

METHODS = ("auto", "native", "profile", "curve_fit")


class EmpiricalEstimate(NamedTuple):
    est_sigmas: np.ndarray  # (N,) variogram sill estimates
    est_ls: np.ndarray  # (N,) lengthscale estimates
    smooth_ls: np.ndarray  # (N,) ±10-point smoothed lengthscales
    est_stds: np.ndarray  # (N, M) local std estimates
    est_r: np.ndarray  # (N, M, M) local correlation estimates
    est_b: np.ndarray  # (N, M, M) local covariance estimates
    est_l_vecs: np.ndarray  # (N*T,) local Cholesky vectors (constrained)
    est_tilde_sigma2_err: float  # fixed at -4 (empirical_estimation.py:124)


def variogram_gaussian(s, sigma, l):
    """Gaussian variogram model (empirical_estimation.py:59-60)."""
    return sigma**2 * (1.0 - np.exp(-0.5 * s**2 / l**2))


def semivariogram(x_seg: np.ndarray, y_seg: np.ndarray):
    """All-pairs empirical semivariogram of a segment (empirical_estimation.py:35-55).

    Returns (lags, sv) with sv per task: sv[p, m] = 0.5 (y_j − y_i)² for pair p.
    """
    n = x_seg.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    lags = x_seg[ju] - x_seg[iu]
    sv = 0.5 * (y_seg[ju] - y_seg[iu]) ** 2
    return lags, sv


def _profile_fit(lags: np.ndarray, sv: np.ndarray, n_grid: int = 60):
    """Profile least-squares Gaussian-variogram fit: for fixed ℓ the optimal
    σ² is closed-form; sweep ℓ over a log-grid spanning the lag range and
    keep the best.  Returns (sigma, l)."""
    lag_max = max(float(np.max(lags)), 1e-8)
    lag_min = max(float(np.min(lags[lags > 0])) if np.any(lags > 0) else 1e-4, 1e-8)
    grid = np.geomspace(lag_min / 4.0, lag_max * 4.0, n_grid)  # (G,)
    g = 1.0 - np.exp(-0.5 * (lags[None, :] ** 2) / (grid[:, None] ** 2))  # (G, P)
    gg = np.sum(g * g, axis=1)  # (G,)
    gy = g @ sv  # (G,)
    s2 = np.where(gg > 0, gy / np.maximum(gg, 1e-30), 0.0)
    resid = np.sum(sv**2) - 2.0 * s2 * gy + s2**2 * gg
    k = int(np.argmin(resid))
    return float(np.sqrt(max(s2[k], 1e-12))), float(grid[k])


def _curve_fit(lags, sv):
    from scipy.optimize import curve_fit

    cof, _ = curve_fit(variogram_gaussian, lags, sv, maxfev=2000)
    return abs(float(cof[0])), abs(float(cof[1]))


def _tril_to_vec(l: np.ndarray) -> np.ndarray:
    return l[np.tril_indices(l.shape[-1])]


def _local_factors(est_b: np.ndarray, est_ls: np.ndarray):
    """Per-point Cholesky vectors, stds and correlations of the windowed
    covariances (with a ``precision`` diagonal when a factor fails), and the
    ±10-point smoothed lengthscales.  Updates ``est_b`` in place."""
    n, m, _ = est_b.shape
    est_l_vecs = np.zeros((n, m * (m + 1) // 2))
    est_stds = np.zeros((n, m))
    est_r = np.zeros((n, m, m))
    for i in range(n):
        s = est_b[i]
        try:
            l_f = np.linalg.cholesky(s)
        except np.linalg.LinAlgError:
            s = s + np.eye(m) * settings.precision
            est_b[i] = s
            l_f = np.linalg.cholesky(s)
        est_l_vecs[i] = _tril_to_vec(l_f)
        d = np.sqrt(np.diag(s))
        est_stds[i] = d
        est_r[i] = s / np.outer(d, d)
    smooth_ls = np.array([np.mean(est_ls[max(0, i - 10) : min(i + 10, n - 1)]) for i in range(n)])
    return est_l_vecs.reshape(-1), est_stds, est_r, smooth_ls


def local_estimation(
    x: np.ndarray,
    y: np.ndarray,
    window_size: int = 30,
    method: str = "auto",
) -> EmpiricalEstimate:
    """Windowed local estimation of (σ(x), ℓ(x), B_f(x)) (empirical_estimation.py:71-133).

    Window semantics identical to the reference: segment = ``[max(0, n−w),
    min(n+w, N−1))``, covariance = ``YᵀY/(n_seg−1)`` with a ``precision``
    diagonal fallback if the Cholesky fails, smoothing window ±10.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    n, m = y.shape
    if method == "native" or (method == "auto" and native.available()):
        est_sigmas, est_ls = native.local_variogram_fit(x, y, window_size)
        est_b = native.windowed_cov(y, window_size)
    else:
        fit = _curve_fit if method == "curve_fit" else _profile_fit
        est_sigmas = np.zeros(n)
        est_ls = np.zeros(n)
        est_b = np.zeros((n, m, m))
        for i in range(n):
            start = max(0, i - window_size)
            end = min(i + window_size, n - 1)
            x_seg, y_seg = x[start:end], y[start:end]
            lags, sv = semivariogram(x_seg, y_seg)
            cofs = np.array([fit(lags, sv[:, t]) for t in range(m)])
            sigma_i, l_i = np.mean(cofs, axis=0)
            est_sigmas[i] = abs(sigma_i)
            est_ls[i] = abs(l_i)
            est_b[i] = y_seg.T @ y_seg / (y_seg.shape[0] - 1)
    est_l_vecs, est_stds, est_r, smooth_ls = _local_factors(est_b, est_ls)
    return EmpiricalEstimate(
        est_sigmas=est_sigmas,
        est_ls=est_ls,
        smooth_ls=smooth_ls,
        est_stds=est_stds,
        est_r=est_r,
        est_b=est_b,
        est_l_vecs=est_l_vecs,
        est_tilde_sigma2_err=-4.0,
    )
