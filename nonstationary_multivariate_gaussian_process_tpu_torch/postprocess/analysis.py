"""Latent-process summaries of a fitted GNMGP subject.

Counterpart of the GNMGP parts of the JAX package's ``postprocess/analysis.py``
(reference ``Utility/posterior_analysis.py``): chain unpacking (:71-78),
covariance → correlation (:48), the MAP-point processes (the driver-side
unpacking at ``Nonseparable_model.py:290-299``) and the posterior quantile
bands of the latent processes behind ``visualization_pos`` (:109-179), as
host numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops import transforms


def cov2cor(s) -> np.ndarray:
    """Covariance → correlation matrices, batched over leading axes
    (posterior_analysis.py:48-57)."""
    s = np.asarray(s)
    d = np.sqrt(np.diagonal(s, axis1=-2, axis2=-1))
    return s / (d[..., :, None] * d[..., None, :])


def unpack_hist_gnmgp(hist, n: int, m: int):
    """(S, P) chain → ``(tilde_l (S, N), ul (S, N·T), tilde_sigma2_err (S,))``
    (posterior_analysis.py:71-78)."""
    hist = np.asarray(hist)
    t = transforms.tri_size(m)
    return hist[:, :n], hist[:, n : n + n * t], hist[:, -1]


def _cov_processes(ul: np.ndarray, m: int):
    """Unconstrained L-vectors (..., T) → ``(B = L Lᵀ, R, stds)`` of shapes
    (..., M, M), (..., M, M), (..., M): the diagonal of L is ``exp`` of its
    entry, the rest as given, in ``tril_indices`` order."""
    t = transforms.tri_size(m)
    mask = np.zeros(t, bool)
    mask[transforms.diag_indices_vec(m)] = True
    lv = np.where(mask, np.exp(ul), ul)
    ls = np.zeros(ul.shape[:-1] + (m, m))
    rows, cols = np.tril_indices(m)
    ls[..., rows, cols] = lv
    b = ls @ np.swapaxes(ls, -1, -2)
    stds = np.sqrt(np.diagonal(b, axis1=-2, axis2=-1))
    cor = b / (stds[..., :, None] * stds[..., None, :])
    return b, cor, stds


class LatentSummary(NamedTuple):
    """Pointwise posterior quantile bands of the GNMGP latent processes."""

    tilde_l_q: np.ndarray  # (3, N) quantiles of log-lengthscale process
    std_q: np.ndarray  # (3, N, M) quantiles of the std processes
    cor_q: np.ndarray  # (3, N, M, M) quantiles of the correlation processes
    b_mean: np.ndarray  # (N, M, M) posterior-mean covariance process


def gnmgp_latent_summary(hist, n: int, m: int, percentiles=(2.5, 50.0, 97.5)) -> LatentSummary:
    """Posterior bands of ℓ(x), std(x), R(x) from a GNMGP chain (S, P),
    vectorized over the draws (``posterior_analysis.visualization_pos``,
    :109-179)."""
    tilde_l_h, ul_h, _ = unpack_hist_gnmgp(np.asarray(hist, np.float64), n, m)
    b, cor, stds = _cov_processes(ul_h.reshape(ul_h.shape[0], n, transforms.tri_size(m)), m)
    q = list(percentiles)
    return LatentSummary(
        tilde_l_q=np.percentile(tilde_l_h, q, axis=0),
        std_q=np.percentile(stds, q, axis=0),
        cor_q=np.percentile(cor, q, axis=0),
        b_mean=b.mean(axis=0),
    )


def gnmgp_map_latents(vec, n: int, m: int):
    """MAP-point latent processes ``(tilde_l, B_f(x), R_f(x), stds(x))``:
    (N,), (N, M, M), (N, M, M), (N, M)."""
    vec = np.asarray(vec, np.float64)
    b, cor, stds = _cov_processes(vec[n : n + n * transforms.tri_size(m)].reshape(n, -1), m)
    return vec[:n], b, cor, stds
