"""Latent-process summaries of a fitted GNMGP subject.

Counterpart of the MAP parts of the JAX package's ``postprocess/analysis.py``
(reference ``Utility/posterior_analysis.py:48``, the driver-side unpacking
at ``Nonseparable_model.py:290-299``): host numpy code.  The chain
summaries wait for the sampler (HMC is not ported yet).
"""

from __future__ import annotations

import numpy as np

from ..ops import transforms


def cov2cor(s) -> np.ndarray:
    """Covariance → correlation matrices, batched over leading axes
    (posterior_analysis.py:48-57)."""
    s = np.asarray(s)
    d = np.sqrt(np.diagonal(s, axis1=-2, axis2=-1))
    return s / (d[..., :, None] * d[..., None, :])


def gnmgp_map_latents(vec, n: int, m: int):
    """MAP-point latent processes ``(tilde_l, B_f(x), R_f(x), stds(x))``:
    (N,), (N, M, M), (N, M, M), (N, M)."""
    vec = np.asarray(vec, np.float64)
    t = transforms.tri_size(m)
    tilde_l = vec[:n]
    ul = vec[n : n + n * t].reshape(n, t)
    mask = np.zeros(t, bool)
    mask[transforms.diag_indices_vec(m)] = True
    lv = np.where(mask, np.exp(ul), ul)
    ls = np.zeros((n, m, m))
    rows, cols = np.tril_indices(m)
    ls[:, rows, cols] = lv
    b = ls @ np.swapaxes(ls, -1, -2)
    stds = np.sqrt(np.diagonal(b, axis1=-2, axis2=-1))
    cor = b / (stds[..., :, None] * stds[..., None, :])
    return tilde_l, b, cor, stds
