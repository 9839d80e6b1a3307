"""Initialization strategies for MAP training.

Counterpart of the LMC, SNMGP and GNMGP builders of the JAX package's
``inference/init.py`` (reference ``Stationary_model.py:88-101``,
``Separable_model.py:101-144``, ``Nonseparable_model.py:115-151``).  Each
builder works in numpy float64 on the host and returns a packed parameter
vector on ``device`` in ``dtype`` (default: ``cuda``, raising when there is
none; ``settings.dtype``).  The JAX builders' optional ``key`` noise is not
ported: ``run_subject`` passes none.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import settings
from ..ops import transforms
from .empirical import EmpiricalEstimate


def _as(v, device, dtype) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(v), dtype=dtype or settings.dtype, device=settings.resolve_device(device)
    )


def _lvecs_to_ulvecs(l_vecs: np.ndarray, n: int, m: int) -> np.ndarray:
    """Constrained → unconstrained per-input L-vectors, (N·T,): log on the
    diagonal slots (reference utils.py:48-54)."""
    t = transforms.tri_size(m)
    lv = np.asarray(l_vecs, np.float64).reshape(n, t)
    mask = np.zeros(t, bool)
    mask[transforms.diag_indices_vec(m)] = True
    return np.where(mask, np.log(np.where(mask, lv, 1.0)), lv).reshape(-1)


def _host(vec) -> np.ndarray:
    return np.asarray(vec.detach().cpu() if torch.is_tensor(vec) else vec, np.float64)


def lmc_from_empirical(emp: EmpiricalEstimate, n: int, m: int, device=None, dtype=None):
    """Stationary_model.py:88-101: means of the local empirical estimates,
    unit scale (``tilde_sigma = 0``)."""
    tilde_l = np.mean(np.log(emp.est_ls))
    ul_vec = _lvecs_to_ulvecs(emp.est_l_vecs, n, m).reshape(n, -1).mean(axis=0)
    return _as(np.concatenate([[tilde_l, 0.0], ul_vec, [emp.est_tilde_sigma2_err]]), device, dtype)


def snmgp_from_stationary(lmc_vec, n: int, device=None, dtype=None):
    """Separable_model.py:101-111: the stationary MAP broadcast over N."""
    v = _host(lmc_vec)
    return _as(np.concatenate([np.full(n, v[0]), np.full(n, v[1]), v[2:-1], [v[-1]]]), device, dtype)


def snmgp_combined(lmc_vec, emp: EmpiricalEstimate, n: int, m: int, device=None, dtype=None):
    """Separable_model.py:126-144: the stationary lengthscale, the empirical
    task covariance, unit σ-process."""
    v = _host(lmc_vec)
    ul_vec = _lvecs_to_ulvecs(emp.est_l_vecs, n, m).reshape(n, -1).mean(axis=0)
    return _as(np.concatenate([np.full(n, v[0]), np.ones(n), ul_vec, [emp.est_tilde_sigma2_err]]),
               device, dtype)


def snmgp_from_empirical(emp: EmpiricalEstimate, n: int, m: int, device=None, dtype=None):
    """Separable_model.py:112-125: empirical ℓ-process, unit σ-process."""
    tilde_l = np.log(emp.est_ls)
    ul_vec = _lvecs_to_ulvecs(emp.est_l_vecs, n, m).reshape(n, -1).mean(axis=0)
    tilde_sigma = np.ones(n)
    return _as(np.concatenate([tilde_l, tilde_sigma, ul_vec, [emp.est_tilde_sigma2_err]]),
               device, dtype)


def gnmgp_from_empirical(emp: EmpiricalEstimate, n: int, m: int, smooth: bool = False,
                         device=None, dtype=None):
    """Nonseparable_model.py:132-141: empirical ℓ-process and L-process."""
    tilde_l = np.log(emp.smooth_ls if smooth else emp.est_ls)
    ul_vecs = _lvecs_to_ulvecs(emp.est_l_vecs, n, m)
    return _as(np.concatenate([tilde_l, ul_vecs, [emp.est_tilde_sigma2_err]]), device, dtype)


def gnmgp_from_separable(snmgp_vec, n: int, m: int, device=None, dtype=None):
    """Nonseparable_model.py:117-130: scale the separable task-Cholesky by
    σ(x), so the per-input factor is ``L_vec · exp(tilde_sigma_n)``."""
    v = _host(snmgp_vec)
    tilde_l = v[:n]
    tilde_sigma = v[n : 2 * n]
    l_vec = v[2 * n : -1]
    l_vecs = np.concatenate([l_vec * s for s in np.exp(tilde_sigma)])
    ul_vecs = _lvecs_to_ulvecs(np.abs(l_vecs) + 1e-12, n, m)
    # off-diagonals keep their sign; only diagonal slots were abs-ed for the log
    t = transforms.tri_size(m)
    mask = np.zeros(t, bool)
    mask[transforms.diag_indices_vec(m)] = True
    ul_vecs = np.where(np.tile(mask, n), ul_vecs, l_vecs)
    return _as(np.concatenate([tilde_l, ul_vecs, [v[-1]]]), device, dtype)
