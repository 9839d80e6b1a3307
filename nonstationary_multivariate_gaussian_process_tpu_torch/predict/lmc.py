"""Posterior-predictive machinery for the LMC (stationary) model.

Counterpart of the JAX package's ``predict/lmc.py`` (reference
``Utility/prediction.py``: ``pointwise_predmap_S`` :1566, ``test_predmap_S``
:1601, ``pointwise/test_predsample_S`` :1640, :1667).  The Kronecker
structure is factorized once per parameter draw (M batched N×N Choleskys)
and the whole grid is served by batched triangular solves, as in
``predict.snmgp``.  As in the JAX package the covariances here are the
stationary ``rbf_cov`` (with its nugget on the self form), so LMC
prediction launches no hand-written kernel.
"""

from __future__ import annotations

import torch

from ..models import lmc as model
from ..models.base import FullData, task_major
from ..ops import kernels
from .snmgp import GridPrediction, band, kron_factors, kron_moments, normals, setup


def _factorize(p: model.Params, data: FullData):
    n, m = data.y.shape
    b_f = model.task_cov(p.ul_vec, m)
    sigma, ell = torch.exp(p.tilde_sigma), torch.exp(p.tilde_l)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    k_x = kernels.rbf_cov(data.x, alpha=sigma, beta=ell)
    chols, alpha_mat, w_mat = kron_factors(b_f, k_x, sigma2_err, task_major(data.y), m, n)
    return b_f, sigma, ell, sigma2_err, chols, alpha_mat, w_mat


def _moments(data: FullData, grid, factors):
    """Predictive mean and variance (G, M); the self term is σ²·diag(B_f),
    no nugget (prediction.py:1594)."""
    b_f, sigma, ell, sigma2_err, chols, alpha_mat, w_mat = factors
    k_cross = kernels.rbf_cov(data.x, grid, alpha=sigma, beta=ell)  # (N, G)
    return kron_moments(b_f, chols, alpha_mat, w_mat, k_cross, sigma**2, sigma2_err)


@torch.no_grad()
def predict_map(vec, data: FullData, grid, device=None, dtype=None) -> GridPrediction:
    """Plug-in MAP prediction on a grid (pointwise_predmap_S / test_predmap_S).

    ``vec``, ``data`` and ``grid`` may be numpy arrays or tensors; they are
    moved to ``device`` (default: ``cuda``, raising when there is none) in
    ``dtype`` (default: ``settings.dtype``).
    """
    data, grid, as_t = setup(data, grid, device, dtype, "lmc")
    p = model.unpack(as_t(vec), data.y.shape[1])
    mu, s2 = _moments(data, grid, _factorize(p, data))
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


@torch.no_grad()
def predict_sample(
    generator: torch.Generator | None,
    hist_vecs,
    data: FullData,
    grid,
    n_sample: int | None = None,
    device=None,
    dtype=None,
    noise=None,
) -> torch.Tensor:
    """Prediction over a chain (pointwise/test_predsample_S): (S, G, M)
    draws of y, one per draw of the chain (the last ``n_sample`` when given),
    in the JAX function's layout.  As there, every output gets its own normal
    (the reference reuses one scalar normal per draw, prediction.py:1662).

    The normals come from ``generator`` or from ``noise`` (S, G, M).  Device
    and dtype as in :func:`predict_map`.
    """
    data, grid, as_t = setup(data, grid, device, dtype, "lmc")
    m = data.y.shape[1]
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    if noise is None:
        noise = normals(generator, (hist.shape[0], grid.shape[0], m), grid.device, grid.dtype)
    ys = []
    for vec, z in zip(hist, as_t(noise)):
        mu, s2 = _moments(data, grid, _factorize(model.unpack(vec, m), data))
        ys.append(mu + torch.sqrt(s2) * z)
    return torch.stack(ys)
