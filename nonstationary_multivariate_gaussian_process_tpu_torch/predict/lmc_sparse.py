"""Posterior-predictive machinery for the sparse (inducing-point) LMC.

Counterpart of the JAX package's ``predict/lmc_sparse.py`` for the full
layout: the stationary case of ``predict/snmgp_sparse.py``, with no latent
process to krige.  The cross Gram at new inputs is ``B_f ⊗ K_x(*, Z)`` at
the scalar (σ, ℓ) broadcast to constant processes; on CUDA ``K_x(*, Z)`` is
kernel K1's cross form and each Woodbury factor set takes K1's self and
cross forms, no gradient.  ``predict_sample`` returns (G, S, M), as JAX's
sparse predictor does (the dense LMC's returns (S, G, M)).  The Hadamard
layout's predictors (``*_hadamard``) take the raw task vector of
``models.lmc_sparse.make_objective_hadamard``, with K1 where JAX's take the
stationary ``rbf_cov`` (the model module says why the two agree).
"""

from __future__ import annotations

import torch

from .. import settings
from ..models import lmc_sparse as model
from ..models.base import FullData
from ..ops import kernels
from .hadamard import _setup as hadamard_setup
from .snmgp import GridPrediction, band, normals, setup
from .snmgp_sparse import flat_moments, hadamard_moments, indexed_draws


def _cross(p: model.Params, ops: model.SparseOps, grid):
    """``(K_gz, k(x*, x*))`` at the scalar (σ, ℓ) broadcast to constant
    processes."""
    sig, ell = torch.exp(p.tilde_sigma), torch.exp(p.tilde_l)
    ones_g, ones_z = torch.ones_like(grid), torch.ones_like(ops.z)
    sig_g = sig * ones_g
    k_gz = kernels.nonstationary_rbf_cov(grid, sigma1=sig_g, ell1=ell * ones_g, x2=ops.z, sigma2=sig * ones_z,
                                         ell2=ell * ones_z)  # kernel K1, cross form
    return k_gz, sig_g * sig_g + settings.jitter


def _conditional(p: model.Params, data: FullData, ops: model.SparseOps, grid, approx: str, mask):
    """Predictive ``(mu (G, M), s2_y (G, M))`` at ``grid`` for one vector."""
    m = data.y.shape[1]
    w = model._woodbury(p, data, ops, m, approx, mask)
    return flat_moments(w, model.task_cov(p.ul_vec, m), *_cross(p, ops, grid), torch.exp(p.tilde_sigma2_err))


def _moments(vec, data: FullData, ops: model.SparseOps, grid, approx: str = "fitc", mask=None, device=None,
             dtype=None):
    data, grid, as_t = setup(data, grid, device, dtype, "lmc_sparse")
    return _conditional(model.unpack(as_t(vec), data.y.shape[1]), data, ops, grid, approx, mask)


@torch.no_grad()
def predict_map(vec, data: FullData, ops: model.SparseOps, grid, hyper=None, approx: str = "fitc", mask=None,
                device=None, dtype=None) -> GridPrediction:
    """Plug-in MAP grid prediction (the sparse analogue of ``predict.lmc``);
    ``hyper`` is taken so that every tier's pipeline calls it alike.  Device
    and dtype as in ``predict.snmgp_sparse.predict_map``."""
    del hyper
    mu, s2 = _moments(vec, data, ops, grid, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


@torch.no_grad()
def predict_test(vec, data: FullData, ops: model.SparseOps, x_test, hyper=None, approx: str = "fitc", mask=None,
                 device=None, dtype=None):
    """Held-out predictive ``(mean (G, M), var (G, M))`` for RMSE/LPD."""
    del hyper
    return _moments(vec, data, ops, x_test, approx, mask, device, dtype)


@torch.no_grad()
def predict_sample(generator: torch.Generator | None, hist_vecs, data: FullData, ops: model.SparseOps, grid,
                   hyper=None, approx: str = "fitc", mask=None, n_sample: int | None = None, device=None, dtype=None,
                   noise=None) -> torch.Tensor:
    """Prediction over a chain: (G, S, M) y-draws, one per draw (the last
    ``n_sample`` draws when given).  The normals come from ``generator`` or
    from ``noise`` (S, G, M)."""
    del hyper
    data, grid, as_t = setup(data, grid, device, dtype, "lmc_sparse")
    m = data.y.shape[1]
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    if noise is None:
        noise = normals(generator, (hist.shape[0], grid.shape[0], m), grid.device, grid.dtype)
    ys = []
    for vec, z in zip(hist, as_t(noise)):
        mu, s2 = _conditional(model.unpack(vec, m), data, ops, grid, approx, mask)
        ys.append(mu + torch.sqrt(s2) * z)
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# The Hadamard layout: the raw task vector of ``make_objective_hadamard``.
# ---------------------------------------------------------------------------


def _moments_hadamard(vec, data, ops: model.SparseOps, m: int, grid, indx_grid=None, approx: str = "fitc", mask=None,
                      device=None, dtype=None):
    """Sparse Hadamard predictive moments: per task at every grid point ((G,
    M) each), or with task indices each point's own task's ((G,) each)."""
    data, grid, as_t = hadamard_setup(data, grid, device, dtype)
    p = model.unpack(as_t(vec), m)
    w = model._woodbury_hadamard(p, data, ops, m, approx, mask)
    if indx_grid is not None:
        indx_grid = torch.as_tensor(indx_grid, dtype=torch.long, device=grid.device)
    return hadamard_moments(w, model.raw_task_cov(p.ul_vec, m), *_cross(p, ops, grid), torch.exp(p.tilde_sigma2_err),
                            indx_grid)


@torch.no_grad()
def predict_map_hadamard(vec, data, ops: model.SparseOps, m: int, grid, hyper=None, approx: str = "fitc", mask=None,
                         device=None, dtype=None) -> GridPrediction:
    """Plug-in MAP grid prediction, every task at every point (the sparse
    analogue of ``predict.hadamard.lmc_predict_map``); ``hyper`` is taken so
    that every tier's pipeline calls it alike."""
    del hyper
    mu, s2 = _moments_hadamard(vec, data, ops, m, grid, None, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


@torch.no_grad()
def predict_test_hadamard(vec, data, ops: model.SparseOps, m: int, x_test, indx_test, hyper=None,
                          approx: str = "fitc", mask=None, device=None, dtype=None):
    """Held-out ``(mean (G,), var (G,))`` at each test point's own task."""
    del hyper
    return _moments_hadamard(vec, data, ops, m, x_test, indx_test, approx, mask, device, dtype)


@torch.no_grad()
def predict_test_hadamard_sample(generator: torch.Generator | None, hist_vecs, data, ops: model.SparseOps, m: int,
                                 x_test, indx_test, hyper=None, approx: str = "fitc", mask=None,
                                 n_sample: int | None = None, device=None, dtype=None, noise=None) -> torch.Tensor:
    """(G_test, S) indexed chain-sample draws for sample-based scoring; the
    normals come from ``generator`` or from ``noise`` (S, G_test)."""
    del hyper
    data, x_test, as_t = hadamard_setup(data, x_test, device, dtype)
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    if noise is None:
        noise = normals(generator, (hist.shape[0], x_test.shape[0]), x_test.device, x_test.dtype)
    return indexed_draws(lambda v: _moments_hadamard(v, data, ops, m, x_test, indx_test, approx, mask, x_test.device,
                                                     x_test.dtype), hist, as_t(noise))
