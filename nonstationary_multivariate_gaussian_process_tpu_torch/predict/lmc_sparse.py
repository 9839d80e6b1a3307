"""Posterior-predictive machinery for the sparse (inducing-point) LMC.

Counterpart of the JAX package's ``predict/lmc_sparse.py`` for the full
layout: the stationary case of ``predict/snmgp_sparse.py``, with no latent
process to krige.  The cross Gram at new inputs is ``B_f ⊗ K_x(*, Z)`` at
the scalar (σ, ℓ) broadcast to constant processes; on CUDA ``K_x(*, Z)`` is
kernel K1's cross form and each Woodbury factor set takes K1's self and
cross forms, no gradient.  ``predict_sample`` returns (G, S, M), as JAX's
sparse predictor does (the dense LMC's returns (S, G, M)).
"""

from __future__ import annotations

import torch

from .. import settings
from ..models import lmc_sparse as model
from ..models.base import FullData
from ..ops import kernels
from .snmgp import GridPrediction, band, normals, setup
from .snmgp_sparse import flat_moments


def _conditional(p: model.Params, data: FullData, ops: model.SparseOps, grid, approx: str, mask):
    """Predictive ``(mu (G, M), s2_y (G, M))`` at ``grid`` for one vector."""
    m = data.y.shape[1]
    w = model._woodbury(p, data, ops, m, approx, mask)
    sig, ell = torch.exp(p.tilde_sigma), torch.exp(p.tilde_l)
    ones_g, ones_z = torch.ones_like(grid), torch.ones_like(ops.z)
    sig_g = sig * ones_g
    k_gz = kernels.nonstationary_rbf_cov(grid, sigma1=sig_g, ell1=ell * ones_g, x2=ops.z, sigma2=sig * ones_z,
                                         ell2=ell * ones_z)  # kernel K1, cross form
    return flat_moments(w, model.task_cov(p.ul_vec, m), k_gz, sig_g * sig_g + settings.jitter,
                        torch.exp(p.tilde_sigma2_err))


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
