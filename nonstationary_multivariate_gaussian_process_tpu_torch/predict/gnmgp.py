"""Posterior-predictive machinery for the GNMGP (nonseparable/SVC) model.

Counterpart of the JAX package's ``predict/gnmgp.py`` for plug-in MAP
prediction (reference ``point_predmap_inhomogeneous``,
``Utility/prediction.py:912-1036``).  The Gram is factorized once and all G
grid points are served by one triangular solve with G·M right-hand sides:

    μ_f(x*) = L*(x*) · Cᵀ k_*(x*),       C[n] = L_nᵀ α[:,n],  α = mat(Σ⁻¹y)
    Σ_f(x*) = k_**(x*) L*L*ᵀ − L* (FᵀΣ⁻¹F)(x*) L*ᵀ,  F[(m,n),b] = k_*[n] L_n[m,b]

On CUDA the MN×MN Gram is kernel K2 and the (N, G) cross-covariance kernel
K1 (``ops.gram_kernels``).  ``predict_map_sampling`` and ``predict_sample``
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings
from ..models import gnmgp as model
from ..models.base import FullData, check_full_data, task_major
from ..ops import chol as chol_ops
from ..ops import kernels, transforms
from .latent import krige_rbf


class GridPredictionSVC(NamedTuple):
    percentiles: torch.Tensor  # (G, 3, M)
    mean: torch.Tensor  # (G, M)
    std: torch.Tensor  # (G, M)
    l_vecs: torch.Tensor  # (G, T) kriged constrained Cholesky vectors at the grid


def _factorize(p: model.Params, data: FullData):
    n, m = data.y.shape
    ls = model.chol_process(p.ul_vecs, n, m)  # (N, M, M)
    ell = torch.exp(p.tilde_l)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    cov = model.gram(data.x, ell, ls)
    cov.diagonal().add_(sigma2_err)  # in place: the Gram is this function's own
    r = chol_ops.safe_cholesky(cov)
    alpha = chol_ops.chol_solve(r, task_major(data.y)).reshape(m, n)  # (M, N)
    c = torch.einsum("nmb,mn->nb", ls, alpha)  # (N, M): L_nᵀ α[:, n]
    return ls, ell, sigma2_err, r, c


def _moments(data: FullData, grid, l_star, ls_star, factors):
    """Predictive mean/variance at all grid points given latent values there.

    ``l_star``: (G,) lengthscales at the grid; ``ls_star``: (G, M, M)
    Cholesky factors of B_f(x*).
    """
    ls, ell, sigma2_err, r, c = factors
    n, m, _ = ls.shape
    g = grid.shape[0]
    k_cross = kernels.nonstationary_rbf_cov(
        data.x, torch.ones_like(data.x), ell, grid, torch.ones_like(grid), l_star
    )  # (N, G)
    t = k_cross.T @ c  # (G, M)
    mu_f = torch.einsum("gab,gb->ga", ls_star, t)  # (G, M)

    # F[(m,n), b, g] = k_cross[n,g] · L_n[m,b]  → one triangular solve, G·M RHS
    f = torch.einsum("ng,nmb->mnbg", k_cross, ls).reshape(m * n, m * g)
    s = chol_ops.tri_solve(r, f).reshape(m * n, m, g)
    h = torch.einsum("kbg,kcg->gbc", s, s)  # (G, M, M) = FᵀΣ⁻¹F per grid point
    d = torch.einsum("gab,gbc,gac->ga", ls_star, h, ls_star)  # diag(L* H L*ᵀ)
    k_self_star = 1.0 + settings.jitter  # Gibbs self-cov with σ≡1 (prediction.py:976)
    b_star_diag = torch.sum(ls_star**2, dim=-1)  # (G, M) = diag(L* L*ᵀ)
    sigma2_y = k_self_star * b_star_diag - d + sigma2_err
    # noise-variance floor (see the JAX package's predict/snmgp._moments)
    sigma2_y = torch.maximum(sigma2_y, sigma2_err)
    return mu_f, sigma2_y


def _latent_conds(p: model.Params, data: FullData, grid, hp, n: int, m: int):
    t = transforms.tri_size(m)
    cond_l = krige_rbf(
        data.x, grid, p.tilde_l, hp["mu_tilde_l"], hp["alpha_tilde_l"], hp["beta_tilde_l"]
    )
    ul_mat = p.ul_vecs.reshape(n, t).T  # (T, N)
    cond_ul = krige_rbf(data.x, grid, ul_mat, hp["mu_L"], hp["alpha_L"], hp["beta_L"])
    return cond_l, cond_ul  # cond_ul.mean: (T, G)


def predict_map(vec, data: FullData, grid, device=None, dtype=None, hyper=None) -> GridPredictionSVC:
    """Plug-in MAP prediction (reference point_predmap_inhomogeneous).

    ``vec`` (packed MAP vector), ``data`` and ``grid`` may be numpy arrays or
    tensors; they are moved to ``device`` (default: ``cuda``, raising when
    there is none) in ``dtype`` (default: ``settings.dtype``).  ``hyper``
    overrides the latent priors' defaults (``models.gnmgp.DEFAULT_HYPERS``).
    """
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    data = FullData(as_t(data.x), as_t(data.y))
    check_full_data(data, "gnmgp")
    n, m = data.y.shape
    p = model.unpack(as_t(vec), n, m)
    grid = as_t(grid)
    cond_l, cond_ul = _latent_conds(p, data, grid, {**model.DEFAULT_HYPERS, **(hyper or {})}, n, m)
    l_vec_star = transforms.ulvec_to_lvec(cond_ul.mean.T, m)  # (G, T)
    ls_star = transforms.vec_to_tril(l_vec_star, m)  # (G, M, M)
    factors = _factorize(p, data)
    mu, s2 = _moments(data, grid, torch.exp(cond_l.mean), ls_star, factors)
    sd = torch.sqrt(s2)
    pct = torch.stack([mu - 1.96 * sd, mu, mu + 1.96 * sd], dim=1)
    return GridPredictionSVC(percentiles=pct, mean=mu, std=sd, l_vecs=l_vec_star)
