"""Posterior-predictive machinery for the sparse (inducing-point) GNMGP.

Counterpart of the JAX package's ``predict/gnmgp_sparse.py`` for the full
layout.  Prediction rides the Woodbury factor set the likelihood builds
(``models/gnmgp_sparse._woodbury``): with ``A = C⁻¹ K_mn Λ^{-1/2}`` and
``L_in = chol(I + A Aᵀ)``,

    μ*   = w*ᵀ L_in⁻¹ (A d),            t* = C⁻¹ K_m*,  w* = L_in⁻¹ t*
    var* = K**_diag − diag(t*ᵀ t*) + diag(w*ᵀ w*)

so a grid of G points costs one (mM × GM) triangular solve pair.  The latent
processes at new inputs are kriged from their inducing values under the same
RBF priors.  On CUDA the (G, m_z) cross-covariance ``K_gz`` is kernel K1's
cross form (no gradient) and each draw's ``K_mm`` kernel K3.  The
heteroscedastic tier (``predict_map_hetero``, ``predict_test_hetero``)
serves the MAP only, as JAX's does: its predictive noise is kriged from the
noise field at Z.

Randomness comes from an explicit ``torch.Generator`` or from ``noise=``,
the standard normals the JAX function draws, so a caller can replay JAX's
keys.
"""

from __future__ import annotations

import torch

from .. import settings
from ..models import gnmgp_sparse as model
from ..models.base import FullData
from ..models.gnmgp import DEFAULT_HYPERS
from ..ops import chol as chol_ops
from ..ops import kernels, transforms
from .gnmgp import GridPredictionSVC
from .latent import krige_proj
from .snmgp import band, normals, setup


def _hp(hyper):
    return {**DEFAULT_HYPERS, **(hyper or {})}


def _latents_at(p: model.SparseParams, z, grid, hp, m: int):
    """Kriged latent fields Z → grid: ``(tilde_l* (G,), l_vecs* (G, T),
    ls* (G, M, M))``."""
    m_z = z.shape[0]
    t = transforms.tri_size(m)
    proj_l, _ = krige_proj(z, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    proj_ul, _ = krige_proj(z, grid, hp["alpha_L"], hp["beta_L"])
    tl_g = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ proj_l
    ul_g = (hp["mu_L"] + (p.ul_vecs_z.reshape(m_z, t).T - hp["mu_L"]) @ proj_ul).T  # (G, T)
    l_vec_g = transforms.ulvec_to_lvec(ul_g, m)
    return tl_g, l_vec_g, transforms.vec_to_tril(l_vec_g, m)


def _conditional(p: model.SparseParams, w, z, grid, ell_g, ls_g, m: int, noise=None):
    """Predictive ``(mu (G, M), s2_y (G, M))`` at ``grid`` from the Woodbury
    factors ``w`` and the latent values there (``ell_g`` (G,), ``ls_g`` (G,
    M, M)); the observation noise is ``exp(p.tilde_sigma2_err)`` or, for
    the hetero tier, ``noise`` (G, M)."""
    g = grid.shape[0]
    m_z = z.shape[0]
    lz = model.chol_factors(p.ul_vecs_z.reshape(m_z, -1), m)
    k_gz = kernels.nonstationary_rbf_cov(grid, ell1=ell_g, x2=z, ell2=torch.exp(p.tilde_l_z))  # kernel K1, cross form
    k_gm = model.cross_gram(k_gz, ls_g, lz)  # (GM, mM)
    t_star = chol_ops.tri_solve(w.c_mm, k_gm.T)  # (mM, GM)
    w_star = chol_ops.tri_solve(w.c_in, t_star)
    v = chol_ops.tri_solve(w.c_in, w.a @ w.d)  # (mM,)
    mu = (w_star.T @ v).reshape(m, g).T  # (G, M) from task-major flat
    k_star_diag = ((1.0 + settings.jitter) * torch.sum(ls_g * ls_g, dim=-1)).T.reshape(-1)
    var = (k_star_diag - torch.sum(t_star * t_star, dim=0) + torch.sum(w_star * w_star, dim=0)).reshape(m, g).T
    sigma2_err = torch.exp(p.tilde_sigma2_err) if noise is None else noise
    return mu, torch.maximum(var + sigma2_err, sigma2_err)  # the noise floor (see predict/snmgp)


def _moments(vec, data: FullData, ops: model.SparseOps, grid, hyper=None, approx: str = "fitc", mask=None,
             device=None, dtype=None):
    """Predictive mean and variance at ``grid``: ``(mu (G, M), s2_y (G, M),
    l_vecs (G, T))``."""
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp_sparse")
    hp = _hp(hyper)
    m = data.y.shape[1]
    p = model.unpack(as_t(vec), ops.z.shape[0], m)
    w = model._woodbury(p, data, ops, m, approx, hp, mask)
    tl_g, l_vec_g, ls_g = _latents_at(p, ops.z, grid, hp, m)
    mu, s2 = _conditional(p, w, ops.z, grid, torch.exp(tl_g), ls_g, m)
    return mu, s2, l_vec_g


@torch.no_grad()
def predict_map(vec, data: FullData, ops: model.SparseOps, grid, hyper=None, approx: str = "fitc", mask=None,
                device=None, dtype=None) -> GridPredictionSVC:
    """Plug-in MAP grid prediction, the sparse analogue of
    ``predict.gnmgp.predict_map``.  ``vec``, ``data`` and ``grid`` may be
    numpy arrays or tensors; they are moved to ``device`` (default ``cuda``,
    raising when there is none) in ``dtype`` (default ``settings.dtype``),
    where ``ops`` must already lie."""
    mu, s2, l_vec_g = _moments(vec, data, ops, grid, hyper, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPredictionSVC(percentiles=pct, mean=mu, std=sd, l_vecs=l_vec_g)


@torch.no_grad()
def predict_test(vec, data: FullData, ops: model.SparseOps, x_test, hyper=None, approx: str = "fitc", mask=None,
                 device=None, dtype=None):
    """Held-out predictive ``(mean (G, M), var (G, M))`` for RMSE/LPD scoring."""
    mu, s2, _ = _moments(vec, data, ops, x_test, hyper, approx, mask, device, dtype)
    return mu, s2


@torch.no_grad()
def predict_sample(generator: torch.Generator | None, hist_vecs, data: FullData, ops: model.SparseOps, grid,
                   hyper=None, approx: str = "fitc", mask=None, n_sample: int | None = None, device=None, dtype=None,
                   noise=None) -> torch.Tensor:
    """Prediction over a chain: (G, S, M) y-draws, one per draw (the last
    ``n_sample`` draws when given).  Latent uncertainty at the grid enters
    through the kriging marginal variances, observation uncertainty through
    the sparse predictive variance.  The normals come from ``generator`` or
    from ``noise = (z_l (S, G), z_ul (S, T, G), z_y (S, G, M))``.  Device and
    dtype as in :func:`predict_map`."""
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp_sparse")
    hp = _hp(hyper)
    m = data.y.shape[1]
    m_z = ops.z.shape[0]
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    s, g, t = hist.shape[0], grid.shape[0], transforms.tri_size(m)
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(t, g), draw(g, m))
    z_l, z_ul, z_y = (as_t(a) for a in noise)
    proj_l, var_l = krige_proj(ops.z, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    proj_ul, var_ul = krige_proj(ops.z, grid, hp["alpha_L"], hp["beta_L"])
    ys = []
    for i, vec in enumerate(hist):
        p = model.unpack(vec, m_z, m)
        tl = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ proj_l + torch.sqrt(var_l) * z_l[i]
        ul = (hp["mu_L"] + (p.ul_vecs_z.reshape(m_z, t).T - hp["mu_L"]) @ proj_ul
              + torch.sqrt(var_ul)[None, :] * z_ul[i])  # (T, G)
        w = model._woodbury(p, data, ops, m, approx, hp, mask)
        mu, s2 = _conditional(p, w, ops.z, grid, torch.exp(tl), model.chol_factors(ul.T, m), m)
        ys.append(mu + torch.sqrt(s2) * z_y[i])
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# The heteroscedastic tier: the predictive noise kriged from the Z noise field.
# ---------------------------------------------------------------------------


def _moments_hetero(vec, data: FullData, ops_h: model.SparseHeteroOps, grid, hyper=None, approx: str = "fitc",
                    mask=None, device=None, dtype=None):
    """Sparse hetero predictive moments: the homoscedastic machinery with the
    per-slot training noise in the Woodbury factors and the kriged noise at
    the grid in the predictive variance.  Returns ``(mu (G, M), s2_y (G,
    M), l_vecs (G, T))``."""
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp_hetero_sparse")
    hp = {**model.HETERO_DEFAULT_HYPERS, **(hyper or {})}
    m = data.y.shape[1]
    z = ops_h.base.z
    p = model.unpack_hetero(as_t(vec), z.shape[0], m)
    sp_p = model._base_params(p)
    noise_tr = torch.exp(model.noise_at_data(p, ops_h, m, hp))
    w = model._woodbury_noise(sp_p, data, ops_h.base, m, approx, noise_tr, hp, mask)
    tl_g, l_vec_g, ls_g = _latents_at(sp_p, z, grid, hp, m)
    proj_err, _ = krige_proj(z, grid, hp["alpha_err"], hp["beta_err"])
    noise_g = torch.exp(hp["mu_err"] + (p.tilde_sigma2_err.reshape(m, z.shape[0]) - hp["mu_err"]) @ proj_err).T
    mu, s2 = _conditional(sp_p, w, z, grid, torch.exp(tl_g), ls_g, m, noise=noise_g)
    return mu, s2, l_vec_g


@torch.no_grad()
def predict_map_hetero(vec, data: FullData, ops_h: model.SparseHeteroOps, grid, hyper=None, approx: str = "fitc",
                       mask=None, device=None, dtype=None) -> GridPredictionSVC:
    """Plug-in MAP grid prediction of the sparse hetero tier.  Device and
    dtype as in :func:`predict_map`."""
    mu, s2, l_vec_g = _moments_hetero(vec, data, ops_h, grid, hyper, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPredictionSVC(percentiles=pct, mean=mu, std=sd, l_vecs=l_vec_g)


@torch.no_grad()
def predict_test_hetero(vec, data: FullData, ops_h: model.SparseHeteroOps, x_test, hyper=None, approx: str = "fitc",
                        mask=None, device=None, dtype=None):
    """Held-out predictive ``(mean (G, M), var (G, M))`` of the sparse hetero
    tier."""
    mu, s2, _ = _moments_hetero(vec, data, ops_h, x_test, hyper, approx, mask, device, dtype)
    return mu, s2
