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
noise field at Z.  The Hadamard layout's predictors (``*_hadamard``) take
the raw L-vectors of ``models.gnmgp_sparse.make_objective_hadamard``, all
tasks at each grid point, or at indexed test points (x*, task*) each
point's own task.

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
from ..ops import kernels, transforms
from .gnmgp import GridPredictionSVC
from .hadamard import _select_indexed
from .hadamard import _setup as hadamard_setup
from .latent import krige_proj
from .snmgp import band, normals, setup
from .snmgp_sparse import star_moments


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


def _conditional(p: model.SparseParams, w, z, grid, ell_g, ls_g, m: int, noise=None, lz=None, indx_grid=None):
    """Predictive ``(mu, s2_y)`` at ``grid`` from the Woodbury factors ``w``
    and the latent values there (``ell_g`` (G,), ``ls_g`` (G, M, M)): (G,
    M) each, or with ``indx_grid`` (G,) each point's own task's, (G,).  The
    inducing factors ``lz`` default to the full layout's; the observation
    noise is ``exp(p.tilde_sigma2_err)`` or, for the hetero tier, ``noise``
    (G, M)."""
    g = grid.shape[0]
    if lz is None:
        lz = model.chol_factors(p.ul_vecs_z.reshape(z.shape[0], -1), m)
    k_gz = kernels.nonstationary_rbf_cov(grid, ell1=ell_g, x2=z, ell2=torch.exp(p.tilde_l_z))  # kernel K1, cross form
    if indx_grid is None:
        k_gm = model.cross_gram(k_gz, ls_g, lz)  # (GM, mM), task-major rows
        k_star_diag = ((1.0 + settings.jitter) * torch.sum(ls_g * ls_g, dim=-1)).T.reshape(-1)
    else:
        rows = model.task_rows(ls_g, indx_grid)  # (G, M)
        k_gm = (k_gz[:, None, :] * torch.einsum("ib,jcb->icj", rows, lz)).reshape(g, -1)
        k_star_diag = (1.0 + settings.jitter) * torch.sum(rows * rows, dim=-1)
    mu, var = star_moments(w, k_gm, k_star_diag)
    if indx_grid is None:
        mu, var = mu.reshape(m, g).T, var.reshape(m, g).T  # (G, M) from task-major flat
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
# The Hadamard layout: the raw L-vectors of ``make_objective_hadamard``.
# ---------------------------------------------------------------------------


def _hadamard_hp(hyper):
    return {**model.HADAMARD_DEFAULT_HYPERS, **(hyper or {})}


def _latents_at_hadamard(p: model.SparseParams, z, grid, hp, m: int):
    """Kriged latent fields Z → grid under the Hadamard conventions (raw
    L-vectors): ``(tilde_l* (G,), l_vecs* (G, T), ls* (G, M, M))``."""
    proj_l, _ = krige_proj(z, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    proj_ul, _ = krige_proj(z, grid, hp["alpha_L"], hp["beta_L"])
    tl_g = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ proj_l
    l_g = (hp["mu_L"] + (p.ul_vecs_z.reshape(z.shape[0], -1).T - hp["mu_L"]) @ proj_ul).T  # (G, T) raw
    return tl_g, l_g, transforms.vec_to_tril(l_g, m)


def _raw_lz(p: model.SparseParams, m_z: int, m: int) -> torch.Tensor:
    return transforms.vec_to_tril(p.ul_vecs_z.reshape(m_z, -1), m)


def _moments_hadamard(vec, data, ops: model.SparseOps, m: int, grid, indx_grid=None, hyper=None, approx: str = "fitc",
                      mask=None, device=None, dtype=None):
    """Sparse Hadamard predictive moments: per task at every grid point ((G,
    M) each), or with task indices each point's own task's ((G,) each, for
    test scoring; reference prediction.py:585-708).  Returns ``(mu, s2_y,
    l_vecs (G, T))``."""
    data, grid, as_t = hadamard_setup(data, grid, device, dtype)
    hp = _hadamard_hp(hyper)
    m_z = ops.z.shape[0]
    p = model.unpack(as_t(vec), m_z, m)
    w = model._woodbury_hadamard(p, data, ops, m, approx, hp, mask)
    tl_g, l_g, ls_g = _latents_at_hadamard(p, ops.z, grid, hp, m)
    if indx_grid is not None:
        indx_grid = torch.as_tensor(indx_grid, dtype=torch.long, device=grid.device)
    mu, s2 = _conditional(p, w, ops.z, grid, torch.exp(tl_g), ls_g, m, lz=_raw_lz(p, m_z, m), indx_grid=indx_grid)
    return mu, s2, l_g


@torch.no_grad()
def predict_map_hadamard(vec, data, ops: model.SparseOps, m: int, grid, hyper=None, approx: str = "fitc", mask=None,
                         device=None, dtype=None) -> GridPredictionSVC:
    """Plug-in MAP grid prediction, every task at every point (the sparse
    analogue of ``predict.hadamard.svc_predict_map``).  ``vec``, ``data``
    (a ``HadamardData``) and ``grid`` may be numpy arrays or tensors; they
    are moved to ``device`` (default ``cuda``, raising when there is none)
    in ``dtype`` (default ``settings.dtype``), where ``ops`` must already
    lie."""
    mu, s2, l_g = _moments_hadamard(vec, data, ops, m, grid, None, hyper, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPredictionSVC(percentiles=pct, mean=mu, std=sd, l_vecs=l_g)


@torch.no_grad()
def predict_test_hadamard(vec, data, ops: model.SparseOps, m: int, x_test, indx_test, hyper=None,
                          approx: str = "fitc", mask=None, device=None, dtype=None):
    """Held-out ``(mean (G,), var (G,))`` at each test point's own task, for
    RMSE/LPD.  Device and dtype as in :func:`predict_map_hadamard`."""
    mu, s2, _ = _moments_hadamard(vec, data, ops, m, x_test, indx_test, hyper, approx, mask, device, dtype)
    return mu, s2


@torch.no_grad()
def predict_sample_hadamard(generator: torch.Generator | None, hist_vecs, data, ops: model.SparseOps, m: int, grid,
                            hyper=None, approx: str = "fitc", mask=None, n_sample: int | None = None, device=None,
                            dtype=None, noise=None) -> torch.Tensor:
    """Chain-sample sparse Hadamard prediction: (G, S, M) y-draws.  Per draw
    the latent fields are drawn at the grid from their kriging conditionals
    (mean and marginal variance under the RBF priors at Z), the Woodbury
    factors give the f-conditional and the observation noise is added.  The
    normals come from ``generator`` or from ``noise = (z_l (S, G), z_ul (S,
    T, G), z_y (S, G, M))``, JAX's ``split(k, 3)`` per draw."""
    data, grid, as_t = hadamard_setup(data, grid, device, dtype)
    hp = _hadamard_hp(hyper)
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
        lv = (hp["mu_L"] + (p.ul_vecs_z.reshape(m_z, t).T - hp["mu_L"]) @ proj_ul
              + torch.sqrt(var_ul)[None, :] * z_ul[i])  # (T, G), raw
        w = model._woodbury_hadamard(p, data, ops, m, approx, hp, mask)
        mu, s2 = _conditional(p, w, ops.z, grid, torch.exp(tl), transforms.vec_to_tril(lv.T, m), m,
                              lz=_raw_lz(p, m_z, m))
        ys.append(mu + torch.sqrt(s2) * z_y[i])
    return torch.stack(ys, dim=1)


def predict_test_hadamard_sample(generator: torch.Generator | None, hist_vecs, data, ops: model.SparseOps, m: int,
                                 x_test, indx_test, hyper=None, approx: str = "fitc", mask=None,
                                 n_sample: int | None = None, device=None, dtype=None, noise=None) -> torch.Tensor:
    """(G_test, S) indexed chain-sample draws: :func:`predict_sample_hadamard`
    at the test points, then each point's own task (the sample-based scoring
    path, reference prediction.py:678-708)."""
    ys = predict_sample_hadamard(generator, hist_vecs, data, ops, m, x_test, hyper, approx, mask, n_sample, device,
                                 dtype, noise)
    return _select_indexed(ys, indx_test)


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
