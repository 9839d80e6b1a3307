"""Posterior-predictive machinery for the sparse (inducing-point) SNMGP.

Counterpart of the JAX package's ``predict/snmgp_sparse.py`` for the full
layout.  The SGPR algebra of ``predict/gnmgp_sparse.py`` over the
likelihood's Woodbury factor set: with ``A = C⁻¹ K_mn Λ^{-1/2}`` and
``L_in = chol(I + A Aᵀ)``,

    μ*   = w*ᵀ L_in⁻¹ (A d),            t* = C⁻¹ K_m*,  w* = L_in⁻¹ t*
    var* = K**_diag − diag(t*ᵀ t*) + diag(w*ᵀ w*)

The cross Gram at new inputs is the Kronecker ``B_f ⊗ K_x(*, Z)``; the
latent ℓ̃ and σ̃ processes there are kriged from their inducing values under
the exact model's RBF priors.  On CUDA ``K_x(*, Z)`` is kernel K1's cross
form, and each Woodbury factor set takes K1's self form (``K_zz``) and its
cross form (``K_xz``), no gradient.  The Hadamard layout's predictors
(``*_hadamard``) take the raw task vector of ``models.snmgp_sparse.
make_objective_hadamard``, all tasks at each grid point, or at indexed test
points (x*, task*) each point's own task, ``K_*m[g, (c, j)] = B_f[indx_g,
c]·K_x(x*_g, z_j)``.

Randomness comes from an explicit ``torch.Generator`` or from ``noise=``,
the standard normals the JAX function draws, so a caller can replay JAX's
keys.
"""

from __future__ import annotations

import torch

from .. import settings
from ..models import snmgp_sparse as model
from ..models.base import FullData
from ..ops import chol as chol_ops
from ..ops import kernels
from .hadamard import _setup as hadamard_setup
from .latent import krige_proj
from .snmgp import GridPrediction, band, normals, setup


def _hp(hyper):
    return {**model.DEFAULT_HYPERS, **(hyper or {})}


def star_moments(w, k_gm: torch.Tensor, k_star_diag: torch.Tensor):
    """The SGPR predictive solves from a Woodbury factor set: flat ``(mu,
    var_f)`` along ``k_gm``'s rows (task-major G·M)."""
    t_star = chol_ops.tri_solve(w.c_mm, k_gm.T)
    w_star = chol_ops.tri_solve(w.c_in, t_star)
    v = chol_ops.tri_solve(w.c_in, w.a @ w.d)
    mu = w_star.T @ v
    var = k_star_diag - torch.sum(t_star * t_star, dim=0) + torch.sum(w_star * w_star, dim=0)
    return mu, var


def flat_moments(w, b_f, k_gz, k_x_star, sigma2_err):
    """Predictive ``(mu (G, M), s2_y (G, M))`` of a separable tier from its
    Woodbury factors ``w``, the task covariance, the (G, m_z) cross
    covariance and ``k(x*, x*)`` (G,)."""
    g, m = k_gz.shape[0], b_f.shape[0]
    k_star_diag = (torch.diagonal(b_f)[:, None] * k_x_star[None, :]).reshape(-1)
    mu, var = star_moments(w, torch.kron(b_f, k_gz), k_star_diag)
    s2 = var.reshape(m, g).T + sigma2_err
    return mu.reshape(m, g).T, torch.maximum(s2, sigma2_err)  # the noise floor (see predict/snmgp)


def hadamard_moments(w, b_f, k_gz, k_x_star, sigma2_err, indx_grid=None):
    """:func:`flat_moments`, or with ``indx_grid`` (G,) each point's own
    task's ``(mu (G,), s2_y (G,))``: the rows ``K_*m[g, (c, j)] =
    B_f[indx_g, c]·K_gz[g, j]``."""
    if indx_grid is None:
        return flat_moments(w, b_f, k_gz, k_x_star, sigma2_err)
    g, m = k_gz.shape[0], b_f.shape[0]
    onehot = model.task_onehot(indx_grid, m, b_f.dtype)
    k_gm = (k_gz[:, None, :] * (onehot @ b_f)[:, :, None]).reshape(g, -1)
    mu, var = star_moments(w, k_gm, (onehot @ torch.diagonal(b_f)) * k_x_star)
    return mu, torch.maximum(var + sigma2_err, sigma2_err)


def _conditional(p: model.SparseParams, w, ops: model.SparseOps, grid, tl_g, ts_g, m: int, indx_grid=None,
                 b_f=None):
    """Predictive moments at ``grid`` given the latent ℓ̃ and σ̃ values there
    (``b_f`` defaults to the full layout's task covariance)."""
    sig_g = torch.exp(ts_g)
    k_gz = kernels.nonstationary_rbf_cov(grid, sigma1=sig_g, ell1=torch.exp(tl_g), x2=ops.z,
                                         sigma2=torch.exp(p.tilde_sigma_z), ell2=torch.exp(p.tilde_l_z))  # K1, cross
    return hadamard_moments(w, model.task_cov(p.ul_vec, m) if b_f is None else b_f, k_gz,
                            sig_g * sig_g + settings.jitter, torch.exp(p.tilde_sigma2_err), indx_grid)


def _projs(z, grid, hp):
    """``krige_proj`` Z → grid of the ℓ̃ prior and of the σ̃ prior."""
    return (krige_proj(z, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"]),
            krige_proj(z, grid, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"]))


def _moments(vec, data: FullData, ops: model.SparseOps, grid, hyper=None, approx: str = "fitc", mask=None,
             device=None, dtype=None):
    """Predictive mean and variance at ``grid``: ``(mu (G, M), s2_y (G, M))``."""
    data, grid, as_t = setup(data, grid, device, dtype, "snmgp_sparse")
    hp = _hp(hyper)
    m = data.y.shape[1]
    p = model.unpack(as_t(vec), ops.z.shape[0], m)
    (proj_l, _), (proj_s, _) = _projs(ops.z, grid, hp)
    tl_g = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ proj_l
    ts_g = hp["mu_tilde_sigma"] + (p.tilde_sigma_z - hp["mu_tilde_sigma"]) @ proj_s
    w = model._woodbury(p, data, ops, m, approx, hp, mask)
    return _conditional(p, w, ops, grid, tl_g, ts_g, m)


@torch.no_grad()
def predict_map(vec, data: FullData, ops: model.SparseOps, grid, hyper=None, approx: str = "fitc", mask=None,
                device=None, dtype=None) -> GridPrediction:
    """Plug-in MAP grid prediction, the sparse analogue of
    ``predict.snmgp.predict_map``.  ``vec``, ``data`` and ``grid`` may be
    numpy arrays or tensors; they are moved to ``device`` (default ``cuda``,
    raising when there is none) in ``dtype`` (default ``settings.dtype``),
    where ``ops`` must already lie."""
    mu, s2 = _moments(vec, data, ops, grid, hyper, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


@torch.no_grad()
def predict_test(vec, data: FullData, ops: model.SparseOps, x_test, hyper=None, approx: str = "fitc", mask=None,
                 device=None, dtype=None):
    """Held-out predictive ``(mean (G, M), var (G, M))`` for RMSE/LPD scoring."""
    return _moments(vec, data, ops, x_test, hyper, approx, mask, device, dtype)


@torch.no_grad()
def predict_sample(generator: torch.Generator | None, hist_vecs, data: FullData, ops: model.SparseOps, grid,
                   hyper=None, approx: str = "fitc", mask=None, n_sample: int | None = None, device=None, dtype=None,
                   noise=None) -> torch.Tensor:
    """Prediction over a chain: (G, S, M) y-draws, one per draw (the last
    ``n_sample`` draws when given); per draw the latent fields are drawn at
    the grid from their kriging conditionals at Z.  The normals come from
    ``generator`` or from ``noise = (z_l (S, G), z_s (S, G), z_y (S, G,
    M))``.  Device and dtype as in :func:`predict_map`."""
    data, grid, as_t = setup(data, grid, device, dtype, "snmgp_sparse")
    hp = _hp(hyper)
    m = data.y.shape[1]
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    s, g = hist.shape[0], grid.shape[0]
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(g), draw(g, m))
    z_l, z_s, z_y = (as_t(a) for a in noise)
    (proj_l, var_l), (proj_s, var_s) = _projs(ops.z, grid, hp)
    ys = []
    for i, vec in enumerate(hist):
        p = model.unpack(vec, ops.z.shape[0], m)
        tl = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ proj_l + torch.sqrt(var_l) * z_l[i]
        ts = hp["mu_tilde_sigma"] + (p.tilde_sigma_z - hp["mu_tilde_sigma"]) @ proj_s + torch.sqrt(var_s) * z_s[i]
        w = model._woodbury(p, data, ops, m, approx, hp, mask)
        mu, s2 = _conditional(p, w, ops, grid, tl, ts, m)
        ys.append(mu + torch.sqrt(s2) * z_y[i])
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# The Hadamard layout: the raw task vector of ``make_objective_hadamard``.
# ---------------------------------------------------------------------------


def _moments_hadamard(vec, data, ops: model.SparseOps, m: int, grid, indx_grid=None, hyper=None, approx: str = "fitc",
                      mask=None, device=None, dtype=None):
    """Sparse Hadamard predictive moments: per task at every grid point ((G,
    M) each), or with task indices each point's own task's ((G,) each)."""
    data, grid, as_t = hadamard_setup(data, grid, device, dtype)
    hp = _hp(hyper)
    p = model.unpack(as_t(vec), ops.z.shape[0], m)
    (proj_l, _), (proj_s, _) = _projs(ops.z, grid, hp)
    tl_g = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ proj_l
    ts_g = hp["mu_tilde_sigma"] + (p.tilde_sigma_z - hp["mu_tilde_sigma"]) @ proj_s
    w = model._woodbury_hadamard(p, data, ops, m, approx, hp, mask)
    if indx_grid is not None:
        indx_grid = torch.as_tensor(indx_grid, dtype=torch.long, device=grid.device)
    return _conditional(p, w, ops, grid, tl_g, ts_g, m, indx_grid, b_f=model.raw_task_cov(p.ul_vec, m))


@torch.no_grad()
def predict_map_hadamard(vec, data, ops: model.SparseOps, m: int, grid, hyper=None, approx: str = "fitc", mask=None,
                         device=None, dtype=None) -> GridPrediction:
    """Plug-in MAP grid prediction, every task at every point (the sparse
    analogue of ``predict.hadamard.snmgp_predict_map``).  ``data`` is a
    ``HadamardData``; device and dtype as in :func:`predict_map`."""
    mu, s2 = _moments_hadamard(vec, data, ops, m, grid, None, hyper, approx, mask, device, dtype)
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


@torch.no_grad()
def predict_test_hadamard(vec, data, ops: model.SparseOps, m: int, x_test, indx_test, hyper=None,
                          approx: str = "fitc", mask=None, device=None, dtype=None):
    """Held-out ``(mean (G,), var (G,))`` at each test point's own task."""
    return _moments_hadamard(vec, data, ops, m, x_test, indx_test, hyper, approx, mask, device, dtype)


def indexed_draws(moments, hist, noise):
    """(G, S) draws ``mu + sqrt(s2)·z`` of the indexed moments of each chain
    vector, ``noise`` (S, G)."""
    ys = []
    for vec, z in zip(hist, noise):
        mu, s2 = moments(vec)
        ys.append(mu + torch.sqrt(s2) * z)
    return torch.stack(ys, dim=1)


@torch.no_grad()
def predict_test_hadamard_sample(generator: torch.Generator | None, hist_vecs, data, ops: model.SparseOps, m: int,
                                 x_test, indx_test, hyper=None, approx: str = "fitc", mask=None,
                                 n_sample: int | None = None, device=None, dtype=None, noise=None) -> torch.Tensor:
    """(G_test, S) indexed chain-sample draws: per chain vector one y* draw
    from the indexed predictive.  The normals come from ``generator`` or
    from ``noise`` (S, G_test)."""
    data, x_test, as_t = hadamard_setup(data, x_test, device, dtype)
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    if noise is None:
        noise = normals(generator, (hist.shape[0], x_test.shape[0]), x_test.device, x_test.dtype)
    return indexed_draws(lambda v: _moments_hadamard(v, data, ops, m, x_test, indx_test, hyper, approx, mask,
                                                     x_test.device, x_test.dtype), hist, as_t(noise))
