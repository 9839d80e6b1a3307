"""Posterior-predictive machinery for the GNMGP (nonseparable/SVC) model.

Counterpart of the JAX package's ``predict/gnmgp.py`` (reference
``Utility/prediction.py``):

* :func:`predict_map`          — plug-in MAP prediction
  (``point_predmap_inhomogeneous``, prediction.py:912-1036)
* :func:`predict_map_sampling` — latent sampling at the MAP, or draws of
  ℓ̃(x*) or L_f(x*) alone (``point_predmap_inhomogeneous_sampling``)
* :func:`predict_sample`       — prediction over an HMC chain
  (``point_predsample_inhomogeneous``)

The Gram is factorized once per parameter draw and all G grid points are
served by one triangular solve with G·M right-hand sides:

    μ_f(x*) = L*(x*) · Cᵀ k_*(x*),       C[n] = L_nᵀ α[:,n],  α = mat(Σ⁻¹y)
    Σ_f(x*) = k_**(x*) L*L*ᵀ − L* (FᵀΣ⁻¹F)(x*) L*ᵀ,  F[(m,n),b] = k_*[n] L_n[m,b]

On CUDA the MN×MN Gram is kernel K2 and the (N, G) cross-covariance kernel
K1 (``ops.gram_kernels``), once per draw on the sampling paths.  The kriging
projections depend on the inputs, the grid and the priors only, so a call
over many draws computes them once (the JAX package's ``vmap`` leaves them
unbatched for the same reason).

Randomness comes from an explicit ``torch.Generator`` (draws are made on its
device), or from ``noise=``: the standard normals the JAX functions draw,
so that a caller can replay JAX's keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings
from ..models import gnmgp as model
from ..models.base import FullData, task_major
from ..ops import chol as chol_ops
from ..ops import kernels, transforms
from .latent import LatentConditional, krige_proj, krige_rbf
from .snmgp import SampledPrediction, band, normals, setup, summarize


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


def _moments(data: FullData, grid, l_star, ls_star, factors, noise_var=None):
    """Predictive mean/variance at all grid points given latent values there.

    ``l_star``: (G,) lengthscales at the grid; ``ls_star``: (G, M, M)
    Cholesky factors of B_f(x*).  ``noise_var`` ((G, M) or scalar) replaces
    the training noise in the predictive variance and its floor: the
    heteroscedastic model passes its kriged noise process here.
    """
    ls, ell, sigma2_err, r, c = factors
    if noise_var is not None:
        sigma2_err = noise_var
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


def _hp(hyper):
    return {**model.DEFAULT_HYPERS, **(hyper or {})}


def _krige_projs(x, grid, hp):
    """:func:`krige_proj` of the ℓ̃ prior and of the L-entry prior."""
    return (krige_proj(x, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"]),
            krige_proj(x, grid, hp["alpha_L"], hp["beta_L"]))


def _latent_conds(p: model.Params, data: FullData, grid, hp, n: int, m: int, projs=(None, None)):
    """The kriged ℓ̃ and L-entry processes at the grid; ``projs`` (from
    :func:`_krige_projs`) saves recomputing the projections."""
    t = transforms.tri_size(m)
    cond_l = krige_rbf(
        data.x, grid, p.tilde_l, hp["mu_tilde_l"], hp["alpha_tilde_l"], hp["beta_tilde_l"], projs[0]
    )
    ul_mat = p.ul_vecs.reshape(n, t).T  # (T, N)
    cond_ul = krige_rbf(data.x, grid, ul_mat, hp["mu_L"], hp["alpha_L"], hp["beta_L"], projs[1])
    return cond_l, cond_ul  # cond_ul.mean: (T, G)


def _l_star(cond_ul: LatentConditional, z_ul: torch.Tensor, m: int) -> torch.Tensor:
    """Cholesky factors of B_f at the grid (..., G, M, M) from normals
    (..., T, G) around the kriged L-entry processes."""
    ul = cond_ul.mean + torch.sqrt(cond_ul.var) * z_ul  # (..., T, G)
    return transforms.vec_to_tril(transforms.ulvec_to_lvec(ul.mT, m), m)


def _y_draw(data, grid, cond_l, cond_ul, factors, z, m: int) -> torch.Tensor:
    """One (G, M) draw of y at the grid: ℓ̃ and the L-entries drawn around
    their kriged values, then y around the predictive moments."""
    z_l, z_ul, z_y = z
    tl = cond_l.mean + torch.sqrt(cond_l.var) * z_l
    mu, s2 = _moments(data, grid, torch.exp(tl), _l_star(cond_ul, z_ul, m), factors)
    return mu + torch.sqrt(s2) * z_y


@torch.no_grad()
def predict_map(vec, data: FullData, grid, device=None, dtype=None, hyper=None) -> GridPredictionSVC:
    """Plug-in MAP prediction (reference point_predmap_inhomogeneous).

    ``vec`` (packed MAP vector), ``data`` and ``grid`` may be numpy arrays or
    tensors; they are moved to ``device`` (default: ``cuda``, raising when
    there is none) in ``dtype`` (default: ``settings.dtype``).  ``hyper``
    overrides the latent priors' defaults (``models.gnmgp.DEFAULT_HYPERS``).
    """
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp")
    n, m = data.y.shape
    p = model.unpack(as_t(vec), n, m)
    cond_l, cond_ul = _latent_conds(p, data, grid, _hp(hyper), n, m)
    l_vec_star = transforms.ulvec_to_lvec(cond_ul.mean.T, m)  # (G, T)
    ls_star = transforms.vec_to_tril(l_vec_star, m)  # (G, M, M)
    factors = _factorize(p, data)
    mu, s2 = _moments(data, grid, torch.exp(cond_l.mean), ls_star, factors)
    pct, sd = band(mu, s2)
    return GridPredictionSVC(percentiles=pct, mean=mu, std=sd, l_vecs=l_vec_star)


@torch.no_grad()
def predict_map_sampling(
    generator: torch.Generator | None,
    n_sample: int,
    vec,
    data: FullData,
    grid,
    hyper=None,
    pred_smoothness: bool = False,
    pred_cov: bool = False,
    device=None,
    dtype=None,
    noise=None,
):
    """Latent-sampling prediction at the MAP (point_predmap_inhomogeneous_sampling).

    ``pred_smoothness=True`` → (G, S) draws of ℓ̃(x*);
    ``pred_cov=True``        → (G, S, M, M) draws of L_f(x*);
    otherwise                → :class:`SampledPrediction` over y draws.

    The normals come from ``generator`` or from ``noise``: (S, G) for
    ``pred_smoothness``, (S, T, G) for ``pred_cov``, else
    ``(z_l (S, G), z_ul (S, T, G), z_y (S, G, M))``.  Device and dtype as
    in :func:`predict_map`.
    """
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp")
    n, m = data.y.shape
    g, t = grid.shape[0], transforms.tri_size(m)
    draw = lambda *shape: normals(generator, (n_sample,) + shape, grid.device, grid.dtype)
    p = model.unpack(as_t(vec), n, m)
    cond_l, cond_ul = _latent_conds(p, data, grid, _hp(hyper), n, m)

    if pred_smoothness:
        z = draw(g) if noise is None else as_t(noise)
        return (cond_l.mean + torch.sqrt(cond_l.var) * z).T  # (G, S)
    if pred_cov:
        z = draw(t, g) if noise is None else as_t(noise)
        return _l_star(cond_ul, z, m).movedim(0, 1)  # (G, S, M, M)

    z = (draw(g), draw(t, g), draw(g, m)) if noise is None else tuple(as_t(a) for a in noise)
    factors = _factorize(p, data)
    ys = torch.stack([_y_draw(data, grid, cond_l, cond_ul, factors, zs, m) for zs in zip(*z)])
    return summarize(ys)


@torch.no_grad()
def predict_sample(
    generator: torch.Generator | None,
    hist_vecs,
    data: FullData,
    grid,
    hyper=None,
    n_sample: int | None = None,
    device=None,
    dtype=None,
    noise=None,
) -> torch.Tensor:
    """Prediction over an HMC chain (point_predsample_inhomogeneous):
    (G, S, M) draws of y, one per draw of the chain (the last ``n_sample``
    draws when given).

    As in the JAX package the L-process conditional krigs each draw's
    unconstrained uL-vectors and transforms them, so the sampled factors are
    valid Cholesky factors.  The normals come from ``generator`` or from
    ``noise = (z_l (S, G), z_ul (S, T, G), z_y (S, G, M))``.  Device and
    dtype as in :func:`predict_map`.
    """
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp")
    hp = _hp(hyper)
    n, m = data.y.shape
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    s, g, t = hist.shape[0], grid.shape[0], transforms.tri_size(m)
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(t, g), draw(g, m))
    z = tuple(as_t(a) for a in noise)
    projs = _krige_projs(data.x, grid, hp)
    ys = []
    for vec, zs in zip(hist, zip(*z)):
        p = model.unpack(vec, n, m)
        cond_l, cond_ul = _latent_conds(p, data, grid, hp, n, m, projs)
        ys.append(_y_draw(data, grid, cond_l, cond_ul, _factorize(p, data), zs, m))
    return torch.stack(ys, dim=1)
