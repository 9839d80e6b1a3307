"""Posterior-predictive machinery for the SNMGP (separable) model.

Counterpart of the JAX package's ``predict/snmgp.py`` (reference
``Utility/prediction.py``):

* :func:`predict_map`          — plug-in MAP prediction
  (``point_predmap``/``pointwise_predmap``/``test_predmap``, prediction.py:337-458)
* :func:`predict_map_sampling` — latent sampling at the MAP
  (``point_predmap_sampling``, prediction.py:189-334)
* :func:`predict_sample`       — prediction over an HMC chain
  (``point_predsample``, prediction.py:34-186)

``Σ = B_f ⊗ K_x + σ²I = (v_B ⊗ I) blockdiag_j(w_j K_x + σ²I) (v_B ⊗ I)ᵀ`` is
factorized once per parameter draw (M batched N×N Choleskys) and every grid
point reduces to batched triangular solves:

    μ_f(x*) = B_f · α · k_*(x*),           α = mat(Σ⁻¹y)
    σ²_f(x*)[m] = k_**(x*) B_f[m,m] − Σ_j (v_BᵀB_f)[j,m]² ‖R_j⁻¹ k_*(x*)‖²

On CUDA ``K_x`` is kernel K1's self form and the (N, G) cross-covariance
K1's cross form, both with the σ-process on their sides; once per draw on
the sampling paths.  The kriging projections depend on the inputs, the grid
and the priors only, so a call over many draws computes them once.

Randomness comes from an explicit ``torch.Generator`` (draws are made on its
device), or from ``noise=``: the standard normals the JAX functions draw,
so that a caller can replay JAX's keys.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings
from ..models import snmgp as model
from ..models.base import FullData, check_full_data, task_major
from ..ops import kernels, kron
from .latent import krige_proj, krige_rbf


class GridPrediction(NamedTuple):
    percentiles: torch.Tensor  # (G, 3, M): mean ∓ 1.96σ, mean, mean + 1.96σ
    mean: torch.Tensor  # (G, M)
    std: torch.Tensor  # (G, M)


class SampledPrediction(NamedTuple):
    quantiles: torch.Tensor  # (G, 2, M): 2.5 / 97.5 percentiles over draws
    mean: torch.Tensor  # (G, M)
    std: torch.Tensor  # (G, M)


def setup(data: FullData, grid, device, dtype, name: str):
    """``data`` and ``grid`` as tensors on ``device`` (default ``cuda``,
    raising when there is none) in ``dtype`` (default ``settings.dtype``),
    and the converter used for them."""
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    data = FullData(as_t(data.x), as_t(data.y))
    check_full_data(data, name)
    return data, as_t(grid), as_t


def normals(generator: torch.Generator, shape, device, dtype) -> torch.Tensor:
    """Standard normals of ``shape`` drawn on the generator's device."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=generator.device).to(device)


def band(mu: torch.Tensor, s2: torch.Tensor):
    """``(percentiles (G, 3, M), std)``: mean ∓ 1.96σ, mean, mean + 1.96σ."""
    sd = torch.sqrt(s2)
    return torch.stack([mu - 1.96 * sd, mu, mu + 1.96 * sd], dim=1), sd


def summarize(ys: torch.Tensor) -> SampledPrediction:
    """2.5/97.5 percentiles, mean and std (ddof 0) over (S, G, M) draws."""
    q = torch.quantile(ys, torch.tensor([0.025, 0.975], dtype=ys.dtype, device=ys.device), dim=0)
    return SampledPrediction(quantiles=q.movedim(0, 1), mean=ys.mean(dim=0), std=ys.std(dim=0, correction=0))


def kron_factors(b_f, k_x, sigma2_err, y_tm, m: int, n: int):
    """Factor ``σ²I + B_f ⊗ K_x`` (``kron_chol_factors``) and solve it against
    the task-major observations: ``(chols (M, N, N), α = mat(Σ⁻¹y) (M, N),
    v_Bᵀ B_f (M, M))``."""
    _, v_b, chols = kron.kron_chol_factors(b_f, k_x, sigma2_err)
    z = v_b.T @ y_tm.reshape(m, n)
    sol = torch.cholesky_solve(z[:, :, None], chols, upper=False)[:, :, 0]
    return chols, v_b @ sol, v_b.T @ b_f


def kron_moments(b_f, chols, alpha_mat, w_mat, k_cross, k_self_star, sigma2_err):
    """Predictive mean (G, M) and variance (G, M), floored at the noise
    variance, from a Kronecker factorization and the (N, G)
    cross-covariance; ``k_self_star`` is k(x*, x*), (G,) or a scalar."""
    mu_f = (b_f @ (alpha_mat @ k_cross)).T
    s = torch.linalg.solve_triangular(chols, k_cross.expand(chols.shape[0], -1, -1), upper=False)
    q = torch.sum(s * s, dim=1)  # (M, G)
    d = ((w_mat**2).T @ q).T  # (G, M)
    k_self_star = torch.as_tensor(k_self_star, dtype=mu_f.dtype, device=mu_f.device)
    sigma2_f = k_self_star.reshape(-1, 1) * torch.diagonal(b_f)[None, :] - d
    # floor at the noise variance: the predictive variance cannot fall below
    # sigma2_err; float32 cancellation in sigma2_f otherwise produces
    # near-zero (overconfident) variances (the reference clips to 1e-6)
    return mu_f, torch.maximum(sigma2_f + sigma2_err, sigma2_err)


def _factorize(p: model.Params, data: FullData):
    """One factorization of Σ = B_f ⊗ K_x + σ²I (K_x: kernel K1's self form)."""
    n, m = data.y.shape
    b_f, k_x, sigma2_err = model._covs(p, data.x, m)
    chols, alpha_mat, w_mat = kron_factors(b_f, k_x, sigma2_err, task_major(data.y), m, n)
    return b_f, sigma2_err, chols, alpha_mat, w_mat


def _moments(p: model.Params, data: FullData, grid, l_star, sigma_star, factors):
    """Predictive mean/variance at all grid points given the latent
    lengthscales ``l_star`` (G,) and scales ``sigma_star`` (G,) there."""
    b_f, sigma2_err, chols, alpha_mat, w_mat = factors
    k_cross = kernels.nonstationary_rbf_cov(
        data.x, torch.exp(p.tilde_sigma), torch.exp(p.tilde_l), grid, sigma_star, l_star
    )  # (N, G): kernel K1's cross form
    k_self_star = sigma_star**2 + settings.jitter  # Gibbs self-cov (kernels.py:64)
    return kron_moments(b_f, chols, alpha_mat, w_mat, k_cross, k_self_star, sigma2_err)


def _hp(hyper):
    return {**model.DEFAULT_HYPERS, **(hyper or {})}


def _krige_projs(x, grid, hp):
    """:func:`krige_proj` of the ℓ̃ prior and of the σ̃ prior."""
    return (krige_proj(x, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"]),
            krige_proj(x, grid, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"]))


def _latent_conds(p: model.Params, data: FullData, grid, hp, projs=(None, None)):
    """The kriged ℓ̃ and σ̃ processes at the grid."""
    cond_l = krige_rbf(data.x, grid, p.tilde_l, hp["mu_tilde_l"], hp["alpha_tilde_l"], hp["beta_tilde_l"],
                       projs[0])
    cond_s = krige_rbf(data.x, grid, p.tilde_sigma, hp["mu_tilde_sigma"], hp["alpha_tilde_sigma"],
                       hp["beta_tilde_sigma"], projs[1])
    return cond_l, cond_s


def _y_draw(p, data, grid, cond_l, cond_s, factors, z) -> torch.Tensor:
    """One (G, M) draw of y at the grid: ℓ̃ and σ̃ drawn around their kriged
    values, then y around the predictive moments."""
    z_l, z_s, z_y = z
    tl = cond_l.mean + torch.sqrt(cond_l.var) * z_l
    ts = cond_s.mean + torch.sqrt(cond_s.var) * z_s
    mu, s2 = _moments(p, data, grid, torch.exp(tl), torch.exp(ts), factors)
    return mu + torch.sqrt(s2) * z_y


@torch.no_grad()
def predict_map(vec, data: FullData, grid, device=None, dtype=None, hyper=None) -> GridPrediction:
    """Plug-in MAP prediction (reference point/pointwise/test_predmap): the
    latent processes at the grid set to their GP-conditional means
    (prediction.py:354-366), y-moments in closed form.

    ``vec``, ``data`` and ``grid`` may be numpy arrays or tensors; they are
    moved to ``device`` (default: ``cuda``, raising when there is none) in
    ``dtype`` (default: ``settings.dtype``).  ``hyper`` overrides the latent
    priors' defaults (``models.snmgp.DEFAULT_HYPERS``).
    """
    data, grid, as_t = setup(data, grid, device, dtype, "snmgp")
    n, m = data.y.shape
    p = model.unpack(as_t(vec), n, m)
    cond_l, cond_s = _latent_conds(p, data, grid, _hp(hyper))
    mu, s2 = _moments(p, data, grid, torch.exp(cond_l.mean), torch.exp(cond_s.mean), _factorize(p, data))
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


@torch.no_grad()
def predict_map_sampling(
    generator: torch.Generator | None,
    n_sample: int,
    vec,
    data: FullData,
    grid,
    hyper=None,
    device=None,
    dtype=None,
    noise=None,
) -> SampledPrediction:
    """Latent-sampling prediction at the MAP (prediction.py:189-277): per
    draw, ℓ̃ and σ̃ at the grid from their GP conditionals, then one y draw;
    the Σ factorization is shared across draws.

    The normals come from ``generator`` or from
    ``noise = (z_l (S, G), z_s (S, G), z_y (S, G, M))``.  Device and dtype
    as in :func:`predict_map`.
    """
    data, grid, as_t = setup(data, grid, device, dtype, "snmgp")
    n, m = data.y.shape
    g = grid.shape[0]
    p = model.unpack(as_t(vec), n, m)
    if noise is None:
        draw = lambda *shape: normals(generator, (n_sample,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(g), draw(g, m))
    cond_l, cond_s = _latent_conds(p, data, grid, _hp(hyper))
    factors = _factorize(p, data)
    ys = torch.stack([_y_draw(p, data, grid, cond_l, cond_s, factors, zs)
                      for zs in zip(*(as_t(a) for a in noise))])
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
    """Prediction over an HMC chain (prediction.py:34-157): (G, S, M) draws
    of y, one per draw of the chain (the last ``n_sample`` draws when given),
    each from its own factorization.

    The normals come from ``generator`` or from
    ``noise = (z_l (S, G), z_s (S, G), z_y (S, G, M))``.  Device and dtype
    as in :func:`predict_map`.
    """
    data, grid, as_t = setup(data, grid, device, dtype, "snmgp")
    hp = _hp(hyper)
    n, m = data.y.shape
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    s, g = hist.shape[0], grid.shape[0]
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(g), draw(g, m))
    projs = _krige_projs(data.x, grid, hp)
    ys = []
    for vec, zs in zip(hist, zip(*(as_t(a) for a in noise))):
        p = model.unpack(vec, n, m)
        cond_l, cond_s = _latent_conds(p, data, grid, hp, projs)
        ys.append(_y_draw(p, data, grid, cond_l, cond_s, _factorize(p, data), zs))
    return torch.stack(ys, dim=1)
