"""Posterior prediction for Hadamard-layout data (one observation per
(input, task) pair), for the three dense model families.

Counterpart of the JAX package's ``predict/hadamard.py`` (reference
``Utility/prediction.py``: LMC ``point/pointwise/indexedpoint/
test_predmap_S_hadamard`` :1695-1792, GNMGP ``point_predmap_SVC_hadamard``
:1401-1563, SNMGP Hadamard sampling :461-910).  The dense N×N Gram is
factorized once per parameter vector by the robust Cholesky, and every
(grid point × task) pair is served by one triangular solve with G·M
right-hand sides.

Every routine predicts y(x*, a) for every task a at every grid point:
(G, 3, M) percentile stacks and (G, M) moments, (G, S, M) draws over a
chain, or, at indexed test points (x*, task*), (mean, std) vectors and
(G_test, S) draws.  On CUDA the SNMGP and GNMGP Grams are kernel K1's self
form and their (N, G) cross-covariances K1's cross form; LMC takes the
stationary ``rbf_cov`` and launches no hand-written kernel.

Device and dtype: ``vec``, ``data`` and the grid may be numpy arrays or
tensors; they are moved to ``device`` (default ``cuda``, raising when there
is none) in ``dtype`` (default ``settings.dtype``).  Randomness comes from
an explicit ``torch.Generator`` (draws are made on its device), or from
``noise=``: the standard normals the JAX functions draw from their split
keys, so that a caller can replay JAX's.
"""

from __future__ import annotations

import torch

from .. import settings
from ..models import gnmgp as gnmgp_model
from ..models import lmc as lmc_model
from ..models import snmgp as snmgp_model
from ..models.base import HadamardData, as_hadamard_data
from ..ops import chol as chol_ops
from ..ops import kernels, transforms
from .latent import krige_proj, krige_rbf
from .snmgp import GridPrediction, band, normals


def _setup(data: HadamardData, grid, device, dtype):
    """``data`` and ``grid`` on the device in the dtype, and the converter."""
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return as_hadamard_data(*data, device=device, dtype=dtype), as_t(grid), as_t


def _factor(gram: torch.Tensor, sigma2_err, y: torch.Tensor):
    """``(r, β)``: the robust factor of ``gram + σ²I`` and ``β = Σ⁻¹y``."""
    gram.diagonal().add_(sigma2_err)  # in place: the Gram is the caller's own
    r = chol_ops.safe_cholesky(gram)
    return r, chol_ops.chol_solve(r, y)


def _solve_moments(r, beta, k_cross_full, self_var, sigma2_err):
    """Shared dense-path moments.

    ``k_cross_full``: (N, G, M) cross covariance for every (grid, task) pair,
    ``self_var``: (G, M) prior variance of f(x*, a), ``beta`` = Σ⁻¹y.
    Returns the mean and the variance of y, floored at the noise variance.
    """
    n, g, m = k_cross_full.shape
    mu = torch.einsum("nga,n->ga", k_cross_full, beta)
    s = torch.linalg.solve_triangular(r, k_cross_full.reshape(n, g * m), upper=False)
    d = torch.sum(s * s, dim=0).reshape(g, m)
    return mu, torch.maximum(self_var - d + sigma2_err, sigma2_err)


def _prediction(mu, s2) -> GridPrediction:
    pct, sd = band(mu, s2)
    return GridPrediction(percentiles=pct, mean=mu, std=sd)


def _at_tasks(pred: GridPrediction, indx_test):
    """Each test point's (mean, std) at its own task."""
    idx = torch.as_tensor(indx_test, dtype=torch.long, device=pred.mean.device)
    g = torch.arange(idx.shape[0], device=idx.device)
    return pred.mean[g, idx], pred.std[g, idx]


def _select_indexed(ys: torch.Tensor, indx_test) -> torch.Tensor:
    """(G, S, M) grid draws → (G, S) draws at each point's own task index."""
    idx = torch.as_tensor(indx_test, dtype=torch.long, device=ys.device)
    return torch.gather(ys, 2, idx[:, None, None].expand(-1, ys.shape[1], 1))[:, :, 0]


def _chain(hist_vecs, as_t, n_sample):
    hist = as_t(hist_vecs)
    return hist[-n_sample:] if n_sample is not None else hist


# ---------------------------------------------------------------------------
# LMC (stationary) Hadamard
# ---------------------------------------------------------------------------


def _lmc_setup(vec: torch.Tensor, data: HadamardData, m: int):
    p = lmc_model.unpack(vec, m)
    l_mat = transforms.vec_to_tril(p.ul_vec, m)  # raw L_vec (logpos.py:679)
    b_f = l_mat @ l_mat.T
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    r, beta = _factor(lmc_model.hadamard_gram(p, data.x, data.indx, m), sigma2_err, data.y)
    return p, b_f, sigma2_err, r, beta


def _lmc_moments(setup, data: HadamardData, grid, m: int):
    p, b_f, sigma2_err, r, beta = setup
    sigma, ell = torch.exp(p.tilde_sigma), torch.exp(p.tilde_l)
    k_cross = kernels.rbf_cov(data.x, grid, alpha=sigma, beta=ell)  # (N, G)
    k_full = k_cross[:, :, None] * b_f[data.indx, :][:, None, :]  # (N, G, M)
    # prior self term: kron(B_f, RBF self at one point) includes the nugget
    # (prediction.py:1719)
    self_var = ((sigma**2 + settings.jitter) * torch.diagonal(b_f)[None, :]).expand(grid.shape[0], m)
    return _solve_moments(r, beta, k_full, self_var, sigma2_err)


@torch.no_grad()
def lmc_predict_map(vec, data: HadamardData, grid, m: int, device=None, dtype=None) -> GridPrediction:
    """point/pointwise_predmap_S_hadamard (prediction.py:1695-1740)."""
    data, grid, as_t = _setup(data, grid, device, dtype)
    return _prediction(*_lmc_moments(_lmc_setup(as_t(vec), data, m), data, grid, m))


def lmc_predict_test(vec, data: HadamardData, x_test, indx_test, m: int, device=None, dtype=None):
    """indexedpoint/test_predmap_S_hadamard (prediction.py:1742-1792): each
    test pair (x*, task*)'s posterior mean and std."""
    return _at_tasks(lmc_predict_map(vec, data, x_test, m, device, dtype), indx_test)


@torch.no_grad()
def lmc_predict_sample(generator: torch.Generator | None, hist_vecs, data: HadamardData, grid, m: int,
                       n_sample=None, device=None, dtype=None, noise=None) -> torch.Tensor:
    """Chain-sample Hadamard-LMC prediction: (G, S, M) draws of y, one per
    draw of the chain (the last ``n_sample`` when given).  The reference
    ships only MAP prediction here; the JAX package extends the family so
    all three models score the same way.  The normals come from
    ``generator`` or from ``noise`` (S, G, M)."""
    data, grid, as_t = _setup(data, grid, device, dtype)
    hist = _chain(hist_vecs, as_t, n_sample)
    if noise is None:
        noise = normals(generator, (hist.shape[0], grid.shape[0], m), grid.device, grid.dtype)
    ys = []
    for vec, z in zip(hist, as_t(noise)):
        mu, s2 = _lmc_moments(_lmc_setup(vec, data, m), data, grid, m)
        ys.append(mu + torch.sqrt(s2) * z)
    return torch.stack(ys, dim=1)


def lmc_predict_test_sample(generator: torch.Generator | None, hist_vecs, data: HadamardData, x_test,
                            indx_test, m: int, n_sample=None, device=None, dtype=None,
                            noise=None) -> torch.Tensor:
    """(G_test, S) indexed chain-sample draws for Hadamard-LMC."""
    ys = lmc_predict_sample(generator, hist_vecs, data, x_test, m, n_sample, device, dtype, noise)
    return _select_indexed(ys, indx_test)


# ---------------------------------------------------------------------------
# SNMGP (separable nonstationary) Hadamard
# ---------------------------------------------------------------------------


def _snmgp_setup(vec: torch.Tensor, data: HadamardData, m: int):
    p = snmgp_model.unpack(vec, data.y.shape[0], m)
    l_mat = transforms.vec_to_tril(p.ul_vec, m)  # raw L_vec (logpos.py:517)
    b_f = l_mat @ l_mat.T
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    r, beta = _factor(snmgp_model.hadamard_gram(p, data.x, data.indx, m), sigma2_err, data.y)  # K1 self form
    return p, b_f, sigma2_err, r, beta


def _snmgp_moments(setup, data: HadamardData, grid, tl, ts):
    """Moments at the grid given the latent log-lengthscales ``tl`` and
    log-scales ``ts`` (G,) there."""
    p, b_f, sigma2_err, r, beta = setup
    sigma_star = torch.exp(ts)
    k_cross = kernels.nonstationary_rbf_cov(
        data.x, torch.exp(p.tilde_sigma), torch.exp(p.tilde_l), grid, sigma_star, torch.exp(tl)
    )  # (N, G): kernel K1's cross form
    k_full = k_cross[:, :, None] * b_f[data.indx, :][:, None, :]
    self_var = (sigma_star**2 + settings.jitter)[:, None] * torch.diagonal(b_f)[None, :]
    return _solve_moments(r, beta, k_full, self_var, sigma2_err)


def _snmgp_projs(data: HadamardData, grid, hp):
    return (krige_proj(data.x, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"]),
            krige_proj(data.x, grid, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"]))


def _snmgp_conds(p, data: HadamardData, grid, hp, projs):
    return (krige_rbf(data.x, grid, p.tilde_l, hp["mu_tilde_l"], hp["alpha_tilde_l"], hp["beta_tilde_l"],
                      projs[0]),
            krige_rbf(data.x, grid, p.tilde_sigma, hp["mu_tilde_sigma"], hp["alpha_tilde_sigma"],
                      hp["beta_tilde_sigma"], projs[1]))


@torch.no_grad()
def snmgp_predict_map(vec, data: HadamardData, grid, m: int, hyper=None, device=None,
                      dtype=None) -> GridPrediction:
    """MAP prediction with the kriged latent processes' means
    (prediction.py:710-809 analog)."""
    hp = {**snmgp_model.DEFAULT_HYPERS, **(hyper or {})}
    data, grid, as_t = _setup(data, grid, device, dtype)
    setup = _snmgp_setup(as_t(vec), data, m)
    cond_l, cond_s = _snmgp_conds(setup[0], data, grid, hp, _snmgp_projs(data, grid, hp))
    return _prediction(*_snmgp_moments(setup, data, grid, cond_l.mean, cond_s.mean))


def snmgp_predict_test(vec, data: HadamardData, x_test, indx_test, m: int, hyper=None, device=None,
                       dtype=None):
    """Each test pair (x*, task*)'s MAP posterior mean and std."""
    return _at_tasks(snmgp_predict_map(vec, data, x_test, m, hyper, device, dtype), indx_test)


@torch.no_grad()
def snmgp_predict_sample(generator: torch.Generator | None, hist_vecs, data: HadamardData, grid, m: int,
                         hyper=None, n_sample=None, device=None, dtype=None, noise=None) -> torch.Tensor:
    """Posterior-sample prediction over a chain (point_predsample_hadamard,
    prediction.py:461-583): per draw, ℓ̃ and σ̃ at the grid from their GP
    conditionals, then one y draw.  Returns (G, S, M).  The normals come
    from ``generator`` or from ``noise = (z_l (S, G), z_s (S, G),
    z_y (S, G, M))``."""
    hp = {**snmgp_model.DEFAULT_HYPERS, **(hyper or {})}
    data, grid, as_t = _setup(data, grid, device, dtype)
    hist = _chain(hist_vecs, as_t, n_sample)
    s, g = hist.shape[0], grid.shape[0]
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(g), draw(g, m))
    projs = _snmgp_projs(data, grid, hp)
    ys = []
    for vec, (z_l, z_s, z_y) in zip(hist, zip(*(as_t(a) for a in noise))):
        setup = _snmgp_setup(vec, data, m)
        cond_l, cond_s = _snmgp_conds(setup[0], data, grid, hp, projs)
        tl = cond_l.mean + torch.sqrt(cond_l.var) * z_l
        ts = cond_s.mean + torch.sqrt(cond_s.var) * z_s
        mu, s2 = _snmgp_moments(setup, data, grid, tl, ts)
        ys.append(mu + torch.sqrt(s2) * z_y)
    return torch.stack(ys, dim=1)


def snmgp_predict_test_sample(generator: torch.Generator | None, hist_vecs, data: HadamardData, x_test,
                              indx_test, m: int, hyper=None, n_sample=None, device=None, dtype=None,
                              noise=None) -> torch.Tensor:
    """Posterior-draw predictions at indexed (x*, task*) test pairs over a
    chain (``indexedpoint_predsample_hadamard``/``test_predsample_hadamard``,
    prediction.py:585-708): (G_test, S).  The reference loops test points
    and draws, sampling each point's latents independently from their
    marginals; sampling all points at once with independent normals has the
    same marginals."""
    ys = snmgp_predict_sample(generator, hist_vecs, data, x_test, m, hyper, n_sample, device, dtype, noise)
    return _select_indexed(ys, indx_test)


# ---------------------------------------------------------------------------
# GNMGP (SVC) Hadamard
# ---------------------------------------------------------------------------


def _svc_setup(vec: torch.Tensor, data: HadamardData, m: int):
    n = data.y.shape[0]
    t = transforms.tri_size(m)
    p = gnmgp_model.unpack(vec, n, m)
    # Hadamard SVC uses raw (constrained) L_vecs (logpos.py:603-604)
    _, rows = gnmgp_model.hadamard_rows(p.ul_vecs.reshape(n, t), data.indx, m)
    ell = torch.exp(p.tilde_l)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    k_x = kernels.nonstationary_rbf_cov(data.x, ell1=ell)  # kernel K1, self form
    r, beta = _factor(k_x * (rows @ rows.T), sigma2_err, data.y)
    return p, rows, ell, sigma2_err, r, beta


def _svc_moments(setup, data: HadamardData, grid, tl, ls_star):
    """Moments at the grid given the latent log-lengthscales ``tl`` (G,) and
    the L-factors ``ls_star`` (G, M, M) there."""
    p, rows, ell, sigma2_err, r, beta = setup
    n, g = data.x.shape[0], grid.shape[0]
    k_cross = kernels.nonstationary_rbf_cov(
        data.x, torch.ones(n, dtype=grid.dtype, device=grid.device), ell,
        grid, torch.ones(g, dtype=grid.dtype, device=grid.device), torch.exp(tl),
    )  # (N, G): kernel K1's cross form
    # cross term ⟨L_n[indx_n,:], L*_g[a,:]⟩
    k_full = torch.einsum("ng,nb,gab->nga", k_cross, rows, ls_star)
    self_var = (1.0 + settings.jitter) * torch.sum(ls_star**2, dim=-1)  # (G, M)
    return _solve_moments(r, beta, k_full, self_var, sigma2_err)


def _svc_projs(data: HadamardData, grid, hp):
    return (krige_proj(data.x, grid, hp["alpha_tilde_l"], hp["beta_tilde_l"]),
            krige_proj(data.x, grid, hp["alpha_L"], hp["beta_L"]))


def _svc_conds(p, data: HadamardData, grid, m: int, hp, projs):
    """The kriged ℓ̃ process and the kriged raw L-entry processes (T, G),
    whose prior applies to them directly."""
    t = transforms.tri_size(m)
    l_mat = p.ul_vecs.reshape(-1, t).T  # (T, N)
    return (krige_rbf(data.x, grid, p.tilde_l, hp["mu_tilde_l"], hp["alpha_tilde_l"], hp["beta_tilde_l"],
                      projs[0]),
            krige_rbf(data.x, grid, l_mat, hp["mu_L"], hp["alpha_L"], hp["beta_L"], projs[1]))


@torch.no_grad()
def svc_predict_map(vec, data: HadamardData, grid, m: int, hyper=None, device=None,
                    dtype=None) -> GridPrediction:
    """point_predmap_SVC_hadamard (prediction.py:1401-1478).  The latent
    priors are ``models.gnmgp.DEFAULT_HYPERS``, as in the JAX function (the
    objective's own defaults are ``HADAMARD_HYPERS``)."""
    hp = {**gnmgp_model.DEFAULT_HYPERS, **(hyper or {})}
    data, grid, as_t = _setup(data, grid, device, dtype)
    setup = _svc_setup(as_t(vec), data, m)
    cond_l, cond_lv = _svc_conds(setup[0], data, grid, m, hp, _svc_projs(data, grid, hp))
    ls_star = transforms.vec_to_tril(cond_lv.mean.T, m)  # (G, M, M)
    return _prediction(*_svc_moments(setup, data, grid, cond_l.mean, ls_star))


def svc_predict_test(vec, data: HadamardData, x_test, indx_test, m: int, hyper=None, device=None,
                     dtype=None):
    """Each test pair (x*, task*)'s MAP posterior mean and std."""
    return _at_tasks(svc_predict_map(vec, data, x_test, m, hyper, device, dtype), indx_test)


@torch.no_grad()
def svc_predict_sample(generator: torch.Generator | None, hist_vecs, data: HadamardData, grid, m: int,
                       hyper=None, n_sample=None, device=None, dtype=None, noise=None) -> torch.Tensor:
    """Posterior-sample Hadamard-SVC prediction over a chain: per draw, the
    pointwise latents (ℓ̃(x*) and the L-entry processes) at the grid, then
    one y draw.  Returns (G, S, M).  The normals come from ``generator`` or
    from ``noise = (z_l (S, G), z_lv (S, T, G), z_y (S, G, M))``."""
    hp = {**gnmgp_model.DEFAULT_HYPERS, **(hyper or {})}
    data, grid, as_t = _setup(data, grid, device, dtype)
    hist = _chain(hist_vecs, as_t, n_sample)
    s, g, t = hist.shape[0], grid.shape[0], transforms.tri_size(m)
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(t, g), draw(g, m))
    projs = _svc_projs(data, grid, hp)
    ys = []
    for vec, (z_l, z_lv, z_y) in zip(hist, zip(*(as_t(a) for a in noise))):
        setup = _svc_setup(vec, data, m)
        cond_l, cond_lv = _svc_conds(setup[0], data, grid, m, hp, projs)
        tl = cond_l.mean + torch.sqrt(cond_l.var) * z_l
        lv_star = (cond_lv.mean + torch.sqrt(cond_lv.var)[None, :] * z_lv).T  # (G, T)
        mu, s2 = _svc_moments(setup, data, grid, tl, transforms.vec_to_tril(lv_star, m))
        ys.append(mu + torch.sqrt(s2) * z_y)
    return torch.stack(ys, dim=1)


def svc_predict_test_sample(generator: torch.Generator | None, hist_vecs, data: HadamardData, x_test,
                            indx_test, m: int, hyper=None, n_sample=None, device=None, dtype=None,
                            noise=None) -> torch.Tensor:
    """GNMGP-Hadamard analogue of :func:`snmgp_predict_test_sample`: (G_test, S)."""
    ys = svc_predict_sample(generator, hist_vecs, data, x_test, m, hyper, n_sample, device, dtype, noise)
    return _select_indexed(ys, indx_test)
