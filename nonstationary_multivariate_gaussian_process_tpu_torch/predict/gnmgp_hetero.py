"""Posterior-predictive machinery for the heteroscedastic-noise GNMGP.

Counterpart of the JAX package's ``predict/gnmgp_hetero.py`` (the
reference's extended driver, ``Nonseparable_model_mpiKAISER_extended.py:428-582``).
The noise log-variance is an (input × task) latent process with a GP prior
(``models/gnmgp_hetero.py``), so prediction also kriges ``tilde_sigma2_err``
to the query points, each task's noise process with the same GP conditional
treatment as the lengthscale process, and feeds it to the GNMGP moments as
their noise variance (``predict.gnmgp._moments(noise_var=...)``).

On CUDA the Gram is kernel K2 (task-major, with the task-major noise
diagonal) and the (N, G) cross-covariance kernel K1's cross form, once per
parameter draw.  The kriging projections depend on the inputs, the grid and
the priors only, so a call over many draws computes them once.  Randomness
comes from an explicit ``torch.Generator`` or from ``noise=`` (JAX's normals
replayed).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import gnmgp as base_model
from ..models import gnmgp_hetero as model
from ..models.base import FullData, task_major
from ..ops import chol as chol_ops
from ..ops import transforms
from .gnmgp import _krige_projs, _l_star, _latent_conds, _moments
from .latent import krige_proj, krige_rbf
from .snmgp import band, normals, setup


class GridPredictionHetero(NamedTuple):
    percentiles: torch.Tensor  # (G, 3, M)
    mean: torch.Tensor  # (G, M)
    std: torch.Tensor  # (G, M)
    l_vecs: torch.Tensor  # (G, T) kriged constrained Cholesky vectors
    noise_var: torch.Tensor  # (G, M) kriged noise variances at the grid


def _hp(hyper):
    return {**model.DEFAULT_HYPERS, **(hyper or {})}


def _factorize(p: model.Params, data: FullData):
    """Like ``predict.gnmgp._factorize`` with the per-(input, task) noise
    diagonal; the noise slot of the factors is a placeholder, since
    ``_moments`` gets ``noise_var`` explicitly."""
    n, m = data.y.shape
    ls = base_model.chol_process(p.ul_vecs, n, m)
    ell = torch.exp(p.tilde_l)
    cov = base_model.gram(data.x, ell, ls)  # kernel K2, task-major
    cov.diagonal().add_(torch.exp(p.tilde_sigma2_err))  # task-major noise, in place
    r = chol_ops.safe_cholesky(cov)
    alpha = chol_ops.chol_solve(r, task_major(data.y)).reshape(m, n)
    c = torch.einsum("nmb,mn->nb", ls, alpha)
    return ls, ell, torch.zeros((), dtype=data.y.dtype, device=data.y.device), r, c


def _noise_cond(p: model.Params, data: FullData, grid, hp, n: int, m: int, proj=None):
    """GP conditional of each task's noise log-variance process at the grid
    (``.mean``: (M, G)); ``proj`` is its :func:`krige_proj` when known."""
    err_mat = p.tilde_sigma2_err.reshape(m, n)  # task-major rows
    return krige_rbf(data.x, grid, err_mat, hp["mu_err"], hp["alpha_err"], hp["beta_err"], proj)


@torch.no_grad()
def predict_map(vec, data: FullData, grid, device=None, dtype=None, hyper=None) -> GridPredictionHetero:
    """Plug-in MAP prediction with the kriged noise process.

    ``vec``, ``data`` and ``grid`` may be numpy arrays or tensors; they are
    moved to ``device`` (default: ``cuda``, raising when there is none) in
    ``dtype`` (default: ``settings.dtype``).
    """
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp_hetero")
    hp = _hp(hyper)
    n, m = data.y.shape
    p = model.unpack(as_t(vec), n, m)
    cond_l, cond_ul = _latent_conds(p, data, grid, hp, n, m)
    noise_var = torch.exp(_noise_cond(p, data, grid, hp, n, m).mean).T  # (G, M)
    l_vec_star = transforms.ulvec_to_lvec(cond_ul.mean.T, m)
    ls_star = transforms.vec_to_tril(l_vec_star, m)
    mu, s2 = _moments(data, grid, torch.exp(cond_l.mean), ls_star, _factorize(p, data), noise_var=noise_var)
    pct, sd = band(mu, s2)
    return GridPredictionHetero(percentiles=pct, mean=mu, std=sd, l_vecs=l_vec_star, noise_var=noise_var)


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
    """Prediction over an HMC chain: per draw, the lengthscale, L-process and
    noise process at the grid drawn from their GP conditionals, then y from
    the plug-in predictive.  Returns (G, S, M).

    The normals come from ``generator`` or from
    ``noise = (z_l (S, G), z_ul (S, T, G), z_err (S, M, G), z_y (S, G, M))``
    (JAX's ``split(k, 4)`` per draw).  Device and dtype as in
    :func:`predict_map`.
    """
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp_hetero")
    hp = _hp(hyper)
    n, m = data.y.shape
    hist = as_t(hist_vecs)
    if n_sample is not None:
        hist = hist[-n_sample:]
    s, g, t = hist.shape[0], grid.shape[0], transforms.tri_size(m)
    if noise is None:
        draw = lambda *shape: normals(generator, (s,) + shape, grid.device, grid.dtype)
        noise = (draw(g), draw(t, g), draw(m, g), draw(g, m))
    projs = _krige_projs(data.x, grid, hp)
    proj_err = krige_proj(data.x, grid, hp["alpha_err"], hp["beta_err"])
    ys = []
    for vec, (z_l, z_ul, z_e, z_y) in zip(hist, zip(*(as_t(a) for a in noise))):
        p = model.unpack(vec, n, m)
        cond_l, cond_ul = _latent_conds(p, data, grid, hp, n, m, projs)
        cond_err = _noise_cond(p, data, grid, hp, n, m, proj_err)
        tl = cond_l.mean + torch.sqrt(cond_l.var) * z_l
        te = cond_err.mean + torch.sqrt(cond_err.var) * z_e  # (M, G)
        mu, s2 = _moments(data, grid, torch.exp(tl), _l_star(cond_ul, z_ul, m), _factorize(p, data),
                          noise_var=torch.exp(te).T)
        ys.append(mu + torch.sqrt(s2) * z_y)
    return torch.stack(ys, dim=1)


@torch.no_grad()
def predict_noise_map(vec, data: FullData, grid, device=None, dtype=None, hyper=None) -> torch.Tensor:
    """Kriged MAP noise-variance process at the grid, (G, M): the extended
    driver's analogue of ``pred_smoothness_grids`` for the noise latent."""
    data, grid, as_t = setup(data, grid, device, dtype, "gnmgp_hetero")
    n, m = data.y.shape
    p = model.unpack(as_t(vec), n, m)
    return torch.exp(_noise_cond(p, data, grid, _hp(hyper), n, m).mean).T
