"""LMC — stationary multi-task GP (linear model of coregionalization).

Counterpart of the JAX package's ``models/lmc.py`` for fully observed data
(reference ``vec2pars_S``, ``logpos_S``/``nlogpos_obj_S``,
``Utility/logpos.py:46``, ``:383-462``).  Covariance
``B_f ⊗ K_x(σ, ℓ) + σ²_err I`` with a scalar scale and lengthscale.  As in
the reference, ``K_x`` is the nonstationary Gibbs kernel with σ and ℓ
broadcast to constant (N,) processes: on CUDA that is kernel K1's self form
(``ops.gram_kernels.gibbs_gram``), whose backward kernel returns per-input
gradients that autograd sums through the broadcast.  The likelihood runs
through the rotated batched-Cholesky Kronecker solver (``ops.kron``).  The
Hadamard variant (:func:`log_posterior_hadamard`, one observation per
(input, task) pair; reference ``logpos_hadamard_S``) takes the stationary
``rbf_cov`` for ``K_x``, as the reference's does, so it launches no
hand-written kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import dists
from ..ops import kernels, transforms
from . import snmgp
from .base import FullData, HadamardData, check_full_data, check_vec, mask_dense_gram, task_major

#: Reference default hyper-parameters (Stationary_model.py:80).
DEFAULT_HYPERS = {
    "mu_tilde_l": 0.0,
    "sigma_tilde_l": 1.0,
    "a": 1.0,
    "b": 1.0,
    "c": 10.0,
}


class Params(NamedTuple):
    tilde_l: torch.Tensor  # () log lengthscale
    tilde_sigma: torch.Tensor  # () log scale (fixed at 0 in the reference driver)
    ul_vec: torch.Tensor  # (T,) unconstrained task-covariance Cholesky vector
    tilde_sigma2_err: torch.Tensor  # () log noise variance


def n_params(m: int) -> int:
    return 2 + transforms.tri_size(m) + 1


def unpack(vec: torch.Tensor, m: int) -> Params:
    """Layout identical to reference vec2pars_S (logpos.py:46-57)."""
    t = transforms.tri_size(m)
    check_vec(vec, 3 + t, "lmc", "[tilde_l, tilde_sigma, uL_vec(T), tilde_sigma2_err]")
    return Params(tilde_l=vec[0], tilde_sigma=vec[1], ul_vec=vec[2 : 2 + t], tilde_sigma2_err=vec[-1])


def pack(p: Params) -> torch.Tensor:
    return torch.cat([p.tilde_l.reshape(1), p.tilde_sigma.reshape(1), p.ul_vec,
                      p.tilde_sigma2_err.reshape(1)])


def task_cov(ul_vec: torch.Tensor, m: int) -> torch.Tensor:
    """``B_f = L Lᵀ`` from the unconstrained task-Cholesky vector (T,)."""
    l_mat = transforms.vec_to_tril(transforms.ulvec_to_lvec(ul_vec, m), m)
    return l_mat @ l_mat.T


def input_cov(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``K_x``: the Gibbs kernel with σ and ℓ broadcast to constant (N,)
    processes (logpos.py:424-429) — kernel K1's self form, with its nugget."""
    ones = torch.ones_like(x)
    return kernels.nonstationary_rbf_cov(
        x, sigma1=torch.exp(p.tilde_sigma) * ones, ell1=torch.exp(p.tilde_l) * ones
    )


def log_lik(p: Params, data: FullData, mask=None) -> torch.Tensor:
    """Kronecker marginal log-likelihood (unnormalized, logpos.py:424-443).
    ``mask`` (N,) boolean excludes padded inputs exactly."""
    m = data.y.shape[1]
    b_f = task_cov(p.ul_vec, m)
    k_x = input_cov(p, data.x)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    return dists.mvn_logpdf_kron(task_major(data.y), 0.0, b_f, k_x, sigma2_err, mask=mask)


def log_posterior(
    p: Params,
    data: FullData,
    mu_tilde_l=0.0,
    sigma_tilde_l=1.0,
    a=1.0,
    b=1.0,
    c=10.0,
    prior: bool = True,
    mask=None,
):
    """Mirrors reference ``logpos_S`` (logpos.py:405-462).  Returns
    ``(logpos, components)``."""
    loglik = log_lik(p, data, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.normal_logpdf(p.tilde_l, mu_tilde_l, sigma_tilde_l)
    lp_ul = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, c))
    lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=a, beta=b)
    res = loglik
    if prior:
        res = res + lp_l + lp_ul + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_uL_vec": lp_ul,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def nlogpos(vec, y, x, mu_tilde_l=0.0, sigma_tilde_l=1.0, verbose=False, prior=True, **hyper):
    """Parity API, mirrors ``nlogpos_obj_S`` (logpos.py:383-402)."""
    hp = {**DEFAULT_HYPERS, **hyper, "mu_tilde_l": mu_tilde_l, "sigma_tilde_l": sigma_tilde_l}
    res, comps = log_posterior(unpack(vec, y.shape[1]), FullData(x, y), prior=prior, **hp)
    if verbose:
        return (-res,) + tuple(comps.values())
    return -res


def deviance(vec, y, x) -> torch.Tensor:
    """Deviance ``-2 loglik``."""
    return -2.0 * log_lik(unpack(vec, y.shape[1]), FullData(x, y))


def make_objective(data: FullData, hyper: dict | None = None, prior: bool = True):
    """Negative-log-posterior closure ``vec -> scalar`` (no GP prior to hoist)."""
    check_full_data(data, "lmc")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    m = data.y.shape[1]

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior(unpack(vec, m), data, prior=prior, **hp)
        return -res

    return nlp


# ---------------------------------------------------------------------------
# Hadamard variant: one observation per (input, task) pair.
# ---------------------------------------------------------------------------


def hadamard_gram(p: Params, x: torch.Tensor, indx: torch.Tensor, m: int) -> torch.Tensor:
    """Dense N×N Gram ``K = K_x ∘ B_f[indx, indx']`` (no noise): the raw
    task-Cholesky vector (logpos.py:679), the stationary ``rbf_cov`` with
    its nugget (logpos.py:685), and the task term of
    ``snmgp.hadamard_task_cov``."""
    k_x = kernels.rbf_cov(x, alpha=torch.exp(p.tilde_sigma), beta=torch.exp(p.tilde_l))
    return k_x * snmgp.hadamard_task_cov(transforms.vec_to_tril(p.ul_vec, m), indx)


def log_posterior_hadamard(
    p: Params,
    data: HadamardData,
    m: int,
    mu_tilde_l=0.0,
    sigma_tilde_l=1.0,
    a=1.0,
    b=1.0,
    c=10.0,
    prior: bool = True,
    mask=None,
):
    """Mirrors reference ``logpos_hadamard_S`` (logpos.py:676-716).  Returns
    ``(logpos, components)``.

    The Gram is :func:`hadamard_gram`'s.  ``mask`` (N,) excludes padded
    observations exactly (:func:`base.mask_dense_gram`).
    """
    x, indx, y = data
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    gram_h = hadamard_gram(p, x, indx, m)
    if mask is None:
        cov = torch.diagonal_scatter(gram_h, torch.diagonal(gram_h) + sigma2_err)
    else:
        cov, y = mask_dense_gram(gram_h, sigma2_err, y, mask)
    loglik = dists.mvn_logpdf_dense_unnorm(y, 0.0, cov)
    lp_l = dists.normal_logpdf(p.tilde_l, mu_tilde_l, sigma_tilde_l)
    lp_lvec = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, c))
    lp_s2 = dists.inverse_gamma_logpdf_u(sigma2_err, alpha=a, beta=b)
    res = loglik
    if prior:
        res = res + lp_l + lp_lvec + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_L_vec": lp_lvec,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def nlogpos_hadamard(vec, x, indx, y, m: int, mu_tilde_l=0.0, sigma_tilde_l=1.0, verbose=False, prior=True,
                     **hyper):
    """Parity API, mirrors ``nlogpos_obj_hadamard_S`` (logpos.py:662-673)."""
    hp = {**DEFAULT_HYPERS, **hyper, "mu_tilde_l": mu_tilde_l, "sigma_tilde_l": sigma_tilde_l}
    res, comps = log_posterior_hadamard(unpack(vec, m), HadamardData(x, indx, y), m, prior=prior, **hp)
    if verbose:
        return (-res,) + tuple(comps.values())
    return -res


def make_objective_hadamard(data: HadamardData, m: int, hyper: dict | None = None, prior: bool = True,
                            mask=None):
    """:func:`nlogpos_hadamard` as a closure ``vec -> scalar`` (no GP prior to
    hoist)."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hadamard(unpack(vec, m), data, m, prior=prior, mask=mask, **hp)
        return -res

    return nlp
