"""SNMGP — separable nonstationary multivariate Gaussian process.

Counterpart of the JAX package's ``models/snmgp.py`` for fully observed data
(reference ``vec2pars``, ``logpos``/``nlogpos_obj``, ``Utility/logpos.py:17``,
``:216-296``).  Covariance ``B_f ⊗ K_x(σ(x), ℓ(x)) + σ²_err I`` with GP
priors on the log-lengthscale and log-scale processes.  ``K_x`` is kernel
K1's self form (``ops.gram_kernels.gibbs_gram``), whose backward kernel
carries the gradient in σ and ℓ; the likelihood runs through the rotated
batched-Cholesky Kronecker solver (``ops.kron``).  The Hadamard variant
(:func:`log_posterior_hadamard`, one observation per (input, task) pair;
reference ``logpos_hadamard``) builds the dense N_obs × N_obs Gram
``K_x ∘ B_f[indx, indx']`` from the same K1 self form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import dists
from ..ops import chol, kernels, transforms
from .base import FullData, HadamardData, check_full_data, check_vec, mask_dense_gram, task_major

#: Reference default hyper-parameters (logpos.py:14).
DEFAULT_HYPERS = {
    "mu_tilde_l": 0.0,
    "alpha_tilde_l": 1.0,
    "beta_tilde_l": 1.0,
    "mu_tilde_sigma": 0.0,
    "alpha_tilde_sigma": 1.0,
    "beta_tilde_sigma": 1.0,
    "a": 1.0,
    "b": 1.0,
    "c": 10.0,
}


class Params(NamedTuple):
    tilde_l: torch.Tensor  # (N,) log lengthscale process
    tilde_sigma: torch.Tensor  # (N,) log scale process
    ul_vec: torch.Tensor  # (T,) unconstrained task-covariance Cholesky vector
    tilde_sigma2_err: torch.Tensor  # () log noise variance


def n_params(n: int, m: int) -> int:
    return 2 * n + transforms.tri_size(m) + 1


def unpack(vec: torch.Tensor, n: int, m: int) -> Params:
    """Layout identical to reference vec2pars (logpos.py:17-29)."""
    t = transforms.tri_size(m)
    check_vec(vec, 2 * n + t + 1, "snmgp",
              f"[tilde_l({n}), tilde_sigma({n}), uL_vec({t}), tilde_sigma2_err] for N={n}, M={m}")
    return Params(
        tilde_l=vec[:n],
        tilde_sigma=vec[n : 2 * n],
        ul_vec=vec[2 * n : 2 * n + t],
        tilde_sigma2_err=vec[-1],
    )


def pack(p: Params) -> torch.Tensor:
    return torch.cat([p.tilde_l, p.tilde_sigma, p.ul_vec, p.tilde_sigma2_err.reshape(1)])


def _covs(p: Params, x: torch.Tensor, m: int):
    l_vec = transforms.ulvec_to_lvec(p.ul_vec, m)
    l_mat = transforms.vec_to_tril(l_vec, m)
    b_f = l_mat @ l_mat.T
    ell = torch.exp(p.tilde_l)
    sigma = torch.exp(p.tilde_sigma)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    k_x = kernels.nonstationary_rbf_cov(x, sigma1=sigma, ell1=ell)  # kernel K1, self form
    return b_f, k_x, sigma2_err


def log_lik(p: Params, data: FullData, mask=None) -> torch.Tensor:
    """Marginal log-likelihood (unnormalized, reference convention).
    ``mask`` (N,) boolean excludes padded inputs exactly."""
    m = data.y.shape[1]
    b_f, k_x, sigma2_err = _covs(p, data.x, m)
    return dists.mvn_logpdf_kron(task_major(data.y), 0.0, b_f, k_x, sigma2_err, mask=mask)


def log_posterior(
    p: Params,
    data: FullData,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    a=1.0,
    b=1.0,
    c=10.0,
    prior: bool = True,
    prior_chol_l=None,
    prior_chol_sigma=None,
    mask=None,
):
    """Log joint posterior; mirrors reference ``logpos`` (logpos.py:237-296).
    Returns ``(logpos, components)``."""
    x = data.x
    loglik = log_lik(p, data, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    if prior_chol_l is None:
        prior_chol_l = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_tilde_l, beta=beta_tilde_l))
    if prior_chol_sigma is None:
        prior_chol_sigma = chol.safe_cholesky(
            kernels.rbf_cov(x, alpha=alpha_tilde_sigma, beta=beta_tilde_sigma)
        )
    lp_l = dists.mvn_logpdf_chol(p.tilde_l, mu_tilde_l, prior_chol_l)
    lp_sigma = dists.mvn_logpdf_chol(p.tilde_sigma, mu_tilde_sigma, prior_chol_sigma)
    lp_ul = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, c))
    lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=a, beta=b)
    res = loglik
    if prior:
        # + log-Jacobian of the exp transform on tilde_sigma2_err (logpos.py:292)
        res = res + lp_l + lp_sigma + lp_ul + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_tilde_sigma": lp_sigma,
        "log_prior_uL_vec": lp_ul,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def nlogpos(vec, y, x, verbose=False, prior=True, **hyper):
    """Parity API, mirrors reference ``nlogpos_obj`` (logpos.py:216-234)."""
    hp = {**DEFAULT_HYPERS, **hyper}
    n, m = y.shape
    res, comps = log_posterior(unpack(vec, n, m), FullData(x, y), prior=prior, **hp)
    if verbose:
        return (-res,) + tuple(comps.values())
    return -res


def deviance(vec, y, x) -> torch.Tensor:
    """Deviance ``-2 loglik`` (reference deviance, logpos.py:176-213)."""
    n, m = y.shape
    return -2.0 * log_lik(unpack(vec, n, m), FullData(x, y))


def make_objective(data: FullData, hyper: dict | None = None, prior: bool = True):
    """Negative-log-posterior closure ``vec -> scalar`` with the prior factors
    hoisted (host float64, ``ops.chol.prior_rbf_inv``)."""
    check_full_data(data, "snmgp")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    n, m = data.y.shape
    pc_l = chol.prior_rbf_inv(data.x, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    pc_sigma = chol.prior_rbf_inv(data.x, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"])

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior(
            unpack(vec, n, m), data, prior=prior, prior_chol_l=pc_l, prior_chol_sigma=pc_sigma,
            **hp,
        )
        return -res

    return nlp


# ---------------------------------------------------------------------------
# Hadamard variant: one observation per (input, task) pair.
# ---------------------------------------------------------------------------


def hadamard_gram(p: Params, x: torch.Tensor, indx: torch.Tensor, m: int) -> torch.Tensor:
    """Dense N×N Gram ``K = K_x ∘ B_f[indx, indx']`` (no noise).

    As in the reference's Hadamard objectives the task-Cholesky vector enters
    raw, with no exp on its diagonal (logpos.py:517), so ``p.ul_vec`` is a
    plain L-vector here.  ``K_x`` is kernel K1's self form.  The task term is
    :func:`hadamard_task_cov`'s.
    """
    l_mat = transforms.vec_to_tril(p.ul_vec, m)
    k_x = kernels.nonstationary_rbf_cov(x, sigma1=torch.exp(p.tilde_sigma), ell1=torch.exp(p.tilde_l))
    return k_x * hadamard_task_cov(l_mat, indx)


def hadamard_task_cov(l_mat: torch.Tensor, indx: torch.Tensor) -> torch.Tensor:
    """``B_f[indx, indx']`` (N, N) for ``B_f = L Lᵀ``, as ``R Rᵀ`` with
    ``R = L[indx]`` each observation's task row: the same products as
    gathering ``B_f``, but its gradient gathers N rows back into M, where the
    (N, N) gather's would scatter N² cotangents into M² cells (on the card a
    sort of the N² indices per gradient)."""
    rows = l_mat[indx]
    return rows @ rows.T


def log_posterior_hadamard(
    p: Params,
    data: HadamardData,
    m: int,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_tilde_sigma=0.0,
    alpha_tilde_sigma=1.0,
    beta_tilde_sigma=1.0,
    a=1.0,
    b=1.0,
    c=10.0,
    prior: bool = True,
    prior_chol_l=None,
    prior_chol_sigma=None,
    mask=None,
):
    """Mirrors reference ``logpos_hadamard`` (logpos.py:502-563).  Returns
    ``(logpos, components)``.  ``mask`` (N,) excludes padded observations
    exactly (:func:`base.mask_dense_gram`)."""
    x, indx, y = data
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    gram_h = hadamard_gram(p, x, indx, m)
    if mask is None:
        cov = torch.diagonal_scatter(gram_h, torch.diagonal(gram_h) + sigma2_err)
    else:
        cov, y = mask_dense_gram(gram_h, sigma2_err, y, mask)
    loglik = dists.mvn_logpdf_dense_unnorm(y, 0.0, cov)
    if prior_chol_l is None:
        prior_chol_l = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_tilde_l, beta=beta_tilde_l))
    if prior_chol_sigma is None:
        prior_chol_sigma = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_tilde_sigma, beta=beta_tilde_sigma))
    lp_l = dists.mvn_logpdf_chol(p.tilde_l, mu_tilde_l, prior_chol_l)
    lp_sigma = dists.mvn_logpdf_chol(p.tilde_sigma, mu_tilde_sigma, prior_chol_sigma)
    lp_l_vec = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, c))
    lp_s2 = dists.inverse_gamma_logpdf_u(sigma2_err, alpha=a, beta=b)
    res = loglik
    if prior:
        res = res + lp_l + lp_sigma + lp_l_vec + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_tilde_sigma": lp_sigma,
        "log_prior_L_vec": lp_l_vec,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def nlogpos_hadamard(vec, x, indx, y, m: int, verbose=False, prior=True, **hyper):
    """Parity API, mirrors ``nlogpos_obj_hadamard`` (logpos.py:465-499).

    ``m`` is explicit: the reference derives it with ``torch.unique``
    (logpos.py:479), which a subject missing a task would get wrong.
    """
    hp = {**DEFAULT_HYPERS, **hyper}
    p = unpack(vec, y.shape[0], m)
    res, comps = log_posterior_hadamard(p, HadamardData(x, indx, y), m, prior=prior, **hp)
    if verbose:
        return (-res,) + tuple(comps.values())
    return -res


def make_objective_hadamard(data: HadamardData, m: int, hyper: dict | None = None, prior: bool = True,
                            mask=None):
    """:func:`nlogpos_hadamard` as a closure ``vec -> scalar`` with the prior
    factors hoisted: factored once on the data's device by the same robust
    Cholesky that the JAX objective runs at every call."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    n = data.y.shape[0]
    pc_l = chol.safe_cholesky(kernels.rbf_cov(data.x, alpha=hp["alpha_tilde_l"], beta=hp["beta_tilde_l"]))
    pc_sigma = chol.safe_cholesky(
        kernels.rbf_cov(data.x, alpha=hp["alpha_tilde_sigma"], beta=hp["beta_tilde_sigma"])
    )

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hadamard(unpack(vec, n, m), data, m, prior=prior, prior_chol_l=pc_l,
                                        prior_chol_sigma=pc_sigma, mask=mask, **hp)
        return -res

    return nlp
