"""Heteroscedastic-noise GNMGP: per-(input, task) noise variance with a GP prior.

Counterpart of the JAX package's ``models/gnmgp_hetero.py``, the model that
the reference's extended driver intends
(``Nonseparable_model_mpiKAISER_extended.py:155-247``):

* parameters ``[tilde_l (N), uL_vecs (N·T), tilde_sigma2_err (N·M)]``, the
  noise log-variances task-major (entry (a, n) at a·N + n),
* likelihood ``MVN(0, K + diag(exp(tilde_sigma2_err)))`` with the GNMGP Gram,
* independent GP priors on each task's noise log-variance process plus the
  log-Jacobian of the exp transform over all N·M entries,
* the GNMGP's GP priors on ``tilde_l`` and the L-entry processes.

As in the port's ``models/gnmgp.log_lik`` the likelihood's Gram is
input-major (kernel K3, row n·M + a), whose backward kernel carries the
gradient; the task-major noise is permuted to that layout and the mask is
repeated per input (``repeat_interleave``), so the problem is a symmetric
permutation of JAX's with the same log-likelihood.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import dists, settings
from ..ops import chol, gram_kernels, kernels, transforms
from . import gnmgp as base
from .base import FullData, check_full_data, check_vec, mask_dense_gram

DEFAULT_HYPERS = {
    **{k: v for k, v in base.DEFAULT_HYPERS.items() if k not in ("a", "b")},
    # the base inverse-gamma hypers are replaced by the noise-GP hypers
    "mu_err": 0.0,
    "alpha_err": 1.0,
    "beta_err": 1.0,
}


class Params(NamedTuple):
    tilde_l: torch.Tensor  # (N,)
    ul_vecs: torch.Tensor  # (N*T,)
    tilde_sigma2_err: torch.Tensor  # (N*M,) task-major log noise variances


def n_params(n: int, m: int) -> int:
    return n + n * transforms.tri_size(m) + n * m


def unpack(vec: torch.Tensor, n: int, m: int) -> Params:
    t = transforms.tri_size(m)
    check_vec(vec, n + n * t + n * m, "gnmgp_hetero",
              f"[tilde_l({n}), uL_vecs({n}·{t}), tilde_sigma2_err({n}·{m} task-major)] for N={n}, M={m}")
    return Params(tilde_l=vec[:n], ul_vecs=vec[n : n + n * t], tilde_sigma2_err=vec[n + n * t :])


def pack(p: Params) -> torch.Tensor:
    return torch.cat([p.tilde_l, p.ul_vecs, p.tilde_sigma2_err])


def log_lik(p: Params, data: FullData, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Marginal log-likelihood (unnormalized, reference convention).

    ``mask``: (N,) boolean, True for real observations.  Masked entries are
    projected out of the Gram as in ``models.gnmgp.log_lik`` (rows and
    columns zeroed, unit diagonal, zero observation), so the padded slots'
    noise latents only feel their GP prior.
    """
    n, m = data.y.shape
    ls = base.chol_process(p.ul_vecs, n, m)
    ell = torch.exp(p.tilde_l)
    cov = gram_kernels.svc_gram_tiled(data.x.contiguous(), ell, ls.contiguous(), settings.jitter)
    y = data.y.reshape(-1)  # row-major: entry (n, a) at n·M + a
    noise = torch.exp(p.tilde_sigma2_err).reshape(m, n).T.reshape(-1)  # task-major → input-major
    if mask is None:
        cov = torch.diagonal_scatter(cov, torch.diagonal(cov) + noise)
    else:
        cov, y = mask_dense_gram(cov, noise, y, torch.as_tensor(mask, device=y.device).repeat_interleave(m))
    return dists.mvn_logpdf_dense_unnorm(y, 0.0, cov)


def log_posterior(
    p: Params,
    data: FullData,
    mu_tilde_l=0.0,
    alpha_tilde_l=5.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=5.0,
    beta_L=1.0,
    mu_err=0.0,
    alpha_err=1.0,
    beta_err=1.0,
    prior: bool = True,
    prior_chol_l=None,
    prior_chol_L=None,
    prior_chol_err=None,
    mask=None,
):
    """Returns ``(logpos, components)``; the prior factors may be hoisted
    Cholesky factors or ``dists.TriInv``."""
    x = data.x
    n, m = data.y.shape
    t = transforms.tri_size(m)
    loglik = log_lik(p, data, mask=mask)
    if prior_chol_l is None:
        prior_chol_l = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_tilde_l, beta=beta_tilde_l))
    if prior_chol_L is None:
        prior_chol_L = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_L, beta=beta_L))
    if prior_chol_err is None:
        prior_chol_err = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_err, beta=beta_err))
    lp_l = dists.mvn_logpdf_chol(p.tilde_l, mu_tilde_l, prior_chol_l)
    lp_uL = base._l_process_prior(p.ul_vecs.reshape(n, t), mu_L, prior_chol_L)
    # one GP prior per task's noise log-variance process (task-major rows)
    lp_err = torch.sum(dists.mvn_logpdf_chol(p.tilde_sigma2_err.reshape(m, n), mu_err, prior_chol_err))
    res = loglik
    if prior:
        # + log-Jacobian of exp over every noise entry
        res = res + lp_l + lp_uL + lp_err + torch.sum(p.tilde_sigma2_err)
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_uL_vecs": lp_uL,
        "log_prior_sigma2_err": lp_err,
    }
    return res, comps


def nlogpos(vec, y, x, verbose=False, prior=True, **hyper):
    hp = {**DEFAULT_HYPERS, **hyper}
    n, m = y.shape
    res, comps = log_posterior(unpack(vec, n, m), FullData(x, y), prior=prior, **hp)
    if verbose:
        return (-res,) + tuple(comps.values())
    return -res


def deviance(vec, y, x) -> torch.Tensor:
    """Deviance ``-2 loglik``."""
    n, m = y.shape
    return -2.0 * log_lik(unpack(vec, n, m), FullData(x, y))


def make_objective(data: FullData, hyper: dict | None = None, prior: bool = True, mask=None):
    """Negative-log-posterior closure ``vec -> scalar`` with the three prior
    factors hoisted (host float64, ``ops.chol.prior_rbf_inv``)."""
    check_full_data(data, "gnmgp_hetero")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    n, m = data.y.shape
    pc_l = chol.prior_rbf_inv(data.x, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    pc_L = chol.prior_rbf_inv(data.x, hp["alpha_L"], hp["beta_L"])
    pc_e = chol.prior_rbf_inv(data.x, hp["alpha_err"], hp["beta_err"])

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior(
            unpack(vec, n, m), data, prior=prior, mask=mask, prior_chol_l=pc_l, prior_chol_L=pc_L,
            prior_chol_err=pc_e, **hp,
        )
        return -res

    return nlp


def init_from_gnmgp(gn_vec: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Warm start: a homoscedastic GNMGP vector with its scalar noise
    broadcast over the (input × task) process."""
    return torch.cat([gn_vec[:-1], gn_vec[-1].expand(n * m)])
