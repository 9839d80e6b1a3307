"""Sparse (inducing-point) LMC — the stationary model's large-N tier.

Counterpart of the JAX package's ``models/lmc_sparse.py`` for the full
layout (FITC and VFE, the ``mixed`` tier, ``mask=``).  The LMC vector is
already N-free, so it keeps the dense packed layout (``n_params(m)``,
``unpack(vec, m)``, re-exported here) and only the likelihood changes: the
stationary separable covariance ``B_f ⊗ K_x`` is Nyström-compressed over
m_z inducing inputs as in the SNMGP tier (``models/snmgp_sparse.py``).

As in the dense LMC (``models/lmc.py``), ``K_x`` is the Gibbs kernel with
the scalar σ and ℓ broadcast to constant processes: on the card ``K_x(Z,
Z)`` is kernel K1's self form and ``K_x(X, Z)`` its cross form, whose
backward kernels return per-input gradients that autograd sums through the
broadcast.

The Hadamard layout (:func:`make_objective_hadamard`) takes the raw
task-Cholesky vector, as the dense Hadamard LMC does, and the structure of
the SNMGP tier's (``snmgp_sparse.hadamard_pieces``,
``gnmgp_sparse._loglik_separable_hadamard``).  Where the JAX module takes
the stationary ``rbf_cov(alpha=σ, beta=ℓ)`` there, this one keeps K1 with
the constant processes: the Gibbs prefactor is then ``sqrt(2ℓ²/2ℓ²) = 1``,
so the two agree within rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import dists, settings
from ..ops import kernels
from .base import FullData, HadamardData, check_full_data
from .gnmgp_sparse import (_loglik_separable, _loglik_separable_hadamard, _woodbury_core, choose_inducing,
                           hadamard_inducing)
from .lmc import DEFAULT_HYPERS, Params, n_params, pack, task_cov, unpack  # noqa: F401  (the dense layout)
from .snmgp_sparse import hadamard_pieces, kron_pieces, raw_task_cov


class SparseOps(NamedTuple):
    """The stationary tier has no latent processes to krige: its ops are Z."""

    z: torch.Tensor  # (m_z,) inducing inputs


def make_ops(x: torch.Tensor, z, hyper: dict | None = None) -> SparseOps:
    """Z on ``x``'s device in ``x``'s dtype."""
    del hyper
    return SparseOps(torch.as_tensor(z, dtype=x.dtype, device=x.device))


def _factors(p: Params, data, ops: SparseOps, m: int, raw: bool = False):
    """The separable factors ``(b_f, k_zz, k_xz, k_x_diag)``, the scalars
    broadcast to pointwise processes as the dense tier does
    (logpos.py:424-429); ``raw`` reads the task vector as the Hadamard
    objective does."""
    sig, ell = torch.exp(p.tilde_sigma), torch.exp(p.tilde_l)
    ones_x, ones_z = torch.ones_like(data.x), torch.ones_like(ops.z)
    sig_x, sig_z = sig * ones_x, sig * ones_z
    ell_z = ell * ones_z
    k_zz = kernels.nonstationary_rbf_cov(ops.z, sigma1=sig_z, ell1=ell_z)  # kernel K1, self form
    k_xz = kernels.nonstationary_rbf_cov(data.x, sigma1=sig_x, ell1=ell * ones_x, x2=ops.z, sigma2=sig_z,
                                         ell2=ell_z)  # kernel K1, cross form
    b_f = raw_task_cov(p.ul_vec, m) if raw else task_cov(p.ul_vec, m)
    return b_f, k_zz, k_xz, sig_x * sig_x + settings.jitter


def _assemble(p: Params, data: FullData, ops: SparseOps, m: int, mask=None):
    """The materialized cross pieces ``K_** = B_f ⊗ K_x(·,·)`` (prediction
    and the LOO conditionals)."""
    return kron_pieces(*_factors(p, data, ops, m), data.y, mask)


def _woodbury(p: Params, data: FullData, ops: SparseOps, m: int, approx: str, mask=None):
    k_mm, k_nm, k_diag, y_flat, mv = _assemble(p, data, ops, m, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y_flat, torch.exp(p.tilde_sigma2_err), approx, mv)


def log_lik(p: Params, data: FullData, ops: SparseOps, approx: str = "fitc", hyper=None,
            mask=None) -> torch.Tensor:
    """Sparse stationary marginal log-likelihood (unnormalized convention);
    ``approx="vfe"`` lower-bounds ``models.lmc.log_lik``.  ``hyper`` is
    taken so that every tier's pipeline calls it alike (no latent process
    depends on it).  The Kronecker products are never formed
    (``gnmgp_sparse._loglik_separable``)."""
    del hyper
    b_f, k_zz, k_xz, k_x_diag = _factors(p, data, ops, data.y.shape[1])
    return _loglik_separable(b_f, k_zz, k_xz, k_x_diag, data.y, torch.exp(p.tilde_sigma2_err), approx, mask)


def log_posterior(p: Params, data: FullData, ops: SparseOps, approx: str = "fitc", hyper=None, prior: bool = True,
                  mask=None):
    """Sparse log-posterior under the exact LMC priors (logpos.py:405-462):
    N(mu, sigma) on tilde_l, N(0, c) on the task vector, the inverse-gamma
    noise prior and its exp Jacobian.  Returns ``(logpos, components)``."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    loglik = log_lik(p, data, ops, approx=approx, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.normal_logpdf(p.tilde_l, hp["mu_tilde_l"], hp["sigma_tilde_l"])
    lp_ul = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, hp["c"]))
    lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=hp["a"], beta=hp["b"])
    res = loglik
    if prior:
        res = res + lp_l + lp_ul + lp_s2 + p.tilde_sigma2_err
    comps = {"loglik": loglik, "log_prior_tilde_l": lp_l, "log_prior_uL_vec": lp_ul, "log_prior_sigma2_err": lp_s2}
    return res, comps


def make_objective(data: FullData, z=None, n_inducing: int = 64, hyper: dict | None = None, approx: str = "fitc",
                   prior: bool = True, mask=None):
    """Sparse negative-log-posterior closure: ``(nlp, ops)`` over the dense
    LMC packed vector (``3 + T`` slots)."""
    check_full_data(data, "lmc_sparse")
    if approx not in ("fitc", "vfe"):
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    if z is None:
        x_real = data.x if mask is None else data.x[: int(torch.as_tensor(mask).sum())]
        z = choose_inducing(x_real, min(n_inducing, x_real.shape[0]))
    ops = make_ops(data.x, z, hp)
    m = data.y.shape[1]

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior(unpack(vec, m), data, ops, approx=approx, hyper=hp, prior=prior, mask=mask)
        return -res

    return nlp, ops


# ---------------------------------------------------------------------------
# The Hadamard layout: one observation per (input, task) pair.
# ---------------------------------------------------------------------------


def _assemble_hadamard(p: Params, data: HadamardData, ops: SparseOps, m: int, mask=None):
    """The materialized Hadamard cross pieces (``snmgp_sparse.hadamard_pieces``;
    prediction and the LOO conditionals)."""
    return hadamard_pieces(*_factors(p, data, ops, m, raw=True), data.indx, data.y, mask)


def _woodbury_hadamard(p: Params, data: HadamardData, ops: SparseOps, m: int, approx: str, mask=None):
    """Hadamard-layout Woodbury factors (see :func:`_assemble_hadamard`)."""
    k_mm, k_nm, k_diag, y, mv = _assemble_hadamard(p, data, ops, m, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y, torch.exp(p.tilde_sigma2_err), approx, mv)


def log_lik_hadamard(p: Params, data: HadamardData, ops: SparseOps, m: int, approx: str = "fitc", hyper=None,
                     mask=None) -> torch.Tensor:
    """Sparse Hadamard marginal log-likelihood (see :func:`log_lik`), the
    Kronecker ``K_mm`` never formed (``gnmgp_sparse.
    _loglik_separable_hadamard``)."""
    del hyper
    return _loglik_separable_hadamard(*_factors(p, data, ops, m, raw=True), data.indx, data.y,
                                      torch.exp(p.tilde_sigma2_err), approx, mask)


def log_posterior_hadamard(p: Params, data: HadamardData, ops: SparseOps, m: int, approx: str = "fitc", hyper=None,
                           prior: bool = True, mask=None):
    """Sparse Hadamard log-posterior under the exact Hadamard LMC priors
    (N(0, c) on the raw task vector, the unnormalized inverse-gamma noise
    prior and its exp Jacobian).  Returns ``(logpos, components)``."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    loglik = log_lik_hadamard(p, data, ops, m, approx=approx, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.normal_logpdf(p.tilde_l, hp["mu_tilde_l"], hp["sigma_tilde_l"])
    lp_l_vec = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, hp["c"]))
    lp_s2 = dists.inverse_gamma_logpdf_u(sigma2_err, alpha=hp["a"], beta=hp["b"])
    res = loglik
    if prior:
        res = res + lp_l + lp_l_vec + lp_s2 + p.tilde_sigma2_err
    comps = {"loglik": loglik, "log_prior_tilde_l": lp_l, "log_prior_L_vec": lp_l_vec, "log_prior_sigma2_err": lp_s2}
    return res, comps


def make_objective_hadamard(data: HadamardData, m: int, z=None, n_inducing: int = 64, hyper: dict | None = None,
                            approx: str = "fitc", prior: bool = True, mask=None):
    """Sparse Hadamard negative-log-posterior closure: ``(nlp, ops)`` over the
    dense LMC packed vector (``n_params(m)`` slots)."""
    if approx not in ("fitc", "vfe"):
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    ops = make_ops(data.x, hadamard_inducing(data, z, n_inducing, mask))

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hadamard(unpack(vec, m), data, ops, m, approx=approx, hyper=hyper, prior=prior,
                                        mask=mask)
        return -res

    return nlp, ops
