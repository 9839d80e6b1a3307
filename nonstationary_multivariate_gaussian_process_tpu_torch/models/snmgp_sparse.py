"""Sparse (inducing-point) SNMGP — the separable model's large-N tier.

Counterpart of the JAX package's ``models/snmgp_sparse.py`` for the full
layout (FITC and VFE, the ``mixed`` tier, ``mask=``).  The log-lengthscale
and log-scale processes live at m_z inducing inputs Z and are kriged to the
data as the prior conditional mean under the exact model's RBF priors
(fixed (m_z, N) projections built once in float64), so the vector has
``2 m_z + T + 1`` slots.  The f-process takes the Nyström compression over
the same Z, which keeps the separable structure: ``K_mm = B_f ⊗ K_x(Z, Z)``
and ``K_nm = B_f ⊗ K_x(X, Z)``.

Kernels, on the card: ``K_x(Z, Z)`` is kernel K1's self form (with its
nugget) and ``K_x(X, Z)`` its cross form, with the σ- and ℓ-processes on
both sides; both carry a gradient, through K1's self-form and cross-form
backward kernels.  The likelihood never forms the Kronecker products
(``gnmgp_sparse._loglik_separable``: two small factors and M per-task inner
products); :func:`_assemble` forms them for prediction and the LOO
conditionals, with ``torch.kron``'s column order ``c·m_z + j``, JAX's.

The Hadamard layout (:func:`make_objective_hadamard`) takes the reference's
Hadamard conventions: the task-Cholesky vector enters raw, no exp on its
diagonal.  The inducing latents are the full task set at Z, ``K_mm = B_f ⊗
K_x(Z, Z)``, while each observation row selects its task, ``K_nm[i, (c, j)]
= B_f[indx_i, c]·K_x(x_i, z_j)``; the likelihood never forms either
(``gnmgp_sparse._loglik_separable_hadamard``), and the same two K1 forms and
backward kernels carry it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import dists, settings
from ..ops import chol, kernels, transforms
from . import snmgp
from .base import FullData, HadamardData, check_full_data, check_vec, task_major
from .gnmgp_sparse import (_loglik_separable, _loglik_separable_hadamard, _woodbury_core, choose_inducing,
                           hadamard_inducing, task_onehot)
from .lmc import task_cov
from .snmgp import DEFAULT_HYPERS


class SparseParams(NamedTuple):
    tilde_l_z: torch.Tensor  # (m_z,) log lengthscale process at Z
    tilde_sigma_z: torch.Tensor  # (m_z,) log scale process at Z
    ul_vec: torch.Tensor  # (T,) unconstrained task-Cholesky vector (global)
    tilde_sigma2_err: torch.Tensor  # () log noise variance


def n_params(m_z: int, m: int) -> int:
    return 2 * m_z + transforms.tri_size(m) + 1


def unpack(vec: torch.Tensor, m_z: int, m: int) -> SparseParams:
    """Packed layout ``[tilde_l_z(m_z), tilde_sigma_z(m_z), uL_vec(T),
    tilde_sigma2_err]``: the exact layout (logpos.py:17-29) with N → m_z."""
    t = transforms.tri_size(m)
    check_vec(vec, 2 * m_z + t + 1, "snmgp_sparse",
              f"[tilde_l_z({m_z}), tilde_sigma_z({m_z}), uL_vec({t}), tilde_sigma2_err] for m_z={m_z}, M={m}")
    return SparseParams(tilde_l_z=vec[:m_z], tilde_sigma_z=vec[m_z : 2 * m_z], ul_vec=vec[2 * m_z : 2 * m_z + t],
                        tilde_sigma2_err=vec[-1])


def pack(p: SparseParams) -> torch.Tensor:
    return torch.cat([p.tilde_l_z, p.tilde_sigma_z, p.ul_vec, p.tilde_sigma2_err.reshape(1)])


class SparseOps(NamedTuple):
    """Loop-invariant pieces, built once per objective (float64 islands)."""

    z: torch.Tensor  # (m_z,) inducing inputs
    proj_l: torch.Tensor  # (m_z, N) kriging projection, tilde_l prior
    proj_sigma: torch.Tensor  # (m_z, N) kriging projection, tilde_sigma prior
    pc_l_z: dists.TriInv  # the tilde_l prior Gram at Z
    pc_sigma_z: dists.TriInv  # the tilde_sigma prior Gram at Z


def make_ops(x: torch.Tensor, z, hyper: dict | None = None) -> SparseOps:
    """The kriging projections Z → x and the prior factors at Z, on ``x``'s
    device in ``x``'s dtype."""
    from ..predict.latent import krige_proj

    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    z = torch.as_tensor(z, dtype=x.dtype, device=x.device)
    proj_l, _ = krige_proj(z, x, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    proj_sigma, _ = krige_proj(z, x, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"])
    return SparseOps(z, proj_l, proj_sigma, chol.prior_rbf_inv(z, hp["alpha_tilde_l"], hp["beta_tilde_l"]),
                     chol.prior_rbf_inv(z, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"]))


def latents_at_data(p: SparseParams, ops: SparseOps, hyper=None):
    """Kriged latent fields at the data: ``(tilde_l_x (N,), tilde_sigma_x (N,))``."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    tl_x = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ ops.proj_l
    ts_x = hp["mu_tilde_sigma"] + (p.tilde_sigma_z - hp["mu_tilde_sigma"]) @ ops.proj_sigma
    return tl_x, ts_x


def raw_task_cov(l_vec: torch.Tensor, m: int) -> torch.Tensor:
    """``B_f = L Lᵀ`` from a raw task-Cholesky vector (the Hadamard
    convention: no exp on the diagonal)."""
    l_mat = transforms.vec_to_tril(l_vec, m)
    return l_mat @ l_mat.T


def _factors(p: SparseParams, data, ops: SparseOps, m: int, hyper=None, raw: bool = False):
    """The separable factors ``(b_f, k_zz, k_xz, k_x_diag)`` that ``K_** =
    B_f ⊗ K_x(·,·)`` is built from; ``raw`` reads the task vector as the
    Hadamard objective does."""
    tl_x, ts_x = latents_at_data(p, ops, hyper)
    sig_x, sig_z = torch.exp(ts_x), torch.exp(p.tilde_sigma_z)
    ell_z = torch.exp(p.tilde_l_z)
    k_zz = kernels.nonstationary_rbf_cov(ops.z, sigma1=sig_z, ell1=ell_z)  # kernel K1, self form
    k_xz = kernels.nonstationary_rbf_cov(data.x, sigma1=sig_x, ell1=torch.exp(tl_x), x2=ops.z, sigma2=sig_z,
                                         ell2=ell_z)  # kernel K1, cross form
    # the Gibbs self-covariance's diagonal is σ_n² (+ the additive jitter)
    b_f = raw_task_cov(p.ul_vec, m) if raw else task_cov(p.ul_vec, m)
    return b_f, k_zz, k_xz, sig_x * sig_x + settings.jitter


def kron_pieces(b_f, k_zz, k_xz, k_x_diag, y: torch.Tensor, mask=None):
    """The materialized cross pieces ``(k_mm, k_nm, k_diag, y_flat, mv)`` of a
    separable tier: ``K_mm = B_f ⊗ K_zz`` (columns ``c·m_z + j``), ``K_nm =
    B_f ⊗ K_xz`` (rows task-major ``a·N + n``)."""
    m = b_f.shape[0]
    k_diag = (torch.diagonal(b_f)[:, None] * k_x_diag[None, :]).reshape(-1)
    mv = None if mask is None else torch.as_tensor(mask, device=y.device).to(y.dtype).repeat(m)
    return torch.kron(b_f, k_zz), torch.kron(b_f, k_xz), k_diag, task_major(y), mv


def _assemble(p: SparseParams, data: FullData, ops: SparseOps, m: int, hyper=None, mask=None):
    """The materialized cross pieces (prediction and the LOO conditionals;
    the likelihood stays factored)."""
    return kron_pieces(*_factors(p, data, ops, m, hyper), data.y, mask)


def _woodbury(p: SparseParams, data: FullData, ops: SparseOps, m: int, approx: str, hyper=None, mask=None):
    k_mm, k_nm, k_diag, y_flat, mv = _assemble(p, data, ops, m, hyper, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y_flat, torch.exp(p.tilde_sigma2_err), approx, mv)


def log_lik(p: SparseParams, data: FullData, ops: SparseOps, approx: str = "fitc", hyper=None,
            mask=None) -> torch.Tensor:
    """Sparse separable marginal log-likelihood (unnormalized convention):
    FITC, or Titsias' VFE bound on ``models.snmgp.log_lik`` at the same
    kriged fields.  ``mask`` (N,) excludes padded observations exactly.  The
    Kronecker structure is never formed (``gnmgp_sparse._loglik_separable``)."""
    b_f, k_zz, k_xz, k_x_diag = _factors(p, data, ops, data.y.shape[1], hyper)
    return _loglik_separable(b_f, k_zz, k_xz, k_x_diag, data.y, torch.exp(p.tilde_sigma2_err), approx, mask)


def log_posterior(p: SparseParams, data: FullData, ops: SparseOps, approx: str = "fitc", hyper=None,
                  prior: bool = True, mask=None):
    """Sparse log-posterior: the exact model's priors over the Z-latents (RBF
    GP priors at Z, N(0, c) on the task vector, the inverse-gamma noise prior
    and its exp Jacobian; ``logpos``, logpos.py:237-296).  Returns
    ``(logpos, components)``."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    loglik = log_lik(p, data, ops, approx=approx, hyper=hp, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.mvn_logpdf_chol(p.tilde_l_z, hp["mu_tilde_l"], ops.pc_l_z)
    lp_sigma = dists.mvn_logpdf_chol(p.tilde_sigma_z, hp["mu_tilde_sigma"], ops.pc_sigma_z)
    lp_ul = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, hp["c"]))
    lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=hp["a"], beta=hp["b"])
    res = loglik
    if prior:
        res = res + lp_l + lp_sigma + lp_ul + lp_s2 + p.tilde_sigma2_err
    comps = {"loglik": loglik, "log_prior_tilde_l": lp_l, "log_prior_tilde_sigma": lp_sigma,
             "log_prior_uL_vec": lp_ul, "log_prior_sigma2_err": lp_s2}
    return res, comps


def make_objective(data: FullData, z=None, n_inducing: int = 64, hyper: dict | None = None, approx: str = "fitc",
                   prior: bool = True, mask=None):
    """Sparse negative-log-posterior closure: ``(nlp, ops)``, the objective
    over the packed ``2 m_z + T + 1`` vector and the hoisted
    :class:`SparseOps`.  ``z`` defaults to ``choose_inducing(x, n_inducing)``
    over the real (unmasked) inputs."""
    check_full_data(data, "snmgp_sparse")
    if approx not in ("fitc", "vfe"):
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    if z is None:
        x_real = data.x if mask is None else data.x[: int(torch.as_tensor(mask).sum())]
        z = choose_inducing(x_real, min(n_inducing, x_real.shape[0]))
    ops = make_ops(data.x, z, hp)
    m_z, m = ops.z.shape[0], data.y.shape[1]

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior(unpack(vec, m_z, m), data, ops, approx=approx, hyper=hp, prior=prior, mask=mask)
        return -res

    return nlp, ops


# ---------------------------------------------------------------------------
# The Hadamard layout: one observation per (input, task) pair.
# ---------------------------------------------------------------------------


def hadamard_pieces(b_f, k_zz, k_xz, k_x_diag, indx, y, mask=None):
    """The materialized Hadamard cross pieces ``(k_mm, k_nm, k_diag, y, mv)``
    of a separable tier (prediction and the LOO conditionals): ``K_mm = B_f
    ⊗ K_zz``, ``K_nm[i, (c, j)] = B_f[indx_i, c]·K_xz[i, j]``."""
    m, m_z = b_f.shape[0], k_zz.shape[0]
    onehot = task_onehot(indx, m, b_f.dtype)
    k_nm = (k_xz[:, None, :] * (onehot @ b_f)[:, :, None]).reshape(y.shape[0], m * m_z)
    k_diag = (onehot @ torch.diagonal(b_f)) * k_x_diag
    mv = None if mask is None else torch.as_tensor(mask, device=y.device).to(y.dtype)
    return torch.kron(b_f, k_zz), k_nm, k_diag, y, mv


def _assemble_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, hyper=None, mask=None):
    """The materialized Hadamard cross pieces (prediction and the LOO
    conditionals; the likelihood stays factored)."""
    return hadamard_pieces(*_factors(p, data, ops, m, hyper, raw=True), data.indx, data.y, mask)


def _woodbury_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, approx: str, hyper=None,
                       mask=None):
    """Hadamard-layout Woodbury factors (see :func:`hadamard_pieces`)."""
    k_mm, k_nm, k_diag, y, mv = _assemble_hadamard(p, data, ops, m, hyper, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y, torch.exp(p.tilde_sigma2_err), approx, mv)


def log_lik_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, approx: str = "fitc", hyper=None,
                     mask=None) -> torch.Tensor:
    """Sparse Hadamard marginal log-likelihood (see :func:`log_lik`), the
    Kronecker ``K_mm`` never formed (``gnmgp_sparse.
    _loglik_separable_hadamard``)."""
    return _loglik_separable_hadamard(*_factors(p, data, ops, m, hyper, raw=True), data.indx, data.y,
                                      torch.exp(p.tilde_sigma2_err), approx, mask)


def log_posterior_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, approx: str = "fitc",
                           hyper=None, prior: bool = True, mask=None):
    """Sparse Hadamard log-posterior: the exact Hadamard SNMGP's priors over
    the Z-latents (N(0, c) on the raw task vector, the unnormalized
    inverse-gamma noise prior and its exp Jacobian; ``models.snmgp.
    log_posterior_hadamard``).  Returns ``(logpos, components)``."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    loglik = log_lik_hadamard(p, data, ops, m, approx=approx, hyper=hp, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.mvn_logpdf_chol(p.tilde_l_z, hp["mu_tilde_l"], ops.pc_l_z)
    lp_sigma = dists.mvn_logpdf_chol(p.tilde_sigma_z, hp["mu_tilde_sigma"], ops.pc_sigma_z)
    lp_l_vec = torch.sum(dists.normal_logpdf(p.ul_vec, 0.0, hp["c"]))
    lp_s2 = dists.inverse_gamma_logpdf_u(sigma2_err, alpha=hp["a"], beta=hp["b"])
    res = loglik
    if prior:
        res = res + lp_l + lp_sigma + lp_l_vec + lp_s2 + p.tilde_sigma2_err
    comps = {"loglik": loglik, "log_prior_tilde_l": lp_l, "log_prior_tilde_sigma": lp_sigma,
             "log_prior_L_vec": lp_l_vec, "log_prior_sigma2_err": lp_s2}
    return res, comps


def make_objective_hadamard(data: HadamardData, m: int, z=None, n_inducing: int = 64, hyper: dict | None = None,
                            approx: str = "fitc", prior: bool = True, mask=None):
    """Sparse Hadamard negative-log-posterior closure: ``(nlp, ops)``, the
    vector of ``n_params(m_z, m)`` slots for the m_z inducing inputs that
    come back in ``ops.z`` (``gnmgp_sparse.hadamard_inducing``)."""
    if approx not in ("fitc", "vfe"):
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    ops = make_ops(data.x, hadamard_inducing(data, z, n_inducing, mask), hp)
    m_z = ops.z.shape[0]

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hadamard(unpack(vec, m_z, m), data, ops, m, approx=approx, hyper=hp, prior=prior,
                                        mask=mask)
        return -res

    return nlp, ops


def init_from_empirical(emp_vec, n: int, m_z: int, m: int, x, z) -> torch.Tensor:
    """Subsample an exact-model empirical init (N-layout) onto the Z-layout:
    each inducing slot takes the latent values at its nearest data input;
    the task vector and the noise slot pass through.  On ``emp_vec``'s
    device in its dtype."""
    p = snmgp.unpack(emp_vec, n, m)
    host = lambda v: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)
    nearest = np.argmin(np.abs(host(x)[None, :] - host(z)[:, None]), axis=1)  # (m_z,)
    idx = torch.as_tensor(nearest, device=emp_vec.device)
    return torch.cat([p.tilde_l[idx], p.tilde_sigma[idx], p.ul_vec, p.tilde_sigma2_err.reshape(1)])
