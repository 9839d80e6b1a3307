"""GNMGP — generalized (nonseparable) nonstationary multivariate GP ("SVC").

Counterpart of the JAX package's ``models/gnmgp.py`` for fully observed data
(reference ``vec2pars_SVC``, ``logpos_SVC``/``nlogpos_obj_SVC``,
``Utility/logpos.py:32``, ``:299-380``).  At every input x_n the task
covariance is ``B_f(x_n) = L_n L_nᵀ``, giving the Gram

    K[(a,n), (c,p)] = (K_x[n,p] + jitter·δ_np) · (L_n L_pᵀ)[a,c]     (task-major)

with K_x the σ≡1 Gibbs kernel of (x, ℓ).  Two layouts of it serve two paths:

* :func:`gram` is task-major (row ``a·N + n``, observations
  ``Y.T.reshape(-1)``) — kernel K2, for prediction;
* :func:`log_lik` builds it input-major (row ``n·M + a``, observations
  ``Y.reshape(-1)``) — kernel K3, whose backward kernel carries the
  training gradient.  The two are one symmetric permutation of each other
  and the Gaussian log-likelihood is invariant under it, so both layouts give
  the same value.

:func:`make_objective_batched` evaluates the objective for a population of
vectors at once (B, P) → (B,), as ``jax.vmap`` of JAX's objective does:
one launch of the batched K3 (``gram_kernels.svc_gram_tiled_batched``) and
a batched Cholesky with its jitter ladder per member, so that a particle
sampler's whole population takes one forward and one backward launch.

The Hadamard variant (:func:`log_posterior_hadamard`, one observation per
(input, task) pair; reference ``logpos_hadamard_SVC``) gathers each
observation's task row of its L_n: its Gram ``K_x ∘ (R Rᵀ)`` is N_obs ×
N_obs, with ``K_x`` kernel K1's self form (σ ≡ 1), whose backward kernel
carries the gradient in ℓ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import dists, settings
from ..ops import chol, gram_kernels, kernels, transforms
from .base import FullData, HadamardData, check_full_data, check_vec, mask_dense_gram

#: Reference default hyper-parameters (logpos.py:299 signature defaults).
DEFAULT_HYPERS = {
    "mu_tilde_l": 0.0,
    "alpha_tilde_l": 5.0,
    "beta_tilde_l": 1.0,
    "mu_L": 0.0,
    "alpha_L": 5.0,
    "beta_L": 1.0,
    "a": 1.0,
    "b": 1.0,
}


class Params(NamedTuple):
    tilde_l: torch.Tensor  # (N,) log lengthscale process
    ul_vecs: torch.Tensor  # (N*T,) unconstrained per-input Cholesky vectors
    tilde_sigma2_err: torch.Tensor  # () log noise variance


def n_params(n: int, m: int) -> int:
    return n + n * transforms.tri_size(m) + 1


def unpack(vec: torch.Tensor, n: int, m: int) -> Params:
    """Layout identical to reference vec2pars_SVC (logpos.py:32-43)."""
    t = transforms.tri_size(m)
    check_vec(vec, n + n * t + 1, "gnmgp",
              f"[tilde_l({n}), uL_vecs({n}·{t}), tilde_sigma2_err] for N={n}, M={m}")
    return Params(tilde_l=vec[:n], ul_vecs=vec[n : n + n * t], tilde_sigma2_err=vec[-1])


def pack(p: Params) -> torch.Tensor:
    return torch.cat([p.tilde_l, p.ul_vecs, p.tilde_sigma2_err.reshape(1)])


def chol_process(ul_vecs: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """(..., N*T) unconstrained vectors → (..., N, M, M) lower-triangular factors."""
    t = transforms.tri_size(m)
    l_vecs = transforms.ulvec_to_lvec(ul_vecs.reshape(*ul_vecs.shape[:-1], n, t), m)
    return transforms.vec_to_tril(l_vecs, m)


def gram(x: torch.Tensor, ell: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """The task-major MN×MN Gram from inputs x (N,), lengthscales ℓ (N,) and
    the L-process (N, M, M).

    Equal to the JAX package's ``gram(nonstationary_rbf_cov(x, ell1=ell), ls)``:
    the Gibbs term K_x (with its self-nugget) is fused into the assembly, so
    on CUDA this is one launch of kernel K2 (``ops.gram_kernels.svc_gram``)
    that never stores K_x or the (N, M, N, M) task product.
    """
    return gram_kernels.svc_gram(
        x.contiguous(), ell.contiguous(), ls.contiguous(), settings.jitter, layout="task"
    )


def log_lik(p: Params, data: FullData, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Marginal log-likelihood (unnormalized, reference convention).

    The Gram is input-major (kernel K3) against row-major observations
    ``Y.reshape(-1)``; the JAX package's task-major Gram against ``Y.T`` is a
    permutation of the same problem, with the same log-likelihood.

    ``mask``: (N,) boolean, True for real observations.  Masked entries are
    projected out of the Gram (rows and columns zeroed, unit diagonal, zero
    observation) so they contribute nothing to the logdet or the quadratic
    form.
    """
    n, m = data.y.shape
    ls = chol_process(p.ul_vecs, n, m)
    ell = torch.exp(p.tilde_l)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    cov = gram_kernels.svc_gram_tiled(data.x.contiguous(), ell, ls.contiguous(), settings.jitter)
    y = data.y.reshape(-1)  # row-major: entry (n, a) at n·M + a
    if mask is None:
        cov = torch.diagonal_scatter(cov, torch.diagonal(cov) + sigma2_err)
    else:
        cov, y = mask_dense_gram(cov, sigma2_err, y, torch.as_tensor(mask, device=y.device).repeat_interleave(m))
    return dists.mvn_logpdf_dense_unnorm(y, 0.0, cov)


def _l_process_prior(ul_mat: torch.Tensor, mu_L, prior_chol) -> torch.Tensor:
    """Sum of T independent GP log-priors over the columns of (..., N, T)
    ``ul_mat`` (logpos.py:362-365), batched against one prior factor."""
    return torch.sum(dists.mvn_logpdf_chol(ul_mat.transpose(-1, -2), mu_L, prior_chol), dim=-1)


def log_posterior(
    p: Params,
    data: FullData,
    mu_tilde_l=0.0,
    alpha_tilde_l=5.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=5.0,
    beta_L=1.0,
    a=1.0,
    b=1.0,
    prior: bool = True,
    prior_chol_l=None,
    prior_chol_L=None,
    mask=None,
):
    """Mirrors reference ``logpos_SVC`` (logpos.py:326-380).  Returns
    ``(logpos, components)``.  With ``mask``, padded observations leave the
    likelihood; the GP priors still cover the padded latent slots."""
    x = data.x
    n, m = data.y.shape
    t = transforms.tri_size(m)
    loglik = log_lik(p, data, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    if prior_chol_l is None:
        prior_chol_l = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_tilde_l, beta=beta_tilde_l))
    if prior_chol_L is None:
        prior_chol_L = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_L, beta=beta_L))
    lp_l = dists.mvn_logpdf_chol(p.tilde_l, mu_tilde_l, prior_chol_l)
    lp_uL = _l_process_prior(p.ul_vecs.reshape(n, t), mu_L, prior_chol_L)
    lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=a, beta=b)
    res = loglik
    if prior:
        res = res + lp_l + lp_uL + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_uL_vecs": lp_uL,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def nlogpos(vec, y, x, verbose=False, prior=True, **hyper):
    """Parity API, mirrors ``nlogpos_obj_SVC`` (logpos.py:299-323)."""
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
    """Negative-log-posterior closure ``vec -> scalar`` with the prior factors
    hoisted: built once on the host in float64 (``ops.chol.prior_rbf_inv``)
    and kept on the data's device in its dtype."""
    check_full_data(data, "gnmgp")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    n, m = data.y.shape
    pc_l = chol.prior_rbf_inv(data.x, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    pc_L = chol.prior_rbf_inv(data.x, hp["alpha_L"], hp["beta_L"])

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior(
            unpack(vec, n, m), data, prior=prior, prior_chol_l=pc_l, prior_chol_L=pc_L,
            mask=mask, **hp,
        )
        return -res

    return nlp


#: The (NM, NM) Grams' worth of memory a member of the batched objective
#: takes at its peak across its value and gradient, for sizing its chunks:
#: one population gradient at (B, N, M) = (256, 200, 2) in float64 peaked
#: 7.02 Grams a member above its inputs on an H100, rounded up here
#: (``chip_smoke.py``'s smc phase measures it and fails above this); and the
#: bytes a chunk may take on the CPU.
BATCH_COPIES = 8
CPU_BATCH_BYTES = 1 << 30


def batch_rows(b: int, nm: int, dtype: torch.dtype, device: torch.device) -> int:
    """Members of a (B, NM, NM) batch that one chunk of the batched objective
    takes: half the device's free memory (the CPU: ``CPU_BATCH_BYTES``) over
    ``BATCH_COPIES`` Grams a member, at least 1."""
    per = BATCH_COPIES * nm * nm * torch.tensor([], dtype=dtype).element_size()
    budget = torch.cuda.mem_get_info(device)[0] // 2 if device.type == "cuda" else CPU_BATCH_BYTES
    return max(1, min(b, budget // per))


def make_objective_batched(data: FullData, hyper: dict | None = None, prior: bool = True):
    """:func:`make_objective` over a population: ``vecs`` (B, P) → (B,),
    row ``i`` the negative log posterior of ``vecs[i]`` (``jax.vmap`` of the
    JAX objective).  The Gram of every row is one launch of the batched K3
    (and its gradient one of the batched backward), the logdet and
    quadratic form one batched Cholesky with the jitter ladder per member
    (``ops.chol.psd_logdet_quad_batched``), and the priors run over the
    leading axis.  Nothing mixes rows: a row whose factor fails is NaN
    alone, and the gradient of the rows' sum is each row's gradient.

    Float64 or float32; ``NMGP_PRECISION=mixed`` has no batched form (its
    callers evaluate row by row).  A population whose Grams would not fit
    the device's free memory (:func:`batch_rows`) is evaluated in chunks,
    with the gradient of each chunk recomputed in its backward pass
    (``torch.utils.checkpoint``); the rows' values do not change.
    """
    check_full_data(data, "gnmgp")
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    n, m = data.y.shape
    t = transforms.tri_size(m)
    pc_l = chol.prior_rbf_inv(data.x, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    pc_L = chol.prior_rbf_inv(data.x, hp["alpha_L"], hp["beta_L"])
    x = data.x.contiguous()
    y = data.y.reshape(-1)  # row-major: entry (n, a) at n·M + a

    def rows(vecs: torch.Tensor) -> torch.Tensor:
        tilde_l, ul_vecs, tilde_s2 = vecs[:, :n], vecs[:, n : n + n * t], vecs[:, -1]
        ls = chol_process(ul_vecs, n, m)
        sigma2_err = torch.exp(tilde_s2)
        cov = gram_kernels.svc_gram_tiled_batched(x, torch.exp(tilde_l).contiguous(), ls.contiguous(),
                                                  settings.jitter)
        cov = torch.diagonal_scatter(cov, torch.diagonal(cov, dim1=-2, dim2=-1) + sigma2_err[:, None],
                                     dim1=-2, dim2=-1)
        logdet, quad = chol.psd_logdet_quad_batched(cov, y)
        res = -0.5 * logdet - 0.5 * quad
        if prior:
            lp_l = dists.mvn_logpdf_chol(tilde_l, hp["mu_tilde_l"], pc_l)
            lp_ul = _l_process_prior(ul_vecs.reshape(-1, n, t), hp["mu_L"], pc_L)
            lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=hp["a"], beta=hp["b"])
            res = res + lp_l + lp_ul + lp_s2 + tilde_s2
        return -res

    def nlp_batched(vecs: torch.Tensor) -> torch.Tensor:
        if vecs.dim() != 2 or vecs.shape[1] != n + n * t + 1:
            raise ValueError(f"gnmgp: the batched objective takes (B, {n + n * t + 1}) vectors "
                             f"[tilde_l({n}), uL_vecs({n}·{t}), tilde_sigma2_err] for N={n}, M={m}; "
                             f"got shape {tuple(vecs.shape)}")
        step = batch_rows(vecs.shape[0], n * m, vecs.dtype, vecs.device)
        if step >= vecs.shape[0]:
            return rows(vecs)
        graph = torch.is_grad_enabled() and vecs.requires_grad
        return torch.cat([checkpoint(rows, c, use_reentrant=False) if graph else rows(c)
                          for c in torch.split(vecs, step)])

    return nlp_batched


# ---------------------------------------------------------------------------
# Hadamard variant: one observation per (input, task) pair.
# ---------------------------------------------------------------------------

#: The Hadamard objective's own defaults (reference ``nlogpos_obj_hadamard_SVC``
#: signature, logpos.py:566), which are not :data:`DEFAULT_HYPERS`.
HADAMARD_HYPERS = {
    "mu_tilde_l": 0.0,
    "alpha_tilde_l": 1.0,
    "beta_tilde_l": 1.0,
    "mu_L": 0.0,
    "alpha_L": 1.0,
    "beta_L": 1.0,
    "a": 1.0,
    "b": 1.0,
}


def hadamard_rows(l_vecs_mat: torch.Tensor, indx: torch.Tensor, m: int):
    """``(ls (N, M, M), rows (N, M))``: the raw (N, T) L-vectors as factors,
    and each observation's own task row ``L_i[indx_i, :]``, gathered on the
    device."""
    ls = transforms.vec_to_tril(l_vecs_mat, m)
    return ls, ls[torch.arange(ls.shape[0], device=ls.device), indx]


def hadamard_gram(l_vecs_mat: torch.Tensor, indx: torch.Tensor, k_x: torch.Tensor, m: int) -> torch.Tensor:
    """N×N Gram ``K = K_x ∘ K_i`` with ``K_i[i,j] = ⟨L_i[indx_i,:], L_j[indx_j,:]⟩``
    (reference ``generate_K_index_SVC_hadamard0``, logpos.py:121-124): the
    task rows of :func:`hadamard_rows`, one matrix product."""
    _, rows = hadamard_rows(l_vecs_mat, indx, m)
    return k_x * (rows @ rows.T)


def log_posterior_hadamard(
    p: Params,
    data: HadamardData,
    m: int,
    mu_tilde_l=0.0,
    alpha_tilde_l=1.0,
    beta_tilde_l=1.0,
    mu_L=0.0,
    alpha_L=1.0,
    beta_L=1.0,
    a=1.0,
    b=1.0,
    prior: bool = True,
    prior_chol_l=None,
    prior_chol_L=None,
    mask=None,
):
    """Mirrors reference ``logpos_hadamard_SVC`` (logpos.py:588-659).  Returns
    ``(logpos, components)``.

    As in the reference the per-input Cholesky vectors enter raw, with no
    exp on their diagonals (logpos.py:603-604), and the GP prior applies to
    them directly: ``p.ul_vecs`` holds plain L-vectors here.  ``mask`` (N,)
    excludes padded observations exactly (:func:`base.mask_dense_gram`).
    """
    x, indx, y = data
    n = y.shape[0]
    t = transforms.tri_size(m)
    ell = torch.exp(p.tilde_l)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    k_x = kernels.nonstationary_rbf_cov(x, ell1=ell)  # kernel K1, self form
    gram_h = hadamard_gram(p.ul_vecs.reshape(n, t), indx, k_x, m)
    if mask is None:
        cov = torch.diagonal_scatter(gram_h, torch.diagonal(gram_h) + sigma2_err)
    else:
        cov, y = mask_dense_gram(gram_h, sigma2_err, y, mask)
    loglik = dists.mvn_logpdf_dense_unnorm(y, 0.0, cov)
    if prior_chol_l is None:
        prior_chol_l = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_tilde_l, beta=beta_tilde_l))
    if prior_chol_L is None:
        prior_chol_L = chol.safe_cholesky(kernels.rbf_cov(x, alpha=alpha_L, beta=beta_L))
    lp_l = dists.mvn_logpdf_chol(p.tilde_l, mu_tilde_l, prior_chol_l)
    lp_L = _l_process_prior(p.ul_vecs.reshape(n, t), mu_L, prior_chol_L)
    lp_s2 = dists.inverse_gamma_logpdf_u(sigma2_err, alpha=a, beta=b)
    res = loglik
    if prior:
        res = res + lp_l + lp_L + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_L_vecs": lp_L,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def nlogpos_hadamard(vec, x, indx, y, m: int, verbose=False, prior=True, **hyper):
    """Parity API, mirrors ``nlogpos_obj_hadamard_SVC`` (logpos.py:566-585)."""
    hp = {**HADAMARD_HYPERS, **hyper}
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
    hp = {**HADAMARD_HYPERS, **(hyper or {})}
    n = data.y.shape[0]
    pc_l = chol.safe_cholesky(kernels.rbf_cov(data.x, alpha=hp["alpha_tilde_l"], beta=hp["beta_tilde_l"]))
    pc_L = chol.safe_cholesky(kernels.rbf_cov(data.x, alpha=hp["alpha_L"], beta=hp["beta_L"]))

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hadamard(unpack(vec, n, m), data, m, prior=prior, prior_chol_l=pc_l,
                                        prior_chol_L=pc_L, mask=mask, **hp)
        return -res

    return nlp
