"""Model scoring: RMSE, LPD, PMSE, AIC, BIC, DIC, WAIC and PSIS-LOO.

Counterpart of the JAX package's ``evaluate.py`` for these scores (reference
``Utility/utils.py:165-197``, ``Utility/model_validation.py``): host numpy
code, apart from DIC's deviances and the LOO conditionals, which run on the
chain's device.  WAIC and PSIS-LOO take their non-factorized form: the GP
likelihood is one joint MVN, so the pointwise terms are the exact
leave-one-out conditionals ``p(y_i | y_{−i}, θ)`` from one precision matrix
per draw.  The dense LOO conditionals cover ``lmc``, ``snmgp``, ``gnmgp``
and ``gnmgp_hetero``, in the Hadamard layout ``lmc``, ``snmgp`` and
``gnmgp``, and the sparse ones ``gnmgp_sparse``, ``gnmgp_hetero_sparse``,
``snmgp_sparse`` and ``lmc_sparse`` (from their Woodbury factors, never the
dense precision), the first, third and fourth in the Hadamard layout too;
the G/P/D scores, ``loo_compare`` and
``stacking_weights`` are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import settings
from .models import gnmgp, gnmgp_hetero, gnmgp_sparse, lmc, lmc_sparse, snmgp, snmgp_sparse
from .models.base import task_major
from .ops import chol, kernels

#: The sparse models, whose LOO conditionals come from their Woodbury factors
#: (:func:`chain_conditional_loglik_sparse`); their observation covariance is
#: never formed.
SPARSE_MODELS = ("gnmgp_sparse", "gnmgp_hetero_sparse", "snmgp_sparse", "lmc_sparse")
#: The sparse models with a Hadamard-layout objective
#: (:func:`chain_conditional_loglik_sparse_hadamard`).
HADAMARD_SPARSE_MODELS = ("gnmgp_sparse", "snmgp_sparse", "lmc_sparse")

def mse(a, b, axis=None):
    """Mean squared error (utils.py:165-172)."""
    return np.mean((np.asarray(a) - np.asarray(b)) ** 2, axis=axis)


def rmse(a, b, axis=None):
    """Root mean squared error (utils.py:175-182)."""
    return np.sqrt(mse(a, b, axis=axis))


def lpd(mean, std, y):
    """Mean log predictive density under pointwise normals (utils.py:185-197)."""
    mean = np.asarray(mean).reshape(-1)
    std = np.asarray(std).reshape(-1)
    y = np.asarray(y).reshape(-1)
    z = (y - mean) / std
    return float(np.mean(-0.5 * z**2 - np.log(std) - 0.5 * np.log(2 * np.pi)))


def pmse(pred_mean, y_test):
    """Predictive mean squared error on held-out data."""
    return float(mse(pred_mean, y_test))


def get_aic(vec, deviance_fn, *args, **kwargs):
    """AIC = deviance + 2 N_p (model_validation.py:9-19)."""
    n_p = int(vec.shape[0])
    return float(deviance_fn(vec, *args, **kwargs)) + 2.0 * n_p


def get_bic(vec, deviance_fn, n_obs: int, *args, **kwargs):
    """BIC = deviance + log(N) N_p (model_validation.py:21-33); ``n_obs`` is
    the number of inputs N (the reference uses ``Y.size()[0]``)."""
    n_p = int(vec.shape[0])
    return float(deviance_fn(vec, *args, **kwargs)) + float(np.log(n_obs)) * n_p


def get_dic(hist_vecs, deviance_fn, *args, **kwargs):
    """DIC = bar_D + p_D with p_D = bar_D − D(posterior mean)
    (model_validation.py:35-51).

    ``hist_vecs`` is the (S, P) chain.  The JAX function vmaps the deviance
    over it; here the draws go one at a time under ``torch.no_grad()``, so
    a chain at N=1000 never holds S Grams at once.
    """
    hist = torch.as_tensor(hist_vecs)
    with torch.no_grad():
        devs = torch.stack([deviance_fn(v, *args, **kwargs) for v in hist])
        bar_d = float(torch.mean(devs))
        d_mean = float(deviance_fn(torch.mean(hist, dim=0), *args, **kwargs))
    p_d = bar_d - d_mean
    return bar_d + p_d


def _logsumexp(a, axis=None):
    a = np.asarray(a, dtype=np.float64)
    mx = np.max(a, axis=axis, keepdims=True)
    s = np.sum(np.exp(a - mx), axis=axis)
    out = np.log(s) + np.reshape(mx, np.shape(s))
    return out if axis is not None else float(out)


def observation_cov(model: str, vec: torch.Tensor, x: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Dense task-major (MN×MN) observation covariance for one packed vector:
    the marginal covariance of ``y = Y.T.reshape(-1)`` under the model's
    likelihood (Gram + noise).  On CUDA the ``gnmgp`` and ``gnmgp_hetero``
    Gram is kernel K2 (``models.gnmgp.gram``, with its self-nugget), and
    the ``lmc`` and ``snmgp`` input covariance ``K_x`` kernel K1's self form,
    expanded as ``B_f ⊗ K_x``.  A sparse model's covariance is never formed,
    here or in JAX: its name raises, as an unknown one does."""
    if model in ("gnmgp", "gnmgp_hetero"):
        mod = gnmgp if model == "gnmgp" else gnmgp_hetero
        p = mod.unpack(vec, n, m)
        cov = gnmgp.gram(x, torch.exp(p.tilde_l), gnmgp.chol_process(p.ul_vecs, n, m))
        # in place: the Gram is this function's own; a scalar or task-major noise
        cov.diagonal().add_(torch.exp(p.tilde_sigma2_err))
        return cov
    if model == "snmgp":
        b_f, k_x, sigma2_err = snmgp._covs(snmgp.unpack(vec, n, m), x, m)
    elif model == "lmc":
        p = lmc.unpack(vec, m)
        b_f, k_x, sigma2_err = lmc.task_cov(p.ul_vec, m), lmc.input_cov(p, x), torch.exp(p.tilde_sigma2_err)
    elif model in SPARSE_MODELS:
        raise ValueError(f"unknown model {model!r} for a dense observation covariance (a sparse model's LOO "
                         "conditionals come from chain_conditional_loglik_sparse)")
    else:
        raise ValueError(f"unknown model {model!r}")
    cov = torch.kron(b_f, k_x)
    cov.diagonal().add_(sigma2_err)
    return cov


def pointwise_conditional_loglik(cov: torch.Tensor, y_tm: torch.Tensor, mask_tm=None) -> torch.Tensor:
    """Exact per-coordinate leave-one-out conditional log densities.

    For ``y ~ N(0, cov)`` with precision ``Λ = cov⁻¹`` the conditional of
    coordinate *i* given all others is ``N(y_i − (Λy)_i/Λ_ii, 1/Λ_ii)``
    evaluated at ``y_i``: ``½log Λ_ii − ½log 2π − ½(Λy)_i²/Λ_ii``, from one
    Cholesky factor and a solve against I.  ``y_tm`` is the task-major
    observation vector; ``mask_tm`` (MN,) boolean projects padded slots out
    and zeroes their terms.  A factor that fails gives NaN terms, as in JAX.
    """
    if mask_tm is not None:
        mask_tm = torch.as_tensor(mask_tm, dtype=torch.bool, device=cov.device)
        mv = mask_tm.to(cov.dtype)
        cov = cov * (mv[:, None] * mv[None, :]) + torch.diag(1.0 - mv)
        y_tm = y_tm * mv
    l = chol.safe_cholesky(cov)
    lam = chol.chol_solve(l, torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device))
    d = torch.diagonal(lam)
    lam_y = lam @ y_tm
    ll = 0.5 * torch.log(d) - 0.5 * math.log(2.0 * math.pi) - 0.5 * lam_y**2 / d
    if mask_tm is not None:
        ll = torch.where(mask_tm, ll, 0.0)
    return ll


def chain_conditional_loglik(
    model: str, hist_vecs, x, y, mask=None, chunk: int = 8, device=None, dtype=None
) -> np.ndarray:
    """(S, MN) exact LOO-conditional log densities across a chain, as numpy
    float64.

    The draws run one at a time on ``device`` (default ``cuda``, raising
    when there is none) in ``dtype`` (default ``settings.dtype``): each
    builds its covariance, factors it and forms its precision, so only one
    MN×MN precision is alive at a time; ``chunk`` draws' rows are copied to
    the host together.  The result does not depend on ``chunk``.  ``mask``
    is the (N,) subject mask, tiled to the task-major layout.
    """
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    hist, x, y = as_t(hist_vecs), as_t(x), as_t(y)
    n, m = y.shape
    y_tm = task_major(y)
    mask_tm = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=device).repeat(m)
    out = np.empty((hist.shape[0], n * m))
    with torch.no_grad():
        for start in range(0, hist.shape[0], chunk):
            rows = [pointwise_conditional_loglik(observation_cov(model, v, x, n, m), y_tm, mask_tm)
                    for v in hist[start : start + chunk]]
            out[start : start + len(rows)] = torch.stack(rows).cpu().numpy()
    return out


def chain_conditional_loglik_sparse(
    hist_vecs, data, ops, approx: str = "fitc", hyper=None, mask=None, chunk: int = 8, hetero: bool = False,
    model: str = "gnmgp_sparse", device=None, dtype=None,
) -> np.ndarray:
    """(S, MN) exact LOO-conditional log densities under a sparse model, as
    numpy float64, task-major slots.

    The sparse observation covariance is ``Σ = diag(Λ) + BᵀB``, so the LOO
    identity's two ingredients come from the Woodbury factors the likelihood
    builds (``models.gnmgp_sparse._woodbury``), never the dense MN × MN
    precision:

        diag(Σ⁻¹) = (1 − colnorms²(L_in⁻¹ A)) / Λ
        Σ⁻¹ y     = (d − Aᵀ inner⁻¹ (A d)) / sqrt(Λ)

    ``model`` picks the Woodbury factor set: ``"gnmgp_sparse"`` (with
    ``hetero=True`` the per-slot-noise tier, whose ``ops`` are its
    ``SparseHeteroOps``; ``"gnmgp_hetero_sparse"`` names it too),
    ``"snmgp_sparse"`` or ``"lmc_sparse"``.  As in JAX, ``hetero=True``
    with a separable model's name raises, since it would read the draws in
    the hetero layout; so does an unknown name.

    The draws run one at a time on ``device`` (default ``cuda``, raising when
    there is none) in ``dtype`` (default ``settings.dtype``), ``data`` and
    ``ops`` already there; ``chunk`` draws' rows are copied to the host
    together, and the result does not depend on ``chunk``.
    """
    if model not in SPARSE_MODELS:
        raise ValueError(f"unknown sparse model {model!r} (want one of {SPARSE_MODELS})")
    if hetero and model not in ("gnmgp_sparse", "gnmgp_hetero_sparse"):
        raise ValueError(f"hetero=True applies to the GNMGP sparse family only (got model={model!r})")
    hetero = hetero or model == "gnmgp_hetero_sparse"
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    hist = torch.as_tensor(hist_vecs, dtype=dtype, device=device)
    n, m = data.y.shape
    m_z = (ops.base.z if hetero else ops.z).shape[0]
    mask_tm = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=device).repeat(m)

    def woodbury(v):
        if hetero:
            p = gnmgp_sparse.unpack_hetero(v, m_z, m)
            noise = torch.exp(gnmgp_sparse.noise_at_data(p, ops, m, hyper))
            return gnmgp_sparse._woodbury_noise(gnmgp_sparse._base_params(p), data, ops.base, m, approx, noise,
                                                hyper, mask)
        if model == "snmgp_sparse":
            return snmgp_sparse._woodbury(snmgp_sparse.unpack(v, m_z, m), data, ops, m, approx, hyper, mask)
        if model == "lmc_sparse":
            return lmc_sparse._woodbury(lmc_sparse.unpack(v, m), data, ops, m, approx, mask)
        return gnmgp_sparse._woodbury(gnmgp_sparse.unpack(v, m_z, m), data, ops, m, approx, hyper, mask)

    return _loo_rows(hist, woodbury, n * m, mask_tm, chunk)


def _loo_rows(hist: torch.Tensor, woodbury, n_slots: int, mask_flat, chunk: int) -> np.ndarray:
    """(S, n_slots) LOO conditionals from each draw's Woodbury factors
    ``woodbury(v)``, one draw at a time; ``chunk`` draws' rows are copied to
    the host together."""
    out = np.empty((hist.shape[0], n_slots))
    with torch.no_grad():
        for start in range(0, hist.shape[0], chunk):
            rows = [_loo_from_woodbury(woodbury(v), mask_flat) for v in hist[start : start + chunk]]
            out[start : start + len(rows)] = torch.stack(rows).cpu().numpy()
    return out


def chain_conditional_loglik_sparse_hadamard(
    hist_vecs, data, ops, m: int, approx: str = "fitc", hyper=None, mask=None, chunk: int = 8,
    model: str = "gnmgp_sparse", device=None, dtype=None,
) -> np.ndarray:
    """(S, N) exact LOO-conditional log densities of a sparse model in the
    Hadamard layout (``data`` a ``HadamardData`` with ``m`` tasks), as numpy
    float64: :func:`chain_conditional_loglik_sparse` with the model's
    ``_woodbury_hadamard`` (``"gnmgp_sparse"``, ``"snmgp_sparse"`` or
    ``"lmc_sparse"``; another name raises).  Device, dtype and ``chunk`` as
    there."""
    if model not in HADAMARD_SPARSE_MODELS:
        raise ValueError(f"model {model!r} has no sparse Hadamard layout (want one of {HADAMARD_SPARSE_MODELS})")
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    hist = torch.as_tensor(hist_vecs, dtype=dtype, device=device)
    m_z = ops.z.shape[0]
    mask_b = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=device)
    if model == "lmc_sparse":
        woodbury = lambda v: lmc_sparse._woodbury_hadamard(lmc_sparse.unpack(v, m), data, ops, m, approx, mask)
    else:
        mod = gnmgp_sparse if model == "gnmgp_sparse" else snmgp_sparse
        woodbury = lambda v: mod._woodbury_hadamard(mod.unpack(v, m_z, m), data, ops, m, approx, hyper, mask)
    return _loo_rows(hist, woodbury, data.y.shape[0], mask_b, chunk)


def _loo_from_woodbury(w, mask_flat=None) -> torch.Tensor:
    """Per-slot LOO conditional log densities from sparse Woodbury factors."""
    u = chol.tri_solve(w.c_in, w.a)  # L_in⁻¹ A
    prec_diag = (1.0 - torch.sum(u * u, dim=0)) / w.lam
    prec_y = (w.d - w.a.T @ chol.chol_solve(w.c_in, w.a @ w.d)) / torch.sqrt(w.lam)
    d = torch.clamp(prec_diag, min=1e-300)
    ll = 0.5 * torch.log(d) - 0.5 * math.log(2.0 * math.pi) - 0.5 * prec_y**2 / d
    if mask_flat is not None:
        ll = torch.where(mask_flat, ll, 0.0)
    return ll


def observation_cov_hadamard(model: str, vec: torch.Tensor, x: torch.Tensor, indx: torch.Tensor,
                             m: int) -> torch.Tensor:
    """Dense (N×N) observation covariance for Hadamard-layout data (one
    observation per (input, task) pair): the covariance each
    ``log_posterior_hadamard`` builds, ``K_x ∘ K_indx + σ²I``.  On CUDA the
    ``gnmgp`` and ``snmgp`` ``K_x`` is kernel K1's self form; ``lmc`` takes
    the stationary ``rbf_cov``."""
    n = x.shape[0]
    if model == "gnmgp":
        p = gnmgp.unpack(vec, n, m)
        k_x = kernels.nonstationary_rbf_cov(x, ell1=torch.exp(p.tilde_l))
        cov = gnmgp.hadamard_gram(p.ul_vecs.reshape(n, -1), indx, k_x, m)
    elif model == "snmgp":
        p = snmgp.unpack(vec, n, m)
        cov = snmgp.hadamard_gram(p, x, indx, m)
    elif model == "lmc":
        p = lmc.unpack(vec, m)
        cov = lmc.hadamard_gram(p, x, indx, m)
    else:
        raise ValueError(f"unknown hadamard model {model!r}")
    cov.diagonal().add_(torch.exp(p.tilde_sigma2_err))  # in place: the Gram is this function's own
    return cov


def chain_conditional_loglik_hadamard(
    model: str, hist_vecs, x, indx, y, m: int, mask=None, chunk: int = 8, device=None, dtype=None
) -> np.ndarray:
    """(S, N) exact LOO-conditional log densities for Hadamard-layout chains,
    as numpy float64.

    As :func:`chain_conditional_loglik`: the draws run one at a time on
    ``device`` (default ``cuda``, raising when there is none) in ``dtype``
    (default ``settings.dtype``), ``chunk`` draws' rows are copied to the
    host together, and the result does not depend on ``chunk``.  ``mask``
    (N,) projects padded observations out and zeroes their terms.
    """
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    hist, x, y = as_t(hist_vecs), as_t(x), as_t(y)
    indx = torch.as_tensor(indx, dtype=torch.long, device=device)
    mask = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=device)
    out = np.empty((hist.shape[0], y.shape[0]))
    with torch.no_grad():
        for start in range(0, hist.shape[0], chunk):
            rows = [pointwise_conditional_loglik(observation_cov_hadamard(model, v, x, indx, m), y, mask)
                    for v in hist[start : start + chunk]]
            out[start : start + len(rows)] = torch.stack(rows).cpu().numpy()
    return out


def waic(cond_loglik) -> dict:
    """WAIC from (S, MN) pointwise log densities (non-factorized form).

    ``elpd_i = log mean_s exp(ll_is) − var_s(ll_is)``; with the exact LOO
    conditionals (:func:`chain_conditional_loglik`) as pointwise terms this
    is the conditional WAIC.  Returns totals, the effective parameter count
    ``p_waic`` and the pointwise vector.
    """
    ll = np.asarray(cond_loglik, dtype=np.float64)
    s = ll.shape[0]
    lppd_i = _logsumexp(ll, axis=0) - np.log(s)
    p_i = ll.var(axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    return {
        "elpd_waic": float(elpd_i.sum()),
        "p_waic": float(p_i.sum()),
        "waic": float(-2.0 * elpd_i.sum()),
        "pointwise": elpd_i,
    }


def psis_loo(cond_loglik) -> dict:
    """PSIS-LOO from (S, MN) exact LOO-conditional log densities.

    The importance ratios for leaving out coordinate *i* are
    ``r_is ∝ 1/p(y_i | y_{−i}, θ_s)``; each coordinate's log ratios are
    Pareto-smoothed (``inference.pathfinder.psis_smooth``) and its k̂ is the
    reliability diagnostic (k̂ > 0.7 flags an untrustworthy estimate).
    Returns ``elpd_loo``, ``p_loo``, ``looic``, the pointwise elpd, the k̂
    vector and ``n_bad_k``.
    """
    from .inference.pathfinder import psis_smooth

    ll = np.asarray(cond_loglik, dtype=np.float64)
    s, mn = ll.shape
    elpd_i = np.empty(mn)
    k_hats = np.empty(mn)
    for i in range(mn):
        lw, k = psis_smooth(-ll[:, i])
        lw = lw - _logsumexp(lw)
        elpd_i[i] = _logsumexp(lw + ll[:, i])
        k_hats[i] = k
    lppd = _logsumexp(ll, axis=0) - np.log(s)
    return {
        "elpd_loo": float(elpd_i.sum()),
        "p_loo": float((lppd - elpd_i).sum()),
        "looic": float(-2.0 * elpd_i.sum()),
        "pointwise": elpd_i,
        "k_hat": k_hats,
        "n_bad_k": int((k_hats > 0.7).sum()),
    }
