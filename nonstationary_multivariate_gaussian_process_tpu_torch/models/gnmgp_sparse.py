"""Sparse (inducing-point) GNMGP — the large-N tier.

Counterpart of the JAX package's ``models/gnmgp_sparse.py`` for the full
layout (FITC and VFE, the ``mixed`` tier, ``mask=``).  The latent processes
live at m_z inducing inputs Z: their values at the data are the prior
conditional mean (kriging) under the exact model's RBF priors, a fixed (m_z,
N) projection built once in float64 (``predict/latent.krige_proj``).  The
f-process takes the Nyström approximation ``Q = K_nm K_mm⁻¹ K_mn`` over the
same set, with the FITC diagonal correction (``approx="fitc"``: Λ = diag(K −
Q) + σ²) or Titsias' VFE bound (``approx="vfe"``: Λ = σ² and the penalty
``−tr(K − Q)/(2σ²)``), so the likelihood is one Woodbury solve over an
(m_z·M)² inner system and never factors the dense MN × MN Gram.

Kernels, on the card:

* ``K_mm``, the self-form SVC Gram of (Z, ℓ_z, L_z) with its nugget, is
  differentiated, so it is kernel K3 (``gram_kernels.svc_gram_tiled``, with
  its backward kernel).  K3 builds it input-major (row ``j·M + a``); the
  rows and columns are permuted to JAX's task-major layout (row ``a·m_z +
  j``) so that every later piece — ``K_nm``, the factors, the LOO's slots —
  is JAX's matrix.
* ``K_xz``, the Gibbs cross-covariance of (x, ℓ_x) against (Z, ℓ_z), is
  kernel K1's cross form; ℓ_x is kriged from ``tilde_l_z``, so both sides
  carry a gradient, through K1's cross-form backward kernel.
* ``cross_gram`` stays a ``torch.einsum``, as JAX leaves it to XLA.
* The factors take ``chol.robust_cholesky_small`` and ``tri_solve_small``.

The module also holds what the other sparse tiers share: the separable
likelihood :func:`_loglik_separable` (``models/snmgp_sparse.py`` and
``models/lmc_sparse.py``: ``K_mm = B_f ⊗ K_zz`` and ``K_nm = B_f ⊗ K_xz``,
never materialized, with ``K_zz`` from K1's self form and ``K_xz`` from its
cross form, σ and ℓ on both sides, each with its backward kernel), and the
heteroscedastic tier (``gnmgp_hetero_sparse``: a per-(input, task) noise GP
at Z, kriged to the data, with the per-slot VFE penalty).

The Hadamard layout (one observation per (input, task) pair, so a channel
may be missing at any time) has its own objective here
(:func:`make_objective_hadamard`): the per-input Cholesky vectors enter raw,
with no exp on their diagonals, under :data:`HADAMARD_DEFAULT_HYPERS`; each
observation row of ``K_nm`` takes its own task's row of ``L_x``.  The same
kernels carry it: K3 for ``K_mm``, K1's cross form for ``K_xz``, each with
its backward kernel.  The separable tiers' Hadamard likelihood is
:func:`_loglik_separable_hadamard`.

Inducing-input refinement (:func:`refine_inducing`, every sparse model in
both layouts) moves Z down the objective: :func:`make_ops_traced` and
:func:`make_ops_traced_hetero` build the kriging projections and prior
factors in the graph, so the gradient in z runs through them, through K3 at
z (``K_mm``, its backward kernel giving z̄ too) and through K1's cross form
(``K_xz``, its backward kernel giving the column side's z̄); the separable
tiers' ``K_zz`` takes K1's self form, whose backward kernel gives z̄ as well.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import dists, settings
from ..ops import chol, gram_kernels, kernels, transforms
from .base import FullData, HadamardData, check_full_data, check_vec, task_major
from .gnmgp import DEFAULT_HYPERS, HADAMARD_HYPERS


class SparseParams(NamedTuple):
    tilde_l_z: torch.Tensor  # (m_z,) log lengthscale process at Z
    ul_vecs_z: torch.Tensor  # (m_z*T,) unconstrained Cholesky vectors at Z
    tilde_sigma2_err: torch.Tensor  # () log noise variance


def n_params(m_z: int, m: int) -> int:
    return m_z + m_z * transforms.tri_size(m) + 1


def unpack(vec: torch.Tensor, m_z: int, m: int) -> SparseParams:
    """Packed layout ``[tilde_l_z(m_z), uL_vecs_z(m_z*T), tilde_sigma2_err]``
    — the exact model's layout (logpos.py:32-43) with N replaced by m_z."""
    t = transforms.tri_size(m)
    check_vec(vec, m_z + m_z * t + 1, "gnmgp_sparse",
              f"[tilde_l_z({m_z}), uL_vecs_z({m_z}*{t}), tilde_sigma2_err] for m_z={m_z}, M={m}")
    return SparseParams(tilde_l_z=vec[:m_z], ul_vecs_z=vec[m_z : m_z + m_z * t], tilde_sigma2_err=vec[-1])


def pack(p: SparseParams) -> torch.Tensor:
    return torch.cat([p.tilde_l_z, p.ul_vecs_z, p.tilde_sigma2_err.reshape(1)])


def choose_inducing(x, m_z: int) -> torch.Tensor:
    """Evenly spaced quantile subset of the sorted inputs as inducing inputs,
    chosen on the host; on ``x``'s device in its dtype (a tensor ``x``), else
    on the CPU in ``settings.dtype``."""
    x64 = np.sort(np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, np.float64))
    n = x64.shape[0]
    if not 2 <= m_z <= n:
        raise ValueError(f"choose_inducing: need 2 <= m_z <= N, got m_z={m_z}, N={n}")
    idx = np.unique(np.round(np.linspace(0, n - 1, m_z)).astype(int))
    z = np.unique(x64[idx])
    if torch.is_tensor(x):
        return torch.as_tensor(z, dtype=x.dtype, device=x.device)
    return torch.as_tensor(z, dtype=settings.dtype)


class SparseOps(NamedTuple):
    """Loop-invariant pieces, built once per objective (float64 islands)."""

    z: torch.Tensor  # (m_z,) inducing inputs
    proj_l: torch.Tensor  # (m_z, N) prior-conditional projection, tilde_l kernel
    proj_ul: torch.Tensor  # (m_z, N) projection under the L-entry kernel
    pc_l_z: dists.TriInv  # the tilde_l prior Gram at Z
    pc_ul_z: dists.TriInv  # the L-entry prior Gram at Z


def make_ops(x: torch.Tensor, z: torch.Tensor, hyper: dict | None = None) -> SparseOps:
    """The kriging projections Z → x and the prior factors at Z, on ``x``'s
    device in ``x``'s dtype."""
    from ..predict.latent import krige_proj

    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    z = torch.as_tensor(z, dtype=x.dtype, device=x.device)
    proj_l, _ = krige_proj(z, x, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    proj_ul, _ = krige_proj(z, x, hp["alpha_L"], hp["beta_L"])
    pc_l_z = chol.prior_rbf_inv(z, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    pc_ul_z = chol.prior_rbf_inv(z, hp["alpha_L"], hp["beta_L"])
    return SparseOps(z, proj_l, proj_ul, pc_l_z, pc_ul_z)


def latents_at_data(p: SparseParams, ops: SparseOps, m: int, hyper=None):
    """Kriged latent fields at the data: ``(tilde_l_x (N,), ul_x (N, T))``,
    the prior conditional mean under the exact model's latent priors."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    m_z = ops.z.shape[0]
    t = transforms.tri_size(m)
    tl_x = hp["mu_tilde_l"] + (p.tilde_l_z - hp["mu_tilde_l"]) @ ops.proj_l
    ul_mat_z = p.ul_vecs_z.reshape(m_z, t)  # (m_z, T)
    ul_x = (hp["mu_L"] + (ul_mat_z.T - hp["mu_L"]) @ ops.proj_ul).T  # (N, T)
    return tl_x, ul_x


def chol_factors(ul: torch.Tensor, m: int) -> torch.Tensor:
    """(n, T) unconstrained L-vectors → (n, M, M) lower-triangular factors."""
    return transforms.vec_to_tril(transforms.ulvec_to_lvec(ul, m), m)


def cross_gram(k_xz: torch.Tensor, lx: torch.Tensor, lz: torch.Tensor) -> torch.Tensor:
    """Task-major cross Gram ``K[(a,n),(c,j)] = K_x[n,j]·(Lx_n Lz_jᵀ)[a,c]``:
    rows ``a·N + n`` (``models.gnmgp.gram``'s layout), columns ``c·m_z + j``."""
    n, m, _ = lx.shape
    m_z = lz.shape[0]
    b4 = torch.einsum("nab,jcb->najc", lx, lz)
    k4 = torch.einsum("nj,najc->ancj", k_xz, b4)
    return k4.reshape(n * m, m_z * m)


def _task_major_perm(n: int, m: int, device) -> torch.Tensor:
    """Row ``a·n + j`` of the task-major layout is row ``j·m + a`` of the
    input-major one."""
    return torch.arange(n * m, device=device).reshape(n, m).T.reshape(-1)


def inducing_gram(z: torch.Tensor, ell_z: torch.Tensor, lz: torch.Tensor) -> torch.Tensor:
    """``K_mm``: the self-form SVC Gram ``(K_z + jitter·I)[j,k]·(Lz_j Lz_kᵀ)[a,c]``
    in the task-major layout (JAX's ``gram(nonstationary_rbf_cov(z,
    ell1=ell_z), lz)``), by kernel K3 (input-major, with its backward kernel)
    and one symmetric permutation."""
    k_in = gram_kernels.svc_gram_tiled(z.contiguous(), ell_z.contiguous(), lz.contiguous(), settings.jitter)
    perm = _task_major_perm(z.shape[0], lz.shape[1], z.device)
    return k_in[perm][:, perm]


class _Woodbury(NamedTuple):
    """The FITC/VFE factor set (prediction and the LOO read it too)."""

    c_mm: torch.Tensor  # (mM, mM) chol(K_mm)
    a: torch.Tensor  # (mM, NM) = C⁻¹ K_mn Λ^{-1/2}, masked columns zeroed
    c_in: torch.Tensor  # (mM, mM) chol(I + A Aᵀ)
    lam: torch.Tensor  # (NM,) diagonal (1.0 at masked slots)
    d: torch.Tensor  # (NM,) = y_task_major / sqrt(Λ), masked zeroed
    corr: torch.Tensor  # (NM,) clamp(K_diag − Q_diag, 0): the FITC/VFE correction
    mv: torch.Tensor | None  # (NM,) mask in the task-major layout (None: all real)


def _half_woodbury(k_mm, k_nm, k_diag, y_flat, sigma2_err, approx: str, mv=None):
    """Everything before the inner factorization: ``(a, lam, d, corr, c_mm)``.

    ``K_mm`` is factored by the robust ladder, forced on, with a relative
    ridge of 1e-8 (float64) or 1e-5 (float32) of its mean diagonal, as JAX
    does: near-singular L_z rows make it rank-deficient in a way the data
    cannot see through Q."""
    if mv is not None:
        k_nm = k_nm * mv[:, None]
        y_flat = y_flat * mv
    ridge = (1e-8 if k_mm.dtype == torch.float64 else 1e-5) * torch.mean(torch.diagonal(k_mm))
    eye = torch.eye(k_mm.shape[0], dtype=k_mm.dtype, device=k_mm.device)
    c_mm = chol.robust_cholesky_small(k_mm + ridge * eye)
    b = chol.tri_solve_small(c_mm, k_nm.T)  # (mM, NM)
    q_diag = torch.sum(b * b, dim=0)
    corr = torch.clamp(k_diag - q_diag, min=0.0)
    if approx == "fitc":
        lam = corr + sigma2_err
    elif approx == "vfe":
        lam = torch.as_tensor(sigma2_err, dtype=q_diag.dtype, device=q_diag.device).expand(q_diag.shape)
    else:
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    if mv is not None:
        lam = torch.where(mv > 0, lam, 1.0)
    rsqrt_lam = torch.rsqrt(lam)
    return b * rsqrt_lam[None, :], lam, y_flat * rsqrt_lam, corr, c_mm


def _woodbury_core(k_mm, k_nm, k_diag, y_flat, sigma2_err, approx: str, mv=None) -> _Woodbury:
    """The layout-agnostic factor set (see :func:`_half_woodbury`)."""
    a, lam, d, corr, c_mm = _half_woodbury(k_mm, k_nm, k_diag, y_flat, sigma2_err, approx, mv)
    inner = torch.eye(a.shape[0], dtype=a.dtype, device=a.device) + a @ a.T
    return _Woodbury(c_mm, a, chol.safe_cholesky(inner), lam, d, corr, mv)


def _assemble_full(p: SparseParams, data: FullData, ops: SparseOps, m: int, hyper=None, mask=None):
    """Cross pieces ``(k_mm, k_nm, k_diag, y_flat, mv)`` for the full layout."""
    m_z = ops.z.shape[0]
    tl_x, ul_x = latents_at_data(p, ops, m, hyper)
    lx = chol_factors(ul_x, m)  # (N, M, M)
    lz = chol_factors(p.ul_vecs_z.reshape(m_z, -1), m)  # (m_z, M, M)
    ell_x = torch.exp(tl_x)
    ell_z = torch.exp(p.tilde_l_z)
    k_mm = inducing_gram(ops.z, ell_z, lz)  # (mM, mM)
    k_xz = kernels.nonstationary_rbf_cov(data.x, ell1=ell_x, x2=ops.z, ell2=ell_z)  # kernel K1, cross form
    k_nm = cross_gram(k_xz, lx, lz)  # (NM, mM)
    # the Gibbs self-covariance is 1 (+ jitter), so diag K[(a,n)] = (1 + j)·||Lx_n[a,:]||²
    k_diag = ((1.0 + settings.jitter) * torch.sum(lx * lx, dim=-1)).T.reshape(-1)
    mv = None
    if mask is not None:
        mv = torch.as_tensor(mask, device=data.y.device).to(data.y.dtype).repeat(m)  # task-major (NM,)
    return k_mm, k_nm, k_diag, task_major(data.y), mv


def _woodbury(p: SparseParams, data: FullData, ops: SparseOps, m: int, approx: str, hyper=None,
              mask=None) -> _Woodbury:
    k_mm, k_nm, k_diag, y_flat, mv = _assemble_full(p, data, ops, m, hyper, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y_flat, torch.exp(p.tilde_sigma2_err), approx, mv)


def _loglik_from_woodbury(w: _Woodbury, sigma2_err, approx: str) -> torch.Tensor:
    u = w.a @ w.d
    sol = chol.tri_solve(w.c_in, u)
    quad = torch.sum(w.d * w.d) - torch.sum(sol * sol)
    logdet = torch.sum(torch.log(w.lam)) + chol.chol_logdet(w.c_in)
    res = -0.5 * logdet - 0.5 * quad
    if approx == "vfe":
        corr = w.corr if w.mv is None else w.corr * w.mv
        res = res - 0.5 * torch.sum(corr) / sigma2_err
    return res


def _inner_logdet_quad(inner, u):
    """``(logdet, uᵀ inner⁻¹ u)`` of the Woodbury inner system by precision:
    ``mixed_logdet_quad`` under ``NMGP_PRECISION=mixed`` (its eigenvalues lie
    in [1, 1 + ||A||²], inside the mixed kernel's range), else the robust
    small factor."""
    if settings.mixed_solves and inner.dtype == torch.float64:
        from ..ops import mixed

        return mixed.mixed_logdet_quad(inner, u)
    c_in = chol.robust_cholesky_small(inner)
    sol = chol.tri_solve_small(c_in, u)
    return chol.chol_logdet(c_in), torch.sum(sol * sol)


def _loglik_mixed_inner(k_mm, k_nm, k_diag, y_flat, noise, approx: str, mv=None) -> torch.Tensor:
    """The float64-accurate sparse log-likelihood with the inner system served
    by the mixed-precision kernel (``NMGP_PRECISION=mixed``): ``K_mm`` keeps
    its float64 robust factor (at sampled hyperparameters its condition,
    ~1e8, defeats every float32-preconditioned scheme), the inner ``I + A
    Aᵀ`` (condition ~1e5) takes ``mixed_logdet_quad``."""
    a, lam, d, corr, _ = _half_woodbury(k_mm, k_nm, k_diag, y_flat, noise, approx, mv)
    inner = torch.eye(a.shape[0], dtype=a.dtype, device=a.device) + a @ a.T
    ld_in, quad_in = _inner_logdet_quad(inner, a @ d)
    res = -0.5 * (torch.sum(torch.log(lam)) + ld_in) - 0.5 * (torch.sum(d * d) - quad_in)
    if approx == "vfe":
        c = corr if mv is None else corr * mv
        res = res - 0.5 * torch.sum(c / noise)
    return res


def _loglik_pieces(pieces, noise, approx: str) -> torch.Tensor:
    """Assembled cross pieces to the factor path or, under
    ``NMGP_PRECISION=mixed`` with float64 inputs, the mixed inner kernel."""
    k_mm, k_nm, k_diag, y_flat, mv = pieces
    if settings.mixed_solves and k_mm.dtype == torch.float64:
        return _loglik_mixed_inner(k_mm, k_nm, k_diag, y_flat, noise, approx, mv)
    w = _woodbury_core(k_mm, k_nm, k_diag, y_flat, noise, approx, mv)
    if approx == "vfe" and noise.dim() > 0:
        # per-slot noise (the hetero tier): the Titsias penalty is pointwise
        res = _loglik_from_woodbury(w, 1.0, approx="fitc")
        c = w.corr if w.mv is None else w.corr * w.mv
        return res - 0.5 * torch.sum(c / noise)
    return _loglik_from_woodbury(w, noise, approx)


def _loglik_separable(b_f, k_zz, k_xz, k_x_diag, y_nm, noise, approx: str, mask=None) -> torch.Tensor:
    """Kronecker-factored sparse likelihood of the separable tiers.

    Equal to assembling ``K_mm = B_f ⊗ K_zz`` and ``K_nm = B_f ⊗ K_xz`` and
    going through :func:`_loglik_pieces`, but the Kronecker products are
    never formed:

    * ``chol(B ⊗ K) = chol(B) ⊗ chol(K)``: two small robust factors, M×M and
      m_z×m_z, each with its own ridge of 1e-8 (float64) or 1e-5 (float32)
      of its mean diagonal, where the assembled path puts one on ``K_mm``;
    * the solve ``C⁻¹ K_mn`` stays factored, ``B_b = L_b⁻¹ B_f`` and
      ``B_k = L_k⁻¹ K_xzᵀ``, so ``Q``'s diagonal is the outer product of
      their column norms;
    * the inner Gram ``I + A Aᵀ = I + Σ_a (B_b[:,a] B_b[:,a]ᵀ) ⊗ (B_k
      diag(w_a) B_kᵀ)`` takes M batched (m_z × N × m_z) products;
    * its logdet and quadratic form go through :func:`_inner_logdet_quad`,
      so ``NMGP_PRECISION=mixed`` routes them as JAX does.

    ``y_nm`` is the (N, M) observation matrix; ``mask`` (N,) excludes padded
    rows exactly (zero weight, unit Λ)."""
    m, m_z = b_f.shape[0], k_zz.shape[0]
    dtype, device = k_zz.dtype, k_zz.device
    rel = 1e-8 if dtype == torch.float64 else 1e-5
    eye = lambda k: torch.eye(k, dtype=dtype, device=device)
    lb = chol.robust_cholesky_small(b_f + rel * torch.mean(torch.diagonal(b_f)) * eye(m))
    lk = chol.robust_cholesky_small(k_zz + rel * torch.mean(torch.diagonal(k_zz)) * eye(m_z))
    bb = chol.tri_solve_small(lb, b_f)  # (M, M)
    bk = chol.tri_solve_small(lk, k_xz.T)  # (m_z, N)
    y_mn = y_nm.T  # task-major rows (M, N)
    qb = torch.sum(bb * bb, dim=0)  # (M,)
    qk = torch.sum(bk * bk, dim=0)  # (N,)
    corr = torch.clamp(torch.diagonal(b_f)[:, None] * k_x_diag[None, :] - qb[:, None] * qk[None, :], min=0.0)
    if approx == "fitc":
        lam = corr + noise
    elif approx == "vfe":
        lam = torch.as_tensor(noise, dtype=dtype, device=device).expand(corr.shape)
    else:
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    mv = None if mask is None else torch.as_tensor(mask, device=device).to(dtype)  # (N,)
    if mv is not None:
        lam = torch.where(mv[None, :] > 0, lam, 1.0)
        y_mn = y_mn * mv[None, :]
    w = 1.0 / lam if mv is None else mv[None, :] / lam  # (M, N)
    dd = torch.sum(y_mn * y_mn / lam)
    u = (bb @ (bk @ (y_mn / lam).T).T).reshape(-1)  # (M·m_z,), index c·m_z + j
    g = (bk[None] * w[:, None, :]) @ bk.T  # (M, m_z, m_z): B_k diag(w_a) B_kᵀ per task
    bb2 = bb[:, None, :] * bb[None, :, :]  # (c, d, a)
    inner = torch.einsum("cda,ajk->cjdk", bb2, g).reshape(m * m_z, m * m_z) + eye(m * m_z)
    ld_in, quad_in = _inner_logdet_quad(inner, u)
    res = -0.5 * (torch.sum(torch.log(lam)) + ld_in) - 0.5 * (dd - quad_in)
    if approx == "vfe":
        c = corr if mv is None else corr * mv[None, :]
        res = res - 0.5 * torch.sum(c) / noise
    return res


def task_onehot(indx: torch.Tensor, m: int, dtype) -> torch.Tensor:
    """(N, M) one-hot rows of the observations' tasks.  A selection from an
    (M,) or (M, M) object is then a product with it, whose backward is a
    product too (an ``index_select``'s backward adds N rows into M with
    atomics, in no fixed order)."""
    return torch.nn.functional.one_hot(indx, m).to(dtype)


def task_rows(ls: torch.Tensor, indx: torch.Tensor) -> torch.Tensor:
    """(N, M): each observation's own task row ``L_i[indx_i, :]`` of the (N,
    M, M) factors ``ls``, gathered (the backward writes each slot once)."""
    return torch.gather(ls, 1, indx[:, None, None].expand(-1, 1, ls.shape[-1]))[:, 0, :]


def _loglik_separable_hadamard(b_f, k_zz, k_xz, k_x_diag, indx, y, noise, approx: str, mask=None) -> torch.Tensor:
    """The Hadamard-layout counterpart of :func:`_loglik_separable`.

    Each observation row selects its task, so the solved cross factor is a
    Khatri-Rao column product ``b[:, i] = B_b[:, indx_i] ⊗ B_k[:, i]``; the
    inner Gram still assembles per task, ``I + Σ_a (B_b[:,a] B_b[:,a]ᵀ) ⊗
    (B_k diag(w·[indx = a]) B_kᵀ)``, as M batched (m_z × N × m_z) products.
    ``k_x_diag`` (N,) is ``K_x``'s diagonal at the observations, ``indx``
    (N,) their tasks and ``y`` (N,) their values; ``mask`` (N,) excludes
    padded rows exactly."""
    m, m_z = b_f.shape[0], k_zz.shape[0]
    dtype, device = k_zz.dtype, k_zz.device
    rel = 1e-8 if dtype == torch.float64 else 1e-5
    eye = lambda k: torch.eye(k, dtype=dtype, device=device)
    lb = chol.robust_cholesky_small(b_f + rel * torch.mean(torch.diagonal(b_f)) * eye(m))
    lk = chol.robust_cholesky_small(k_zz + rel * torch.mean(torch.diagonal(k_zz)) * eye(m_z))
    bb = chol.tri_solve_small(lb, b_f)  # (M, M)
    bk = chol.tri_solve_small(lk, k_xz.T)  # (m_z, N)
    onehot = task_onehot(indx, m, dtype)  # (N, M)
    qb = torch.sum(bb * bb, dim=0)  # (M,)
    qk = torch.sum(bk * bk, dim=0)  # (N,)
    corr = torch.clamp((onehot @ torch.diagonal(b_f)) * k_x_diag - (onehot @ qb) * qk, min=0.0)
    if approx == "fitc":
        lam = corr + noise
    elif approx == "vfe":
        lam = torch.as_tensor(noise, dtype=dtype, device=device).expand(corr.shape)
    else:
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    mv = None if mask is None else torch.as_tensor(mask, device=device).to(dtype)
    if mv is not None:
        lam = torch.where(mv > 0, lam, 1.0)
        y = y * mv
    w = 1.0 / lam if mv is None else mv / lam  # (N,)
    dd = torch.sum(y * y / lam)
    bb_g = bb @ onehot.T  # (M, N): each observation's task column of B_b
    u = (bb_g @ (bk * (y / lam)[None, :]).T).reshape(-1)  # (M·m_z,), index c·m_z + j
    g = (bk[None] * (onehot.T * w[None, :])[:, None, :]) @ bk.T  # (M, m_z, m_z)
    bb2 = bb[:, None, :] * bb[None, :, :]  # (c, d, a)
    inner = torch.einsum("cda,ajk->cjdk", bb2, g).reshape(m * m_z, m * m_z) + eye(m * m_z)
    ld_in, quad_in = _inner_logdet_quad(inner, u)
    res = -0.5 * (torch.sum(torch.log(lam)) + ld_in) - 0.5 * (dd - quad_in)
    if approx == "vfe":
        c = corr if mv is None else corr * mv
        res = res - 0.5 * torch.sum(c) / noise
    return res


def log_lik(p: SparseParams, data: FullData, ops: SparseOps, approx: str = "fitc", hyper=None,
            mask=None) -> torch.Tensor:
    """Sparse marginal log-likelihood (unnormalized, reference convention).

    ``approx="fitc"``: log N(y; 0, Q + diag(K − Q) + σ²I).  ``approx="vfe"``:
    log N(y; 0, Q + σ²I) − tr(K − Q)/(2σ²), Titsias' collapsed bound.
    ``mask`` (N,) excludes padded observations exactly (rows of K_nm zeroed,
    unit Λ, zero observation)."""
    pieces = _assemble_full(p, data, ops, data.y.shape[1], hyper, mask)
    return _loglik_pieces(pieces, torch.exp(p.tilde_sigma2_err), approx)


def log_posterior(p: SparseParams, data: FullData, ops: SparseOps, approx: str = "fitc", hyper=None,
                  prior: bool = True, mask=None):
    """Sparse log-posterior: the exact model's priors over the Z-latents (RBF
    at Z, the inverse-gamma noise prior and its exp-transform Jacobian;
    ``logpos_SVC``, logpos.py:326-380, with the latent fields at Z).  Returns
    ``(logpos, components)``."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    m_z = ops.z.shape[0]
    t = transforms.tri_size(data.y.shape[1])
    loglik = log_lik(p, data, ops, approx=approx, hyper=hp, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.mvn_logpdf_chol(p.tilde_l_z, hp["mu_tilde_l"], ops.pc_l_z)
    lp_ul = torch.sum(dists.mvn_logpdf_chol(p.ul_vecs_z.reshape(m_z, t).T, hp["mu_L"], ops.pc_ul_z))
    lp_s2 = dists.inverse_gamma_logpdf(sigma2_err, alpha=hp["a"], beta=hp["b"])
    res = loglik
    if prior:
        res = res + lp_l + lp_ul + lp_s2 + p.tilde_sigma2_err
    comps = {
        "loglik": loglik,
        "log_prior_tilde_l": lp_l,
        "log_prior_uL_vecs": lp_ul,
        "log_prior_sigma2_err": lp_s2,
    }
    return res, comps


def make_objective(data: FullData, z=None, n_inducing: int = 64, hyper: dict | None = None, approx: str = "fitc",
                   prior: bool = True, mask=None):
    """Sparse negative-log-posterior closure: ``(nlp, ops)``, the objective
    over the packed ``m_z(1+T)+1`` vector and the hoisted :class:`SparseOps`
    (which prediction needs again).  ``z`` defaults to
    ``choose_inducing(x, n_inducing)`` over the real (unmasked) inputs."""
    check_full_data(data, "gnmgp_sparse")
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


def _traced_pieces(x: torch.Tensor, z: torch.Tensor, alpha, beta):
    """The kriging projection ``K_zz⁻¹ K_zx`` and the prior factor at Z of
    one stationary RBF prior, in the graph (the robust traced factor)."""
    sigma = kernels.rbf_cov(z, alpha=alpha, beta=beta)
    k_cross = kernels.rbf_cov(z, x, alpha=alpha, beta=beta)
    c = chol.safe_cholesky(sigma, force_robust=True)
    return chol.chol_solve(c, k_cross), c


def make_ops_traced(x: torch.Tensor, z: torch.Tensor, hyper: dict | None = None) -> SparseOps:
    """Differentiable-in-Z :class:`SparseOps` for inducing refinement.

    :func:`make_ops` builds the projections and prior factors once, in float64
    on the host, outside the graph; this builds the same pieces in the graph
    (stationary ``rbf_cov``, the robust factor, ``chol_solve``), so a
    gradient in ``z`` flows through the kriging projections, the f-process's
    Grams and the latent priors at Z.  The prior factors come back as plain
    Cholesky factors, which ``dists.mvn_logpdf_chol`` takes as it takes a
    :class:`~..dists.TriInv`.  Use only inside :func:`refine_inducing`'s
    Z-steps; rebuild with :func:`make_ops` at the refined Z."""
    hp = {**DEFAULT_HYPERS, **(hyper or {})}
    z = torch.as_tensor(z, dtype=x.dtype, device=x.device)
    proj_l, c_l = _traced_pieces(x, z, hp["alpha_tilde_l"], hp["beta_tilde_l"])
    proj_ul, c_ul = _traced_pieces(x, z, hp["alpha_L"], hp["beta_L"])
    return SparseOps(z, proj_l, proj_ul, c_l, c_ul)


def init_from_empirical(emp_vec, n: int, m_z: int, m: int, x, z) -> torch.Tensor:
    """Subsample an exact-model empirical init (N-layout) onto the Z-layout:
    each inducing slot takes the latent values of its nearest data input.
    On ``emp_vec``'s device in its dtype."""
    from . import gnmgp as dense

    p = dense.unpack(emp_vec, n, m)
    host = lambda v: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64)
    nearest = np.argmin(np.abs(host(x)[None, :] - host(z)[:, None]), axis=1)  # (m_z,)
    idx = torch.as_tensor(nearest, device=emp_vec.device)
    t = transforms.tri_size(m)
    return torch.cat([p.tilde_l[idx], p.ul_vecs.reshape(n, t)[idx].reshape(-1), p.tilde_sigma2_err.reshape(1)])


# ---------------------------------------------------------------------------
# The Hadamard layout: one observation per (input, task) pair.
# ---------------------------------------------------------------------------

#: The Hadamard defaults, the exact Hadamard SVC's (logpos.py:566-585).
HADAMARD_DEFAULT_HYPERS = HADAMARD_HYPERS


def make_ops_hadamard(x: torch.Tensor, z, hyper: dict | None = None) -> SparseOps:
    """:func:`make_ops` under :data:`HADAMARD_DEFAULT_HYPERS`."""
    return make_ops(x, z, {**HADAMARD_DEFAULT_HYPERS, **(hyper or {})})


def _assemble_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, hyper=None, mask=None):
    """Hadamard-layout cross pieces ``(k_mm, k_nm, k_diag, y, mv)``.

    The reference's Hadamard-SVC conventions (``models.gnmgp.
    log_posterior_hadamard``): the per-input Cholesky vectors enter raw, no
    exp on their diagonals, so ``p.ul_vecs_z`` holds plain L-vectors at Z
    and their kriged field is used as it is.  Row i of ``K_nm`` is
    ``K_xz[i, j]·(Lx_i Lz_jᵀ)[indx_i, c]`` at column ``c·m_z + j``."""
    hp = {**HADAMARD_DEFAULT_HYPERS, **(hyper or {})}
    x, indx, y = data
    m_z = ops.z.shape[0]
    tl_x, l_x = latents_at_data(p, ops, m, hp)  # the raw L-vectors, kriged
    lz = transforms.vec_to_tril(p.ul_vecs_z.reshape(m_z, -1), m)  # (m_z, M, M)
    rows = task_rows(transforms.vec_to_tril(l_x, m), indx)  # (N, M) observed task rows
    ell_z = torch.exp(p.tilde_l_z)
    k_mm = inducing_gram(ops.z, ell_z, lz)  # (mM, mM), kernel K3
    k_xz = kernels.nonstationary_rbf_cov(x, ell1=torch.exp(tl_x), x2=ops.z, ell2=ell_z)  # kernel K1, cross form
    b3 = torch.einsum("ib,jcb->icj", rows, lz)  # (N, M, m_z)
    k_nm = (k_xz[:, None, :] * b3).reshape(y.shape[0], m * m_z)  # columns as k_mm's
    k_diag = (1.0 + settings.jitter) * torch.sum(rows * rows, dim=-1)
    mv = None if mask is None else torch.as_tensor(mask, device=y.device).to(y.dtype)
    return k_mm, k_nm, k_diag, y, mv


def _woodbury_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, approx: str, hyper=None,
                       mask=None) -> _Woodbury:
    """Hadamard-layout Woodbury factors (see :func:`_assemble_hadamard`)."""
    k_mm, k_nm, k_diag, y, mv = _assemble_hadamard(p, data, ops, m, hyper, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y, torch.exp(p.tilde_sigma2_err), approx, mv)


def log_lik_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, approx: str = "fitc", hyper=None,
                     mask=None) -> torch.Tensor:
    """Sparse Hadamard marginal log-likelihood (see :func:`log_lik`)."""
    pieces = _assemble_hadamard(p, data, ops, m, hyper, mask)
    return _loglik_pieces(pieces, torch.exp(p.tilde_sigma2_err), approx)


def log_posterior_hadamard(p: SparseParams, data: HadamardData, ops: SparseOps, m: int, approx: str = "fitc",
                           hyper=None, prior: bool = True, mask=None):
    """Sparse Hadamard log-posterior: the exact Hadamard SVC's priors over the
    Z-latents (GP priors on ℓ̃ and the raw L-vector columns, the
    unnormalized inverse-gamma noise prior and its exp Jacobian;
    ``models.gnmgp.log_posterior_hadamard``).  Returns ``(logpos,
    components)``."""
    hp = {**HADAMARD_DEFAULT_HYPERS, **(hyper or {})}
    m_z = ops.z.shape[0]
    loglik = log_lik_hadamard(p, data, ops, m, approx=approx, hyper=hp, mask=mask)
    sigma2_err = torch.exp(p.tilde_sigma2_err)
    lp_l = dists.mvn_logpdf_chol(p.tilde_l_z, hp["mu_tilde_l"], ops.pc_l_z)
    lp_L = torch.sum(dists.mvn_logpdf_chol(p.ul_vecs_z.reshape(m_z, -1).T, hp["mu_L"], ops.pc_ul_z))
    lp_s2 = dists.inverse_gamma_logpdf_u(sigma2_err, alpha=hp["a"], beta=hp["b"])
    res = loglik
    if prior:
        res = res + lp_l + lp_L + lp_s2 + p.tilde_sigma2_err
    comps = {"loglik": loglik, "log_prior_tilde_l": lp_l, "log_prior_L_vecs": lp_L, "log_prior_sigma2_err": lp_s2}
    return res, comps


def hadamard_inducing(data: HadamardData, z, n_inducing: int, mask=None) -> torch.Tensor:
    """``z``, or by default ``choose_inducing`` over the real (unmasked)
    inputs.  The Hadamard layout repeats a time once per observed channel
    and ``choose_inducing`` keeps one of each, so m_z can come back below
    ``n_inducing``."""
    if z is not None:
        return z
    x_real = data.x if mask is None else data.x[: int(torch.as_tensor(mask).sum())]
    return choose_inducing(x_real, min(n_inducing, x_real.shape[0]))


def make_objective_hadamard(data: HadamardData, m: int, z=None, n_inducing: int = 64, hyper: dict | None = None,
                            approx: str = "fitc", prior: bool = True, mask=None):
    """Sparse Hadamard negative-log-posterior closure: ``(nlp, ops)`` as
    :func:`make_objective`, for a :class:`~.base.HadamardData` with ``m``
    tasks; the vector has ``n_params(m_z, m)`` slots for the m_z inducing
    inputs that come back in ``ops.z``."""
    if approx not in ("fitc", "vfe"):
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    hp = {**HADAMARD_DEFAULT_HYPERS, **(hyper or {})}
    ops = make_ops(data.x, hadamard_inducing(data, z, n_inducing, mask), hp)
    m_z = ops.z.shape[0]

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hadamard(unpack(vec, m_z, m), data, ops, m, approx=approx, hyper=hp, prior=prior,
                                        mask=mask)
        return -res

    return nlp, ops


# ---------------------------------------------------------------------------
# The heteroscedastic tier: a per-(input, task) noise GP, also at Z.
# ---------------------------------------------------------------------------

#: The hetero defaults, as ``models/gnmgp_hetero.py``'s: the noise GP
#: replaces the inverse-gamma prior.
HETERO_DEFAULT_HYPERS = {k: v for k, v in DEFAULT_HYPERS.items() if k not in ("a", "b")}
HETERO_DEFAULT_HYPERS.update({"mu_err": 0.0, "alpha_err": 1.0, "beta_err": 1.0})


class SparseHeteroOps(NamedTuple):
    """:class:`SparseOps` and the noise process's kriging projection and prior
    factor at Z."""

    base: SparseOps
    proj_err: torch.Tensor  # (m_z, N)
    pc_err_z: dists.TriInv  # the noise-GP prior Gram at Z


def n_params_hetero(m_z: int, m: int) -> int:
    return m_z + m_z * transforms.tri_size(m) + m_z * m


def unpack_hetero(vec: torch.Tensor, m_z: int, m: int):
    """Layout ``[tilde_l_z(m_z), uL_vecs_z(m_z·T), tilde_sigma2_err_z(m_z·M
    task-major)]``: ``models/gnmgp_hetero.py``'s with N → m_z, as its
    ``Params``."""
    from .gnmgp_hetero import Params as HeteroParams

    t = transforms.tri_size(m)
    check_vec(vec, m_z + m_z * t + m_z * m, "gnmgp_hetero_sparse",
              f"[tilde_l_z({m_z}), uL_vecs_z({m_z}*{t}), tilde_sigma2_err_z({m_z}*{m})] for m_z={m_z}, M={m}")
    return HeteroParams(tilde_l=vec[:m_z], ul_vecs=vec[m_z : m_z + m_z * t], tilde_sigma2_err=vec[m_z + m_z * t :])


def make_ops_hetero(x: torch.Tensor, z: torch.Tensor, hyper: dict | None = None) -> SparseHeteroOps:
    """:func:`make_ops` and the noise GP's projection and prior factor at Z,
    on ``x``'s device in ``x``'s dtype."""
    from ..predict.latent import krige_proj

    hp = {**HETERO_DEFAULT_HYPERS, **(hyper or {})}
    base = make_ops(x, z, hp)
    proj_err, _ = krige_proj(base.z, x, hp["alpha_err"], hp["beta_err"])
    return SparseHeteroOps(base, proj_err, chol.prior_rbf_inv(base.z, hp["alpha_err"], hp["beta_err"]))


def noise_at_data(p, ops_h: SparseHeteroOps, m: int, hyper=None) -> torch.Tensor:
    """The kriged task-major (N·M,) log-noise field at the data inputs."""
    hp = {**HETERO_DEFAULT_HYPERS, **(hyper or {})}
    err_mat_z = p.tilde_sigma2_err.reshape(m, ops_h.base.z.shape[0])  # task-major rows
    return (hp["mu_err"] + (err_mat_z - hp["mu_err"]) @ ops_h.proj_err).reshape(-1)


def _base_params(p) -> SparseParams:
    """The hetero parameters as :class:`SparseParams` (the scalar noise slot
    unused)."""
    return SparseParams(p.tilde_l, p.ul_vecs, torch.zeros((), dtype=p.tilde_l.dtype, device=p.tilde_l.device))


def log_lik_hetero(p, data: FullData, ops_h: SparseHeteroOps, approx: str = "fitc", hyper=None,
                   mask=None) -> torch.Tensor:
    """Sparse heteroscedastic marginal log-likelihood: the Nyström structure of
    :func:`log_lik` with the per-slot noise diagonal ``exp(kriged log-noise)``;
    under VFE the penalty is the per-slot ``−corr_i / (2 λ_i)``."""
    m = data.y.shape[1]
    noise = torch.exp(noise_at_data(p, ops_h, m, hyper))  # (N·M,)
    pieces = _assemble_full(_base_params(p), data, ops_h.base, m, hyper, mask)
    return _loglik_pieces(pieces, noise, approx)


def _woodbury_noise(sp_p: SparseParams, data: FullData, ops: SparseOps, m: int, approx: str, noise: torch.Tensor,
                    hyper=None, mask=None) -> _Woodbury:
    """:func:`_woodbury` with an explicit per-slot noise diagonal."""
    k_mm, k_nm, k_diag, y_flat, mv = _assemble_full(sp_p, data, ops, m, hyper, mask)
    return _woodbury_core(k_mm, k_nm, k_diag, y_flat, noise, approx, mv)


def log_posterior_hetero(p, data: FullData, ops_h: SparseHeteroOps, approx: str = "fitc", hyper=None,
                         prior: bool = True, mask=None):
    """Sparse hetero log-posterior: the exact hetero model's priors at Z (GP
    priors on ``tilde_l``, the L-entry columns and each task's log-noise
    row, and the exp Jacobian summed over the noise slots).  The L-entry and
    noise priors are batched: one product with the hoisted prior factor for
    all their series.  Returns ``(logpos, components)``."""
    hp = {**HETERO_DEFAULT_HYPERS, **(hyper or {})}
    m_z = ops_h.base.z.shape[0]
    m = data.y.shape[1]
    t = transforms.tri_size(m)
    loglik = log_lik_hetero(p, data, ops_h, approx=approx, hyper=hp, mask=mask)
    lp_l = dists.mvn_logpdf_chol(p.tilde_l, hp["mu_tilde_l"], ops_h.base.pc_l_z)
    lp_ul = torch.sum(dists.mvn_logpdf_chol(p.ul_vecs.reshape(m_z, t).T, hp["mu_L"], ops_h.base.pc_ul_z))
    lp_err = torch.sum(dists.mvn_logpdf_chol(p.tilde_sigma2_err.reshape(m, m_z), hp["mu_err"], ops_h.pc_err_z))
    res = loglik
    if prior:
        res = res + lp_l + lp_ul + lp_err + torch.sum(p.tilde_sigma2_err)
    comps = {"loglik": loglik, "log_prior_tilde_l": lp_l, "log_prior_uL_vecs": lp_ul,
             "log_prior_sigma2_err": lp_err}
    return res, comps


def make_objective_hetero(data: FullData, z=None, n_inducing: int = 64, hyper: dict | None = None,
                          approx: str = "fitc", prior: bool = True, mask=None):
    """Sparse hetero negative-log-posterior closure: ``(nlp, ops_h)``."""
    check_full_data(data, "gnmgp_hetero_sparse")
    if approx not in ("fitc", "vfe"):
        raise ValueError(f"approx must be 'fitc' or 'vfe', got {approx!r}")
    hp = {**HETERO_DEFAULT_HYPERS, **(hyper or {})}
    if z is None:
        x_real = data.x if mask is None else data.x[: int(torch.as_tensor(mask).sum())]
        z = choose_inducing(x_real, min(n_inducing, x_real.shape[0]))
    ops_h = make_ops_hetero(data.x, z, hp)
    m_z, m = ops_h.base.z.shape[0], data.y.shape[1]

    def nlp(vec: torch.Tensor) -> torch.Tensor:
        res, _ = log_posterior_hetero(unpack_hetero(vec, m_z, m), data, ops_h, approx=approx, hyper=hp,
                                      prior=prior, mask=mask)
        return -res

    return nlp, ops_h


def make_ops_traced_hetero(x: torch.Tensor, z: torch.Tensor, hyper: dict | None = None) -> SparseHeteroOps:
    """Differentiable-in-Z :class:`SparseHeteroOps` (see
    :func:`make_ops_traced`): the base pieces and the noise GP's kriging
    projection and prior factor, all in the graph."""
    hp = {**HETERO_DEFAULT_HYPERS, **(hyper or {})}
    base = make_ops_traced(x, z, hp)
    proj_err, c_err = _traced_pieces(x, base.z, hp["alpha_err"], hp["beta_err"])
    return SparseHeteroOps(base, proj_err, c_err)


# ---------------------------------------------------------------------------
# Inducing-input refinement
# ---------------------------------------------------------------------------


def _refine_builders(model: str, hadamard: bool):
    """Each sparse model's pieces for :func:`refine_inducing`:
    ``(default_hypers, traced_ops(x, z, hp), unpack(vec, m_z, m),
    logpost(p, data, ops, m, **kw), objective(data, m, **kw))``.

    Every sparse model is differentiable in Z: the GNMGP family through its
    traced kriging projections, the separable family through its traced
    projections and K1 at Z, the stationary LMC directly (its ops are Z)."""
    from . import lmc_sparse as lsp
    from . import snmgp_sparse as ssp
    from .lmc import DEFAULT_HYPERS as LMC_HYPERS
    from .snmgp import DEFAULT_HYPERS as SNMGP_HYPERS

    if model == "gnmgp_hetero_sparse":
        if hadamard:
            raise ValueError("gnmgp_hetero_sparse has no Hadamard objective")
        return (HETERO_DEFAULT_HYPERS, make_ops_traced_hetero, unpack_hetero,
                lambda p, d, o, m, **kw: log_posterior_hetero(p, d, o, **kw),
                lambda d, m, **kw: make_objective_hetero(d, **kw))
    # (default hypers, traced ops, unpack(vec, m_z, m), (log posterior, objective) of the full layout, of the
    # Hadamard one)
    tiers = {
        "gnmgp_sparse": (HADAMARD_DEFAULT_HYPERS if hadamard else DEFAULT_HYPERS, make_ops_traced, unpack,
                         (log_posterior, make_objective), (log_posterior_hadamard, make_objective_hadamard)),
        "snmgp_sparse": (SNMGP_HYPERS, ssp.make_ops_traced, ssp.unpack, (ssp.log_posterior, ssp.make_objective),
                         (ssp.log_posterior_hadamard, ssp.make_objective_hadamard)),
        # the stationary tier's ops are the inducing set: traced as they are
        "lmc_sparse": (LMC_HYPERS, lambda x, z, hp: lsp.SparseOps(z), lambda vec, m_z, m: lsp.unpack(vec, m),
                       (lsp.log_posterior, lsp.make_objective), (lsp.log_posterior_hadamard,
                                                                 lsp.make_objective_hadamard)),
    }
    if model not in tiers:
        raise ValueError(f"unknown sparse model {model!r}")
    hypers, traced, unpack_fn, full, had = tiers[model]
    if hadamard:
        return (hypers, traced, unpack_fn, *had)
    logpost, objective = full
    return (hypers, traced, unpack_fn, lambda p, d, o, m, **kw: logpost(p, d, o, **kw),
            lambda d, m, **kw: objective(d, **kw))


def _z_objective(data, m_z: int, m, hyper, approx: str, prior: bool, mask, hypers_base, model: str):
    """``(m, nlp_z(z, vec), objective(data, m, **kw))``: the task count, the
    traced negative log posterior as a function of Z (and the latents) that
    :func:`refine_inducing` descends, and the model's objective builder."""
    hadamard = isinstance(data, HadamardData)
    base_default, traced_ops, unpack_fn, logpost_fn, objective_fn = _refine_builders(model, hadamard)
    hp = {**(hypers_base if hypers_base is not None else base_default), **(hyper or {})}
    if hadamard:
        if m is None:
            raise ValueError("refine_inducing on Hadamard data needs the task count m")
        m = int(m)
    else:
        m = int(data.y.shape[1])

    def nlp_z(z, vec):
        res, _ = logpost_fn(unpack_fn(vec, m_z, m), data, traced_ops(data.x, z, hp), m, approx=approx, hyper=hp,
                            prior=prior, mask=mask)
        return -res

    return m, nlp_z, objective_fn


#: Adam's constants for the Z-steps (optax's ``adam`` defaults).
_Z_B1, _Z_B2, _Z_EPS = 0.9, 0.999, 1e-8


def refine_inducing(data, z0, vec0, n_rounds: int = 2, z_iters: int = 40, vec_iters: int = 200,
                    lr_z: float = 5e-3, lr_vec: float = 2e-1, hyper: dict | None = None, approx: str = "fitc",
                    prior: bool = True, mask=None, method: str = "adam", hypers_base: dict | None = None,
                    m: int | None = None, model: str = "gnmgp_sparse"):
    """Alternating inducing-input refinement: move Z down the objective.

    The FITC/VFE objective is differentiable in Z (:func:`make_ops_traced` and
    each model's counterpart, :func:`_refine_builders`), so at small m_z the
    fidelity a fixed quantile grid loses can be bought back by moving the
    inducing inputs rather than adding more.  Each round takes ``z_iters``
    plain Adam steps on Z at fixed latents (optax's ``adam(lr_z)``; a
    non-finite gradient entry counts as 0; Z clipped to the data's range),
    one host-free loop on Z's device, then on the host re-sorts Z, pulls
    apart inputs closer than ``1e-6·(max x − min x)``, rebuilds the
    objective at the new Z and refits the latents by ``map.fit_map`` (the
    standard, hoisted ops).  Returns ``(z, vec, ops, final_nlp)`` with
    ``ops`` rebuilt at the refined Z.

    ``model`` picks the sparse family (``gnmgp_sparse``,
    ``gnmgp_hetero_sparse``, ``snmgp_sparse``, ``lmc_sparse``);
    ``hypers_base`` replaces its default hyper table.  The layout is read
    from ``data``'s type: :class:`~.base.HadamardData` (which needs ``m``)
    or :class:`~.base.FullData`."""
    from ..inference import map as map_mod

    x = data.x
    m, nlp_z, objective_fn = _z_objective(data, int(np.shape(z0)[0]), m, hyper, approx, prior, mask, hypers_base,
                                          model)
    lo, hi = float(x.min()), float(x.max())
    z = torch.as_tensor(z0, dtype=x.dtype, device=x.device)
    vec = torch.as_tensor(vec0, dtype=x.dtype, device=x.device).detach()
    m_z = int(z.shape[0])

    def z_descent(z_, vec_):
        mu, nu = torch.zeros_like(z_), torch.zeros_like(z_)
        for count in range(1, z_iters + 1):
            with torch.enable_grad():
                zc = z_.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(nlp_z(zc, vec_), zc)
            g = torch.where(torch.isfinite(g), g, 0.0)
            mu = (1 - _Z_B1) * g + _Z_B1 * mu
            nu = (1 - _Z_B2) * g**2 + _Z_B2 * nu
            upd = mu / (1 - _Z_B1**count) / (torch.sqrt(nu / (1 - _Z_B2**count)) + _Z_EPS) * -lr_z
            z_ = torch.clamp(z_ + upd, lo, hi)
        return z_

    final_nlp = ops = None
    for _ in range(max(1, int(n_rounds))):
        # re-sort and de-collide: the kriging Gram at Z degenerates where two
        # inducing inputs coincide
        z_np = np.sort(z_descent(z, vec).cpu().numpy().astype(np.float64))
        min_gap = 1e-6 * max(hi - lo, 1e-12)
        for i in range(1, m_z):
            if z_np[i] - z_np[i - 1] < min_gap:
                z_np[i] = z_np[i - 1] + min_gap
        z = torch.as_tensor(np.clip(z_np, lo, hi + m_z * min_gap), dtype=x.dtype, device=x.device)
        nlp, ops = objective_fn(data, m, z=z, hyper=hyper, approx=approx, prior=prior, mask=mask)
        res = map_mod.fit_map(nlp, vec, n_iters=vec_iters, lr=lr_vec, method=method)
        vec = res.vec
        with torch.no_grad():
            final_nlp = float(nlp(vec))
    return z, vec, ops, final_nlp
