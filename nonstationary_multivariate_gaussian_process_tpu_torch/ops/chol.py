"""Robust dense Cholesky solves with a deterministic jitter ladder.

Counterpart of the JAX package's ``ops/chol.py`` (``safe_cholesky``,
``tri_solve``, ``chol_solve``, ``chol_logdet``, ``psd_logdet_quad``,
``psd_solve``, their batched forms over a leading member axis
(``safe_cholesky_batched``, ``psd_logdet_quad_batched``: JAX's functions
under ``vmap``), the host-side prior factors ``prior_cholesky``,
``prior_rbf_cholesky``, ``prior_rbf_inv``, and the precision tier's routes:
the blocked product-based factor and solves behind ``NMGP_BLOCKED_CHOL=1``,
the loop-free small factors behind ``NMGP_UNROLLED_CHOL``, and the mixed
logdet/quadratic form behind ``NMGP_PRECISION=mixed``).  The reference's
stochastic retry loop (``Utility/logpos.py:267-268``) becomes a two-rung
ladder: the plain factor, then — only when it failed — one retry with jitter
``fallback · mean(diag)``.

JAX signals a failed factorization with NaNs; ``torch.linalg.cholesky_ex``
returns an ``info`` code and a partly filled factor instead, so the ladder is
driven from ``info != 0`` (from non-finite entries on the blocked and
unrolled routes, whose failed tiles are NaNs).  A factor that fails even
after the retry comes back as NaNs, as in JAX, so the caller sees it rather
than a partial matrix.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import settings
from . import blocked, mixed

#: Relative fallback jitter (fraction of the mean diagonal) when the plain
#: Cholesky fails: f64 keeps the reference-scale 1e-4; f32 needs ~1e-3.
FALLBACK_REL_F64 = 1e-4
FALLBACK_REL_F32 = 1e-3

#: float64 factorizations and solves of at least this size take the blocked
#: routes (ops/blocked.py) when NMGP_BLOCKED_CHOL=1 (off by default, as in
#: the JAX package; on the H100 cuSOLVER's factor is faster, PERF.md).
BLOCKED_MIN_N = 512
_BLOCKED_ENABLED = os.environ.get("NMGP_BLOCKED_CHOL", "0") not in ("0", "false")

#: Minimum size for the mixed-precision logdet + quadratic form.
MIXED_MIN_N = 192

#: Small float64 factors (n <= UNROLLED_MAX_N) take the loop-free recursive
#: kernels of ops/blocked.py when NMGP_UNROLLED_CHOL=1; "0" never.  "auto"
#: (default) decides by the tensor's device from the measured A/B
#: (``PERF.md``): LAPACK wins on the CPU, and on the H100 cuSOLVER's factor
#: and cuBLAS's ``trsm`` beat the eager recursion at every n <= 512.
UNROLLED_MAX_N = 512
_UNROLLED = os.environ.get("NMGP_UNROLLED_CHOL", "auto").lower()
_UNROLLED_AUTO = {"cpu": False, "cuda": False}


def use_unrolled(a: torch.Tensor) -> bool:
    """True when the loop-free small-factor kernels should serve ``a``."""
    if a.dtype != torch.float64 or a.dim() != 2 or a.shape[-1] > UNROLLED_MAX_N:
        return False
    if _UNROLLED == "auto":
        return _UNROLLED_AUTO.get(a.device.type, False)
    return _UNROLLED not in ("0", "false")


def _use_blocked(a: torch.Tensor) -> bool:
    return _BLOCKED_ENABLED and a.dtype == torch.float64 and a.shape[-1] >= BLOCKED_MIN_N


def _fallback(a: torch.Tensor) -> float:
    return FALLBACK_REL_F32 if a.dtype == torch.float32 else FALLBACK_REL_F64


def _jittered(a: torch.Tensor, fallback: float) -> torch.Tensor:
    scale = torch.mean(torch.diagonal(a, dim1=-2, dim2=-1))
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return a + (fallback * scale) * eye


def _cholesky(a: torch.Tensor) -> tuple[torch.Tensor, bool]:
    if _use_blocked(a):
        chol = blocked.blocked_cholesky(a)
        return chol, bool(torch.isfinite(chol).all())
    chol, info = torch.linalg.cholesky_ex(a)
    return chol, bool((info == 0).all())


def best_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor by the route for the dtype and size (the blocked one
    when enabled); NaNs when it fails."""
    chol, ok = _cholesky(a)
    return chol if ok else a * float("nan")


def safe_cholesky_unrolled(a: torch.Tensor, fallback: float | None = None) -> torch.Tensor:
    """:func:`safe_cholesky`'s jitter ladder over ``blocked.unrolled_cholesky``:
    the retry runs only when the plain factor is not finite."""
    chol = blocked.unrolled_cholesky(a)
    if bool(torch.isfinite(chol).all()):
        return chol
    return blocked.unrolled_cholesky(_jittered(a, _fallback(a) if fallback is None else fallback))


def robust_cholesky_small(a: torch.Tensor) -> torch.Tensor:
    """Jitter-ladder factor of a small Gram: the loop-free kernel where
    :func:`use_unrolled` says so, else :func:`safe_cholesky` with the ladder
    forced on."""
    if use_unrolled(a):
        return safe_cholesky_unrolled(a)
    return safe_cholesky(a, force_robust=True)


def tri_solve_small(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L⁻¹ b`` by the explicit loop-free inverse where :func:`use_unrolled`
    says so (one product), else :func:`tri_solve`."""
    if use_unrolled(l):
        return blocked.unrolled_tri_inv(l) @ b
    return tri_solve(l, b)


def safe_cholesky(a: torch.Tensor, force_robust: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric PSD matrix with jitter escalation.

    The retry runs only when the plain factor failed, with jitter
    ``fallback · mean(diag(a))``, ``fallback`` being :data:`FALLBACK_REL_F64`
    or :data:`FALLBACK_REL_F32` by dtype.  With
    ``settings.robust_cholesky`` off and ``force_robust`` unset there is no
    retry.  A factor that still fails is returned as NaNs.
    """
    chol, ok = _cholesky(a)
    if not ok and (settings.robust_cholesky or force_robust):
        chol, ok = _cholesky(_jittered(a, _fallback(a)))
    if not ok:
        # NaNs that keep a's autograd link, so the gradient through a failed
        # factor is NaN too, as JAX's is: a sampler's trajectory that leaves
        # the positive-definite region then ends non-finite and is rejected
        chol = a * float("nan")
    return chol


def safe_cholesky_batched(a: torch.Tensor, force_robust: bool = False) -> torch.Tensor:
    """:func:`safe_cholesky` of each member of a batch ``a`` (B, n, n), with
    the ladder per member, as JAX's ``safe_cholesky`` runs under ``vmap``:
    a member whose plain factor succeeds keeps it (its retry jitter is 0);
    a failed one is refactored alone with jitter ``fallback · mean(diag)``
    of its own diagonal; one that fails again comes back as NaNs, its
    gradient NaN too, and no other member changes.

    The plain factors of the whole batch are one ``cholesky_ex`` and its
    ``info`` is read once; only the failed members are factored again.
    Their plain factors are partial matrices, whose autograd terms are
    replaced by zeros (they take no part in the result) so that no NaN of
    theirs reaches the gradient of the input.  No blocked route.
    """
    a_in = a.view_as(a) if a.requires_grad else a
    chol, info = torch.linalg.cholesky_ex(a_in)
    bad = info != 0
    idx = torch.nonzero(bad).flatten()  # the one read of info
    if idx.numel() == 0:
        return chol
    if a_in.requires_grad:
        zero_bad = lambda g: torch.where(bad[:, None, None], torch.zeros_like(g), g)
        a_in.register_hook(zero_bad)
    sub = a[idx]
    if settings.robust_cholesky or force_robust:
        scale = torch.mean(torch.diagonal(sub, dim1=-2, dim2=-1), dim=-1)
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        retry, info2 = torch.linalg.cholesky_ex(sub + (_fallback(a) * scale)[:, None, None] * eye)
        # NaNs, and NaN gradients, where the retry failed too (a product,
        # not a where: the untaken side of a where would send its zero
        # cotangent through a NaN factor into the members that succeeded)
        ones = torch.ones_like(scale)
        retry = retry * torch.where(info2 != 0, ones * float("nan"), ones)[:, None, None]
    else:
        retry = sub * float("nan")
    return chol.index_put((idx,), retry)


def psd_logdet_quad_batched(a: torch.Tensor, y: torch.Tensor):
    """``(logdet A_i, yᵀ A_i⁻¹ y)`` (each (B,)) for a batch ``a`` (B, n, n)
    and one ``y`` (n,) or one per member (B, n), through
    :func:`safe_cholesky_batched`: :func:`psd_logdet_quad` of each member
    (never the mixed route)."""
    c = safe_cholesky_batched(a)
    rhs = y.expand(a.shape[:-1]).unsqueeze(-1)
    sol = torch.linalg.solve_triangular(c, rhs, upper=False)[..., 0]
    return chol_logdet(c), torch.sum(sol * sol, dim=-1)


def tri_solve(l: torch.Tensor, b: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """``L⁻¹ b`` (or ``L⁻ᵀ b`` with ``trans``) for lower-triangular ``L``.

    ``b`` may be (n,) or (n, k).  Blocked substitution where enabled.
    """
    if _use_blocked(l):
        return blocked.blocked_trsm(l, b, trans)
    vec = b.dim() == 1
    rhs = b[:, None] if vec else b
    if trans:
        out = torch.linalg.solve_triangular(l.mT, rhs, upper=True)
    else:
        out = torch.linalg.solve_triangular(l, rhs, upper=False)
    return out[:, 0] if vec else out


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given the lower factor ``chol`` of ``A``; b (n,) or (n, k)."""
    if _use_blocked(chol):
        return blocked.blocked_chol_solve(chol, b)
    vec = b.dim() == 1
    out = torch.cholesky_solve(b[:, None] if vec else b, chol, upper=False)
    return out[:, 0] if vec else out


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """``logdet(A)`` from its Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def psd_logdet_quad(a: torch.Tensor, y: torch.Tensor):
    """``(logdet A, yᵀ A⁻¹ y)`` via one robust Cholesky (the reference's dense
    ``torch.inverse`` + ``torch.logdet`` pair, ``Utility/logpos.py:352-353``).

    With ``settings.mixed_solves``, a float64 ``a`` of at least
    :data:`MIXED_MIN_N` and a 1-D ``y`` take ``mixed.mixed_logdet_quad``.
    """
    if settings.mixed_solves and a.dtype == torch.float64 and a.shape[-1] >= MIXED_MIN_N and y.dim() == 1:
        return mixed.mixed_logdet_quad(a, y)
    c = safe_cholesky(a)
    sol = tri_solve(c, y)
    return chol_logdet(c), torch.sum(sol * sol, dim=-1)


def psd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for symmetric PSD ``A`` with the robust Cholesky."""
    return chol_solve(safe_cholesky(a), b)


# ---------------------------------------------------------------------------
# Host-side float64 factors of loop-invariant prior Grams
# ---------------------------------------------------------------------------
#
# Smooth-RBF prior covariances are badly conditioned (spectra spanning ~1e18
# without the nugget), so their Grams are built and factored once per
# objective on the host in numpy float64 and moved to the tensors' device in
# the working dtype — as the JAX package does outside ``jit``.


def _host_chol_ladder(host: np.ndarray) -> np.ndarray:
    """numpy-f64 Cholesky with escalating relative jitter."""
    scale = float(np.mean(np.diag(host)))
    for rel in (0.0, 1e-10, 1e-8, 1e-6, 1e-4, 1e-3, 1e-2):
        try:
            return np.linalg.cholesky(host + rel * scale * np.eye(host.shape[0]))
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError("prior covariance is not positive definite")


def prior_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Host float64 Cholesky of a prior Gram with the jitter ladder, returned
    on ``a``'s device in ``a``'s dtype."""
    c = _host_chol_ladder(a.detach().to("cpu", torch.float64).numpy())
    return torch.as_tensor(c, dtype=a.dtype, device=a.device)


def _host_rbf_gram(x: torch.Tensor, alpha, beta) -> np.ndarray:
    """The RBF prior Gram with its self-nugget, built in float64 on the host
    from the raw inputs (reference ``RBF_cov``, kernels.py:24-43)."""
    x64 = x.detach().to("cpu", torch.float64).numpy()
    d2 = (x64[:, None] - x64[None, :]) ** 2
    return alpha**2 * np.exp(-0.5 * d2 / beta**2) + settings.jitter * np.eye(len(x64))


def prior_rbf_cholesky(x: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Lower factor of the RBF prior Gram of ``x``, built and factored on the
    host in float64, returned on ``x``'s device in ``x``'s dtype."""
    c = _host_chol_ladder(_host_rbf_gram(x, alpha, beta))
    return torch.as_tensor(c, dtype=x.dtype, device=x.device)


def prior_rbf_eig(x: torch.Tensor, alpha, beta):
    """Eigendecomposition ``(U, s)`` of the RBF prior Gram of ``x``: the
    orthogonal basis and the per-direction prior standard deviations, the
    eigenvalues floored at the jitter before the square root.  Built and
    decomposed with numpy's ``eigh`` on the host in float64, as the JAX
    package does: the spectrum has a large cluster at the floor whose basis
    is arbitrary, and only the same LAPACK call on the same Gram gives the
    same basis.  Returned on ``x``'s device in ``x``'s dtype."""
    eigs, u = np.linalg.eigh(_host_rbf_gram(x, alpha, beta))
    s = np.sqrt(np.maximum(eigs, settings.jitter))
    as_t = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return as_t(u), as_t(s)


def prior_rbf_inv(x: torch.Tensor, alpha, beta):
    """The RBF prior Gram of ``x`` as a hoisted ``dists.TriInv``: the inverse
    of its lower factor and its logdet, computed on the host in float64 and
    returned on ``x``'s device in ``x``'s dtype."""
    import scipy.linalg

    from ..dists import TriInv

    c = _host_chol_ladder(_host_rbf_gram(x, alpha, beta))
    w = scipy.linalg.solve_triangular(c, np.eye(c.shape[0]), lower=True)
    logdet = 2.0 * float(np.sum(np.log(np.diag(c))))
    as_t = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)
    return TriInv(as_t(w), as_t(logdet))
