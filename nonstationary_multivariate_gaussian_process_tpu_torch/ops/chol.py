"""Robust dense Cholesky solves with a deterministic jitter ladder.

Counterpart of the JAX package's ``ops/chol.py`` (``safe_cholesky``,
``tri_solve``, ``chol_solve``, ``chol_logdet``).  The reference's stochastic
retry loop (``Utility/logpos.py:267-268``) becomes a two-rung ladder: the
plain factor, then — only when it failed — one retry with jitter
``fallback · mean(diag)``.

JAX signals a failed factorization with NaNs; ``torch.linalg.cholesky_ex``
returns an ``info`` code and a partly filled factor instead, so the ladder is
driven from ``info != 0``.  A factor that fails even after the retry comes
back as NaNs, as in JAX, so the caller sees it rather than a partial matrix.
"""

from __future__ import annotations

import torch

from .. import settings

#: Relative fallback jitter (fraction of the mean diagonal) when the plain
#: Cholesky fails: f64 keeps the reference-scale 1e-4; f32 needs ~1e-3.
FALLBACK_REL_F64 = 1e-4
FALLBACK_REL_F32 = 1e-3


def _cholesky(a: torch.Tensor) -> tuple[torch.Tensor, bool]:
    chol, info = torch.linalg.cholesky_ex(a)
    return chol, bool((info == 0).all())


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
        fallback = FALLBACK_REL_F32 if a.dtype == torch.float32 else FALLBACK_REL_F64
        scale = torch.mean(torch.diagonal(a, dim1=-2, dim2=-1))
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        chol, ok = _cholesky(a + (fallback * scale) * eye)
    if not ok:
        chol = torch.full_like(a, float("nan"))
    return chol


def tri_solve(l: torch.Tensor, b: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """``L⁻¹ b`` (or ``L⁻ᵀ b`` with ``trans``) for lower-triangular ``L``.

    ``b`` may be (n,) or (n, k).
    """
    vec = b.dim() == 1
    rhs = b[:, None] if vec else b
    if trans:
        out = torch.linalg.solve_triangular(l.mT, rhs, upper=True)
    else:
        out = torch.linalg.solve_triangular(l, rhs, upper=False)
    return out[:, 0] if vec else out


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given the lower factor ``chol`` of ``A``; b (n,) or (n, k)."""
    vec = b.dim() == 1
    out = torch.cholesky_solve(b[:, None] if vec else b, chol, upper=False)
    return out[:, 0] if vec else out


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """``logdet(A)`` from its Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
