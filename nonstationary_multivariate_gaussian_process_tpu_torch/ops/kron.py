"""Kronecker-structured linear algebra for ``σ² I + B ⊗ K``.

Counterpart of the JAX package's ``ops/kron.py`` (reference
``Utility/kronecker_operation.py``).  With ``eigh(B) = (w_B, v_B)`` (B is
only M×M),

    σ²I + B⊗K  =  (v_B ⊗ I) diag_m(σ²I + w_B[m] K) (v_B ⊗ I)ᵀ

so the solve and the logdet reduce to M independent N×N Cholesky
factorizations, here one batched ``torch.linalg.cholesky_ex`` call.  A block
that fails to factor comes back as NaNs, as ``jnp.linalg.cholesky`` does, so
the value turns non-finite and the optimizer's guard sees it; the check needs
no host synchronization.  With ``settings.mixed_solves`` and float64 blocks
of at least ``chol.MIXED_MIN_N``, the M blocks go through one batched
``mixed.mixed_logdet_quad`` instead.
"""

from __future__ import annotations

import torch

from .. import settings
from . import chol as _chol
from . import mixed as _mixed


def kron_mv(b: torch.Tensor, k: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(B ⊗ K) y`` without the MN×MN matrix; ``y`` task-major (reference
    kronecker_operation.py:72-85)."""
    m2 = b.shape[1]
    n2 = k.shape[1]
    yt = y.reshape(m2, n2).T  # (N2, M2)
    a = k @ yt @ b.T  # (N1, M1)
    return a.T.reshape(-1)


def kron_chol_factors(b: torch.Tensor, k: torch.Tensor, sigma2):
    """Factor ``σ²I + B ⊗ K`` into ``(w_B, v_B, chols)`` with
    ``chols[m] = chol(σ²I + w_B[m] K)``, one batched Cholesky over the M
    rotated blocks."""
    w_b, v_b = torch.linalg.eigh(b)
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    blocks = w_b[:, None, None] * k[None] + sigma2 * eye[None]
    chols, info = torch.linalg.cholesky_ex(blocks)
    chols = torch.where((info == 0)[:, None, None], chols, torch.nan)
    return w_b, v_b, chols


def kron_chol_logdet_quad(b, k, sigma2, y, mask=None):
    """``(logdet Σ, yᵀ Σ⁻¹ y)`` for ``Σ = σ²I + B⊗K`` and task-major ``y`` (M·N,).

    ``mask`` (N,) boolean marks real inputs of a padded subject: masked rows
    and columns of K are zeroed with a unit diagonal, masked observations
    zeroed, and the padded slots' analytic contribution (``log(w_B[m] + σ²)``
    per slot and rotated block) subtracted, so the result equals the unpadded
    computation.
    """
    m = b.shape[0]
    n = k.shape[0]
    if mask is not None:
        mv = torch.as_tensor(mask, device=k.device).to(k.dtype)
        k = k * (mv[:, None] * mv[None, :]) + torch.diag(1.0 - mv)
        y = y * mv.repeat(m)
    if settings.mixed_solves and k.dtype == torch.float64 and n >= _chol.MIXED_MIN_N:
        w_b, v_b = torch.linalg.eigh(b)
        eye = torch.eye(n, dtype=k.dtype, device=k.device)
        blocks = w_b[:, None, None] * k[None] + sigma2 * eye[None]
        lds, quads = _mixed.mixed_logdet_quad(blocks, v_b.T @ y.reshape(m, n))
        logdet, quad = torch.sum(lds), torch.sum(quads)
    else:
        w_b, v_b, chols = kron_chol_factors(b, k, sigma2)
        z = v_b.T @ y.reshape(m, n)  # rotate the task axis: (M, N)
        sol = torch.linalg.solve_triangular(chols, z[:, :, None], upper=False)[:, :, 0]
        quad = torch.sum(sol * sol)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)))
    if mask is not None:
        n_pad = n - torch.sum(mv)
        logdet = logdet - n_pad * torch.sum(torch.log(w_b + sigma2))
    return logdet, quad


def kron_solve(b, k, sigma2, y) -> torch.Tensor:
    """Solve ``(σ²I + B⊗K) x = y`` (task-major ``y``) by the rotated Cholesky path."""
    m = b.shape[0]
    n = k.shape[0]
    _, v_b, chols = kron_chol_factors(b, k, sigma2)
    z = v_b.T @ y.reshape(m, n)
    sol = torch.cholesky_solve(z[:, :, None], chols, upper=False)[:, :, 0]
    return (v_b @ sol).reshape(-1)
