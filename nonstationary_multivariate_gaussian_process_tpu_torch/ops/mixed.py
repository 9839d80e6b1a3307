"""Mixed-precision PSD logdet + quadratic form with float64-accurate values.

Counterpart of the JAX package's ``ops/mixed.py`` (the ``NMGP_PRECISION=mixed``
tier).  The float32 Cholesky serves only as a preconditioner; float64
accuracy comes back through products and matrix-vector corrections:

* ``L = chol(f32(A))`` (with the f32 jitter rung), ``W = L⁻¹`` and
  ``G = WᵀW ≈ A⁻¹``, all in float32;
* **logdet**: the exact residual ``E = (A + jit·I) − LLᵀ`` in float64 (the
  one float64 n³ product), then the similarity-invariant series
  ``logdet = 2 Σ log diag L + tr(D) − tr(D²)/2 + tr(D³)/3`` with ``D = GE``,
  each trace a float64 pairing of float32 products;
* **quadratic form**: preconditioned iterative refinement, float64 residuals
  ``r = y − (A + jit·I) z`` corrected by ``z += Wᵀ(W r)`` in float32, until
  ``‖r‖² ≤ IR_RTOL²‖y‖²``, until the residual stops dropping below 2% of the
  previous one after two sweeps, or at ``IR_MAX_SWEEPS``.

The backward is the JAX package's custom VJP, ``Ā = ld̄·sym(G) − q̄·zzᵀ`` and
``ȳ = 2q̄z``: float32-class gradients by design (the values carry the float64
accuracy).

A leading batch dimension is allowed (JAX vmaps the function over the
Kronecker blocks).  Each batch member equals its own unbatched call: its
refinement stops at its own exit rule, as a lane of JAX's vmapped
``while_loop`` does; the loop freezes finished members on the device with
``torch.where`` and reads on the host whether any member is still running
every ``IR_CHECK_EVERY`` sweeps.
"""

from __future__ import annotations

import torch

from .. import settings
from .gram_kernels import first_order_only

#: Iterative-refinement cap for the quadratic form.
IR_MAX_SWEEPS = 20

#: Early exit: stop when ||r||² <= IR_RTOL² ||y||².
IR_RTOL = 1e-13

#: Relative diagonal jitter (of the mean f32 diagonal) for the f32 retry.
FALLBACK_REL = 1e-3

#: Sweeps between host reads of "is any member still refining": 1 reads
#: after every sweep; IR_MAX_SWEEPS never reads and runs every sweep with
#: finished members frozen.  The values are the same for every choice.
IR_CHECK_EVERY = 1


def _f32_factor(a64: torch.Tensor):
    """float32 Cholesky of ``a64`` (..., n, n) with the two-rung jitter ladder.

    Returns ``(l32, jit64)``: the factor (NaNs where a member failed to
    factor) and, per member, the float64 jitter applied, so the corrections
    target ``a64 + jit·I``.  With ``settings.robust_cholesky`` off there is no
    retry and the jitter is 0.
    """
    a32 = a64.to(torch.float32)
    l32, info = torch.linalg.cholesky_ex(a32)
    ok = info == 0
    jit32 = torch.zeros(ok.shape, dtype=torch.float32, device=a64.device)
    if settings.robust_cholesky and not bool(ok.all()):
        scale = torch.mean(torch.diagonal(a32, dim1=-2, dim2=-1), dim=-1)
        jit32 = torch.where(ok, 0.0, FALLBACK_REL * scale)
        eye = torch.eye(a64.shape[-1], dtype=torch.float32, device=a64.device)
        # members that factored take a zero jitter and get the same factor
        l32, info = torch.linalg.cholesky_ex(a32 + jit32[..., None, None] * eye)
        ok = info == 0
    # cholesky_ex leaves a partial factor where it failed; JAX's has NaNs
    l32 = torch.where(ok[..., None, None], l32, torch.nan)
    return l32, jit32.to(torch.float64)


def _refine(target, y64, w32):
    """``z ≈ target⁻¹ y64`` by preconditioned iterative refinement, each batch
    member stopping at its own exit rule (see the module docstring)."""
    def prec(r64):
        t = w32 @ r64.to(torch.float32)[..., None]
        return (w32.mT @ t)[..., 0].to(torch.float64)

    z = prec(y64)
    tol2 = IR_RTOL**2 * torch.sum(y64 * y64, dim=-1)
    r2_last = torch.full_like(tol2, torch.inf)
    r2_prev = torch.full_like(tol2, torch.inf)
    active = torch.ones_like(tol2, dtype=torch.bool)
    sweeps = torch.zeros_like(tol2, dtype=torch.int64)
    for it in range(IR_MAX_SWEEPS):
        contracting = (r2_last < 0.02 * r2_prev) if it >= 2 else True
        active = active & (r2_last > tol2) & contracting
        if it % IR_CHECK_EVERY == 0 and not bool(active.any()):
            break
        r = y64 - (target @ z[..., None])[..., 0]
        z = torch.where(active[..., None], z + prec(r), z)
        r2_prev = torch.where(active, r2_last, r2_prev)
        r2_last = torch.where(active, torch.sum(r * r, dim=-1), r2_last)
        sweeps = sweeps + active
    return z, sweeps


def _forward(a64: torch.Tensor, y64: torch.Tensor):
    """``(logdet, quad, z, g32, sweeps)`` for ``a64`` (..., n, n), ``y64`` (..., n)."""
    n = a64.shape[-1]
    l32, jit64 = _f32_factor(a64)
    eye32 = torch.eye(n, dtype=torch.float32, device=a64.device)
    w32 = torch.linalg.solve_triangular(l32, eye32.expand_as(l32), upper=False)
    g32 = w32.mT @ w32  # ≈ A⁻¹

    l64 = l32.to(torch.float64)
    eye64 = torch.eye(n, dtype=torch.float64, device=a64.device)
    target = a64 + jit64[..., None, None] * eye64
    e64 = target - l64 @ l64.mT  # the exact factorization residual

    # the series in the similar matrix X = G E (tr(D^k) = tr(X^k))
    x32 = g32 @ e64.to(torch.float32)
    x2 = x32 @ x32
    x64t = x32.mT.to(torch.float64)
    tr1 = torch.sum(g32.to(torch.float64) * e64, dim=(-2, -1))
    tr2 = torch.sum(x32.to(torch.float64) * x64t, dim=(-2, -1))
    tr3 = torch.sum(x2.to(torch.float64) * x64t, dim=(-2, -1))
    logdet = (
        2.0 * torch.sum(torch.log(torch.diagonal(l64, dim1=-2, dim2=-1)), dim=-1)
        + tr1 - 0.5 * tr2 + tr3 / 3.0
    )
    z, sweeps = _refine(target, y64, w32)
    quad = torch.sum(y64 * z, dim=-1)
    return logdet, quad, z, g32, sweeps


class _MixedLogdetQuad(torch.autograd.Function):
    """The backward reads the forward's solution and float32 inverse, which
    are not part of a graph: first order only."""

    @staticmethod
    def forward(ctx, a64, y64):
        logdet, quad, z, g32, _ = _forward(a64, y64)
        ctx.save_for_backward(z, g32)
        return logdet, quad

    @staticmethod
    @first_order_only
    def backward(ctx, ld_bar, q_bar):
        z, g32 = ctx.saved_tensors
        ginv = g32.to(torch.float64)
        ginv = 0.5 * (ginv + ginv.mT)
        a_bar = ld_bar[..., None, None] * ginv - q_bar[..., None, None] * (z[..., :, None] * z[..., None, :])
        y_bar = 2.0 * q_bar[..., None] * z
        return a_bar, y_bar


def mixed_logdet_quad(a64: torch.Tensor, y64: torch.Tensor):
    """``(logdet A, yᵀ A⁻¹ y)`` for SPD float64 ``A`` (..., n, n) and ``y``
    (..., n) at float64 value accuracy, with all n³ work in float32 but one
    float64 product; float32-class gradients."""
    return _MixedLogdetQuad.apply(a64, y64)

