"""GP kriging of the latent processes at new inputs.

Counterpart of the JAX package's ``predict/latent.py``.  The latent processes
(log-lengthscale, L-entry processes) are conditioned on their values at the
training inputs for all grid points at once: the projection ``Σ⁻¹ K_cross``
is shared by every latent process with the same prior.

Pointwise semantics matched to the reference (``Utility/prediction.py``):
variances are the marginal conditional variances per grid point, the prior is
the stationary RBF with nugget (self-variance ``α² + jitter``), and negative
variances clip to ``settings.precision``.

The smooth-RBF prior Gram is badly conditioned, so the projection is an f64
island whatever the working dtype: built and solved in float64 on the
tensors' own device (no host round trip), then cast back.  The JAX package
solves the same nugget-ed Gram with numpy on the host for concrete inputs and
with its robust Cholesky under ``jit``; this port takes the robust Cholesky.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings
from ..ops import chol as chol_ops
from ..ops import kernels


class LatentConditional(NamedTuple):
    mean: torch.Tensor  # (..., G) conditional mean per grid point
    var: torch.Tensor  # (G,) marginal conditional variance per grid point


def krige_proj(x: torch.Tensor, grid: torch.Tensor, alpha: float, beta: float):
    """The shared pieces of :func:`krige_rbf`: ``(proj (N, G), var (G,))``,
    in the dtype of ``x``, computed in float64 on ``x``'s device."""
    if x.dim() != 1 or grid.dim() != 1:
        raise ValueError(
            f"krige_rbf expects 1-D training inputs and query grid; got "
            f"x shape {tuple(x.shape)}, grid shape {tuple(grid.shape)}"
        )
    x64 = x.to(torch.float64)
    g64 = grid.to(torch.float64)
    sigma = kernels.rbf_cov(x64, alpha=alpha, beta=beta)  # with the self-nugget
    k_cross = kernels.rbf_cov(x64, g64, alpha=alpha, beta=beta)  # (N, G)
    c = chol_ops.safe_cholesky(sigma, force_robust=True)
    proj = chol_ops.chol_solve(c, k_cross)  # Σ⁻¹ K_cross
    var = alpha**2 + settings.jitter - torch.sum(k_cross * proj, dim=0)
    var = torch.clamp(var, min=settings.precision)
    return proj.to(x.dtype), var.to(x.dtype)


def krige_rbf(
    x: torch.Tensor,
    grid: torch.Tensor,
    values: torch.Tensor,
    mu: float,
    alpha: float,
    beta: float,
    proj=None,
) -> LatentConditional:
    """Pointwise GP conditional of latent ``values`` (…, N) at ``grid`` (G,).

    ``values`` may carry leading batch axes (e.g. the T L-entry processes of
    the GNMGP, which share one projection).  Returns means (…, G) and the
    shared marginal variances (G,).  ``proj`` is :func:`krige_proj`'s
    ``(proj, var)`` for the same (x, grid, alpha, beta), when the caller
    already has it.
    """
    proj, var = proj or krige_proj(x, grid, alpha, beta)
    mean = mu + (values - mu) @ proj
    return LatentConditional(mean=mean, var=var)
