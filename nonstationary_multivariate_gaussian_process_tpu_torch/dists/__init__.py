"""Probability densities.

Counterpart of the JAX package's ``dists`` (reference
``Utility/distributions.py`` plus the ``torch.distributions`` calls of
``Utility/logpos.py``).  The normalization conventions are part of the
result and are kept exactly:

* the data likelihood is **unnormalized** — the reference drops the 2π
  constant (distributions.py:22),
* the GP priors are normalized like ``MultivariateNormal.log_prob``
  (logpos.py:274), as is ``Normal.log_prob`` (logpos.py:283),
* ``inverse_gamma_logpdf`` includes its normalizer (distributions.py:126-134),
  the ``_u`` variant does not (:116-124).

Scalar hyper-parameters (``loc``, ``alpha``, ...) may be Python floats or
tensors; every result keeps the dtype and device of the tensor argument.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import chol as _chol
from ..ops import kron as _kron

_LOG2PI = math.log(2.0 * math.pi)


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


# -- multivariate normal -----------------------------------------------------


def mvn_logpdf_kron(y, mu, b, k, sigma2, mask=None):
    """Unnormalized MVN log-pdf with covariance ``B ⊗ K + σ² I`` (task-major y),
    through the rotated batched-Cholesky path of ``ops.kron``.  ``mask`` (N,)
    excludes padded inputs exactly."""
    logdet, quad = _kron.kron_chol_logdet_quad(b, k, sigma2, y - mu, mask=mask)
    return -0.5 * logdet - 0.5 * quad


def mvn_logpdf_dense_unnorm(y, mu, cov):
    """Unnormalized MVN log-pdf with a dense covariance, by one robust Cholesky
    (the reference's ``torch.inverse`` + ``torch.logdet``, logpos.py:352-354)."""
    logdet, quad = _chol.psd_logdet_quad(cov, y - mu)
    return -0.5 * logdet - 0.5 * quad


class TriInv(NamedTuple):
    """Hoisted prior factor: ``w = chol(Σ)⁻¹`` and ``logdet(Σ)``, computed once
    on the host in float64 (``ops.chol.prior_rbf_inv``), so the prior solve
    inside an objective is a matrix product."""

    w: torch.Tensor
    logdet: torch.Tensor


def mvn_logpdf_chol(y, mu, chol):
    """Normalized MVN log-pdf given a Cholesky factor or a :class:`TriInv`.

    ``y`` may carry leading batch axes (..., N): each row is one MVN draw
    against the shared factor.
    """
    n = y.shape[-1]
    r = y - mu
    if isinstance(chol, TriInv):
        sol = r @ chol.w.T
        logdet = chol.logdet
    else:
        sol = _chol.tri_solve(chol, r.T if r.dim() > 1 else r)
        sol = sol.T if r.dim() > 1 else sol
        logdet = _chol.chol_logdet(chol)
    return -0.5 * n * _LOG2PI - 0.5 * logdet - 0.5 * torch.sum(sol * sol, dim=-1)


# -- scalar densities --------------------------------------------------------


def normal_logpdf(x, loc=0.0, scale=1.0):
    """Normalized univariate normal log-pdf (``Normal.log_prob``)."""
    scale = _like(scale, x)
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - 0.5 * _LOG2PI


def inverse_gamma_logpdf(x, alpha=1.0, beta=1.0):
    """Normalized inverse-gamma log-pdf (distributions.py:126-134)."""
    alpha, beta = _like(alpha, x), _like(beta, x)
    return (-alpha - 1.0) * torch.log(x) - beta / x + alpha * torch.log(beta) - torch.lgamma(alpha)


def inverse_gamma_logpdf_u(x, alpha=1.0, beta=1.0):
    """Unnormalized inverse-gamma log-pdf (distributions.py:116-124)."""
    alpha = _like(alpha, x)
    return (-alpha - 1.0) * torch.log(x) - beta / x


def gamma_logpdf(x, alpha=1.0, beta=1.0):
    """Normalized gamma log-pdf (distributions.py:136-137)."""
    alpha, beta = _like(alpha, x), _like(beta, x)
    return (alpha - 1.0) * torch.log(x) - beta * x + alpha * torch.log(beta) - torch.lgamma(alpha)
