"""Covariance kernels.

Counterpart of the JAX package's ``ops/kernels.py`` (reference
``Utility/kernels.py``):

* :func:`sq_dists`              — squared Euclidean pairwise distances,
* :func:`rbf_cov`               — stationary RBF (reference ``RBF_cov``),
* :func:`nonstationary_rbf_cov` — Gibbs kernel with pointwise scale and
  lengthscale processes (reference ``Nonstationary_RBF_cov``).

The *self*-covariance forms (``x2 is None``) add ``jitter * I`` on the
diagonal; the cross-covariance forms do not.  Functions keep the dtype and
device of the tensors they are given.  On a CUDA tensor
:func:`nonstationary_rbf_cov` runs the hand-written Gibbs kernel (K1,
``ops.gram_kernels.gibbs_gram``); on a CPU tensor its plain version.
"""

from __future__ import annotations

import torch

from .. import settings
from . import gram_kernels


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    x = torch.atleast_1d(x)
    return x[:, None] if x.dim() == 1 else x


def sq_dists(x1: torch.Tensor, x2: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared distances between rows of x1 (N1, d) and x2 (N2, d).

    1-D inputs are treated as (N, 1).  Mirrors reference kernels.py:5-21.
    """
    x1 = _as_2d(x1)
    x2 = x1 if x2 is None else _as_2d(x2)
    n1 = torch.sum(x1 * x1, dim=-1)[:, None]
    n2 = torch.sum(x2 * x2, dim=-1)[None, :]
    return n1 + n2 - 2.0 * x1 @ x2.T


def rbf_cov(x1, x2=None, alpha=1.0, beta=1.0) -> torch.Tensor:
    """Stationary RBF covariance ``alpha² exp(-0.5 |x1/beta - x2/beta|²)``.

    When ``x2 is None`` a ``settings.jitter * I`` nugget is added (reference
    kernels.py:33-35).
    """
    self_cov = x2 is None
    d = sq_dists(x1 / beta, None if self_cov else x2 / beta)
    cov = torch.exp(-0.5 * d) * alpha**2
    if self_cov:
        cov = cov + settings.jitter * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return cov


def nonstationary_rbf_cov(
    x1: torch.Tensor,
    sigma1: torch.Tensor | None = None,
    ell1: torch.Tensor | None = None,
    x2: torch.Tensor | None = None,
    sigma2: torch.Tensor | None = None,
    ell2: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gibbs nonstationary RBF covariance with pointwise (σ(x), ℓ(x)) processes.

    ``K[i,j] = σ1_i σ2_j sqrt(2 ℓ1_i ℓ2_j / (ℓ1_i² + ℓ2_j²))
               · exp(−(x1_i − x2_j)² / (ℓ1_i² + ℓ2_j²))``

    For 1-D inputs (N,).  Mirrors reference kernels.py:46-73 including the
    ``settings.jitter * I`` nugget on the self-covariance and σ/ℓ defaulting to ones.
    """
    ones1 = torch.ones_like(x1)
    sigma1 = ones1 if sigma1 is None else sigma1
    ell1 = ones1 if ell1 is None else ell1
    if x2 is None:
        return gram_kernels.gibbs_gram(
            x1.contiguous(), sigma1.contiguous(), ell1.contiguous(), jitter=settings.jitter
        )
    ones2 = torch.ones_like(x2)
    sigma2 = ones2 if sigma2 is None else sigma2
    ell2 = ones2 if ell2 is None else ell2
    return gram_kernels.gibbs_gram(
        x1.contiguous(), sigma1.contiguous(), ell1.contiguous(),
        x2.contiguous(), sigma2.contiguous(), ell2.contiguous(),
    )
