"""Parameter transforms: unconstrained ↔ constrained Cholesky vectors.

Counterpart of the JAX package's ``ops/transforms.py`` (reference
``Utility/utils.py:10-89``).  A lower-triangular M×M matrix is stored
row-major as a length ``T = M(M+1)/2`` vector via ``tril_indices``; the
unconstrained parameterization exponentiates the diagonal entries, which live
at flat positions ``cumsum(1..M) − 1``.  Every transform works on a trailing
axis, so leading batch axes pass through.
"""

from __future__ import annotations

import numpy as np
import torch


def tri_size(m: int) -> int:
    return m * (m + 1) // 2


def diag_indices_vec(m: int) -> np.ndarray:
    """Flat positions of the diagonal entries inside an L-vector (utils.py:12)."""
    return np.cumsum(np.arange(1, m + 1)) - 1


def _diag_mask(m: int, device) -> torch.Tensor:
    mask = torch.zeros(tri_size(m), dtype=torch.bool, device=device)
    mask[torch.as_tensor(diag_indices_vec(m), device=device)] = True
    return mask


def ulvec_to_lvec(ul_vec: torch.Tensor, m: int) -> torch.Tensor:
    """Unconstrained → constrained L-vector: exp on diagonal slots (..., T)."""
    return torch.where(_diag_mask(m, ul_vec.device), torch.exp(ul_vec), ul_vec)


def lvec_to_ulvec(l_vec: torch.Tensor, m: int) -> torch.Tensor:
    """Constrained → unconstrained L-vector: log on diagonal slots (..., T)."""
    mask = _diag_mask(m, l_vec.device)
    return torch.where(mask, torch.log(torch.where(mask, l_vec, 1.0)), l_vec)


def vec_to_tril(x: torch.Tensor, m: int) -> torch.Tensor:
    """Length-T vector(s) → lower-triangular M×M matrix: (..., T) → (..., M, M)."""
    rows, cols = np.tril_indices(m)
    out = torch.zeros(x.shape[:-1] + (m, m), dtype=x.dtype, device=x.device)
    out[..., rows, cols] = x
    return out


def tril_to_vec(l: torch.Tensor, m: int) -> torch.Tensor:
    """Lower-triangular matrix(es) → length-T vector: (..., M, M) → (..., T)."""
    rows, cols = np.tril_indices(m)
    return l[..., rows, cols]
