"""Shared model-layer plumbing.

Counterpart of the JAX package's ``models/base.py``: the fully observed and
Hadamard-layout data containers, the task-major flattening of observations,
the exact masking of a dense likelihood, and the named shape checks at the
boundaries.  Models keep the reference's flat packed parameter vector
(``Utility/logpos.py`` ``vec2pars*``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings


class FullData(NamedTuple):
    """Fully-observed multi-task data: every task observed at every input.

    ``x``: (N,) inputs; ``y``: (N, M) observations.
    """

    x: torch.Tensor
    y: torch.Tensor


class HadamardData(NamedTuple):
    """One observation per (input, task) pair — the reference's "hadamard" layout.

    ``x``: (N,) inputs; ``indx``: (N,) ``torch.long`` task index; ``y``: (N,)
    observations.
    """

    x: torch.Tensor
    indx: torch.Tensor
    y: torch.Tensor


def as_hadamard_data(x, indx, y, device=None, dtype=None) -> HadamardData:
    """``HadamardData`` on ``device`` (default ``cuda``, raising when there is
    none): ``x`` and ``y`` in ``dtype`` (default ``settings.dtype``), the task
    indices as ``torch.long`` on the same device."""
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    return HadamardData(as_t(x), torch.as_tensor(indx, dtype=torch.long, device=device), as_t(y))


def task_major(y: torch.Tensor) -> torch.Tensor:
    """Flatten (N, M) observations task-major: ``y = Y.T.reshape(-1)``.

    Matches the reference's ``y = Y.t().contiguous().view(-1)`` layout.
    """
    return y.T.reshape(-1)


def mask_dense_gram(gram: torch.Tensor, sigma2_err, y: torch.Tensor, mask):
    """Project masked observations exactly out of a dense likelihood.

    ``gram``: (N, N) noiseless Gram, ``mask``: (N,) bool (True = real).
    Masked rows and columns are zeroed with a unit diagonal and the
    observation zeroed, so they contribute exactly nothing to the logdet or
    the quadratic form: the shape-static equivalent of dropping them.
    Returns ``(cov, y_masked)``.
    """
    mv = torch.as_tensor(mask, device=y.device).to(y.dtype)
    cov = gram * (mv[:, None] * mv[None, :])
    cov = cov + torch.diag(torch.where(mv > 0, sigma2_err, 1.0))
    return cov, y * mv


def check_vec(vec, expected: int, model_name: str, layout: str) -> None:
    """Named shape error for a packed parameter vector: a wrong-length vector
    would otherwise be silently mis-sliced."""
    ndim = getattr(vec, "ndim", None)
    n = vec.shape[-1] if ndim else None
    if ndim != 1 or n != expected:
        got = f"shape {tuple(vec.shape)}" if ndim is not None else repr(vec)
        raise ValueError(
            f"{model_name} parameter vector must be 1-D with length "
            f"{expected} ({layout}); got {got}"
        )


def check_full_data(data: FullData, model_name: str, min_n: int = 2) -> None:
    """Named shape errors for FullData at objective/predict boundaries."""
    x, y = data.x, data.y
    if getattr(x, "ndim", None) != 1 or getattr(y, "ndim", None) != 2:
        raise ValueError(
            f"{model_name} expects FullData(x (N,), y (N, M)); got "
            f"x shape {tuple(getattr(x, 'shape', ()))}, "
            f"y shape {tuple(getattr(y, 'shape', ()))}"
        )
    if x.shape[0] != y.shape[0]:
        raise ValueError(
            f"{model_name}: x and y disagree on N ({x.shape[0]} vs {y.shape[0]})"
        )
    if x.shape[0] < min_n:
        raise ValueError(
            f"{model_name}: need at least {min_n} observations, got {x.shape[0]}"
        )
