"""Shared model-layer plumbing.

Counterpart of the JAX package's ``models/base.py``: the fully observed data
container, the task-major flattening of observations, and the named shape
checks at the boundaries.  Models keep the reference's flat packed parameter
vector (``Utility/logpos.py`` ``vec2pars*``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FullData(NamedTuple):
    """Fully-observed multi-task data: every task observed at every input.

    ``x``: (N,) inputs; ``y``: (N, M) observations.
    """

    x: torch.Tensor
    y: torch.Tensor


def task_major(y: torch.Tensor) -> torch.Tensor:
    """Flatten (N, M) observations task-major: ``y = Y.T.reshape(-1)``.

    Matches the reference's ``y = Y.t().contiguous().view(-1)`` layout.
    """
    return y.T.reshape(-1)


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
