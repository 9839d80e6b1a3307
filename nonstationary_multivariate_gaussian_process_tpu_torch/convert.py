"""Carry fitted GNMGP parameters and subjects from the JAX package to the port.

The port keeps the JAX package's packed GNMGP vector (reference
``vec2pars_SVC``: ``[tilde_l (N), uL_vecs (N·T), tilde_sigma2_err]``) and its
artifact-store format, so carrying a fit across is a matter of moving arrays
into tensors on a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import settings
from .models import gnmgp
from .models.base import FullData
from .utils.artifacts import ArtifactStore


class Subject(NamedTuple):
    data: FullData  # x (N,), y (N, M)
    vec: torch.Tensor  # packed MAP vector


def params_from_jax(vec: np.ndarray, n: int, m: int, device=None, dtype=None) -> gnmgp.Params:
    """The JAX package's packed GNMGP vector as the port's ``Params``."""
    t = torch.as_tensor(
        np.asarray(vec), dtype=dtype or settings.dtype, device=settings.resolve_device(device)
    )
    return gnmgp.unpack(t, n, m)


def subject_from_store(
    root: str, sid, model: str = "gnmgp", dataset: str = "sim", device=None, dtype=None
) -> Subject:
    """Read a subject's ``data`` and ``map`` stages from an artifact store
    (written by either package) into the port's tensors."""
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    store = ArtifactStore(root)
    key = lambda stage: ArtifactStore.key(model, dataset, sid, stage)
    if not store.exists(key("map")) or not store.exists(key("data")):
        raise KeyError(f"subject {sid!r} has no fitted artifacts under {root}")
    arrays = store.load(key("data"))
    as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    data = FullData(as_t(arrays["x"]), as_t(arrays["y"]))
    return Subject(data=data, vec=as_t(store.load(key("map"))["vec"]))
