"""Loaders for the reference's on-disk data formats.

Counterpart of ``_np`` and ``load_sim_pickle`` in the JAX package's
``data/io.py``: a simulation pickle ``[x, l, L_vecs, sigma2_err, Y]``
(written by the reference's ``SIM_code/sim.py:273-274``) as numpy arrays,
and ``hadamard_to_full``, which turns a complete Hadamard-layout subject
into the dense (N, M) layout.  The other loaders (empirical pickles,
``MAP.dat``, HMC pickles, the per-ID clinical dicts, CSV) are not ported
yet.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A pickled tensor or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def load_sim_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        x, l, l_vecs, sigma2_err, y = pickle.load(f)
    return {
        "x": _np(x),
        "l": _np(l),
        "l_vecs": _np(l_vecs),
        "sigma2_err": float(sigma2_err),
        "y": _np(y),
    }


def hadamard_to_full(x, indx, y, m: int):
    """Recover the dense layout ``(times (N,), Y (N, M))`` from a *complete*
    Hadamard triple.

    Raises if any (time, task) cell is missing: incomplete subjects stay in
    the Hadamard layout (``workflows.run_subject_hadamard`` takes them).
    """
    x = np.asarray(x, float)
    indx = np.asarray(indx, int)
    y = np.asarray(y, float)
    times = np.unique(x)
    n = times.shape[0]
    if x.shape[0] != n * m:
        raise ValueError(f"incomplete layout: {x.shape[0]} obs != {n} times x {m} tasks")
    yy = np.full((n, m), np.nan)
    yy[np.searchsorted(times, x), indx] = y
    if np.any(np.isnan(yy)):
        raise ValueError("incomplete layout: some (time, task) cells missing")
    return times, yy
