"""Loaders for the reference's on-disk data formats.

Counterpart of ``_np`` and ``load_sim_pickle`` in the JAX package's
``data/io.py``: a simulation pickle ``[x, l, L_vecs, sigma2_err, Y]``
(written by the reference's ``SIM_code/sim.py:273-274``) as numpy arrays.
The other loaders (empirical pickles, ``MAP.dat``, HMC pickles, the
per-ID clinical dicts, CSV) are not ported yet.
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
