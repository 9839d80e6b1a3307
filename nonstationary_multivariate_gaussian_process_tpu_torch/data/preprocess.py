"""Data preprocessing and train/test splitting (host numpy).

Counterpart of the JAX package's ``data/preprocess.py``: the reference's
per-feature detrend and standardization (``Utility/preprocess_realdata.py``)
and its split helpers (``Utility/utils.py:91-162``), for the fully observed
and the Hadamard layout.  The random splits draw from numpy's
``default_rng(seed)`` exactly as there, so both packages hold out the same
points.
"""

from __future__ import annotations

import numpy as np


def orig2adj(y: np.ndarray):
    """Per-feature detrend + standardize (preprocess_realdata.py:6-17).
    Returns ``(adjusted, trend, scale)``."""
    trend = np.mean(y, axis=0)
    adj = y - trend
    scale = np.std(adj, axis=0)
    return adj / scale, trend, scale


def adj2orig(adj_y: np.ndarray, trend, scale):
    """Inverse of :func:`orig2adj` (preprocess_realdata.py:20-30)."""
    return adj_y * scale + trend


def orig2adj_non(y_list):
    """List-of-series variant of :func:`orig2adj`, one series per task
    (preprocess_realdata.py:33-50).  Returns ``(adjusted, trends, scales)``
    lists."""
    adj, trends, scales = [], [], []
    for y in y_list:
        t = np.mean(y)
        a = y - t
        s = np.std(a)
        adj.append(a / s)
        trends.append(t)
        scales.append(s)
    return adj, trends, scales


def adj2orig_non(adj_y_list, trend_list, scale_list):
    """Inverse of :func:`orig2adj_non` (preprocess_realdata.py:53-65)."""
    return [a * s + t for a, t, s in zip(adj_y_list, trend_list, scale_list)]


def data_split(x, y, test_size=0.25, seed=22, shuffle=True):
    """Random split with sorted re-ordering of both halves (utils.py:137-154).
    Returns ``(x_train, x_test, y_train, y_test)``."""
    n = x.shape[0]
    n_test = int(round(n * test_size))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n) if shuffle else np.arange(n)
    test_idx = np.sort(perm[:n_test])
    train_idx = np.sort(perm[n_test:])
    return x[train_idx], x[test_idx], y[train_idx], y[test_idx]


def data_split_extrapolation(x, y, size=5):
    """Last-``size`` holdout (utils.py:157-162)."""
    return x[:-size], x[-size:], y[:-size], y[-size:]


def data_split_non(x, indx, y, test_size=0.25, seed=22, shuffle=True):
    """Random split for Hadamard-layout data (utils.py:91-103).  Returns
    ``(x_train, x_test, indx_train, indx_test, y_train, y_test)``, each half
    in its original order."""
    n = x.shape[0]
    n_test = int(round(n * test_size))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n) if shuffle else np.arange(n)
    te, tr = np.sort(perm[:n_test]), np.sort(perm[n_test:])
    return x[tr], x[te], indx[tr], indx[te], y[tr], y[te]


def data_split_non_chunk(x, indx, y, chunk_size=0.2, seed=22, fix=False):
    """Per-task contiguous-chunk holdout (utils.py:106-134): each task holds
    out ``int(chunk_size · n_task)`` consecutive observations, starting at a
    random offset (or, with ``fix``, at evenly spread offsets).  Returns the
    six arrays of :func:`data_split_non`, grouped by task."""
    m = len(np.unique(indx))
    rng = np.random.default_rng(seed)
    parts = {k: [] for k in ("xtr", "xte", "itr", "ite", "ytr", "yte")}
    for task in range(m):
        x_m = x[indx == task]
        y_m = y[indx == task]
        n_m = x_m.shape[0]
        n_te = int(chunk_size * n_m)
        n_tr = n_m - n_te
        s = int(np.floor(task * n_tr / (m - 1))) if fix else rng.integers(n_tr)
        tr_idx = np.concatenate([np.arange(0, s), np.arange(s + n_te, n_m)])
        te_idx = np.arange(s, s + n_te)
        parts["xtr"].append(x_m[tr_idx])
        parts["xte"].append(x_m[te_idx])
        parts["itr"].append(task * np.ones(n_tr, dtype=int))
        parts["ite"].append(task * np.ones(n_te, dtype=int))
        parts["ytr"].append(y_m[tr_idx])
        parts["yte"].append(y_m[te_idx])
    return tuple(np.concatenate(parts[k]) for k in ("xtr", "xte", "itr", "ite", "ytr", "yte"))
