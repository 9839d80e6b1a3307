"""Train/test splitting (host numpy).

Counterpart of ``data_split`` in the JAX package's ``data/preprocess.py``
(reference ``Utility/utils.py:137-154``).  The split draws from numpy's
``default_rng(seed)`` exactly as there, so both packages hold out the same
points.
"""

from __future__ import annotations

import numpy as np


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
