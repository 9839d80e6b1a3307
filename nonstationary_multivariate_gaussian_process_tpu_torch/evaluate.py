"""Model scoring: RMSE, LPD, PMSE, AIC and BIC.

Counterpart of the scalar scores of the JAX package's ``evaluate.py``
(reference ``Utility/utils.py:165-197``, ``Utility/model_validation.py``),
host numpy code.  DIC, WAIC and PSIS-LOO need a posterior chain and are not
ported yet.
"""

from __future__ import annotations

import numpy as np

def mse(a, b, axis=None):
    """Mean squared error (utils.py:165-172)."""
    return np.mean((np.asarray(a) - np.asarray(b)) ** 2, axis=axis)


def rmse(a, b, axis=None):
    """Root mean squared error (utils.py:175-182)."""
    return np.sqrt(mse(a, b, axis=axis))


def lpd(mean, std, y):
    """Mean log predictive density under pointwise normals (utils.py:185-197)."""
    mean = np.asarray(mean).reshape(-1)
    std = np.asarray(std).reshape(-1)
    y = np.asarray(y).reshape(-1)
    z = (y - mean) / std
    return float(np.mean(-0.5 * z**2 - np.log(std) - 0.5 * np.log(2 * np.pi)))


def pmse(pred_mean, y_test):
    """Predictive mean squared error on held-out data."""
    return float(mse(pred_mean, y_test))


def get_aic(vec, deviance_fn, *args, **kwargs):
    """AIC = deviance + 2 N_p (model_validation.py:9-19)."""
    n_p = int(vec.shape[0])
    return float(deviance_fn(vec, *args, **kwargs)) + 2.0 * n_p


def get_bic(vec, deviance_fn, n_obs: int, *args, **kwargs):
    """BIC = deviance + log(N) N_p (model_validation.py:21-33); ``n_obs`` is
    the number of inputs N (the reference uses ``Y.size()[0]``)."""
    n_p = int(vec.shape[0])
    return float(deviance_fn(vec, *args, **kwargs)) + float(np.log(n_obs)) * n_p
