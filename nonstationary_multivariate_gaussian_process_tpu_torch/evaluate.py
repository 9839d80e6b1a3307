"""Model scoring: RMSE, LPD, PMSE, AIC, BIC and DIC.

Counterpart of the JAX package's ``evaluate.py`` for these scores (reference
``Utility/utils.py:165-197``, ``Utility/model_validation.py``): host numpy
code, apart from DIC's deviances, which run on the chain's device.  WAIC and
PSIS-LOO are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

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


def get_dic(hist_vecs, deviance_fn, *args, **kwargs):
    """DIC = bar_D + p_D with p_D = bar_D − D(posterior mean)
    (model_validation.py:35-51).

    ``hist_vecs`` is the (S, P) chain.  The JAX function vmaps the deviance
    over it; here the draws go one at a time under ``torch.no_grad()``, so
    a chain at N=1000 never holds S Grams at once.
    """
    hist = torch.as_tensor(hist_vecs)
    with torch.no_grad():
        devs = torch.stack([deviance_fn(v, *args, **kwargs) for v in hist])
        bar_d = float(torch.mean(devs))
        d_mean = float(deviance_fn(torch.mean(hist, dim=0), *args, **kwargs))
    p_d = bar_d - d_mean
    return bar_d + p_d
