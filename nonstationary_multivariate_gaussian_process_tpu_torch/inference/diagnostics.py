"""MCMC chain diagnostics: autocorrelation, effective sample size, summaries.

Counterpart of the JAX package's ``inference/diagnostics.py`` (numpy and
scipy, no JAX there either), kept as the port's own copy.  The reference
inspects chains with statsmodels ACF plots and trace pngs
(``Nonseparable_model_mpiKAISER_extended.py:617-623``); here the diagnostics
are library functions over host arrays (a chain on a device is read with
``.cpu().numpy()`` first).
"""

from __future__ import annotations

import numpy as np


def acf(x: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Autocorrelation function of a 1-D chain via FFT."""
    x = np.asarray(x, float)
    n = x.shape[0]
    if max_lag is None:
        max_lag = min(n - 1, 200)
    xc = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft)
    ac = np.fft.irfft(f * np.conjugate(f))[: max_lag + 1].real
    var0 = ac[0]
    if var0 <= 0:
        return np.zeros(max_lag + 1)
    return ac / var0


def ess(x: np.ndarray) -> float:
    """Effective sample size via Geyer's initial positive sequence."""
    x = np.asarray(x, float)
    n = x.shape[0]
    rho = acf(x, max_lag=n - 1 if n > 1 else 0)
    # pair sums rho[2k+1] + rho[2k+2]; truncate at first negative pair
    tau = 1.0
    k = 1
    while k + 1 < len(rho):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        tau += 2.0 * pair
        k += 2
    return float(n / max(tau, 1.0))


def _autocov(x: np.ndarray) -> np.ndarray:
    """Biased (1/n) autocovariance of a 1-D chain via FFT, all lags."""
    x = np.asarray(x, float)
    n = x.shape[0]
    xc = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft)
    return np.fft.irfft(f * np.conjugate(f))[:n].real / n


def ess_multichain(chains: np.ndarray, rank_normalize: bool = True) -> float:
    """Bulk effective sample size across chains (Vehtari et al. 2021).

    ``chains``: (C, S).  Each chain is split in half, values are replaced by
    normal quantiles of their pooled fractional ranks, and the combined
    correlation estimate mixes within- and between-chain variance — so K
    chains that each look internally mixed but sit on different parts of a
    ridge score LOW, unlike summing per-chain ESS.  This is the honest
    denominator for a many-chain tier (the claim "K chains ⇒ K× effective
    draws" is only true if THIS number says so).

    Returns the pooled ESS (≈ C·S for independent white chains).
    """
    c = np.asarray(chains, float)
    if c.ndim == 1:
        c = c[None]
    n_half = c.shape[1] // 2
    if n_half < 2:
        return float("nan")
    c = np.concatenate([c[:, :n_half], c[:, n_half : 2 * n_half]], axis=0)
    m, n = c.shape
    if rank_normalize:
        r = c.reshape(-1).argsort().argsort().reshape(m, n) + 1.0
        from scipy.special import ndtri  # type: ignore

        c = ndtri((r - 0.375) / (m * n + 0.25))
    chain_vars = c.var(axis=1, ddof=1)
    w = chain_vars.mean()
    if not np.isfinite(w) or w <= 0:
        return float(m * n)
    b = n * c.mean(axis=1).var(ddof=1) if m > 1 else 0.0
    var_plus = (n - 1) / n * w + b / n
    # mean within-chain autocovariance per lag
    gamma = np.mean([_autocov(c[j]) for j in range(m)], axis=0)
    rho = 1.0 - (w - gamma) / var_plus
    # Geyer initial monotone positive sequence over paired sums
    tau = 1.0
    prev = np.inf
    k = 1
    while k + 1 < n:
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        prev = pair
        tau += 2.0 * pair
        k += 2
    return float(m * n / max(tau, 1.0))


def rhat(chains: np.ndarray) -> np.ndarray:
    """Split-R̂ potential-scale-reduction per parameter.

    ``chains``: (C, S, P).  Each chain is split in half (so even a single
    chain yields a meaningful statistic); values near 1 indicate convergence.
    """
    c = np.asarray(chains, float)
    if c.ndim == 2:
        c = c[None]
    n_c, n_s, n_p = c.shape
    half = n_s // 2
    splits = np.concatenate([c[:, :half], c[:, half : 2 * half]], axis=0)  # (2C, half, P)
    m, n = splits.shape[0], splits.shape[1]
    chain_means = splits.mean(axis=1)  # (2C, P)
    chain_vars = splits.var(axis=1, ddof=1)  # (2C, P)
    between = n * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_est = (n - 1) / n * within + between / n
    return np.sqrt(var_est / np.maximum(within, 1e-300))


def chain_diagnostics(samples: np.ndarray, stride: int = 1) -> dict:
    """Compact mixing diagnostics for one subject's posterior draws.

    ``samples``: (S, P) single chain or (C, S, P) multi-chain.  Returns
    ``{"min_ess", "median_ess", "max_rhat"}`` over every ``stride``-th
    parameter, with split-R̂ maxed over all parameters.  Multi-chain ESS is
    the rank-normalized POOLED estimator (:func:`ess_multichain`) — never a
    per-chain sum, which stuck-but-disagreeing chains inflate (each chain is
    internally well-mixed, so summed Geyer ESS looks healthy exactly when
    the draws are worthless; the pooled estimator pins at ~1/chain there).
    This is the number a cohort driver must surface so silent non-mixing is
    impossible.
    """
    s = np.asarray(samples, float)
    if s.ndim == 2:
        s = s[None]
    cols = range(0, s.shape[-1], max(1, stride))
    if s.shape[0] >= 2:
        e = np.array([ess_multichain(s[:, :, j]) for j in cols])
    else:
        e = np.array([ess(s[0][:, j]) for j in cols])
    r = rhat(s)
    return {
        "min_ess": float(e.min()),
        "median_ess": float(np.median(e)),
        "max_rhat": float(np.max(r)),
    }


def summary(samples: np.ndarray) -> dict:
    """Per-parameter posterior summary of an (S, P) chain."""
    s = np.asarray(samples, float)
    return {
        "mean": s.mean(axis=0),
        "std": s.std(axis=0),
        "q2.5": np.percentile(s, 2.5, axis=0),
        "q50": np.percentile(s, 50.0, axis=0),
        "q97.5": np.percentile(s, 97.5, axis=0),
        "ess": np.array([ess(s[:, j]) for j in range(s.shape[1])]),
    }


def samples2quantiles(pos_sample: np.ndarray, percentiles=(2.5, 50.0, 97.5)) -> np.ndarray:
    """Pointwise quantiles of posterior samples (posterior_analysis.py:91-99)."""
    return np.percentile(np.asarray(pos_sample), q=list(percentiles), axis=0)
