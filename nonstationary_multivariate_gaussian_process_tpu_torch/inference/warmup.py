"""Stan-style windowed warmup: joint step-size and diagonal-mass adaptation.

Counterpart of the JAX package's ``inference/warmup.py``.  The reference's
sampler contract (``Hamiltonian_Monte_Carlo/HMC_Sampler`` as used at
``Nonseparable_model.py:228-231``) offers a fixed step size with an optional
mass matrix from a pilot run; this schedule replaces the pilot run with
Stan's adaptive warmup:

* **phase I** (``init_buffer`` draws): dual-averaging step-size adaptation
  only, toward ``target_accept``;
* **phase II**: doubling "slow" windows (``window``, then 2x, 4x, ...); each
  accumulates a Welford running variance of the positions, and at its end
  the inverse diagonal mass becomes the regularized variance while dual
  averaging restarts around the current adapted step size;
* **phase III** (``term_buffer`` draws): step-size-only re-adaptation
  against the final metric.

The schedule is host numpy, computed once per chain; the sampler reads its
flags as Python booleans, so following it costs the device nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class WarmupSchedule(NamedTuple):
    """Per-warmup-iteration adaptation schedule (host-precomputed, static)."""

    in_slow: np.ndarray  # (n_warmup,) bool: accumulate Welford this draw
    window_end: np.ndarray  # (n_warmup,) bool: refresh mass + restart DA after this draw
    da_step: np.ndarray  # (n_warmup,) int: 1-based step index within the current DA epoch


def window_schedule(
    n_warmup: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    window: int = 25,
) -> WarmupSchedule:
    """Stan's warmup partition (stan/src/stan/mcmc/windowed_adaptation.hpp).

    If ``n_warmup`` is too small for the requested buffers the three phases
    are shrunk proportionally (Stan's ``15%/75%/10%`` fallback); with no room
    for a slow window at all, the whole warmup is step-size-only.
    """
    n_warmup = int(n_warmup)
    if n_warmup <= 0:
        z = np.zeros((0,), bool)
        return WarmupSchedule(z, z, np.zeros((0,), np.int64))
    if init_buffer + window + term_buffer > n_warmup:
        init_buffer = int(0.15 * n_warmup)
        term_buffer = int(0.10 * n_warmup)
        window = n_warmup - init_buffer - term_buffer

    in_slow = np.zeros((n_warmup,), bool)
    window_end = np.zeros((n_warmup,), bool)
    if window > 0:
        # doubling slow windows covering [init_buffer, n_warmup - term_buffer)
        slow_end = n_warmup - term_buffer
        start, size = init_buffer, window
        while start < slow_end:
            end = start + size
            # final window absorbs the remainder (Stan's behavior)
            if end + 2 * size > slow_end:
                end = slow_end
            in_slow[start:end] = True
            window_end[end - 1] = True
            start, size = end, 2 * size

    # dual-averaging epochs restart after every window end
    da_step = np.zeros((n_warmup,), np.int64)
    step = 0
    for i in range(n_warmup):
        step += 1
        da_step[i] = step
        if window_end[i]:
            step = 0
    return WarmupSchedule(in_slow, window_end, da_step)


def regularized_variance(count, mean, m2: torch.Tensor) -> torch.Tensor:
    """Stan's shrunk variance estimate for the inverse metric.

    ``(n / (n + 5)) * var + 1e-3 * (5 / (n + 5))`` with ``var = m2 / max(n − 1,
    1)``: shrinks the Welford variance toward a small identity, keeping early,
    noisy windows sane.  ``count`` (a number, or a 0-d tensor) follows the
    schedule alone, so it is a host number; ``mean`` is unused, as in the JAX
    signature.
    """
    n = float(count)
    var = m2 / max(n - 1.0, 1.0)
    w = n / (n + 5.0)
    return w * var + 1e-3 * (1.0 - w)
