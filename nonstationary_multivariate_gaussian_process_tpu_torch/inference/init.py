"""Initialization strategies for MAP training.

Counterpart of the LMC, SNMGP and GNMGP builders of the JAX package's
``inference/init.py`` (reference ``Stationary_model.py:88-101``,
``Separable_model.py:101-144``, ``Nonseparable_model.py:115-151``).  Each
builder works in numpy float64 on the host and returns a packed parameter
vector on ``device`` in ``dtype`` (default: ``cuda``, raising when there is
none; ``settings.dtype``).  The JAX builders' optional ``key`` noise is not
ported: ``run_subject`` passes none.  The random fallbacks take a
``torch.Generator`` where JAX takes a key.

The multichain starts, :func:`adam_descent` and
:func:`multichain_starts`, run on the device of their start.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import settings
from ..ops import transforms
from . import map as map_mod
from .empirical import EmpiricalEstimate


def _as(v, device, dtype) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(v), dtype=dtype or settings.dtype, device=settings.resolve_device(device)
    )


def _lvecs_to_ulvecs(l_vecs: np.ndarray, n: int, m: int) -> np.ndarray:
    """Constrained → unconstrained per-input L-vectors, (N·T,): log on the
    diagonal slots (reference utils.py:48-54)."""
    t = transforms.tri_size(m)
    lv = np.asarray(l_vecs, np.float64).reshape(n, t)
    mask = np.zeros(t, bool)
    mask[transforms.diag_indices_vec(m)] = True
    return np.where(mask, np.log(np.where(mask, lv, 1.0)), lv).reshape(-1)


def _host(vec) -> np.ndarray:
    return np.asarray(vec.detach().cpu() if torch.is_tensor(vec) else vec, np.float64)


def lmc_from_empirical(emp: EmpiricalEstimate, n: int, m: int, device=None, dtype=None):
    """Stationary_model.py:88-101: means of the local empirical estimates,
    unit scale (``tilde_sigma = 0``)."""
    tilde_l = np.mean(np.log(emp.est_ls))
    ul_vec = _lvecs_to_ulvecs(emp.est_l_vecs, n, m).reshape(n, -1).mean(axis=0)
    return _as(np.concatenate([[tilde_l, 0.0], ul_vec, [emp.est_tilde_sigma2_err]]), device, dtype)


def snmgp_from_stationary(lmc_vec, n: int, device=None, dtype=None):
    """Separable_model.py:101-111: the stationary MAP broadcast over N."""
    v = _host(lmc_vec)
    return _as(np.concatenate([np.full(n, v[0]), np.full(n, v[1]), v[2:-1], [v[-1]]]), device, dtype)


def snmgp_combined(lmc_vec, emp: EmpiricalEstimate, n: int, m: int, device=None, dtype=None):
    """Separable_model.py:126-144: the stationary lengthscale, the empirical
    task covariance, unit σ-process."""
    v = _host(lmc_vec)
    ul_vec = _lvecs_to_ulvecs(emp.est_l_vecs, n, m).reshape(n, -1).mean(axis=0)
    return _as(np.concatenate([np.full(n, v[0]), np.ones(n), ul_vec, [emp.est_tilde_sigma2_err]]),
               device, dtype)


def snmgp_from_empirical(emp: EmpiricalEstimate, n: int, m: int, device=None, dtype=None):
    """Separable_model.py:112-125: empirical ℓ-process, unit σ-process."""
    tilde_l = np.log(emp.est_ls)
    ul_vec = _lvecs_to_ulvecs(emp.est_l_vecs, n, m).reshape(n, -1).mean(axis=0)
    tilde_sigma = np.ones(n)
    return _as(np.concatenate([tilde_l, tilde_sigma, ul_vec, [emp.est_tilde_sigma2_err]]),
               device, dtype)


def gnmgp_from_empirical(emp: EmpiricalEstimate, n: int, m: int, smooth: bool = False,
                         device=None, dtype=None):
    """Nonseparable_model.py:132-141: empirical ℓ-process and L-process."""
    tilde_l = np.log(emp.smooth_ls if smooth else emp.est_ls)
    ul_vecs = _lvecs_to_ulvecs(emp.est_l_vecs, n, m)
    return _as(np.concatenate([tilde_l, ul_vecs, [emp.est_tilde_sigma2_err]]), device, dtype)


def gnmgp_from_separable(snmgp_vec, n: int, m: int, device=None, dtype=None):
    """Nonseparable_model.py:117-130: scale the separable task-Cholesky by
    σ(x), so the per-input factor is ``L_vec · exp(tilde_sigma_n)``."""
    v = _host(snmgp_vec)
    tilde_l = v[:n]
    tilde_sigma = v[n : 2 * n]
    l_vec = v[2 * n : -1]
    l_vecs = np.concatenate([l_vec * s for s in np.exp(tilde_sigma)])
    ul_vecs = _lvecs_to_ulvecs(np.abs(l_vecs) + 1e-12, n, m)
    # off-diagonals keep their sign; only diagonal slots were abs-ed for the log
    t = transforms.tri_size(m)
    mask = np.zeros(t, bool)
    mask[transforms.diag_indices_vec(m)] = True
    ul_vecs = np.where(np.tile(mask, n), ul_vecs, l_vecs)
    return _as(np.concatenate([tilde_l, ul_vecs, [v[-1]]]), device, dtype)


def lmc_random(generator: torch.Generator, m: int, device=None, dtype=None):
    """Stationary_model.py:102-105 fallback init: log-lengthscale −3, unit
    scale, uniform(0, 1) unconstrained task factor from ``generator``, noise
    variance 0.1."""
    ul_vec = torch.rand(transforms.tri_size(m), generator=generator, dtype=torch.float64,
                        device=generator.device).cpu().numpy()
    return _as(np.concatenate([[-3.0, 0.0], ul_vec, [np.log(0.1)]]), device, dtype)


def gnmgp_random(generator: torch.Generator, n: int, m: int, device=None, dtype=None):
    """Nonseparable_model.py:142-146 fallback init, drawn directly in the
    unconstrained space (the reference logs N(0, 1) diagonals, which NaNs half
    the time): log-lengthscales −4, standard normal L-vectors and the log of
    a uniform noise variance from ``generator``."""
    t = transforms.tri_size(m)
    ul_vecs = torch.randn(n * t, generator=generator, dtype=torch.float64, device=generator.device)
    ts2 = torch.log(torch.rand((), generator=generator, dtype=torch.float64, device=generator.device))
    return _as(np.concatenate([np.full(n, -4.0), ul_vecs.cpu().numpy(), [ts2.item()]]), device, dtype)


# -- Multichain start construction -------------------------------------------


def adam_descent(potential_fn, q0: torch.Tensor, n_iters: int, *, lr: float = 1e-1) -> torch.Tensor:
    """``n_iters`` guarded Adam steps (optax's ``adam(lr)`` arithmetic,
    :func:`.map.guarded_adam_step`) on ``potential_fn`` from ``q0``; returns
    the final iterate, not the best seen (a typical-set start, not an
    optimum).  A non-finite value or gradient skips the update."""
    v = q0
    state = map_mod.adam_init(q0)
    lr_t = torch.full((), float(lr), dtype=q0.dtype, device=q0.device)
    best_vec, best_val = q0, torch.full((), float("inf"), dtype=q0.dtype, device=q0.device)
    for _ in range(int(n_iters)):
        v, state, best_vec, best_val, _ = map_mod.guarded_adam_step(potential_fn, lr_t, v, state, best_vec, best_val)
    return v


def multichain_starts(
    potential_fn,
    center: torch.Tensor,
    n_chains: int,
    generator: torch.Generator | None = None,
    *,
    jitter: float = 0.1,
    descent_iters: int = 300,
    lr: float = 1e-1,
    include_center: bool = True,
    noise=None,
) -> torch.Tensor:
    """Overdispersed-but-feasible multichain starts, (n_chains, P): jitter,
    then descend.

    Raw jitter around a sharp high-dimensional posterior strands chains far
    above the typical set (the JAX function's docstring has the numbers), so
    each start ``center + jitter · N(0, I)`` runs :func:`adam_descent` for
    ``descent_iters`` steps, one chain after another.  Chain 0 is ``center``
    itself when ``include_center`` (it is then not descended: JAX overwrites
    its row with ``center``); a start whose descended potential is
    non-finite falls back to ``center``.  The (n_chains, P) standard normals
    come from ``generator`` (on ``center``'s device) or ``noise=``.
    """
    center = torch.as_tensor(center)
    if center.dim() != 1:
        raise ValueError(f"center must be (P,), got {tuple(center.shape)}")
    shape = (n_chains, center.shape[0])
    if noise is not None:
        z = torch.as_tensor(noise, dtype=center.dtype, device=center.device)
        if tuple(z.shape) != shape:
            raise ValueError(f"noise must be {shape}, got {tuple(z.shape)}")
    elif generator is None:
        raise ValueError("multichain_starts needs a torch.Generator (generator=) or injected noise (noise=)")
    else:
        z = torch.randn(shape, generator=generator, dtype=center.dtype, device=center.device)
    offsets = jitter * z
    if include_center:
        offsets[0] = 0.0
    starts = center[None] + offsets
    if descent_iters <= 0:
        return starts
    first = 1 if include_center else 0
    rows = [center] * first
    for q in starts[first:]:
        q = adam_descent(potential_fn, q, descent_iters, lr=lr)
        with torch.no_grad():
            ok = torch.isfinite(potential_fn(q))
        rows.append(torch.where(ok, q, center))
    return torch.stack(rows)
