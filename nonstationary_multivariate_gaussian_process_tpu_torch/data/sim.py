"""Synthetic data: the nonseparable nonstationary subjects ``sim_mnts`` and
``sim_mnts_hetero``.

Counterpart of ``sim_mnts`` and ``sim_mnts_hetero`` in the JAX package's
``data/sim.py`` (reference ``SIM_MNTS``, ``SIM_code/sim.py:173-275``).  The
latent truth is deterministic in x: log-lengthscale ``3(x−1)³ − 3``, std
processes ``(1+x², 2−x²)``, correlation process ``cos(πx)``; the noise
variance is 1e-2, or for the heteroscedastic subject the task-major
log-variance processes ``(−5 + 3x, −2 − 3x)``.  The inputs and the draw of
``y ~ MVN(0, K + noise)`` come from an explicit ``torch.Generator`` (on the
CPU, then moved), so they cannot match the JAX package's draws for the same
seed; given JAX's x and normals the subject is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings
from ..models import gnmgp
from ..ops import transforms


class SimData(NamedTuple):
    """A simulated subject with ground-truth latent processes.

    Field layout mirrors the reference pickle ``[x, l, L_vecs, sigma2_err, Y]``
    (sim.py:274) plus the truth processes.
    """

    x: torch.Tensor  # (N,) sorted inputs on (0, 1)
    l: torch.Tensor  # (N,) true lengthscale process
    l_vecs: torch.Tensor  # (N*T,) true per-point Cholesky vectors (constrained)
    sigma2_err: float  # true noise variance
    y: torch.Tensor  # (N, M) observations
    stds: torch.Tensor  # (N, M) true std processes
    cors: torch.Tensor  # (N,) true correlation process (task pair 0-1)


def _chol_process_from_std_cor(stds: torch.Tensor, cors: torch.Tensor) -> torch.Tensor:
    """Per-point Cholesky factors of B_f(x) = D R D for M=2 (sim.py:240-249).

    Closed form; ``1 − c²`` is computed as ``(1−c)(1+c)`` to avoid
    cancellation where ``cos(πx)`` nears ±1.
    """
    s1, s2, c = stds[:, 0], stds[:, 1], cors
    l22 = s2 * torch.sqrt(torch.clamp((1.0 - c) * (1.0 + c), min=0.0))
    zeros = torch.zeros_like(s1)
    return torch.stack(
        [torch.stack([s1, zeros], dim=-1), torch.stack([s2 * c, l22], dim=-1)], dim=-2
    )  # (N, 2, 2)


class HeteroSimData(NamedTuple):
    """A heteroscedastic-noise synthetic subject with ground-truth latents."""

    x: torch.Tensor  # (N,)
    l: torch.Tensor  # (N,) true lengthscale process
    l_vecs: torch.Tensor  # (N*T,) true per-point Cholesky vectors
    tilde_sigma2_err: torch.Tensor  # (N*M,) task-major true log noise variances
    y: torch.Tensor  # (N, M)
    stds: torch.Tensor  # (N, M)
    cors: torch.Tensor  # (N,)


def _draw_y(z: torch.Tensor, x, ell, ls, sigma2_err) -> torch.Tensor:
    """y = chol(K + noise) z with the GNMGP Gram (sim.py:256-263); z (N·M,).
    ``sigma2_err`` is a scalar noise variance or a task-major (N·M,) vector.

    Two attempts, independent of the global robust-Cholesky switch (a
    sampler must never emit NaN data): the plain factor, then 1e-3 jitter.
    """
    n, m, _ = ls.shape
    cov = gnmgp.gram(x, ell, ls)
    cov.diagonal().add_(sigma2_err)
    chol, info = torch.linalg.cholesky_ex(cov)
    if int(info) != 0:
        cov.diagonal().add_(1e-3)
        chol = torch.linalg.cholesky(cov)
    return (chol @ z).reshape(m, n).T  # task-major (M, N) → (N, M)


def sim_mnts(
    generator: torch.Generator,
    n: int = 200,
    m: int = 2,
    sigma2_err: float = 1e-2,
    device=None,
    dtype=None,
) -> SimData:
    """Nonseparable nonstationary synthetic subject (reference SIM_MNTS).

    ``generator`` is a CPU ``torch.Generator``; the subject is built on
    ``device`` (default ``cuda``) in ``dtype`` (default ``settings.dtype``).
    """
    if m != 2:
        raise ValueError(f"the reference truth processes are bivariate (M=2), got M={m}")
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    x = torch.sort(torch.rand(n, generator=generator, dtype=dtype)).values.to(device)
    z = torch.randn(n * m, generator=generator, dtype=dtype).to(device)
    tilde_l = 3.0 * (x - 1.0) ** 3 - 3.0
    ell = torch.exp(tilde_l)
    stds = torch.stack([1.0 + x**2, 2.0 - x**2], dim=1)
    cors = torch.cos(x * torch.pi)
    ls = _chol_process_from_std_cor(stds, cors)
    y = _draw_y(z, x, ell, ls, sigma2_err)
    l_vecs = transforms.tril_to_vec(ls, m).reshape(-1)
    return SimData(x, ell, l_vecs, sigma2_err, y, stds, cors)


def hetero_subject(x: torch.Tensor, z: torch.Tensor) -> HeteroSimData:
    """The heteroscedastic subject at sorted inputs ``x`` (N,) from the
    normals ``z`` (N·M,) of its y draw, on their device and in their dtype."""
    n, m = x.shape[0], 2
    tilde_l = 3.0 * (x - 1.0) ** 3 - 3.0
    ell = torch.exp(tilde_l)
    stds = torch.stack([1.0 + x**2, 2.0 - x**2], dim=1)
    cors = torch.cos(x * torch.pi)
    ls = _chol_process_from_std_cor(stds, cors)
    ts2 = torch.cat([-5.0 + 3.0 * x, -2.0 - 3.0 * x])  # task-major (N*M,)
    y = _draw_y(z, x, ell, ls, torch.exp(ts2))
    l_vecs = transforms.tril_to_vec(ls, m).reshape(-1)
    return HeteroSimData(x, ell, l_vecs, ts2, y, stds, cors)


def sim_mnts_hetero(generator: torch.Generator, n: int = 200, m: int = 2, device=None,
                    dtype=None) -> HeteroSimData:
    """SIM_MNTS with input-dependent noise (the extended driver's model,
    ``Nonseparable_model_mpiKAISER_extended.py:155-247``): task 0's noise
    log-variance rises from −5 to −2 across the inputs, task 1's falls from
    −2 to −5.  ``generator``, ``device`` and ``dtype`` as in :func:`sim_mnts`.
    """
    if m != 2:
        raise ValueError(f"the reference truth processes are bivariate (M=2), got M={m}")
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    x = torch.sort(torch.rand(n, generator=generator, dtype=dtype)).values.to(device)
    z = torch.randn(n * m, generator=generator, dtype=dtype).to(device)
    return hetero_subject(x, z)
