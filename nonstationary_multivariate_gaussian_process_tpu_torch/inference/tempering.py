"""Replica-exchange (parallel-tempering) HMC.

Counterpart of the JAX package's ``inference/tempering.py``.  Replica k
samples the tempered target

    U_k(q) = beta_k * U(q) + (1 - beta_k) * R(q),

with ``R`` the reference potential (default the standard normal, the exact
prior of the whitened parameterization, :mod:`.whiten`), so beta = 1 is the
posterior.  Each draw runs one HMC transition per replica, each with its own
dual-averaged step size (seeded ``step_size / sqrt(beta)``), then one
even/odd sweep of adjacent-pair swaps: pairs ``(p, p + 1)`` with ``p ≡ i
(mod 2)`` swap with probability ``exp((beta_p - beta_{p+1}) · (E(q_p) -
E(q_{p+1})))``, ``E = U - R``.  Replica exchange repairs multimodality, not
the funnel neck of these posteriors (see the JAX module).

The port runs eagerly with the JAX sampler's arithmetic step for step; where
JAX ``vmap``s the transition across replicas, the port runs the replicas one
after another.  A transition recomputes its entry gradient (swaps move
positions between temperatures), so it costs ``n_leapfrog + 1`` gradients,
and the swap sweep one potential value per replica.

Noise per draw: for each replica a standard normal (P,) and a uniform, then
the K - 1 swap uniforms, from an explicit ``torch.Generator`` on the chain's
device, or replayed from ``noise=(z (n_total, K, P), u (n_total, K), u_swap
(n_total, K - 1))``: JAX's ``k_trans, k_swap = split(k)``, then for replica
r ``normal(k_mom, (P,))`` and ``uniform(k_acc)`` with ``k_mom, k_acc =
split(split(k_trans, K)[r])``, and ``uniform(k_swap, (K - 1,))``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import DA_GAMMA, DA_KAPPA, DA_T0
from .map import value_and_grad


class TemperedResult(NamedTuple):
    samples: torch.Tensor  # (n_samples, P) beta=1 post-warmup draws
    accept_stat: torch.Tensor  # (K,) mean per-replica HMC acceptance (sampling phase)
    swap_accept: torch.Tensor  # (K-1,) mean adjacent-pair swap acceptance
    step_sizes: torch.Tensor  # (K,) final adapted per-replica step sizes
    betas: torch.Tensor  # (K,) the inverse-temperature ladder
    potentials: torch.Tensor  # (n_samples,) U at each kept beta=1 draw


def geometric_ladder(n_replicas: int, beta_min: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """Geometric inverse-temperature ladder, betas[0] = 1 down to
    ``beta_min``: geometric spacing equalizes adjacent swap rates when the
    energy scale grows smoothly with beta."""
    k = torch.arange(n_replicas, dtype=dtype, device=device)
    return torch.pow(torch.full((), beta_min, dtype=dtype, device=device), k / max(n_replicas - 1, 1))


def _noise_source(generator, noise, n_total: int, k: int, dim: int, dtype, device):
    """``draw(i) -> (z (K, P), u (K,), u_swap (K - 1,))``."""
    if noise is not None:
        z_all, u_all, s_all = (torch.as_tensor(a, dtype=dtype, device=device) for a in noise)
        want = ((n_total, k, dim), (n_total, k), (n_total, k - 1))
        got = tuple(tuple(a.shape) for a in (z_all, u_all, s_all))
        if got != want:
            raise ValueError(f"noise must be z, u and u_swap of shapes {want}, got {got}")
        return lambda i: (z_all[i], u_all[i], s_all[i])
    if generator is None:
        raise ValueError("tempered_hmc_sample needs a torch.Generator (generator=) or injected noise (noise=)")
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the chain on {device}")
    rand = lambda *shape: torch.rand(shape, generator=generator, dtype=dtype, device=device)

    def draw(_):
        zs, us = [], []
        for _r in range(k):
            zs.append(torch.randn(dim, generator=generator, dtype=dtype, device=device))
            us.append(rand())
        return torch.stack(zs), torch.stack(us), rand(k - 1)

    return draw


def tempered_hmc_sample(
    potential_fn: Callable,
    init_position: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    n_replicas: int = 8,
    beta_min: float = 0.05,
    betas=None,
    step_size: float = 1e-3,
    n_leapfrog: int = 20,
    n_warmup: int = 400,
    target_accept: float = 0.75,
    mass_matrix=None,
    reference_fn: Callable | None = None,
    noise=None,
) -> TemperedResult:
    """Replica-exchange HMC over a ``n_replicas``-rung temperature ladder
    (or the given ``betas``), on the device and in the dtype of
    ``init_position``.

    Same potential contract as :func:`.hmc.hmc_sample`.  ``reference_fn``
    is the beta = 0 target's potential (default standard normal: pair it
    with a whitened potential, ``tempered_hmc_sample(w.wrap(nlp),
    w.to_white(vec), ...)``).  ``mass_matrix``: a diagonal (P,) or None.
    Returns the beta = 1 chain and the ladder's diagnostics; healthy
    ``swap_accept`` sits in about 0.2-0.6 per adjacent pair.
    """
    q0 = torch.as_tensor(init_position)
    dtype, device, dim = q0.dtype, q0.device, q0.shape[0]
    if betas is None:
        betas_t = geometric_ladder(int(n_replicas), float(beta_min), dtype, device)
    else:
        betas_t = torch.as_tensor(betas, dtype=dtype, device=device)
    n_rep = betas_t.shape[0]
    if reference_fn is None:
        reference_fn = lambda q: 0.5 * torch.dot(q, q)
    n_samples, n_warmup, n_leapfrog = int(n_samples), int(n_warmup), int(n_leapfrog)
    n_total = n_warmup + n_samples
    draw = _noise_source(generator, noise, n_total, n_rep, dim, dtype, device)
    m_diag = (torch.ones(dim, dtype=dtype, device=device) if mass_matrix is None
              else torch.as_tensor(mass_matrix, dtype=dtype, device=device))
    sqrt_m = torch.sqrt(m_diag)
    m_inv = 1.0 / m_diag

    def transition(q, beta, eps, z, u):
        """One HMC draw from the replica-``beta`` target; the entry gradient
        is recomputed because swaps move positions between betas."""
        pot = lambda v: beta * potential_fn(v) + (1.0 - beta) * reference_fn(v)
        u_q, g_q = value_and_grad(pot, q)
        p = sqrt_m * z
        h0 = u_q + 0.5 * torch.dot(p, m_inv * p)
        p1 = p - 0.5 * eps * g_q
        q1 = q + eps * m_inv * p1
        for _ in range(n_leapfrog - 1):
            p1 = p1 - eps * value_and_grad(pot, q1)[1]
            q1 = q1 + eps * m_inv * p1
        u1, g1 = value_and_grad(pot, q1)
        p1 = p1 - 0.5 * eps * g1
        h1 = u1 + 0.5 * torch.dot(p1, m_inv * p1)
        log_acc = torch.where(torch.isfinite(h1), torch.clamp(h0 - h1, max=0.0), torch.full_like(h1, -math.inf))
        accept = torch.log(u) < log_acc
        return torch.where(accept, q1, q), torch.exp(log_acc)

    eps0 = torch.full((), float(step_size), dtype=dtype, device=device) / torch.sqrt(betas_t)
    mu0 = torch.log(10.0 * eps0)
    log_eps = log_eps_bar = torch.log(eps0)
    h_bar = torch.zeros(n_rep, dtype=dtype, device=device)
    d_beta = betas_t[:-1] - betas_t[1:]
    qs = q0[None, :].repeat(n_rep, 1)
    cold, cold_u, acc_ps, swap_accs, pair_ons = [], [], [], [], []
    for i in range(n_total):
        in_warmup = i < n_warmup
        eps = torch.exp(log_eps if in_warmup else log_eps_bar)
        z, u, u_swap = draw(i)
        moved = [transition(qs[r], betas_t[r], eps[r], z[r], u[r]) for r in range(n_rep)]
        qs = torch.stack([q for q, _ in moved])
        acc_p = torch.stack([a for _, a in moved])

        if in_warmup:
            # per-replica dual averaging
            m = float(i + 1)
            eta = 1.0 / (m + DA_T0)
            h_bar = (1.0 - eta) * h_bar + eta * (target_accept - acc_p)
            log_eps = mu0 - math.sqrt(m) / DA_GAMMA * h_bar
            w = m ** (-DA_KAPPA)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar

        # the even/odd adjacent-pair swap sweep: pairs (p, p+1), p ≡ i (mod 2)
        with torch.no_grad():
            u_all = torch.stack([potential_fn(q).detach() for q in qs])
            e_all = u_all - torch.stack([reference_fn(q) for q in qs])
        log_alpha = d_beta * (e_all[:-1] - e_all[1:])
        pair_on = (torch.arange(n_rep - 1, device=device) % 2) == (i % 2)
        do_swap = pair_on & (torch.log(u_swap) < log_alpha)
        # slot k receives from k+1 if do_swap[k], from k-1 if do_swap[k-1]
        no = torch.zeros(1, dtype=torch.bool, device=device)
        take_next = torch.cat([do_swap, no])
        take_prev = torch.cat([no, do_swap])
        qs = torch.where(take_next[:, None], torch.roll(qs, -1, dims=0),
                         torch.where(take_prev[:, None], torch.roll(qs, 1, dims=0), qs))
        # the cold slot's potential after the sweep, read off the values above
        cold_u.append(torch.where(take_next[0], u_all[1 % n_rep], u_all[0]))
        cold.append(qs[0])
        acc_ps.append(acc_p)
        swap_accs.append(torch.where(pair_on, torch.clamp(torch.exp(log_alpha), max=1.0),
                                     torch.zeros_like(log_alpha)))
        pair_ons.append(pair_on.to(dtype))
    samples = torch.stack(cold[n_warmup:])
    accept_stat = torch.mean(torch.stack(acc_ps[n_warmup:]), dim=0)
    # each pair is proposed every other sweep: normalize by its proposals
    n_prop = torch.clamp(torch.sum(torch.stack(pair_ons[n_warmup:]), dim=0), min=1.0)
    swap_accept = torch.sum(torch.stack(swap_accs[n_warmup:]), dim=0) / n_prop
    return TemperedResult(
        samples=samples,
        accept_stat=accept_stat,
        swap_accept=swap_accept,
        step_sizes=torch.exp(log_eps_bar),
        betas=betas_t,
        potentials=torch.stack(cold_u[n_warmup:]),
    )
