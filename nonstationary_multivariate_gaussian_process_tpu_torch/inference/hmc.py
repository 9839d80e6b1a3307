"""Hamiltonian Monte Carlo with the reference's sampler contract.

Counterpart of the JAX package's ``inference/hmc.py``.  The reference takes
its sampler from a sibling repo (``Nonseparable_model.py:24-25`` imports
``Hamiltonian_Monte_Carlo/HMC_Sampler``; the call sites at :228-231 show the
contract): a potential over a flat vector, a MAP warm start, a fixed step
size and leapfrog count, optional mass-matrix preconditioning and step-size
adaptation, and rejected proposals repeating the current state.

The port runs eagerly, one draw after another, with the JAX driver's
arithmetic step for step:

* the fused leapfrog takes one gradient per step: adjacent half kicks are
  chained into full kicks and the entry gradient is the cached one of the
  current state, so a draw of ``n_leapfrog`` steps costs ``n_leapfrog``
  gradients, and a chain ``1 + n_draws · n_leapfrog``;
* the mass is the identity, a diagonal or a dense SPD matrix (its Cholesky
  taken once); the reference builds one from a pilot run's sample
  covariance (``Nonseparable_model_mpiKAISER_extended.py:542-570``);
* step-size adaptation is Nesterov dual averaging toward ``target_accept``
  over ``n_warmup`` draws, then frozen at the averaged step size;
* ``adapt_mass=True`` follows Stan's windowed warmup (:mod:`.warmup`),
  refreshing a diagonal inverse metric at each slow window's end.

A draw takes a standard normal ``z`` of length P and then one uniform ``u``
from an explicit ``torch.Generator`` on the chain's device; the momentum is
built from ``z`` as the JAX driver builds it from its normal draw.  Passing
``noise=(z, u)`` instead replays given draws, which holds the chain against
the JAX one draw by draw.

The chain stays on the device: accept and reject go through ``torch.where``
on 0-d tensors, the adaptation state is tensors in the chain's dtype, and the
warmup schedule is host numpy read as Python booleans.  Nothing here brings a
value to the host per draw.  Values and gradients are detached
(:func:`..inference.map.value_and_grad`), so a long chain keeps no autograd
graph alive; only the kept draws, their potentials and the per-draw
acceptance are stored.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .map import value_and_grad
from .warmup import regularized_variance, window_schedule

#: Dual-averaging constants (Hoffman & Gelman 2014), as the JAX drivers set them.
DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75

DISPATCHES = ("device", "host")


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (n_samples, P) post-warmup draws
    accept_prob: torch.Tensor  # (n_total,) per-draw acceptance probabilities
    accepted: torch.Tensor  # (n_total,) accept indicator
    step_size: torch.Tensor  # final (possibly adapted) step size, 0-d
    potentials: torch.Tensor  # (n_samples,) potential at each kept draw
    inv_mass: torch.Tensor | None = None  # (P,) adapted inverse metric (windowed warmup)


def estimate_mass_matrix(pilot_samples: torch.Tensor, reg: float = 1e-10) -> torch.Tensor:
    """Mass matrix = inverse of a regularized pilot sample covariance
    (``Nonseparable_model_mpiKAISER_extended.py:542-570``); the covariance
    takes ``correction=1``, as ``jnp.cov`` does."""
    s = torch.as_tensor(pilot_samples)
    cov = torch.cov(s.T, correction=1) + reg * torch.eye(s.shape[1], dtype=s.dtype, device=s.device)
    return torch.linalg.inv(cov)


def _mass_ops(mass, dtype, device):
    """``(momentum(z), kinetic(p), minv(p))`` for the mass spec: ``None``
    (identity), a (P,) diagonal or a (P, P) dense matrix."""
    if mass is None:
        return (lambda z: z), (lambda p: 0.5 * torch.dot(p, p)), (lambda p: p)
    mass = torch.as_tensor(mass, dtype=dtype, device=device)
    if mass.dim() == 1:
        sqrt_m = torch.sqrt(mass)
        return (
            lambda z: sqrt_m * z,
            lambda p: 0.5 * torch.dot(p, p / mass),
            lambda p: p / mass,
        )
    chol_m = torch.linalg.cholesky(mass)
    cho_solve = lambda p: torch.cholesky_solve(p[:, None], chol_m)[:, 0]
    return (
        lambda z: chol_m @ z,
        lambda p: 0.5 * torch.dot(p, cho_solve(p)),
        cho_solve,
    )


def _leapfrog(vg, q, p, g_q, eps, drift, n_leapfrog: int):
    """Fused leapfrog: ``n_leapfrog`` steps cost ``n_leapfrog`` gradients.

    The textbook half-kick/drift/half-kick form costs two gradients a step;
    chaining adjacent half kicks into full kicks and reusing the cached
    gradient ``g_q`` at the entry point brings it to one a step, the last
    one a value and gradient (whose value the Metropolis test needs).
    ``drift(q, p)`` is the position update ``q + eps·M⁻¹p``.
    """
    p = p - 0.5 * eps * g_q
    q = drift(q, p)
    for _ in range(n_leapfrog - 1):
        p = p - eps * vg(q)[1]
        q = drift(q, p)
    u, g = vg(q)
    p = p - 0.5 * eps * g
    return q, p, u, g


def _metropolis(h0, h1, u):
    """``(accept_prob, accept)``: ``log α = min(0, h0 − h1)``, −inf for a
    non-finite end energy, and ``log u < log α``."""
    log_accept = torch.where(torch.isfinite(h1), torch.clamp(h0 - h1, max=0.0),
                             torch.full_like(h1, -math.inf))
    return torch.exp(log_accept), torch.log(u) < log_accept


def _noise_source(generator, noise, n_total: int, dim: int, dtype, device):
    """``draw(i) -> (z (P,), u ())``: from ``noise=(z (n_total, P), u
    (n_total,))`` when given, else ``z`` then ``u`` from ``generator``."""
    if noise is not None:
        z_all, u_all = (torch.as_tensor(a, dtype=dtype, device=device) for a in noise)
        if tuple(z_all.shape) != (n_total, dim) or tuple(u_all.shape) != (n_total,):
            raise ValueError(
                f"noise must be z ({n_total}, {dim}) and u ({n_total},), got "
                f"{tuple(z_all.shape)} and {tuple(u_all.shape)}"
            )
        return lambda i: (z_all[i], u_all[i])
    if generator is None:
        raise ValueError("hmc_sample needs a torch.Generator (generator=) or injected noise (noise=)")
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the chain on {device}")

    def draw(_):
        z = torch.randn(dim, generator=generator, dtype=dtype, device=device)
        return z, torch.rand((), generator=generator, dtype=dtype, device=device)

    return draw


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _run(vg, q0, draw, n_samples, step_size0, n_leapfrog, n_warmup, adapt_step_size, target_accept,
         mass):
    """The plain driver: fixed mass, optional dual averaging over the first
    ``n_warmup`` draws (JAX ``_run``, and ``_run_host`` with the identity
    mass)."""
    momentum, kinetic, minv = _mass_ops(mass, q0.dtype, q0.device)
    n_total = n_warmup + n_samples
    mu = math.log(10.0 * step_size0)
    log_eps = log_eps_bar = _scalar(math.log(step_size0), q0)
    h_bar = _scalar(0.0, q0)
    eps = _scalar(step_size0, q0)
    q = q0
    u_q, g_q = vg(q0)
    qs, us, aps, accs = [], [], [], []
    for i in range(n_total):
        z, u = draw(i)
        p = momentum(z)
        h0 = u_q + kinetic(p)
        drift = lambda q, p: q + eps * minv(p)
        q_new, p_new, u_new, g_new = _leapfrog(vg, q, p, g_q, eps, drift, n_leapfrog)
        h1 = u_new + kinetic(p_new)
        accept_prob, accept = _metropolis(h0, h1, u)
        q = torch.where(accept, q_new, q)
        u_q = torch.where(accept, u_new, u_q)
        g_q = torch.where(accept, g_new, g_q)
        if adapt_step_size:
            # end-of-draw step size: the freshly adapted one while this draw
            # is a warmup draw (the last one included), the average after
            if i < n_warmup:
                m = float(i + 1)
                eta = 1.0 / (m + DA_T0)
                h_bar = (1.0 - eta) * h_bar + eta * (target_accept - accept_prob)
                log_eps = mu - math.sqrt(m) / DA_GAMMA * h_bar
                w = m ** (-DA_KAPPA)
                log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
                eps = torch.exp(log_eps)
            else:
                eps = torch.exp(log_eps_bar)
        qs.append(q)
        us.append(u_q)
        aps.append(accept_prob)
        accs.append(accept)
    return torch.stack(qs), torch.stack(us), torch.stack(aps), torch.stack(accs), eps


def _run_adapt(vg, q0, draw, n_samples, step_size0, n_leapfrog, n_warmup, target_accept):
    """Windowed warmup: joint step-size and diagonal-mass adaptation (JAX
    ``_run_adapt``).  Welford sums run over the schedule's slow windows; at
    each window's end the inverse metric becomes their regularized variance
    and dual averaging restarts around the averaged step size.  The window
    counts follow the schedule alone, so they stay host numbers."""
    sched = window_schedule(n_warmup)
    dim = q0.shape[0]
    n_total = n_warmup + n_samples
    zeros = lambda: torch.zeros(dim, dtype=q0.dtype, device=q0.device)
    log_eps = log_eps_bar = _scalar(math.log(step_size0), q0)
    h_bar = _scalar(0.0, q0)
    mu = torch.log(10.0 * _scalar(step_size0, q0))
    m_inv = torch.ones(dim, dtype=q0.dtype, device=q0.device)
    w_count, w_mean, w_m2 = 0.0, zeros(), zeros()
    q = q0
    u_q, g_q = vg(q0)
    qs, us, aps, accs = [], [], [], []
    for i in range(n_total):
        in_warmup = i < n_warmup
        eps = torch.exp(log_eps if in_warmup else log_eps_bar)
        z, u = draw(i)
        p = z / torch.sqrt(m_inv)
        h0 = u_q + 0.5 * torch.dot(p, m_inv * p)
        drift = lambda q, p: q + eps * m_inv * p
        q_new, p_new, u_new, g_new = _leapfrog(vg, q, p, g_q, eps, drift, n_leapfrog)
        h1 = u_new + 0.5 * torch.dot(p_new, m_inv * p_new)
        accept_prob, accept = _metropolis(h0, h1, u)
        q = torch.where(accept, q_new, q)
        u_q = torch.where(accept, u_new, u_q)
        g_q = torch.where(accept, g_new, g_q)
        if in_warmup:
            # dual averaging within the current epoch (the step restarts per window)
            m = float(sched.da_step[i])
            eta = 1.0 / (m + DA_T0)
            h_bar = (1.0 - eta) * h_bar + eta * (target_accept - accept_prob)
            log_eps = mu - math.sqrt(m) / DA_GAMMA * h_bar
            w = m ** (-DA_KAPPA)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            if sched.in_slow[i]:
                w_count += 1.0
                delta = q - w_mean
                w_mean = w_mean + delta / max(w_count, 1.0)
                w_m2 = w_m2 + delta * (q - w_mean)
            if sched.window_end[i]:
                # refresh the metric, restart dual averaging around the
                # averaged step size, reset the accumulators
                m_inv = regularized_variance(w_count, w_mean, w_m2)
                eps_r = torch.exp(log_eps_bar)
                log_eps = torch.log(eps_r)
                mu = torch.log(10.0 * eps_r)
                h_bar = torch.zeros_like(h_bar)
                w_count, w_mean, w_m2 = 0.0, zeros(), zeros()
        qs.append(q)
        us.append(u_q)
        aps.append(accept_prob)
        accs.append(accept)
    return (torch.stack(qs), torch.stack(us), torch.stack(aps), torch.stack(accs),
            torch.exp(log_eps_bar), m_inv)


def hmc_sample(
    potential_fn: Callable,
    init_position: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    step_size: float = 1e-4,
    n_leapfrog: int = 20,
    n_warmup: int = 0,
    adapt_step_size: bool = False,
    target_accept: float = 0.75,
    mass_matrix=None,
    adapt_mass: bool = False,
    dispatch: str = "device",
    noise=None,
) -> HMCResult:
    """Draw ``n_samples`` HMC samples after ``n_warmup`` adaptation draws, on
    the device and in the dtype of ``init_position``.

    ``potential_fn`` is the negative log posterior over the packed parameter
    vector, the objective the MAP engine minimizes (the reference's
    ``potential_func=logpos.nlogpos_obj_SVC``, Nonseparable_model.py:228-230).
    ``generator`` is a ``torch.Generator`` on the chain's device; ``noise=(z
    (n_total, P), u (n_total,))`` replaces it with given draws.

    ``adapt_mass=True`` runs Stan-style windowed warmup instead of plain
    dual averaging (see :mod:`.warmup`); it excludes ``mass_matrix``.

    ``dispatch`` keeps the JAX signature: there ``"device"`` runs the chain
    as one XLA program and ``"host"`` as one dispatch per draw (identity
    mass only).  The port runs eagerly, so both run the same draw loop; the
    argument checks are JAX's.
    """
    q0 = torch.as_tensor(init_position)
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r} (want 'device' or 'host')")
    if dispatch == "host" and (adapt_mass or mass_matrix is not None):
        raise ValueError("dispatch='host' supports the identity-mass plain chain "
                         "(use the default driver for mass-matrix/windowed warmup)")
    if adapt_mass and mass_matrix is not None:
        raise ValueError("adapt_mass=True adapts the metric; drop mass_matrix")
    n_samples, n_warmup, n_leapfrog = int(n_samples), int(n_warmup), int(n_leapfrog)
    draw = _noise_source(generator, noise, n_warmup + n_samples, q0.shape[0], q0.dtype, q0.device)
    vg = lambda q: value_and_grad(potential_fn, q)
    inv_mass = None
    if adapt_mass:
        qs, us, aps, accs, epsf, inv_mass = _run_adapt(
            vg, q0, draw, n_samples, float(step_size), n_leapfrog, n_warmup, float(target_accept)
        )
    else:
        qs, us, aps, accs, epsf = _run(
            vg, q0, draw, n_samples, float(step_size), n_leapfrog, n_warmup, bool(adapt_step_size),
            float(target_accept), mass_matrix,
        )
    return HMCResult(
        samples=qs[n_warmup:],
        accept_prob=aps,
        accepted=accs,
        step_size=epsf,
        potentials=us[n_warmup:],
        inv_mass=inv_mass,
    )


def chain_generators(generator: torch.Generator | None, n_chains: int, caller: str) -> list[torch.Generator]:
    """One generator per chain on ``generator``'s device, each seeded with
    one of ``n_chains`` integers drawn from ``generator`` (as JAX splits its
    key per chain)."""
    if generator is None:
        raise ValueError(f"{caller} needs a torch.Generator (generator=) or noise=")
    seeds = torch.randint(0, 2**62, (n_chains,), generator=generator, device=generator.device)
    return [torch.Generator(generator.device).manual_seed(int(s)) for s in seeds.tolist()]


def hmc_sample_chains(
    potential_fn: Callable,
    init_positions: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    noise=None,
    **kwargs,
) -> HMCResult:
    """Run several independent chains, one after another.

    ``init_positions``: (C, P), e.g. the MAP plus jittered restarts.  Chain
    c draws from its own generator, seeded with the c-th of C integers drawn
    from ``generator`` (as JAX splits its key per chain), or replays
    ``noise=(z (C, n_total, P), u (C, n_total))[c]``.  Every ``HMCResult``
    field gains a leading chain axis; feed ``samples`` to
    :func:`.diagnostics.rhat` for convergence checks.
    """
    n_chains = init_positions.shape[0]
    if noise is not None:
        per_chain = [dict(noise=(noise[0][c], noise[1][c])) for c in range(n_chains)]
    else:
        per_chain = [dict(generator=g) for g in chain_generators(generator, n_chains, "hmc_sample_chains")]
    runs = [hmc_sample(potential_fn, init_positions[c], n_samples, **per_chain[c], **kwargs)
            for c in range(n_chains)]
    return HMCResult(*(
        None if runs[0][k] is None else torch.stack([r[k] for r in runs])
        for k in range(len(HMCResult._fields))
    ))
