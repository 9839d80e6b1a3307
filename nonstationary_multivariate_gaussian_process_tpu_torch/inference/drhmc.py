"""Delayed-rejection HMC (Modi, Barnett & Carpenter 2023).

Counterpart of the JAX package's ``inference/drhmc.py``.  When the stage-1
proposal (step ``eps``) is rejected, the draw proposes again from the same
point with ``eps / reduction``, and accepts with the Mira/Green
delayed-rejection ratio, which keeps detailed balance by weighing in the
*ghost* proposals launched from the new proposal point:

    a_k(x) = min{1, [ pi(y_k) * prod_{j<k} (1 - a_j(y_k)) ]
                  / [ pi(x)   * prod_{j<k} (1 - a_j(x))   ] }

with ``y_k`` the stage-``k`` proposal (leapfrog at ``eps_k`` and a momentum
flip, an involution) and ``a_j(y_k)`` the stage-``j`` acceptance computed
from ``y_k``.  A stage-``k`` test costs ``2**(k-1)`` trajectories, so a draw
that accepts at stage 1 pays one, and one rejected at every stage
``2**n_stages - 1``.

The port runs eagerly, one draw after another, with the JAX sampler's
arithmetic step for step:

* each proposal recomputes its entry gradient, as JAX's does, so one
  trajectory costs ``n_leapfrog + 1`` gradients;
* the retry stages run only while no stage has accepted: where JAX skips
  them with ``lax.cond``, the port reads "accepted yet" to the host once per
  stage tried (once per draw in the bulk, against ``n_leapfrog + 1``
  gradients), and never computes an untaken stage;
* step-size adaptation dual-averages the stage-1 acceptance toward
  ``target_accept`` over the first ``n_warmup`` draws.

A draw takes a standard normal ``z`` of length P and then ``n_stages``
uniforms from an explicit ``torch.Generator`` on the chain's device, or
replays ``noise=(z (n_total, P), u (n_total, n_stages))``: JAX's
``normal(k_mom, (P,))`` and ``uniform(k_acc, (n_stages,))`` with ``k_mom,
k_acc = split(keys[i])``.  Values and gradients are detached
(:func:`.map.value_and_grad`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import DA_GAMMA, DA_KAPPA, DA_T0
from .map import value_and_grad


class DRHMCResult(NamedTuple):
    samples: torch.Tensor  # (n_samples, P) post-warmup draws
    accept_stage: torch.Tensor  # (n_total,) accepting stage (1-based; 0 = all rejected)
    accept_prob1: torch.Tensor  # (n_total,) stage-1 acceptance probabilities
    step_size: torch.Tensor  # final (adapted) stage-1 step size, 0-d
    potentials: torch.Tensor  # (n_samples,) potential at each kept draw


def _log1m_exp(a: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(a)) for a <= 0, stable at both ends; -inf for a >= 0."""
    a = torch.clamp(a, max=0.0)
    big = a > math.log(0.5)
    # where() evaluates both sides: feed each branch an argument that is
    # safe for it so that no NaN leaks through the untaken side
    safe_hi = torch.clamp(a, max=-1e-12)
    return torch.where(big, torch.log(-torch.expm1(safe_hi)), torch.log1p(-torch.exp(a)))


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an integer ``n`` by JAX's ``lax.integer_pow`` order
    (square and multiply, the reciprocal for ``n < 0``)."""
    if n == 0:
        return torch.ones_like(x)
    k, acc = abs(n), None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return 1.0 / acc if n < 0 else acc


def _noise_source(generator, noise, n_total: int, dim: int, n_stages: int, dtype, device):
    """``draw(i) -> (z (P,), u (n_stages,))``."""
    if noise is not None:
        z_all, u_all = (torch.as_tensor(a, dtype=dtype, device=device) for a in noise)
        if tuple(z_all.shape) != (n_total, dim) or tuple(u_all.shape) != (n_total, n_stages):
            raise ValueError(
                f"noise must be z ({n_total}, {dim}) and u ({n_total}, {n_stages}), got "
                f"{tuple(z_all.shape)} and {tuple(u_all.shape)}"
            )
        return lambda i: (z_all[i], u_all[i])
    if generator is None:
        raise ValueError("drhmc_sample needs a torch.Generator (generator=) or injected noise (noise=)")
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the chain on {device}")

    def draw(_):
        z = torch.randn(dim, generator=generator, dtype=dtype, device=device)
        return z, torch.rand(n_stages, generator=generator, dtype=dtype, device=device)

    return draw


def drhmc_sample(
    potential_fn: Callable,
    init_position: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    step_size: float = 1e-3,
    n_leapfrog: int = 20,
    n_warmup: int = 0,
    n_stages: int = 3,
    reduction: float = 4.0,
    adapt_step_size: bool = True,
    target_accept: float = 0.8,
    mass_matrix=None,
    noise=None,
) -> DRHMCResult:
    """Delayed-rejection HMC over the packed parameter vector, on the device
    and in the dtype of ``init_position``.

    Same potential contract as :func:`.hmc.hmc_sample`.  A draw proposes at
    ``step_size``; each rejection retries from the same point at
    ``step_size / reduction**k`` (``n_stages - 1`` retries).  Step-size
    adaptation dual-averages the *stage-1* acceptance toward
    ``target_accept`` during ``n_warmup``.  ``mass_matrix``: diagonal only
    (a (P,) vector).  ``generator`` is a ``torch.Generator`` on the chain's
    device; ``noise=(z (n_total, P), u (n_total, n_stages))`` replaces it.
    """
    q0 = torch.as_tensor(init_position)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if mass_matrix is not None and torch.as_tensor(mass_matrix).dim() != 1:
        raise ValueError("drhmc_sample takes a diagonal (P,) mass_matrix only")
    n_samples, n_warmup, n_leapfrog, n_stages = int(n_samples), int(n_warmup), int(n_leapfrog), int(n_stages)
    n_total = n_warmup + n_samples
    dim, dtype, device = q0.shape[0], q0.dtype, q0.device
    draw = _noise_source(generator, noise, n_total, dim, n_stages, dtype, device)
    scalar = lambda v: torch.full((), v, dtype=dtype, device=device)
    m_diag = (torch.ones(dim, dtype=dtype, device=device) if mass_matrix is None
              else torch.as_tensor(mass_matrix, dtype=dtype, device=device))
    sqrt_m = torch.sqrt(m_diag)
    m_inv = 1.0 / m_diag
    red = scalar(float(reduction))
    vg = lambda q: value_and_grad(potential_fn, q)
    kinetic = lambda p: 0.5 * torch.dot(p, m_inv * p)

    def propose(q, p, eps):
        """Leapfrog(eps, n_leapfrog) and a momentum flip; the proposal, its
        potential and its total energy."""
        g = vg(q)[1]
        p = p - 0.5 * eps * g
        q = q + eps * m_inv * p
        for _ in range(n_leapfrog - 1):
            p = p - eps * vg(q)[1]
            q = q + eps * m_inv * p
        u, g = vg(q)
        p = p - 0.5 * eps * g
        return q, -p, u, u + kinetic(p)

    def ghost_alphas(q, p, h, upto, eps1):
        """log a_1(z)..log a_upto(z) from ``z = (q, p)``; each a_j(z) feeds
        the deeper stages' denominators, so the tree costs ``2**upto - 1``
        trajectories."""
        las = []
        for k in range(1, upto + 1):
            las.append(stage_alpha(k, q, p, h, las, eps1)[0])
        return las

    def stage_alpha(stage, q, p, h, las_here, eps1):
        """log a_stage(z) given log a_1(z)..log a_{stage-1}(z); the
        numerator weighs the ghost rejections launched from the proposal."""
        eps_k = eps1 * _integer_pow(red, -(stage - 1))
        q1, p1, u1, h1 = propose(q, p, eps_k)
        num = -h1
        den = -h
        if stage > 1:
            las_ghost = ghost_alphas(q1, p1, h1, stage - 1, eps1)
            for j in range(stage - 1):
                num = num + _log1m_exp(las_ghost[j])
                den = den + _log1m_exp(las_here[j])
        ok = torch.isfinite(h1) & torch.isfinite(num) & torch.isfinite(den)
        la = torch.where(ok, torch.clamp(num - den, max=0.0), torch.full_like(h1, -math.inf))
        return la, q1, u1

    mu = math.log(10.0 * float(step_size))
    log_eps = log_eps_bar = scalar(math.log(float(step_size)))
    h_bar = scalar(0.0)
    eps1 = scalar(float(step_size))
    q = q0
    with torch.no_grad():
        u_q = potential_fn(q0).detach()
    qs, us, stages, ap1s = [], [], [], []
    for i in range(n_total):
        z, u = draw(i)
        p = sqrt_m * z
        h0 = u_q + kinetic(p)
        log_u = torch.log(u)
        # stage 1 always runs; las holds log a_j(x) of the stages tried
        la1, q1, u1 = stage_alpha(1, q, p, h0, [], eps1)
        stage = 1 if bool(log_u[0] < la1) else 0
        if stage:
            q, u_q = q1, u1
        las = [la1]
        for s in range(2, n_stages + 1):
            if stage:
                break
            la, q_s, u_s = stage_alpha(s, q, p, h0, las, eps1)
            las.append(la)
            if bool(log_u[s - 1] < la):
                stage, q, u_q = s, q_s, u_s
        accept_prob1 = torch.exp(la1)
        if adapt_step_size:
            if i < n_warmup:
                m = float(i + 1)
                eta = 1.0 / (m + DA_T0)
                h_bar = (1.0 - eta) * h_bar + eta * (target_accept - accept_prob1)
                log_eps = mu - math.sqrt(m) / DA_GAMMA * h_bar
                w = m ** (-DA_KAPPA)
                log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
                eps1 = torch.exp(log_eps)
            else:
                eps1 = torch.exp(log_eps_bar)
        qs.append(q)
        us.append(u_q)
        stages.append(stage)
        ap1s.append(accept_prob1)
    return DRHMCResult(
        samples=torch.stack(qs)[n_warmup:],
        accept_stage=torch.tensor(stages, dtype=torch.int32, device=device),
        accept_prob1=torch.stack(ap1s),
        step_size=eps1,
        potentials=torch.stack(us)[n_warmup:],
    )
