"""ChEES-HMC: cross-chain adaptive trajectory lengths (Hoffman, Radul &
Sountsov, AISTATS 2021).

Counterpart of the JAX package's ``inference/chees.py``.  K chains integrate
in lockstep with a shared jittered trajectory time ``tau_t = u_t · T_t``
(``u_t`` a base-2 Halton point), so they share one leapfrog count
``clip(ceil(tau_t / eps), 1, max_leapfrog)``.  During warmup:

* ``log T`` follows Adam on the ChEES criterion's gradient, the change in
  squared distance from the cross-chain mean times the end velocity's
  projection, weighted by each chain's accept probability, and clipped so
  that ``T`` stays integrable within the leapfrog cap;
* the shared step size dual-averages the harmonic-mean cross-chain accept
  rate (a NaN accept counts as 0);
* an optional diagonal metric is the within-chain Welford variance averaged
  over the chains, shrunk toward the identity, once 20 draws are in.

Post-warmup the averaged ``(eps, T)`` and the metric freeze.

The port runs eagerly with the JAX sampler's arithmetic step for step.  Where
JAX ``vmap``s the K chains, the port's potentials take one vector (and the
Gram kernels are ``autograd.Function``s over their launches), so each
leapfrog step takes the K gradients one after another, and the chains'
arithmetic runs on the (K, P) batch.  The shared leapfrog count is read to
the host once per draw.

Noise: the start jitter (K, P) when ``q0`` is 1-D, then per draw the
momentum normals (K, P) and the K accept uniforms, from an explicit
``torch.Generator`` on the chains' device, or replayed from ``noise=(jitter
(K, P) or None, z (n_total, K, P), u (n_total, K))``: JAX's ``normal(k_init,
(K, P))`` with ``k_init, key = split(key)``, then per draw ``normal(k_mom,
(K, P))`` and ``uniform(k_acc, (K,))`` with ``k_mom, k_acc =
split(split(key, n_total)[i])``.  Values and gradients are detached
(:func:`.map.value_and_grad`).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .hmc import DA_GAMMA, DA_KAPPA, DA_T0
from .map import value_and_grad

#: Adam on log T, as the JAX sampler sets it.
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_LR = 0.9, 0.999, 1e-8, 0.05


class CheesResult(NamedTuple):
    samples: torch.Tensor  # (n_chains, n_samples, P) post-warmup draws
    accept_prob: torch.Tensor  # (n_total, n_chains) per-draw accept probs
    step_size: torch.Tensor  # final (dual-averaged) step size, 0-d
    trajectory_length: torch.Tensor  # final adapted mean trajectory time T, 0-d
    n_leapfrog: torch.Tensor  # (n_total,) shared leapfrog count per draw
    inv_mass: torch.Tensor  # (P,) diagonal inverse metric in effect at the end
    potentials: torch.Tensor  # (n_chains, n_samples) potential at kept draws


def _halton_base2(n: int) -> np.ndarray:
    """First ``n`` points of the base-2 van der Corput sequence, in (0, 1)
    (bit reversal, exact)."""
    idx = np.arange(1, n + 1, dtype=np.uint64)
    out = np.zeros(n)
    f = 0.5
    while idx.any():
        out += f * (idx & 1)
        idx >>= 1
        f *= 0.5
    return out


def _batched(potential_fn: Callable):
    """``(values (K,), gradients (K, P))`` of the potential at each row,
    one row after another."""

    def vg(q):
        pairs = [value_and_grad(potential_fn, row) for row in q]
        return torch.stack([v for v, _ in pairs]), torch.stack([g for _, g in pairs])

    return vg


def _noise_source(generator, noise, n_total: int, k: int, dim: int, jittered: bool, dtype, device):
    """``(jitter (K, P) or None, draw(i) -> (z (K, P), u (K,)))``."""
    if noise is not None:
        jit, z_all, u_all = noise
        z_all, u_all = (torch.as_tensor(a, dtype=dtype, device=device) for a in (z_all, u_all))
        if tuple(z_all.shape) != (n_total, k, dim) or tuple(u_all.shape) != (n_total, k):
            raise ValueError(
                f"noise must carry z ({n_total}, {k}, {dim}) and u ({n_total}, {k}), got "
                f"{tuple(z_all.shape)} and {tuple(u_all.shape)}"
            )
        if jittered:
            if jit is None or tuple(jit.shape) != (k, dim):
                raise ValueError(f"a (P,) start needs the ({k}, {dim}) start jitter in noise[0]")
            jit = torch.as_tensor(jit, dtype=dtype, device=device)
        return (jit if jittered else None), (lambda i: (z_all[i], u_all[i]))
    if generator is None:
        raise ValueError("chees_sample needs a torch.Generator (generator=) or injected noise (noise=)")
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the chains on {device}")
    jit = torch.randn(k, dim, generator=generator, dtype=dtype, device=device) if jittered else None

    def draw(_):
        z = torch.randn(k, dim, generator=generator, dtype=dtype, device=device)
        return z, torch.rand(k, generator=generator, dtype=dtype, device=device)

    return jit, draw


def chees_sample(
    potential_fn: Callable,
    q0,
    n_samples: int,
    generator: torch.Generator | None = None,
    *,
    n_chains: int = 16,
    step_size: float = 1e-2,
    trajectory_length: float | None = None,
    n_warmup: int = 400,
    max_leapfrog: int = 256,
    target_accept: float = 0.651,
    chain_jitter: float = 0.5,
    adapt_mass: bool = True,
    inv_mass=None,
    noise=None,
) -> CheesResult:
    """Run K lockstep ChEES-HMC chains on the device and in the dtype of
    ``q0``; see the module docstring.

    ``q0`` is either (P,), where chain 0 starts there and chains 1..K-1 are
    jittered by ``chain_jitter`` standard normals, or an explicit (K, P)
    start matrix.  ``trajectory_length`` is the initial mean trajectory time
    T (default ``20 * step_size``).  A start whose potential is non-finite,
    or more than ``10·P`` above the best start's, is pulled back to chain
    0's start.  Returns pooled (K, S, P) samples: score them with
    :func:`.diagnostics.ess_multichain`, never per-chain sums.
    """
    q0 = torch.as_tensor(q0)
    if n_samples < 1:
        raise ValueError(f"n_samples must be >= 1, got {n_samples}")
    if q0.dim() == 2:
        n_chains = q0.shape[0]
    elif q0.dim() != 1:
        raise ValueError(f"q0 must be (P,) or (K, P), got {tuple(q0.shape)}")
    if n_chains < 2:
        raise ValueError(
            f"ChEES needs >= 2 chains (the criterion centers on the cross-chain mean), got {n_chains}"
        )
    n_samples, n_warmup, max_leapfrog = int(n_samples), int(n_warmup), int(max_leapfrog)
    n_total = n_warmup + n_samples
    dim, dtype, device = q0.shape[-1], q0.dtype, q0.device
    jit, draw = _noise_source(generator, noise, n_total, n_chains, dim, q0.dim() == 1, dtype, device)
    if q0.dim() == 1:
        jit = chain_jitter * jit
        jit[0] = 0.0
        q0 = q0[None, :] + jit
    inv_mass0 = (torch.ones(dim, dtype=dtype, device=device) if inv_mass is None
                 else torch.as_tensor(inv_mass, dtype=dtype, device=device))
    if tuple(inv_mass0.shape) != (dim,):
        raise ValueError(f"inv_mass must be a ({dim},) diagonal, got {tuple(inv_mass0.shape)}")
    adapt_mass = bool(adapt_mass) and inv_mass is None
    traj0 = 20.0 * step_size if trajectory_length is None else trajectory_length
    halton = torch.as_tensor(_halton_base2(n_total), dtype=dtype, device=device)
    scalar = lambda v: torch.full((), v, dtype=dtype, device=device)
    vg = _batched(potential_fn)

    # sanitize the starts: a chain whose potential is non-finite, or
    # stranded more than 10·P nats above the best chain, would pin the
    # shared accept statistic at zero and collapse eps for every chain;
    # pull it back to chain 0's start
    with torch.no_grad():
        u0 = torch.stack([potential_fn(row).detach() for row in q0])
    finite = torch.isfinite(u0)
    best = torch.min(torch.where(finite, u0, torch.full_like(u0, math.inf)))
    ok0 = finite & (u0 <= best + 10 * dim)
    q = torch.where(ok0[:, None], q0, q0[0:1])
    u_q, g_q = vg(q)

    step0 = scalar(float(step_size))
    mu = torch.log(10.0 * step0)
    log_eps = log_eps_bar = torch.log(step0)
    h_bar = scalar(0.0)
    log_t = log_t_bar = torch.log(scalar(float(traj0)))
    adam_m = adam_v = scalar(0.0)
    m_inv = inv_mass0
    w_count = 0.0
    w_mean = torch.zeros(n_chains, dim, dtype=dtype, device=device)
    w_m2 = torch.zeros_like(w_mean)
    qs, us, aps, n_steps_all = [], [], [], []
    for i in range(n_total):
        in_warmup = i < n_warmup
        eps = torch.exp(log_eps if in_warmup else log_eps_bar)
        t_now = torch.exp(log_t if in_warmup else log_t_bar)
        # shared jittered trajectory time -> shared leapfrog count, read to
        # the host (JAX's saturating int32 cast maps NaN to 0, then clips)
        tau = halton[i] * t_now
        steps = torch.ceil(tau / eps).item()
        n_steps = 1 if math.isnan(steps) else int(min(max(steps, 1.0), max_leapfrog))
        xi, u_acc = draw(i)
        p = xi / torch.sqrt(m_inv)[None, :]
        kin = lambda p: 0.5 * torch.sum(p * p * m_inv[None, :], dim=1)
        h0 = u_q + kin(p)

        # lockstep fused leapfrog: one gradient per chain per step
        p_new = p - 0.5 * eps * g_q
        q_new = q + eps * (m_inv[None, :] * p_new)
        for _ in range(n_steps - 1):
            p_new = p_new - eps * vg(q_new)[1]
            q_new = q_new + eps * (m_inv[None, :] * p_new)
        u_new, g_new = vg(q_new)
        p_new = p_new - 0.5 * eps * g_new
        h1 = u_new + kin(p_new)
        log_accept = torch.where(torch.isfinite(h1), torch.clamp(h0 - h1, max=0.0),
                                 torch.full_like(h1, -math.inf))
        accept_prob = torch.exp(log_accept)
        accept = torch.log(u_acc) < log_accept
        q_out = torch.where(accept[:, None], q_new, q)
        u_out = torch.where(accept, u_new, u_q)
        g_out = torch.where(accept[:, None], g_new, g_q)

        m_i = scalar(float(i)) + 1.0
        if in_warmup:
            # the ChEES gradient: centred displacements, proposals weighted
            # by their accept probability (Hoffman et al. 2021, eq. 8)
            dq0 = q - torch.mean(q, dim=0, keepdim=True)
            dq1 = q_new - torch.mean(q_new, dim=0, keepdim=True)
            v1 = m_inv[None, :] * p_new
            per_chain = (torch.sum(dq1 * dq1, dim=1) - torch.sum(dq0 * dq0, dim=1)) * torch.sum(dq1 * v1, dim=1)
            wsum = torch.sum(accept_prob) + 1e-12
            g_tau = torch.sum(accept_prob * per_chain) / wsum
            g_logt = torch.where(torch.isfinite(g_tau), g_tau * tau, torch.zeros_like(g_tau))
            adam_m = ADAM_B1 * adam_m + (1 - ADAM_B1) * g_logt
            adam_v = ADAM_B2 * adam_v + (1 - ADAM_B2) * g_logt * g_logt
            mhat = adam_m / (1 - ADAM_B1 ** m_i)
            vhat = adam_v / (1 - ADAM_B2 ** m_i)
            log_t_new = log_t + ADAM_LR * mhat / (torch.sqrt(vhat) + ADAM_EPS)
            # keep T integrable within the leapfrog cap at the current eps
            log_t_new = torch.minimum(torch.maximum(log_t_new, torch.log(eps)),
                                      torch.log(0.9 * max_leapfrog * eps))
            w_t = m_i ** (-DA_KAPPA)
            log_t_bar = w_t * log_t_new + (1 - w_t) * log_t_bar
            log_t = log_t_new

            # dual averaging on the harmonic-mean cross-chain accept, a NaN
            # accept counting as 0 and the mean clipped into [0, 1]
            acc_safe = torch.where(torch.isnan(accept_prob), torch.zeros_like(accept_prob), accept_prob)
            hm_accept = torch.clamp(n_chains / torch.sum(1.0 / (acc_safe + 1e-6)), 0.0, 1.0)
            eta = 1.0 / (m_i + DA_T0)
            h_bar = (1 - eta) * h_bar + eta * (target_accept - hm_accept)
            log_eps = mu - torch.sqrt(m_i) / DA_GAMMA * h_bar
            w_e = m_i ** (-DA_KAPPA)
            log_eps_bar = w_e * log_eps + (1 - w_e) * log_eps_bar

            if adapt_mass:
                # per-chain Welford averaged across the chains: the
                # within-chain variance, which chains that have not met yet
                # cannot inflate, shrunk toward the identity
                w_count += 1.0
                delta = q_out - w_mean
                w_mean = w_mean + delta / w_count
                w_m2 = w_m2 + delta * (q_out - w_mean)
                if w_count >= 20.0:
                    var = torch.mean(w_m2, dim=0) / max(w_count - 1.0, 1.0)
                    pooled = w_count * n_chains
                    m_inv = (pooled / (pooled + 5.0)) * var + (5.0 / (pooled + 5.0))

        q, u_q, g_q = q_out, u_out, g_out
        qs.append(q)
        us.append(u_q)
        aps.append(accept_prob)
        n_steps_all.append(n_steps)
    return CheesResult(
        samples=torch.stack(qs[n_warmup:], dim=1),
        accept_prob=torch.stack(aps),
        step_size=torch.exp(log_eps_bar),
        trajectory_length=torch.exp(log_t_bar),
        n_leapfrog=torch.tensor(n_steps_all, dtype=torch.int32, device=device),
        inv_mass=m_inv,
        potentials=torch.stack(us[n_warmup:], dim=1),
    )
