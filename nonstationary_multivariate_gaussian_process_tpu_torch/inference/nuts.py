"""No-U-Turn Sampler (NUTS) with Stan-style adaptive warmup.

Counterpart of the JAX package's ``inference/nuts.py``, a dynamic-trajectory
sampler in the Stan/numpyro family that goes beyond the reference's
fixed-length HMC (``Hamiltonian_Monte_Carlo/HMC_Sampler``, imported at
``Nonseparable_model.py:24-25``):

* **iterative tree building**: a trajectory doubles until it turns, diverges
  or reaches ``max_depth`` doublings.  Each doubling integrates a subtree of
  ``2^depth`` leaves outward from one edge; its sub-U-turn checks need only
  the left-edge momenta of the subtrees that end at the current leaf, kept
  in a checkpoint stack indexed by the leaf's binary decomposition;
* **multinomial (progressive) sampling**: each leaf replaces the subtree's
  proposal with probability ``w_leaf / w_subtree`` (weights ``e^{-H}``), and
  a finished subtree replaces the trajectory's with the biased rule
  ``min(1, w_new / w_old)``; a turning or diverging subtree's proposal is
  discarded;
* **adaptation**: dual averaging of the step size toward ``target_accept``
  on the mean leaf acceptance statistic, and a diagonal inverse metric from
  the windowed warmup schedule (:mod:`.warmup`).

A leaf diverges when its energy error exceeds ``MAX_DELTA_ENERGY`` (a NaN
energy counts as +inf).

The port runs eagerly with the JAX sampler's arithmetic step for step.  The
JAX package's ``lax.while_loop``s become Python loops, whose only decision
the host must read is whether a subtree stops: one read of a 0-d flag a
leaf, on top of the gradient's own synchronization on its Cholesky factor.
Leaf and checkpoint indices are Python integers; a leaf's sub-U-turn checks
are one batched expression; tree directions, proposals and the adaptation
state stay on the device (``torch.where`` on 0-d tensors).  A leaf costs
one gradient, so a draw costs ``n_leapfrog`` gradients and a chain
``1 + Σ n_leapfrog``.

The noise comes from a ``torch.Generator`` on the chain's device: per draw a
standard normal ``z`` of length P (the momentum is ``z / sqrt(m_inv)``, as
JAX builds it), then per doubling a direction (a uniform below 0.5), the
subtree's ``2^depth`` leaf uniforms in one draw and the merge uniform.
``noise=(z, go_right, u_leaf, u_merge)`` replays given draws instead, which
holds the chain against the JAX one draw by draw.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import DA_GAMMA, DA_KAPPA, DA_T0, _scalar, chain_generators
from .map import value_and_grad
from .warmup import regularized_variance, window_schedule

MAX_DELTA_ENERGY = 1000.0


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (n_samples, P) post-warmup draws
    potentials: torch.Tensor  # (n_samples,) potential at each kept draw
    accept_stat: torch.Tensor  # (n_total,) mean leaf acceptance statistic
    tree_depth: torch.Tensor  # (n_total,) doublings realized per draw
    n_leapfrog: torch.Tensor  # (n_total,) gradient evaluations per draw
    diverging: torch.Tensor  # (n_total,) divergence flag per draw
    step_size: torch.Tensor  # final adapted step size, 0-d
    inv_mass: torch.Tensor  # (P,) final (possibly adapted) inverse metric


def _is_turning(m_inv, r_l, r_r, rho):
    """Generalized U-turn criterion: turning when either edge's velocity
    points against the segment's momentum sum ``rho``.  ``r_l`` and ``rho``
    may carry a leading axis of segments (one flag each)."""
    v_l = m_inv * r_l
    v_r = m_inv * r_r
    return ((v_l * rho).sum(-1) <= 0.0) | ((v_r * rho).sum(-1) <= 0.0)


def _leaf_ckpt_idxs(n: int) -> tuple[int, int]:
    """Checkpoint slots touched by leaf ``n`` (0-based) of a subtree.

    ``idx_max`` = popcount(n >> 1): the slot an even (left-edge) leaf stores
    into, and the top of the range an odd leaf checks against; the range
    holds one slot for each subtree whose right edge is leaf n, as many as
    n has trailing one-bits.
    """
    idx_max = bin(n >> 1).count("1")
    trailing_ones = (n ^ (n + 1)).bit_length() - 1
    return idx_max - trailing_ones + 1, idx_max


def _noise_source(generator, noise, n_total: int, dim: int, max_depth: int, dtype, device):
    """``(momentum(i) -> z (P,), tree(i, depth) -> (go_right, u_leaf
    (≥ 2^depth,), u_merge))``: from ``noise`` when given, else drawn from
    ``generator`` in that order."""
    if noise is not None:
        z, go_right, u_leaf, u_merge = noise
        z, u_leaf, u_merge = (torch.as_tensor(a, dtype=dtype, device=device) for a in (z, u_leaf, u_merge))
        go_right = torch.as_tensor(go_right, dtype=torch.bool, device=device)
        want = ((n_total, dim), (n_total, max_depth), (n_total, max_depth, 2 ** (max_depth - 1)),
                (n_total, max_depth))
        got = tuple(tuple(a.shape) for a in (z, go_right, u_leaf, u_merge))
        if got != want:
            raise ValueError(f"noise must be z, go_right, u_leaf, u_merge of shapes {want}, got {got}")
        return (lambda i: z[i]), (lambda i, d: (go_right[i, d], u_leaf[i, d], u_merge[i, d]))
    if generator is None:
        raise ValueError("nuts_sample needs a torch.Generator (generator=) or injected noise (noise=)")
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the chain on {device}")
    rand = lambda *shape: torch.rand(shape, generator=generator, dtype=dtype, device=device)

    def tree(_, depth):
        go_right = rand() < 0.5
        return go_right, rand(1 << depth), rand()

    return (lambda _: torch.randn(dim, generator=generator, dtype=dtype, device=device)), tree


def _transition(vg, q, u_q, g_q, eps, m_inv, z, tree_noise, max_depth: int):
    """One NUTS draw from ``q`` (potential ``u_q``, gradient ``g_q``) with
    momentum noise ``z`` and ``tree_noise(depth)``.  Returns ``(q', u', g',
    accept_stat, depth, n_leaf, diverging)``: the statistic and the flag
    0-d tensors, depth and leaf count Python ints."""
    dim, dtype, device = q.shape[0], q.dtype, q.device
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    neg_inf = torch.full((), -math.inf, dtype=dtype, device=device)
    kinetic = lambda r: 0.5 * torch.dot(r, m_inv * r)

    r0 = z / torch.sqrt(m_inv)
    h0 = u_q + kinetic(r0)
    # the trajectory: its two edges, its proposal, log weight and momentum sum
    z_l = z_r = z_prop = q
    r_l = r_r = rho = r0
    g_l = g_r = g_prop = g_q
    u_prop, log_w = u_q, zero  # the root leaf's weight e^{-(H0-H0)} = 1
    sum_accept, n_leaf = zero, 0
    for depth in range(max_depth):
        go_right, u_leaf, u_merge = tree_noise(depth)
        e = torch.where(go_right, one, -one) * eps
        z, r, g = torch.where(go_right, z_r, z_l), torch.where(go_right, r_r, r_l), torch.where(go_right, g_r, g_l)
        # the subtree: 2^depth leaves outward from that edge, progressive sampling
        s_z, s_u, s_g = z, zero, g
        s_log_w, s_rho, s_sum_accept = neg_inf, torch.zeros_like(r), zero
        r_ck = torch.zeros(max_depth, dim, dtype=dtype, device=device)
        rho_ck = torch.zeros_like(r_ck)
        n_leaves, leaf, stopped = 1 << depth, 0, False
        while not stopped and leaf < n_leaves:
            r = r - 0.5 * e * g
            z = z + e * m_inv * r
            u, g = vg(z)
            r = r - 0.5 * e * g
            dh = u + kinetic(r) - h0
            dh = torch.where(torch.isnan(dh), math.inf, dh)
            s_diverging = dh > MAX_DELTA_ENERGY
            log_w_leaf = -dh
            s_sum_accept = s_sum_accept + torch.clamp(torch.exp(-dh), max=1.0)
            log_w_new = torch.logaddexp(s_log_w, log_w_leaf)
            take = torch.log(u_leaf[leaf]) < log_w_leaf - log_w_new
            s_z, s_u, s_g = torch.where(take, z, s_z), torch.where(take, u, s_u), torch.where(take, g, s_g)
            s_log_w = log_w_new
            s_rho = s_rho + r
            # checkpoints: even leaves push their momentum, odd leaves check
            # every subtree that ends here
            idx_min, idx_max = _leaf_ckpt_idxs(leaf)
            if leaf % 2 == 0:
                r_ck[idx_max] = r
                rho_ck[idx_max] = s_rho - r
                s_turning = torch.zeros((), dtype=torch.bool, device=device)
            else:
                ck = slice(idx_min, idx_max + 1)
                s_turning = _is_turning(m_inv, r_ck[ck], r, s_rho - rho_ck[ck]).any()
            leaf += 1
            # the one host read of a leaf; the subtree's last leaf is read
            # with the trajectory's flags below
            if leaf < n_leaves:
                stopped = bool(s_turning | s_diverging)
        subtree_ok = ~(s_turning | s_diverging)
        # merge: the biased progressive rule, P(take the subtree's) = min(1, w_new/w_old)
        take = subtree_ok & (torch.log(u_merge) < s_log_w - log_w)
        z_prop, u_prop, g_prop = (torch.where(take, s_z, z_prop), torch.where(take, s_u, u_prop),
                                  torch.where(take, s_g, g_prop))
        log_w = torch.where(subtree_ok, torch.logaddexp(log_w, s_log_w), log_w)
        z_l, r_l, g_l = torch.where(go_right, z_l, z), torch.where(go_right, r_l, r), torch.where(go_right, g_l, g)
        z_r, r_r, g_r = torch.where(go_right, z, z_r), torch.where(go_right, r, r_r), torch.where(go_right, g, g_r)
        rho = rho + s_rho
        turning = s_turning | (subtree_ok & _is_turning(m_inv, r_l, r_r, rho))
        diverging = s_diverging
        sum_accept = sum_accept + s_sum_accept
        n_leaf += leaf
        if stopped or depth + 1 == max_depth or bool(turning | diverging):
            break
    accept_stat = sum_accept / float(max(n_leaf, 1))
    return z_prop, u_prop, g_prop, accept_stat, depth + 1, n_leaf, diverging


def _run(vg, q0, momentum, tree_noise, n_samples, step_size0, n_warmup, max_depth, target_accept, adapt_mass,
         m_inv0):
    """The draw loop (JAX ``_run_nuts``): dual averaging over the warmup
    draws, restarted at each slow window's end where ``adapt_mass`` also
    refreshes the inverse metric from the window's Welford sums."""
    sched = window_schedule(n_warmup)
    dim = q0.shape[0]
    zeros = lambda: torch.zeros(dim, dtype=q0.dtype, device=q0.device)
    log_eps = log_eps_bar = torch.log(_scalar(step_size0, q0))
    h_bar = _scalar(0.0, q0)
    mu = torch.log(10.0 * _scalar(step_size0, q0))
    m_inv = torch.ones(dim, dtype=q0.dtype, device=q0.device) if m_inv0 is None else m_inv0
    w_count, w_mean, w_m2 = 0.0, zeros(), zeros()
    q = q0
    u_q, g_q = vg(q0)
    qs, us, accs, depths, leaves, divs = [], [], [], [], [], []
    for i in range(n_warmup + n_samples):
        in_warmup = i < n_warmup
        eps = torch.exp(log_eps if in_warmup else log_eps_bar)
        q, u_q, g_q, accept_stat, depth, n_leaf, diverging = _transition(
            vg, q, u_q, g_q, eps, m_inv, momentum(i), lambda d: tree_noise(i, d), max_depth
        )
        if in_warmup:
            # dual averaging on the mean leaf acceptance statistic
            m = float(sched.da_step[i])
            eta = 1.0 / (m + DA_T0)
            h_bar = (1.0 - eta) * h_bar + eta * (target_accept - accept_stat)
            log_eps = mu - math.sqrt(m) / DA_GAMMA * h_bar
            w = m ** (-DA_KAPPA)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
            if adapt_mass and sched.in_slow[i]:
                w_count += 1.0
                delta = q - w_mean
                w_mean = w_mean + delta / max(w_count, 1.0)
                w_m2 = w_m2 + delta * (q - w_mean)
            if adapt_mass and sched.window_end[i]:
                m_inv = regularized_variance(w_count, w_mean, w_m2)
                eps_r = torch.exp(log_eps_bar)
                log_eps = torch.log(eps_r)
                mu = torch.log(10.0 * eps_r)
                h_bar = torch.zeros_like(h_bar)
                w_count, w_mean, w_m2 = 0.0, zeros(), zeros()
        qs.append(q)
        us.append(u_q)
        accs.append(accept_stat)
        depths.append(depth)
        leaves.append(n_leaf)
        divs.append(diverging)
    as_int = lambda v: torch.tensor(v, dtype=torch.int64, device=q0.device)
    return NUTSResult(
        samples=torch.stack(qs)[n_warmup:],
        potentials=torch.stack(us)[n_warmup:],
        accept_stat=torch.stack(accs),
        tree_depth=as_int(depths),
        n_leapfrog=as_int(leaves),
        diverging=torch.stack(divs),
        step_size=torch.exp(log_eps_bar),
        inv_mass=m_inv,
    )


def nuts_sample(
    potential_fn: Callable,
    init_position: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    *,
    step_size: float = 0.1,
    n_warmup: int = 500,
    max_depth: int = 8,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    mass_matrix=None,
    noise=None,
) -> NUTSResult:
    """Draw ``n_samples`` NUTS samples after ``n_warmup`` adaptive warmup
    draws, on the device and in the dtype of ``init_position``.

    The potential-over-packed-vector contract of :func:`.hmc.hmc_sample`.
    ``generator`` is a ``torch.Generator`` on the chain's device; ``noise=(z
    (n_total, P), go_right (n_total, max_depth), u_leaf (n_total,
    max_depth, 2^(max_depth-1)), u_merge (n_total, max_depth))`` replaces it
    with given draws.  ``mass_matrix`` (P,) is a diagonal mass seeding the
    metric (inverse metric = 1/mass); with ``adapt_mass=False`` it stays
    fixed.
    """
    q0 = torch.as_tensor(init_position)
    n_samples, n_warmup, max_depth = int(n_samples), int(n_warmup), int(max_depth)
    momentum, tree_noise = _noise_source(generator, noise, n_warmup + n_samples, q0.shape[0], max_depth, q0.dtype,
                                         q0.device)
    m_inv0 = None
    if mass_matrix is not None:
        m_inv0 = 1.0 / torch.as_tensor(mass_matrix, dtype=q0.dtype, device=q0.device)
    return _run(lambda q: value_and_grad(potential_fn, q), q0, momentum, tree_noise, n_samples, float(step_size),
                n_warmup, max_depth, float(target_accept), bool(adapt_mass), m_inv0)


def nuts_sample_chains(
    potential_fn: Callable,
    init_positions: torch.Tensor,
    n_samples: int,
    generator: torch.Generator | None = None,
    noise=None,
    **kwargs,
) -> NUTSResult:
    """Several independent NUTS chains, one after another.

    ``init_positions``: (C, P).  Chain c draws from its own generator,
    seeded with the c-th of C integers drawn from ``generator`` (as JAX
    splits its key per chain), or replays ``noise``'s four arrays at
    ``[c]``.  Every ``NUTSResult`` field gains a leading chain axis.
    """
    n_chains = init_positions.shape[0]
    if noise is not None:
        per_chain = [dict(noise=tuple(a[c] for a in noise)) for c in range(n_chains)]
    else:
        per_chain = [dict(generator=g) for g in chain_generators(generator, n_chains, "nuts_sample_chains")]
    runs = [nuts_sample(potential_fn, init_positions[c], n_samples, **per_chain[c], **kwargs)
            for c in range(n_chains)]
    return NUTSResult(*(torch.stack([r[k] for r in runs]) for k in range(len(NUTSResult._fields))))
