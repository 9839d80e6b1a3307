"""Whitened and partially non-centered parameterizations for the latent-GP
blocks.

Counterpart of the JAX package's ``inference/whiten.py``.  The smooth RBF
prior Grams over the latent processes (tilde_l, the uL columns, the hetero
noise rows) have condition numbers of 1e6 and more, so in the natural
parameterization the posterior is a long curved ridge that neither step-size
adaptation nor a diagonal metric fixes.  Sampling the whitened variables
``u`` with ``block = mu + L_prior @ u`` makes the prior over ``u`` standard
normal; the map is a fixed invertible linear one, so its Jacobian is
constant and the whitened chain targets the same posterior whatever ``L``
is.  The reference samples in the natural space
(``Nonseparable_model.py:228-231``).

:func:`retune` is the partially non-centered refinement: with the eigen-mode
whitener (``mode="eig"``, map ``A = U diag(s)`` per block) a pilot chain's
draws estimate each direction's posterior standard deviation, and the map's
scale becomes ``s_prior^(1-interp) · s_posterior^interp``.

Usage::

    w = make_whitener("gnmgp", x, n, m, hyper)              # prior-whitened
    res = hmc.hmc_sample(w.wrap(nlp), w.to_white(map_vec), ...)
    samples = w.from_white_batch(res.samples)

    w0 = make_whitener("gnmgp", x, n, m, hyper, mode="eig")  # PNCP
    pilot = hmc.hmc_sample(w0.wrap(nlp), w0.to_white(map_vec), ...)
    w1 = retune(w0, w0.from_white_batch(pilot.samples))

The maps take any leading batch shape: ``from_white_batch`` and
``to_white_batch`` are the single-vector maps on an (S, P) tensor, one
batched product a block.  ``from_white`` builds its output by concatenating
the blocks and the raw coordinates, so autograd runs through it on every
gradient of a whitened chain.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import gnmgp, gnmgp_hetero, lmc, snmgp
from ..ops import chol, transforms


class _Block(NamedTuple):
    """One latent-GP segment of the packed parameter vector.

    Chol mode (``basis is None``): the map is the lower prior factor ``l``;
    its inverse is a triangular solve.  Eig mode: the map is ``basis ·
    diag-in-layout(scale)`` with an orthogonal ``basis``, inverted by
    ``scale⁻¹ · basisᵀ``; ``scale`` is stored in the whitened layout, per
    direction and per series, and :func:`retune` replaces it.
    """

    start: int
    stop: int
    k: int  # number of independent GP series in the block
    rows: bool  # True: reshape(k, n), series are rows; False: reshape(n, k), columns
    l: torch.Tensor | None  # (n, n) lower prior factor (chol mode)
    mu: float
    basis: torch.Tensor | None = None  # (n, n) orthogonal eigenbasis (eig mode)
    scale: torch.Tensor | None = None  # whitened-layout map scales (eig mode)


def _layout(b: _Block, seg: torch.Tensor) -> torch.Tensor:
    """A block's segment (..., n·k) in its matrix layout: (..., k, n) for
    row blocks, (..., n, k) for column blocks."""
    lead = seg.shape[:-1]
    return seg.reshape(*lead, b.k, -1) if b.rows else seg.reshape(*lead, -1, b.k)


class Whitener(NamedTuple):
    blocks: tuple
    n_params: int
    #: optional per-coordinate scale of the coordinates outside the GP
    #: blocks (raw hypers); entries inside block ranges are ignored.
    raw_scale: torch.Tensor | None = None

    def from_white(self, u: torch.Tensor) -> torch.Tensor:
        """Whitened vector(s) (..., P) -> natural packed vector(s)."""
        vec = u if self.raw_scale is None else u * self.raw_scale

        def block(b, seg):
            if b.basis is not None:
                if b.rows:
                    return b.mu + (seg * b.scale) @ b.basis.T
                return b.mu + b.basis @ (b.scale * seg)
            if b.rows:
                return b.mu + seg @ b.l.T
            return b.mu + b.l @ seg

        # the blocks read u itself: raw_scale applies outside them only
        return self._assemble(vec, u, block)

    def _assemble(self, outside: torch.Tensor, inside: torch.Tensor, block_fn) -> torch.Tensor:
        """A packed (..., P) tensor, by concatenation: the coordinates
        outside the blocks from ``outside``, each block's from
        ``block_fn(block, its segment of inside in the block's layout)``."""
        pieces, pos = [], 0
        for b in self.blocks:
            pieces.append(outside[..., pos : b.start])
            pieces.append(block_fn(b, _layout(b, inside[..., b.start : b.stop])).flatten(-2))
            pos = b.stop
        pieces.append(outside[..., pos:])
        return torch.cat(pieces, dim=-1)

    def to_white(self, vec: torch.Tensor) -> torch.Tensor:
        """Natural packed vector(s) (..., P) -> whitened vector(s)."""
        vec = torch.as_tensor(vec)
        u = vec if self.raw_scale is None else vec / self.raw_scale

        def block(b, seg):
            c = seg - b.mu
            if b.basis is not None:
                if b.rows:
                    return (c @ b.basis) / b.scale
                return (b.basis.T @ c) / b.scale
            if b.rows:
                return torch.linalg.solve_triangular(b.l, c.transpose(-1, -2), upper=False).transpose(-1, -2)
            return torch.linalg.solve_triangular(b.l, c, upper=False)

        return self._assemble(u, vec, block)

    def from_white_batch(self, us: torch.Tensor) -> torch.Tensor:
        return self.from_white(torch.as_tensor(us))

    def to_white_batch(self, vecs: torch.Tensor) -> torch.Tensor:
        return self.to_white(torch.as_tensor(vecs))

    def wrap(self, potential_fn: Callable) -> Callable:
        """Whitened-space potential: the same posterior, benign geometry."""

        def wrapped(u):
            return potential_fn(self.from_white(u))

        return wrapped

    def logdet(self) -> torch.Tensor:
        """``log |det d(from_white)/du|``, the constant Jacobian of the map:
        ``log ∫ exp(-nlp(vec)) dvec = (whitened log evidence) + logdet()``."""
        total = torch.zeros((), dtype=torch.float64)
        covered = np.zeros(self.n_params, dtype=bool)
        for b in self.blocks:
            covered[b.start : b.stop] = True
            if b.basis is not None:  # orthogonal basis: |det| = 1
                total = total + torch.sum(torch.log(torch.abs(b.scale)))
            else:
                total = total + float(b.k) * torch.sum(torch.log(torch.diagonal(b.l)))
        if self.raw_scale is not None:
            keep = torch.as_tensor(~covered, device=self.raw_scale.device)
            total = total + torch.sum(torch.log(torch.abs(self.raw_scale[keep])))
        return total


def _make_block(start, stop, k, rows, x, alpha, beta, mu, mode) -> _Block:
    if mode == "chol":
        return _Block(start, stop, k, rows, chol.prior_rbf_cholesky(x, alpha, beta), mu)
    u, s = chol.prior_rbf_eig(x, alpha, beta)
    n = u.shape[0]
    scale = s.expand(k, n) if rows else s[:, None].expand(n, k)
    return _Block(start, stop, k, rows, None, mu, basis=u, scale=scale)


def make_whitener(
    model_name: str,
    x: torch.Tensor,
    n: int,
    m: int,
    hyper: dict | None = None,
    hadamard: bool = False,
    mode: str = "chol",
) -> Whitener:
    """Prior-factor whitener for a model's latent-GP blocks, on ``x``'s
    device in ``x``'s dtype.

    The factors are built on the host in float64
    (``ops.chol.prior_rbf_cholesky`` / ``prior_rbf_eig``) with the hypers
    the objective uses, so the whitened prior is standard normal to
    factorization roundoff.  LMC has no latent processes: its whitener is
    the identity (no blocks).  ``hadamard=True`` takes the Hadamard-layout
    GNMGP prior defaults (the block layout is the same).  ``mode="eig"``
    takes the orthogonal eigenbasis map that :func:`retune` needs.
    """
    if mode not in ("chol", "eig"):
        raise ValueError(f"mode must be 'chol' or 'eig', got {mode!r}")
    t = transforms.tri_size(m)
    blocks: list[_Block] = []
    if model_name == "gnmgp":
        base_hp = gnmgp.HADAMARD_HYPERS if hadamard else gnmgp.DEFAULT_HYPERS
        hp = {**gnmgp.DEFAULT_HYPERS, **base_hp, **(hyper or {})}
        blocks = [
            _make_block(0, n, 1, False, x, hp["alpha_tilde_l"], hp["beta_tilde_l"], hp["mu_tilde_l"], mode),
            _make_block(n, n + n * t, t, False, x, hp["alpha_L"], hp["beta_L"], hp["mu_L"], mode),
        ]
        n_params = gnmgp.n_params(n, m)
    elif model_name == "snmgp":
        hp = {**snmgp.DEFAULT_HYPERS, **(hyper or {})}
        blocks = [
            _make_block(0, n, 1, False, x, hp["alpha_tilde_l"], hp["beta_tilde_l"], hp["mu_tilde_l"], mode),
            _make_block(n, 2 * n, 1, False, x, hp["alpha_tilde_sigma"], hp["beta_tilde_sigma"],
                        hp["mu_tilde_sigma"], mode),
        ]
        n_params = snmgp.n_params(n, m)
    elif model_name == "gnmgp_hetero":
        hp = {**gnmgp_hetero.DEFAULT_HYPERS, **(hyper or {})}
        blocks = [
            _make_block(0, n, 1, False, x, hp["alpha_tilde_l"], hp["beta_tilde_l"], hp["mu_tilde_l"], mode),
            _make_block(n, n + n * t, t, False, x, hp["alpha_L"], hp["beta_L"], hp["mu_L"], mode),
            # the noise block is task-major: its series are rows
            _make_block(n + n * t, n + n * t + n * m, m, True, x, hp["alpha_err"], hp["beta_err"],
                        hp["mu_err"], mode),
        ]
        n_params = gnmgp_hetero.n_params(n, m)
    elif model_name == "lmc":
        n_params = lmc.n_params(m)
    else:
        raise ValueError(f"unknown model {model_name!r}")
    return Whitener(tuple(blocks), n_params)


def retune(w: Whitener, samples, interp: float = 1.0, floor: float = 1e-3, raw: bool = True) -> Whitener:
    """Partially non-centered retuning from a pilot chain's natural-space
    draws ``samples`` (n_draws, P).

    Each eig-mode block's draws are projected on the prior eigenbasis, and
    each (direction, series) coefficient's posterior standard deviation
    (``correction=0``, as ``jnp.std``) replaces the map's scale,
    geometrically interpolated by ``interp`` (0 keeps the prior whitening,
    1 is fully posterior-scaled) and floored at ``floor ×`` the current
    scale.  With ``raw=True`` the coordinates outside the blocks get a
    diagonal posterior-std scale too.  The result is a fixed linear map, so
    the retuned chain targets the same posterior.
    """
    samples = torch.as_tensor(samples)
    if samples.dim() != 2 or samples.shape[1] != w.n_params:
        raise ValueError(f"samples must be (n_draws, {w.n_params}), got {tuple(samples.shape)}")
    blocks = []
    covered = torch.zeros(w.n_params, dtype=torch.bool, device=samples.device)
    for b in w.blocks:
        if b.basis is None:
            raise ValueError("retune requires an eig-mode whitener (make_whitener(..., mode='eig'))")
        c = _layout(b, samples[:, b.start : b.stop]) - b.mu
        c = c @ b.basis if b.rows else b.basis.T @ c
        sd = torch.std(c, dim=0, correction=0)
        prior = b.scale.expand(sd.shape)
        new = prior ** (1.0 - interp) * torch.maximum(sd, floor * prior) ** interp
        blocks.append(b._replace(scale=new))
        covered[b.start : b.stop] = True
    raw_scale = w.raw_scale
    if raw:
        sd_all = torch.std(samples, dim=0, correction=0)
        base = torch.ones_like(sd_all) if raw_scale is None else raw_scale
        tuned = torch.clamp(sd_all, min=floor) ** interp * base ** (1.0 - interp)
        raw_scale = torch.where(covered, base, tuned)
    return Whitener(tuple(blocks), w.n_params, raw_scale)
