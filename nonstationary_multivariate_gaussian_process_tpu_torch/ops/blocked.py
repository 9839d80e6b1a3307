"""Blocked Cholesky and triangular solves built from products, and loop-free
small factors.

Counterpart of the JAX package's ``ops/blocked.py``, each entry point a
``torch.autograd.Function`` whose backward is that package's custom VJP:

* ``blocked_cholesky`` — right-looking blocked Cholesky, panels of
  ``BLOCK``: factor the diagonal tile, form the column panel with a small
  triangular solve, downdate the trailing matrix with one full-size
  (nb, block) @ (block, nb) product (the panel is zero outside the rows
  below the tile).  Backward: the Murray (2016) pullback with the two
  solves as blocked substitutions.
* ``blocked_trsm`` — block substitution for ``L x = b`` (top-down) or
  ``Lᵀ x = b`` (bottom-up), with the adjoint for both arguments.
* ``blocked_chol_solve`` — the two substitutions.
* ``unrolled_cholesky`` and ``unrolled_tri_inv`` — recursive 2×2-block
  Cholesky and triangular inverse with no loop (the JAX package's small-f64
  factors), with explicit-inverse backwards.  Eagerly the recursion is
  O(n log n) small operations.

A diagonal tile that fails to factor comes back as NaNs (``cholesky_ex``'s
``info``, never a raise), so the ladder above sees the failure.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: Panel width.
BLOCK = 256


def _pad_spd(a: torch.Tensor, nb: int) -> torch.Tensor:
    """Pad an SPD matrix to size nb with an identity tail (Cholesky-neutral)."""
    n = a.shape[-1]
    if n == nb:
        return a
    tail = torch.cat([torch.zeros(n, dtype=a.dtype, device=a.device),
                      torch.ones(nb - n, dtype=a.dtype, device=a.device)])
    return F.pad(a, (0, nb - n, 0, nb - n)) + torch.diag(tail)


def _pad_tril(l: torch.Tensor, nb: int) -> torch.Tensor:
    """Pad a lower-triangular factor to size nb with an identity tail."""
    return _pad_spd(l, nb)


def _ceil_to(n: int, b: int) -> int:
    return -(-n // b) * b


def _tile_cholesky(a: torch.Tensor) -> torch.Tensor:
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.nan)


def _solve_tri(l: torch.Tensor, b: torch.Tensor, trans: bool) -> torch.Tensor:
    """``L⁻¹ b`` or, with ``trans``, ``L⁻ᵀ b`` for lower-triangular ``L``."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


# ---------------------------------------------------------------------------
# Blocked Cholesky
# ---------------------------------------------------------------------------


def _cholesky_scan(a: torch.Tensor, block: int) -> torch.Tensor:
    """Right-looking blocked Cholesky of ``a`` (nb, nb), nb % block == 0."""
    nb = a.shape[-1]
    rows = torch.arange(nb, device=a.device)
    a = a.clone()
    for o in range(0, nb, block):
        lkk = _tile_cholesky(a[o:o + block, o:o + block])
        panel = _solve_tri(lkk, a[:, o:o + block].mT, False).mT  # strip @ lkk⁻ᵀ
        panel_m = torch.where((rows >= o + block)[:, None], panel, 0.0)
        new_strip = panel_m.clone()
        new_strip[o:o + block] = lkk
        a[:, o:o + block] = new_strip
        # trailing (Schur) downdate, nonzero only on rows and columns >= o + block
        a = a - panel_m @ panel_m.mT
    return torch.tril(a)


def _cholesky(a: torch.Tensor, block: int) -> torch.Tensor:
    n = a.shape[-1]
    return _cholesky_scan(_pad_spd(a, _ceil_to(n, block)), block)[:n, :n]


def _phi(x: torch.Tensor) -> torch.Tensor:
    """tril with halved diagonal: the Cholesky pullback's projector."""
    return torch.tril(x) - 0.5 * torch.diag(torch.diagonal(x))


class _BlockedCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, block):
        l = _cholesky(a, block)
        ctx.block = block
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, lbar):
        (l,) = ctx.saved_tensors
        p = _phi(l.mT @ lbar)
        u = _trsm(l, p, True, ctx.block)  # L⁻ᵀ P
        v = _trsm(l, u.mT, True, ctx.block).mT  # L⁻ᵀ P L⁻¹
        return 0.5 * (v + v.mT), None


def blocked_cholesky(a: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``a`` (n, n) by panel updates."""
    return _BlockedCholesky.apply(a, block)


# ---------------------------------------------------------------------------
# Blocked triangular solve (lower factor; optional transpose)
# ---------------------------------------------------------------------------


def _trsm_scan(l: torch.Tensor, b: torch.Tensor, trans: bool, block: int) -> torch.Tensor:
    """Block substitution; ``l`` (nb, nb), ``b`` (nb, r), nb % block == 0.
    The unsolved rows of ``x`` are still zero, so no masking is needed."""
    nb = l.shape[-1]
    x = torch.zeros_like(b)
    order = range(0, nb, block)
    for o in (reversed(order) if trans else order):
        l_rows = l[:, o:o + block].mT if trans else l[o:o + block, :]
        rhs = b[o:o + block] - l_rows @ x
        x[o:o + block] = _solve_tri(l[o:o + block, o:o + block], rhs, trans)
    return x


def _trsm(l: torch.Tensor, b: torch.Tensor, trans: bool, block: int) -> torch.Tensor:
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    n = l.shape[-1]
    nb = _ceil_to(n, block)
    x = _trsm_scan(_pad_tril(l, nb), F.pad(b, (0, 0, 0, nb - n)), trans, block)[:n]
    return x[:, 0] if vec else x


class _BlockedTrsm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l, b, trans, block):
        x = _trsm(l, b, trans, block)
        ctx.trans, ctx.block = trans, block
        ctx.save_for_backward(l, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        l, x = ctx.saved_tensors
        vec = x.dim() == 1
        if vec:
            x, xbar = x[:, None], xbar[:, None]
        # the adjoint of the solve: b̄ solves the transposed system
        bbar = _trsm(l, xbar, not ctx.trans, ctx.block)
        lbar = -torch.tril(x @ bbar.mT) if ctx.trans else -torch.tril(bbar @ x.mT)
        return lbar, (bbar[:, 0] if vec else bbar), None, None


def blocked_trsm(l: torch.Tensor, b: torch.Tensor, trans: bool = False, block: int = BLOCK) -> torch.Tensor:
    """Solve ``L x = b`` (or ``Lᵀ x = b`` with ``trans``) by block
    substitution; ``l`` (n, n) lower-triangular, ``b`` (n,) or (n, r)."""
    return _BlockedTrsm.apply(l, b, trans, block)


def blocked_chol_solve(l: torch.Tensor, b: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """Solve ``A x = b`` given ``L = chol(A)`` by blocked substitutions."""
    return blocked_trsm(l, blocked_trsm(l, b, False, block), True, block)


# ---------------------------------------------------------------------------
# Loop-free recursive Cholesky and triangular inverse for small factors
# ---------------------------------------------------------------------------


def _block(l11, l21, l22) -> torch.Tensor:
    z = torch.zeros(l11.shape[0], l22.shape[1], dtype=l11.dtype, device=l11.device)
    return torch.cat([torch.cat([l11, z], 1), torch.cat([l21, l22], 1)], 0)


def _chol_rec(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[-1]
    if n == 1:
        return torch.sqrt(a)
    if n == 2:
        l11 = torch.sqrt(a[0, 0])
        l21 = a[1, 0] / l11
        l22 = torch.sqrt(a[1, 1] - l21 * l21)
        z = torch.zeros((), dtype=a.dtype, device=a.device)
        return torch.stack([torch.stack([l11, z]), torch.stack([l21, l22])])
    h = n // 2
    l11 = _chol_rec(a[:h, :h])
    # L21 = A21 L11⁻ᵀ through the explicit small inverse (one product)
    l21 = a[h:, :h] @ _tri_inv_rec(l11).mT
    l22 = _chol_rec(a[h:, h:] - l21 @ l21.mT)
    return _block(l11, l21, l22)


def _tri_inv_rec(l: torch.Tensor) -> torch.Tensor:
    n = l.shape[-1]
    if n == 1:
        return 1.0 / l
    if n == 2:
        w11 = 1.0 / l[0, 0]
        w22 = 1.0 / l[1, 1]
        w21 = -l[1, 0] * w11 * w22
        z = torch.zeros((), dtype=l.dtype, device=l.device)
        return torch.stack([torch.stack([w11, z]), torch.stack([w21, w22])])
    h = n // 2
    w11 = _tri_inv_rec(l[:h, :h])
    w22 = _tri_inv_rec(l[h:, h:])
    return _block(w11, -w22 @ (l[h:, :h] @ w11), w22)


class _UnrolledCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a):
        l = _chol_rec(a)
        ctx.save_for_backward(l)
        return l

    @staticmethod
    def backward(ctx, lbar):
        (l,) = ctx.saved_tensors
        w = _tri_inv_rec(l)
        v = w.mT @ _phi(l.mT @ lbar) @ w  # L⁻ᵀ Φ L⁻¹
        return 0.5 * (v + v.mT)


def unrolled_cholesky(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of a small SPD matrix (n, n) by the loop-free recursion; a
    failed factor has NaNs (the square root of a negative pivot)."""
    return _UnrolledCholesky.apply(a)


class _UnrolledTriInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l):
        w = _tri_inv_rec(l)
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, wbar):
        (w,) = ctx.saved_tensors
        # from W L = I: L̄ = tril(−Wᵀ W̄ Wᵀ)
        return -torch.tril(w.mT @ wbar @ w.mT)


def unrolled_tri_inv(l: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a small lower-triangular factor (n, n) by the
    loop-free recursion."""
    return _UnrolledTriInv.apply(l)
