"""GNMGP — generalized (nonseparable) nonstationary multivariate GP ("SVC").

Counterpart of the parts of the JAX package's ``models/gnmgp.py`` that
prediction uses.  At every input x_n the task covariance is
``B_f(x_n) = L_n L_nᵀ``, giving the Gram

    K[(a,n), (c,p)] = (K_x[n,p] + jitter·δ_np) · (L_n L_pᵀ)[a,c]     (task-major)

with K_x the σ≡1 Gibbs kernel of (x, ℓ).  ``log_lik`` and ``log_posterior``
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import settings
from ..ops import gram_kernels, transforms
from .base import check_vec

#: Reference default hyper-parameters (logpos.py:299 signature defaults).
DEFAULT_HYPERS = {
    "mu_tilde_l": 0.0,
    "alpha_tilde_l": 5.0,
    "beta_tilde_l": 1.0,
    "mu_L": 0.0,
    "alpha_L": 5.0,
    "beta_L": 1.0,
    "a": 1.0,
    "b": 1.0,
}


class Params(NamedTuple):
    tilde_l: torch.Tensor  # (N,) log lengthscale process
    ul_vecs: torch.Tensor  # (N*T,) unconstrained per-input Cholesky vectors
    tilde_sigma2_err: torch.Tensor  # () log noise variance


def n_params(n: int, m: int) -> int:
    return n + n * transforms.tri_size(m) + 1


def unpack(vec: torch.Tensor, n: int, m: int) -> Params:
    """Layout identical to reference vec2pars_SVC (logpos.py:32-43)."""
    t = transforms.tri_size(m)
    check_vec(vec, n + n * t + 1, "gnmgp",
              f"[tilde_l({n}), uL_vecs({n}·{t}), tilde_sigma2_err] for N={n}, M={m}")
    return Params(tilde_l=vec[:n], ul_vecs=vec[n : n + n * t], tilde_sigma2_err=vec[-1])


def pack(p: Params) -> torch.Tensor:
    return torch.cat([p.tilde_l, p.ul_vecs, p.tilde_sigma2_err.reshape(1)])


def chol_process(ul_vecs: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """(N*T,) unconstrained vectors → (N, M, M) lower-triangular factors."""
    t = transforms.tri_size(m)
    l_vecs = transforms.ulvec_to_lvec(ul_vecs.reshape(n, t), m)
    return transforms.vec_to_tril(l_vecs, m)


def gram(x: torch.Tensor, ell: torch.Tensor, ls: torch.Tensor) -> torch.Tensor:
    """The task-major MN×MN Gram from inputs x (N,), lengthscales ℓ (N,) and
    the L-process (N, M, M).

    Equal to the JAX package's ``gram(nonstationary_rbf_cov(x, ell1=ell), ls)``:
    the Gibbs term K_x (with its self-nugget) is fused into the assembly, so
    on CUDA this is one launch of kernel K2 (``ops.gram_kernels.svc_gram``)
    that never stores K_x or the (N, M, N, M) task product.
    """
    return gram_kernels.svc_gram(
        x.contiguous(), ell.contiguous(), ls.contiguous(), settings.jitter, layout="task"
    )
