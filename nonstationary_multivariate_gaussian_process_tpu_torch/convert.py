"""Carry state between the JAX package and the port.

The port keeps the JAX package's packed parameter vectors (reference
``vec2pars_SVC``: ``[tilde_l (N), uL_vecs (N·T), tilde_sigma2_err]``;
``vec2pars``: ``[tilde_l (N), tilde_sigma (N), uL_vec (T),
tilde_sigma2_err]``; ``vec2pars_S``: ``[tilde_l, tilde_sigma, uL_vec (T),
tilde_sigma2_err]``; the heteroscedastic GNMGP's ``[tilde_l (N), uL_vecs
(N·T), tilde_sigma2_err (N·M)]``; the sparse GNMGP's ``[tilde_l_z (m_z),
uL_vecs_z (m_z·T), tilde_sigma2_err]``, its hetero tier's with
``tilde_sigma2_err_z (m_z·M)``, the sparse SNMGP's ``[tilde_l_z (m_z),
tilde_sigma_z (m_z), uL_vec (T), tilde_sigma2_err]``, the sparse LMC's the
LMC's, each with its ops), its empirical estimate and its artifact-store
format,
so carrying a fit across is a matter of moving arrays into tensors on a
device.  A Hadamard-layout subject's GNMGP and SNMGP vectors are the dense
layouts with N the number of observations (``params_from_jax(vec, n_obs,
m)``), its data ``models.as_hadamard_data`` of the arrays.
:func:`result_to_numpy` turns a ``run_subject`` (or
``run_subject_hadamard``) result of either package into plain numpy so the
two compare key by key; it reads JAX arrays through ``numpy.asarray`` and
imports nothing of JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import dists, settings
from .inference import whiten
from .inference.empirical import EmpiricalEstimate
from .models import gnmgp, gnmgp_hetero, gnmgp_sparse, lmc, lmc_sparse, snmgp, snmgp_sparse
from .models.base import FullData
from .utils.artifacts import ArtifactStore


class Subject(NamedTuple):
    data: FullData  # x (N,), y (N, M)
    vec: torch.Tensor  # packed MAP vector


def _tensor(vec, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vec), dtype=dtype or settings.dtype, device=settings.resolve_device(device))


def params_from_jax(vec: np.ndarray, n: int, m: int, device=None, dtype=None) -> gnmgp.Params:
    """The JAX package's packed GNMGP vector as the port's ``Params``."""
    return gnmgp.unpack(_tensor(vec, device, dtype), n, m)


def snmgp_params_from_jax(vec: np.ndarray, n: int, m: int, device=None, dtype=None) -> snmgp.Params:
    """The JAX package's packed SNMGP vector as the port's ``Params``."""
    return snmgp.unpack(_tensor(vec, device, dtype), n, m)


def lmc_params_from_jax(vec: np.ndarray, m: int, device=None, dtype=None) -> lmc.Params:
    """The JAX package's packed LMC vector as the port's ``Params``."""
    return lmc.unpack(_tensor(vec, device, dtype), m)


def hetero_params_from_jax(vec: np.ndarray, n: int, m: int, device=None, dtype=None) -> gnmgp_hetero.Params:
    """The JAX package's packed heteroscedastic GNMGP vector (task-major
    noise) as the port's ``Params``."""
    return gnmgp_hetero.unpack(_tensor(vec, device, dtype), n, m)


def sparse_params_from_jax(vec: np.ndarray, m_z: int, m: int, device=None, dtype=None) -> gnmgp_sparse.SparseParams:
    """The JAX package's packed sparse GNMGP vector as the port's ``SparseParams``."""
    return gnmgp_sparse.unpack(_tensor(vec, device, dtype), m_z, m)


def sparse_ops_from_jax(ops, device=None, dtype=None) -> gnmgp_sparse.SparseOps:
    """A JAX ``SparseOps`` (its inducing inputs, kriging projections and the
    prior factors at Z as ``TriInv``s) as the port's, so that both packages
    evaluate the sparse objective with the same float64 islands."""
    t = lambda a: _tensor(np.array(a), device, dtype)
    tri = lambda pc: dists.TriInv(t(pc.w), t(pc.logdet))
    return gnmgp_sparse.SparseOps(t(ops.z), t(ops.proj_l), t(ops.proj_ul), tri(ops.pc_l_z), tri(ops.pc_ul_z))


def sparse_hetero_params_from_jax(vec: np.ndarray, m_z: int, m: int, device=None, dtype=None) -> gnmgp_hetero.Params:
    """The JAX package's packed sparse hetero GNMGP vector (task-major noise
    at Z) as the port's ``Params``."""
    return gnmgp_sparse.unpack_hetero(_tensor(vec, device, dtype), m_z, m)


def sparse_hetero_ops_from_jax(ops_h, device=None, dtype=None) -> gnmgp_sparse.SparseHeteroOps:
    """A JAX ``SparseHeteroOps`` as the port's: its base ``SparseOps`` and the
    noise GP's projection and prior factor at Z."""
    t = lambda a: _tensor(np.array(a), device, dtype)
    return gnmgp_sparse.SparseHeteroOps(sparse_ops_from_jax(ops_h.base, device, dtype), t(ops_h.proj_err),
                                        dists.TriInv(t(ops_h.pc_err_z.w), t(ops_h.pc_err_z.logdet)))


def snmgp_sparse_params_from_jax(vec: np.ndarray, m_z: int, m: int, device=None,
                                 dtype=None) -> snmgp_sparse.SparseParams:
    """The JAX package's packed sparse SNMGP vector as the port's ``SparseParams``."""
    return snmgp_sparse.unpack(_tensor(vec, device, dtype), m_z, m)


def snmgp_sparse_ops_from_jax(ops, device=None, dtype=None) -> snmgp_sparse.SparseOps:
    """A JAX sparse SNMGP ``SparseOps`` (Z, the ℓ̃ and σ̃ projections and
    their prior factors at Z) as the port's."""
    t = lambda a: _tensor(np.array(a), device, dtype)
    tri = lambda pc: dists.TriInv(t(pc.w), t(pc.logdet))
    return snmgp_sparse.SparseOps(t(ops.z), t(ops.proj_l), t(ops.proj_sigma), tri(ops.pc_l_z), tri(ops.pc_sigma_z))


def lmc_sparse_ops_from_jax(ops, device=None, dtype=None) -> lmc_sparse.SparseOps:
    """A JAX sparse LMC ``SparseOps`` (its inducing inputs) as the port's; its
    vector is the LMC's (:func:`lmc_params_from_jax`)."""
    return lmc_sparse.SparseOps(_tensor(np.array(ops.z), device, dtype))


def empirical_from_jax(emp) -> EmpiricalEstimate:
    """A JAX ``EmpiricalEstimate`` (host numpy in both packages) as the port's."""
    return EmpiricalEstimate(*(
        float(v) if name == "est_tilde_sigma2_err" else np.asarray(v, np.float64)
        for name, v in zip(EmpiricalEstimate._fields, emp)
    ))


def whitener_from_jax(w, device=None, dtype=None) -> whiten.Whitener:
    """A JAX ``Whitener`` as the port's: its blocks' ``l``, ``basis`` and
    ``scale`` and its ``raw_scale`` as tensors, the rest as they are (a
    retuned map depends on its pilot chain, so it is carried, not rebuilt)."""
    t = lambda a: None if a is None else _tensor(np.array(a), device, dtype)
    blocks = tuple(
        whiten._Block(int(b.start), int(b.stop), int(b.k), bool(b.rows), t(b.l), float(b.mu), t(b.basis), t(b.scale))
        for b in w.blocks
    )
    return whiten.Whitener(blocks, int(w.n_params), t(w.raw_scale))


def _to_numpy(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _to_numpy(w) for k, w in v.items()}
    if hasattr(v, "_fields"):  # NamedTuple results (estimates, predictions)
        return {k: _to_numpy(w) for k, w in zip(v._fields, v)}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return np.asarray(v)


def result_to_numpy(result: dict) -> dict:
    """A ``run_subject`` result dict of either package as nested plain
    numpy: tensors and JAX arrays become arrays (``hmc_samples`` among
    them), named tuples become dicts keyed by field (the predictions,
    ``empirical``, ``latent_summary``), timings are dropped (they never
    compare)."""
    return {k: _to_numpy(v) for k, v in result.items() if k != "timings"}


def subject_from_store(
    root: str, sid, model: str = "gnmgp", dataset: str = "sim", device=None, dtype=None
) -> Subject:
    """Read a subject's ``data`` and ``map`` stages from an artifact store
    (written by either package) into the port's tensors, for any of the
    dense models."""
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    store = ArtifactStore(root)
    key = lambda stage: ArtifactStore.key(model, dataset, sid, stage)
    if not store.exists(key("map")) or not store.exists(key("data")):
        raise KeyError(f"subject {sid!r} has no fitted artifacts under {root}")
    arrays = store.load(key("data"))
    as_t = lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    data = FullData(as_t(arrays["x"]), as_t(arrays["y"]))
    return Subject(data=data, vec=as_t(store.load(key("map"))["vec"]))
