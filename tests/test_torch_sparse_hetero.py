"""The sparse heteroscedastic GNMGP (``gnmgp_hetero_sparse``: the hetero tier
of ``models/gnmgp_sparse.py``, its predictors and LOO conditionals) against
the JAX package on the CPU, in float64.

Both packages evaluate one objective with JAX's ``SparseHeteroOps``
(``convert.sparse_hetero_ops_from_jax``); ``make_ops_hetero`` itself is held
against JAX's separately.  The JAX sides are jitted once per approximation,
with the mask an argument (all ones for the unmasked case).

Tolerances.  Values and gradients at rtol 1e-6 (they agree to ~1e-13
here); predictions at rtol 1e-6 with a floor of 1e-6 of their scale (each
package kriges Z → grid by its own projection, ~1e-8 apart); the LOO
conditionals at rtol 1e-8; under ``NMGP_PRECISION=mixed`` the value at rtol
1e-8 against float64.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_sparse as jsp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import gnmgp_sparse as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate, settings
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse as sp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp_sparse as pred

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, M_Z, G, S = 40, 2, 8, 9, 4
T = M * (M + 1) // 2
RTOL, FLOOR, LOO_RTOL, MIXED_VALUE_RTOL = 1e-6, 1e-6, 1e-8, 1e-8
MASK = np.arange(N) < N - 6


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _close(got, want, rtol=RTOL, floor=FLOOR, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=floor * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def case():
    """A two-task subject whose noise grows along x, JAX's hetero ops and
    the port's copy of them, a vector near a fit and a short chain."""
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(size=N))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)], axis=1) + (0.05 + 0.2 * x)[:, None] * rng.normal(size=(N, M))
    jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
    _, jops = jsp.make_objective_hetero(jdata, n_inducing=M_Z)
    vec = np.concatenate([np.log(0.2) + 0.1 * rng.normal(size=M_Z), 0.2 * rng.normal(size=M_Z * T),
                          np.log(0.01) + 0.3 * rng.normal(size=M_Z * M)])
    chain = vec[None, :] + 0.02 * rng.normal(size=(S + 2, vec.size))
    return x, y, vec, chain, jdata, jops, convert.sparse_hetero_ops_from_jax(jops, device="cpu")


_JAX_VG = {}


def _jax_value_and_grad(jdata, jops, approx):
    if approx not in _JAX_VG:
        def f(v, mask):
            lp, comps = jsp.log_posterior_hetero(jsp.unpack_hetero(v, M_Z, M), jdata, jops, approx=approx, mask=mask)
            return -lp, comps
        _JAX_VG[approx] = jax.jit(jax.value_and_grad(f, has_aux=True))
    return _JAX_VG[approx]


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
@pytest.mark.parametrize("masked", [False, True])
def test_log_posterior_and_gradient_match_jax(case, approx, masked):
    x, y, vec, _, jdata, jops, ops = case
    (want, wcomps), wgrad = _jax_value_and_grad(jdata, jops, approx)(
        jnp.asarray(vec), jnp.asarray(MASK if masked else np.ones(N, bool)))
    v = _t(vec).requires_grad_(True)
    lp, comps = sp.log_posterior_hetero(sp.unpack_hetero(v, M_Z, M), FullData(_t(x), _t(y)), ops, approx=approx,
                                        mask=torch.tensor(MASK) if masked else None)
    (grad,) = torch.autograd.grad(-lp, v)
    np.testing.assert_allclose((-lp).item(), float(want), rtol=RTOL)
    assert comps.keys() == wcomps.keys()
    for k, w in wcomps.items():
        np.testing.assert_allclose(comps[k].item(), float(w), rtol=RTOL, err_msg=k)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(grad.numpy(), wgrad, rtol=RTOL, atol=RTOL * np.abs(wgrad).max())


def test_per_slot_vfe_branch_equals_the_scalar_penalty_at_a_constant_noise(case):
    """``_loglik_pieces`` with a per-slot noise vector takes the pointwise
    Titsias penalty; at a constant vector it equals the scalar VFE path."""
    x, y, vec, _, _, _, ops = case
    p = sp._base_params(sp.unpack_hetero(_t(vec), M_Z, M))
    pieces = sp._assemble_full(p, FullData(_t(x), _t(y)), ops.base, M, mask=torch.tensor(MASK))
    s2 = torch.tensor(0.03, dtype=T64)
    scalar = sp._loglik_pieces(pieces, s2, "vfe")
    per_slot = sp._loglik_pieces(pieces, s2.expand(N * M).clone(), "vfe")
    np.testing.assert_allclose(per_slot.item(), scalar.item(), rtol=1e-12)
    noise = torch.exp(sp.noise_at_data(sp.unpack_hetero(_t(vec), M_Z, M), ops, M))
    want = jsp._loglik_pieces(tuple(None if t is None else jnp.asarray(t.numpy()) for t in pieces),
                              jnp.asarray(noise.numpy()), "vfe")
    np.testing.assert_allclose(sp._loglik_pieces(pieces, noise, "vfe").item(), float(want), rtol=RTOL)


def test_make_ops_hetero_and_convert_match_jax(case):
    x, _, vec, _, _, jops, ops = case
    got = sp.make_ops_hetero(_t(x), ops.base.z)
    np.testing.assert_array_equal(got.base.z.numpy(), np.asarray(jops.base.z))
    for name, g, w in (("proj_l", got.base.proj_l, jops.base.proj_l), ("proj_ul", got.base.proj_ul, jops.base.proj_ul),
                       ("proj_err", got.proj_err, jops.proj_err)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=name)
    np.testing.assert_allclose(got.pc_err_z.w.numpy(), np.asarray(jops.pc_err_z.w), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.pc_err_z.logdet.item(), float(jops.pc_err_z.logdet), rtol=1e-12)
    np.testing.assert_array_equal(ops.proj_err.numpy(), np.asarray(jops.proj_err))
    p = convert.sparse_hetero_params_from_jax(vec, M_Z, M, device="cpu")
    assert p.tilde_sigma2_err.shape == (M_Z * M,) and sp.n_params_hetero(M_Z, M) == vec.size
    np.testing.assert_allclose(sp.noise_at_data(p, ops, M).numpy(),
                               np.asarray(jsp.noise_at_data(jsp.unpack_hetero(jnp.asarray(vec), M_Z, M), jops, M)),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="gnmgp_hetero_sparse parameter vector"):
        sp.unpack_hetero(_t(vec[:-1]), M_Z, M)


def test_mixed_value_matches_f64_and_jax(case, monkeypatch):
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed

    x, y, vec, _, jdata, jops, ops = case
    for mod in (jsettings, settings):
        monkeypatch.setattr(mod, "robust_cholesky", True)
        monkeypatch.setattr(mod, "mixed_solves", True)
    calls = []
    real = mixed.mixed_logdet_quad
    monkeypatch.setattr(mixed, "mixed_logdet_quad", lambda *a: calls.append(1) or real(*a))
    p, data = sp.unpack_hetero(_t(vec), M_Z, M), FullData(_t(x), _t(y))
    got = sp.log_lik_hetero(p, data, ops, approx="vfe").item()
    assert calls, "the mixed route was not taken"
    want = jax.jit(lambda v: jsp.log_lik_hetero(jsp.unpack_hetero(v, M_Z, M), jdata, jops, approx="vfe"))(
        jnp.asarray(vec))
    monkeypatch.setattr(settings, "mixed_solves", False)
    np.testing.assert_allclose(got, sp.log_lik_hetero(p, data, ops, approx="vfe").item(), rtol=MIXED_VALUE_RTOL)
    np.testing.assert_allclose(got, float(want), rtol=MIXED_VALUE_RTOL)


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_predict_map_hetero_matches_jax(case, approx):
    x, y, vec, _, jdata, jops, ops = case
    grid = np.linspace(0.02, 0.98, G)
    jgrid, jmask = jnp.asarray(grid), jnp.asarray(MASK) if approx == "vfe" else None  # constants of the program
    want = jax.jit(lambda v: jpred.predict_map_hetero(v, jdata, jops, jgrid, approx=approx, mask=jmask))(
        jnp.asarray(vec))
    got = pred.predict_map_hetero(vec, FullData(x, y), ops, grid, approx=approx,
                                  mask=None if jmask is None else torch.tensor(MASK), device="cpu")
    assert got._fields == want._fields
    for f in got._fields:
        assert tuple(getattr(got, f).shape) == np.asarray(getattr(want, f)).shape
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    mean, var = pred.predict_test_hetero(vec, FullData(x, y), ops, grid, approx=approx,
                                         mask=None if jmask is None else torch.tensor(MASK), device="cpu")
    assert torch.equal(mean, got.mean) and torch.equal(torch.sqrt(var), got.std)


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_chain_conditional_loglik_sparse_hetero_matches_jax(case, approx):
    x, y, _, chain, jdata, jops, ops = case
    masked = approx == "vfe"
    want = np.asarray(jevaluate.chain_conditional_loglik_sparse(
        chain, jdata, jops, approx=approx, hetero=True, mask=jnp.asarray(MASK) if masked else None))
    data, mask = FullData(_t(x), _t(y)), torch.tensor(MASK) if masked else None
    got = evaluate.chain_conditional_loglik_sparse(chain, data, ops, approx=approx, hetero=True, mask=mask,
                                                   chunk=4, device="cpu")
    assert got.shape == want.shape == (S + 2, N * M)
    np.testing.assert_allclose(got, want, rtol=LOO_RTOL, atol=1e-14)
    by_name = evaluate.chain_conditional_loglik_sparse(chain, data, ops, approx=approx, model="gnmgp_hetero_sparse",
                                                       mask=mask, device="cpu")
    np.testing.assert_array_equal(by_name, got)


@pytest.mark.parametrize("kw,match", [(dict(hetero=True, model="snmgp_sparse"), "GNMGP sparse family only"),
                                      (dict(hetero=True, model="lmc_sparse"), "GNMGP sparse family only"),
                                      (dict(model="gp_sparse"), "unknown sparse model")])
def test_chain_conditional_loglik_sparse_refuses_a_wrong_pairing(case, kw, match):
    x, y, _, chain, jdata, jops, ops = case
    if "GNMGP" in match:  # JAX refuses it too
        with pytest.raises(ValueError, match=match):
            jevaluate.chain_conditional_loglik_sparse(chain, jdata, jops, **kw)
    with pytest.raises(ValueError, match=match):
        evaluate.chain_conditional_loglik_sparse(chain, FullData(_t(x), _t(y)), ops, device="cpu", **kw)
