"""The sparse SNMGP and LMC tiers (``models/snmgp_sparse.py``,
``models/lmc_sparse.py``, their predictors, ``gnmgp_sparse._loglik_separable``
and their LOO conditionals) against the JAX package on the CPU, in float64.

Inputs are numpy arrays made from a seed.  Both packages evaluate one
objective with the same ops: JAX's go to the port through ``convert``.  The
JAX sides are jitted once per model and approximation (op by op they take
seconds each): the mask is an argument, all ones for the unmasked case,
which JAX's masked likelihood equals exactly, while the port takes
``mask=None`` there.

Tolerances.  Values and gradients at rtol 1e-6 (they agree to ~1e-13
here).  The predictions at rtol 1e-6 with a floor of 1e-6 of their scale:
each package kriges the latents Z → grid by its own projection (~1e-8
apart).  The LOO conditionals read the Woodbury factors alone: rtol 1e-8.
Under ``NMGP_PRECISION=mixed`` the value at rtol 1e-8 against float64.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.models import lmc_sparse as jls
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp_sparse as jss
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import lmc_sparse as jpred_ls
from nonstationary_multivariate_gaussian_process_tpu.predict import snmgp_sparse as jpred_ss
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate, settings
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import empirical, init
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse, lmc_sparse, snmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import lmc_sparse as pred_ls
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import snmgp_sparse as pred_ss

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, M_Z, G, S = 40, 2, 8, 9, 4
RTOL, FLOOR, LOO_RTOL, MIXED_VALUE_RTOL = 1e-6, 1e-6, 1e-8, 1e-8
MASK = np.arange(N) < N - 6
MODELS = ("snmgp_sparse", "lmc_sparse")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _close(got, want, rtol=RTOL, floor=FLOOR, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=floor * np.abs(want).max(), err_msg=err_msg)


class Tier:
    """One model's JAX and port modules, its ops in both packages and a
    vector near a fit."""

    def __init__(self, model, x, y, rng):
        self.model = model
        self.jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
        self.data = FullData(_t(x), _t(y))
        if model == "snmgp_sparse":
            self.jmod, self.mod, self.jpred, self.pred = jss, snmgp_sparse, jpred_ss, pred_ss
            _, self.jops = jss.make_objective(self.jdata, n_inducing=M_Z)
            self.ops = convert.snmgp_sparse_ops_from_jax(self.jops, device="cpu")
            self.vec = np.concatenate([np.log(0.15) + 0.1 * rng.normal(size=M_Z), 0.1 * rng.normal(size=M_Z),
                                       [0.1, -0.3, -0.2], [np.log(0.02)]])
        else:
            self.jmod, self.mod, self.jpred, self.pred = jls, lmc_sparse, jpred_ls, pred_ls
            _, self.jops = jls.make_objective(self.jdata, n_inducing=M_Z)
            self.ops = convert.lmc_sparse_ops_from_jax(self.jops, device="cpu")
            self.vec = np.array([np.log(0.15), 0.1, 0.1, -0.3, -0.2, np.log(0.02)])
        self.chain = self.vec[None, :] + 0.02 * rng.normal(size=(S + 2, self.vec.size))

    def junpack(self, v):
        return self.jmod.unpack(v, M) if self.model == "lmc_sparse" else self.jmod.unpack(v, M_Z, M)

    def unpack(self, v):
        return self.mod.unpack(v, M) if self.model == "lmc_sparse" else self.mod.unpack(v, M_Z, M)


@pytest.fixture(scope="module")
def tiers():
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(size=N))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)], axis=1) + 0.1 * rng.normal(size=(N, M))
    return {model: Tier(model, x, y, rng) for model in MODELS}


_JAX_VG = {}


def _jax_value_and_grad(tier, approx):
    """JAX's (−log posterior, components) and gradient, jitted once per model
    and approximation, with the mask an argument."""
    key = (tier.model, approx)
    if key not in _JAX_VG:
        def f(v, mask):
            lp, comps = tier.jmod.log_posterior(tier.junpack(v), tier.jdata, tier.jops, approx=approx, mask=mask)
            return -lp, comps
        _JAX_VG[key] = jax.jit(jax.value_and_grad(f, has_aux=True))
    return _JAX_VG[key]


def _port_value_and_grad(tier, vec, approx, mask):
    v = _t(vec).requires_grad_(True)
    lp, comps = tier.mod.log_posterior(tier.unpack(v), tier.data, tier.ops, approx=approx,
                                       mask=None if mask is None else torch.tensor(mask))
    (g,) = torch.autograd.grad(-lp, v)
    return (-lp).item(), {k: c.item() for k, c in comps.items()}, g.numpy()


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("approx", ["fitc", "vfe"])
@pytest.mark.parametrize("masked", [False, True])
def test_log_posterior_and_gradient_match_jax(tiers, model, approx, masked):
    tier = tiers[model]
    mask = MASK if masked else None
    (want, wcomps), wgrad = _jax_value_and_grad(tier, approx)(jnp.asarray(tier.vec),
                                                             jnp.asarray(MASK if masked else np.ones(N, bool)))
    got, comps, grad = _port_value_and_grad(tier, tier.vec, approx, mask)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    assert comps.keys() == wcomps.keys()
    for k, w in wcomps.items():
        np.testing.assert_allclose(comps[k], float(w), rtol=RTOL, err_msg=k)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(grad, wgrad, rtol=RTOL, atol=RTOL * np.abs(wgrad).max())


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_separable_likelihood_equals_the_materialized_woodbury(tiers, model, approx):
    """``_loglik_separable`` (two small factors, per-task inner products)
    against the assembled ``B_f ⊗ K`` pieces through ``_loglik_pieces``: the
    two differ by where the ridge sits (1e-8 of a mean diagonal)."""
    tier = tiers[model]
    p = tier.unpack(_t(tier.vec))
    noise = torch.exp(p.tilde_sigma2_err)
    for mask in (None, torch.tensor(MASK)):
        factored = tier.mod.log_lik(p, tier.data, tier.ops, approx=approx, mask=mask)
        args = (p, tier.data, tier.ops, M) + ((None,) if model == "snmgp_sparse" else ())
        pieces = tier.mod._assemble(*args, mask=mask)
        np.testing.assert_allclose(factored.item(), gnmgp_sparse._loglik_pieces(pieces, noise, approx).item(),
                                   rtol=RTOL)


def test_kron_pieces_follow_jaxs_column_order(tiers):
    """``torch.kron``'s layout is ``jnp.kron``'s (``np.kron``'s): rows
    ``a·N + n``, columns ``c·m_z + j``; the mask is tiled task-major."""
    tier = tiers["snmgp_sparse"]
    p = tier.unpack(_t(tier.vec))
    b_f, k_zz, k_xz, k_x_diag = (t.numpy() for t in snmgp_sparse._factors(p, tier.data, tier.ops, M))
    k_mm, k_nm, k_diag, y_flat, mv = snmgp_sparse._assemble(p, tier.data, tier.ops, M, mask=torch.tensor(MASK))
    np.testing.assert_array_equal(k_mm.numpy(), np.kron(b_f, k_zz))
    np.testing.assert_array_equal(k_nm.numpy(), np.kron(b_f, k_xz))
    np.testing.assert_array_equal(k_diag.numpy(), np.kron(np.diag(b_f), k_x_diag))
    np.testing.assert_array_equal(y_flat.numpy(), tier.data.y.numpy().T.reshape(-1))
    np.testing.assert_array_equal(mv.numpy(), np.tile(MASK, M).astype(float))


def test_convert_and_make_ops_match_jax(tiers):
    tier = tiers["snmgp_sparse"]
    ops = snmgp_sparse.make_ops(tier.data.x, tier.ops.z)
    np.testing.assert_array_equal(ops.z.numpy(), np.asarray(tier.jops.z))
    for name in ("proj_l", "proj_sigma"):
        w = np.asarray(getattr(tier.jops, name))
        np.testing.assert_array_equal(getattr(tier.ops, name).numpy(), w)  # convert carries the arrays as they are
        np.testing.assert_allclose(getattr(ops, name).numpy(), w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=name)
    for name in ("pc_l_z", "pc_sigma_z"):
        got, want = getattr(ops, name), getattr(tier.jops, name)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got.logdet.item(), float(want.logdet), rtol=1e-12)
    p = convert.snmgp_sparse_params_from_jax(tier.vec, M_Z, M, device="cpu")
    assert torch.equal(snmgp_sparse.pack(p), _t(tier.vec))
    lmc = tiers["lmc_sparse"]
    np.testing.assert_array_equal(lmc.ops.z.numpy(), np.asarray(lmc.jops.z))
    assert torch.equal(lmc_sparse.make_ops(lmc.data.x, lmc.ops.z).z, lmc.ops.z)


def test_init_from_empirical_matches_jax(tiers):
    tier = tiers["snmgp_sparse"]
    x, y = tier.data.x.numpy(), tier.data.y.numpy()
    dense = init.snmgp_from_empirical(empirical.local_estimation(x, y, window_size=10), N, M, device="cpu")
    jdense = jinit.snmgp_from_empirical(jempirical.local_estimation(x, y, window_size=10), N, M)
    got = snmgp_sparse.init_from_empirical(dense, N, M_Z, M, tier.data.x, tier.ops.z)
    want = jss.init_from_empirical(jdense, N, M_Z, M, jnp.asarray(x), tier.jops.z)
    assert got.shape == (snmgp_sparse.n_params(M_Z, M),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_unpack_refuses_a_wrong_length_and_make_objective_a_bad_approx(tiers):
    tier = tiers["snmgp_sparse"]
    with pytest.raises(ValueError, match="snmgp_sparse parameter vector"):
        snmgp_sparse.unpack(_t(tier.vec[:-1]), M_Z, M)
    for mod in (snmgp_sparse, lmc_sparse):
        with pytest.raises(ValueError, match="approx must be 'fitc' or 'vfe'"):
            mod.make_objective(tier.data, n_inducing=M_Z, approx="dtc")


@pytest.mark.parametrize("model", MODELS)
def test_mixed_value_matches_f64_and_jax(tiers, model, monkeypatch):
    """Under ``NMGP_PRECISION=mixed`` the inner system goes through
    ``mixed_logdet_quad`` in both packages (JAX's routing is read at trace
    time: a fresh jit)."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed

    tier = tiers[model]
    for mod in (jsettings, settings):
        monkeypatch.setattr(mod, "robust_cholesky", True)
        monkeypatch.setattr(mod, "mixed_solves", True)
    calls = []
    real = mixed.mixed_logdet_quad
    monkeypatch.setattr(mixed, "mixed_logdet_quad", lambda *a: calls.append(1) or real(*a))
    p = tier.unpack(_t(tier.vec))
    got = tier.mod.log_lik(p, tier.data, tier.ops, approx="fitc").item()
    assert calls, "the mixed route was not taken"
    want = jax.jit(lambda v: tier.jmod.log_lik(tier.junpack(v), tier.jdata, tier.jops))(jnp.asarray(tier.vec))
    monkeypatch.setattr(settings, "mixed_solves", False)
    f64 = tier.mod.log_lik(p, tier.data, tier.ops, approx="fitc").item()
    np.testing.assert_allclose(got, f64, rtol=MIXED_VALUE_RTOL)
    np.testing.assert_allclose(got, float(want), rtol=MIXED_VALUE_RTOL)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_predict_map_matches_jax(tiers, model, approx):
    tier = tiers[model]
    grid = np.linspace(0.02, 0.98, G)
    masked = approx == "vfe"
    jgrid, jmask = jnp.asarray(grid), jnp.asarray(MASK) if masked else None  # constants of the jitted program
    want = jax.jit(lambda v: tier.jpred.predict_map(v, tier.jdata, tier.jops, jgrid, approx=approx, mask=jmask))(
        jnp.asarray(tier.vec))
    got = tier.pred.predict_map(tier.vec, tier.data, tier.ops, grid, approx=approx,
                                mask=torch.tensor(MASK) if masked else None, device="cpu")
    assert got._fields == want._fields == ("percentiles", "mean", "std")
    for f in got._fields:
        assert tuple(getattr(got, f).shape) == np.asarray(getattr(want, f)).shape
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)


def test_predict_test_matches_jax(tiers):
    """LMC's against JAX's; SNMGP's is its ``predict_map`` moments (one
    function in both packages)."""
    tier = tiers["lmc_sparse"]
    x_test = np.random.default_rng(6).uniform(size=7)
    jx_test = jnp.asarray(x_test)  # a constant of the jitted program
    want = jax.jit(lambda v: tier.jpred.predict_test(v, tier.jdata, tier.jops, jx_test))(jnp.asarray(tier.vec))
    got = tier.pred.predict_test(_t(tier.vec), tier.data, tier.ops, _t(x_test), device="cpu")
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    tier = tiers["snmgp_sparse"]
    mean, var = tier.pred.predict_test(_t(tier.vec), tier.data, tier.ops, _t(x_test), device="cpu")
    gp = tier.pred.predict_map(tier.vec, tier.data, tier.ops, x_test, device="cpu")
    assert torch.equal(mean, gp.mean) and torch.equal(torch.sqrt(var), gp.std)


def _jax_noise(model, key, s):
    """The normals JAX's draws take from ``split(key, S)``: SNMGP splits each
    key in three, ``(z_l (S, G), z_s (S, G), z_y (S, G, M))``; LMC draws
    ``(S, G, M)`` from each key."""
    keys = jax.random.split(key, s)
    if model == "lmc_sparse":
        return np.array(jax.vmap(lambda k: jax.random.normal(k, (G, M), jnp.float64))(keys))

    def one(k):
        k_l, k_s, k_y = jax.random.split(k, 3)
        return (jax.random.normal(k_l, (G,), jnp.float64), jax.random.normal(k_s, (G,), jnp.float64),
                jax.random.normal(k_y, (G, M), jnp.float64))
    return tuple(np.array(a) for a in jax.vmap(one)(keys))


@pytest.mark.parametrize("model", MODELS)
def test_predict_sample_with_jax_noise_matches_jax(tiers, model):
    """Over the chain's last ``n_sample`` draws (JAX's vmapped draws, jitted)."""
    tier = tiers[model]
    grid = np.linspace(0.02, 0.98, G)
    key, n_sample = jax.random.PRNGKey(8), 3
    jgrid = jnp.asarray(grid)  # a constant of the program: the kriging reads it on the host
    want = np.asarray(jax.jit(lambda k, c: tier.jpred.predict_sample(k, c, tier.jdata, tier.jops, jgrid,
                                                                      n_sample=n_sample))(key, jnp.asarray(tier.chain)))
    gram_kernels.reset_launches()
    got = tier.pred.predict_sample(None, tier.chain, tier.data, tier.ops, grid, n_sample=n_sample, device="cpu",
                                   noise=_jax_noise(model, key, n_sample))
    assert got.shape == want.shape == (G, n_sample, M)
    _close(got.numpy(), want)
    assert set(gram_kernels.launches().values()) == {0}  # the CPU launches nothing
    again = [tier.pred.predict_sample(torch.Generator().manual_seed(3), tier.chain, tier.data, tier.ops, grid,
                                      device="cpu") for _ in range(2)]
    assert torch.equal(again[0], again[1]) and again[0].shape == (G, S + 2, M)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_chain_conditional_loglik_sparse_matches_jax(tiers, model, approx):
    tier = tiers[model]
    masked = approx == "fitc"
    want = np.asarray(jevaluate.chain_conditional_loglik_sparse(
        tier.chain, tier.jdata, tier.jops, approx=approx, model=model, mask=jnp.asarray(MASK) if masked else None))
    got = evaluate.chain_conditional_loglik_sparse(tier.chain, tier.data, tier.ops, approx=approx, model=model,
                                                   mask=torch.tensor(MASK) if masked else None, chunk=3,
                                                   device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape == (S + 2, N * M)
    np.testing.assert_allclose(got, want, rtol=LOO_RTOL, atol=1e-14)
    if masked:
        assert (got[:, np.tile(~MASK, M)] == 0.0).all()
