"""The port's LMC model (objective, LOO conditionals, prediction, init
builders) and the SNMGP starts built from an LMC fit, against the JAX
package on the CPU, in float64.

Tolerances.  The objective and its gradient sum the same terms in another
order: rtol 1e-10.  The LMC path has no kriging, so the predictions are held
at rtol 1e-8 (with a floor of 1e-8 of the scale for entries near 0).  The
LOO conditionals take a Cholesky factor and a solve against I of a
covariance whose condition number here is ~1e4-1e6: rtol 1e-8, as in
``test_torch_loo.py``.  The init builders are the same numpy arithmetic:
rtol 1e-13.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.models import lmc as jlmc
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import lmc as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import init as init_mod
from nonstationary_multivariate_gaussian_process_tpu_torch.models import lmc
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import lmc as pred

from test_torch_hmc import jax_sim

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each


T64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _close(got, want, rtol):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=rtol * np.abs(w).max())


def subject(rng, n, m):
    """Inputs, observations and a packed LMC vector."""
    t = m * (m + 1) // 2
    x = np.sort(rng.uniform(size=n))
    y = np.sin(6 * x)[:, None] * np.arange(1, m + 1)[None, :] + 0.1 * rng.normal(size=(n, m))
    vec = np.concatenate([[np.log(0.2), 0.3], 0.4 * rng.normal(size=t), [np.log(2e-2)]])
    return x, y, vec


def _jax_value_and_grad(vec, x, y, mask):
    m = y.shape[1]
    f = lambda v: -jlmc.log_posterior(jlmc.unpack(v, m), JFullData(jnp.asarray(x), jnp.asarray(y)),
                                      mask=None if mask is None else jnp.asarray(mask))[0]
    val, grad = jax.jit(jax.value_and_grad(f))(jnp.asarray(vec))
    return float(val), np.asarray(grad)


@pytest.mark.parametrize("n,m,masked", [(30, 2, False), (30, 2, True), (24, 3, False)])
def test_objective_value_and_gradient_match_jax(rng, n, m, masked):
    x, y, vec = subject(rng, n, m)
    mask = (np.arange(n) < n - 5) if masked else None
    want_v, want_g = _jax_value_and_grad(vec, x, y, mask)
    v = _t(vec).requires_grad_(True)
    got = -lmc.log_posterior(lmc.unpack(v, m), FullData(_t(x), _t(y)),
                             mask=None if mask is None else torch.tensor(mask))[0]
    (grad,) = torch.autograd.grad(got, v)
    np.testing.assert_allclose(got.item(), want_v, rtol=1e-10)
    # sums over N of K1's per-input gradients, through the broadcast σ and ℓ
    np.testing.assert_allclose(grad.numpy(), want_g, rtol=1e-10, atol=1e-10 * np.abs(want_g).max())
    if not masked:
        jargs = (jnp.asarray(vec), jnp.asarray(y), jnp.asarray(x))
        np.testing.assert_allclose(lmc.nlogpos(_t(vec), _t(y), _t(x)).item(), float(jax.jit(jlmc.nlogpos)(*jargs)),
                                   rtol=1e-10)
        obj = lmc.make_objective(FullData(_t(x), _t(y)))
        np.testing.assert_allclose(obj(_t(vec)).item(), want_v, rtol=1e-10)
        np.testing.assert_allclose(lmc.deviance(_t(vec), _t(y), _t(x)).item(),
                                   float(jax.jit(jlmc.deviance)(*jargs)), rtol=1e-10)


def test_layout_round_trips_and_names_a_wrong_length(rng):
    _, _, vec = subject(rng, 8, 3)
    assert lmc.n_params(3) == 9 == vec.size
    p = convert.lmc_params_from_jax(vec, 3, device="cpu")
    np.testing.assert_array_equal(lmc.pack(p).numpy(), vec)
    with pytest.raises(ValueError, match="lmc parameter vector"):
        lmc.unpack(_t(vec[:-1]), 3)


def test_observation_cov_and_loo_conditionals_match_jax(rng):
    n, m, s = 14, 2, 3
    x, y, vec = subject(rng, n, m)
    hist = vec[None, :] + 0.05 * rng.normal(size=(s, vec.size))
    jax_cov = jax.jit(jevaluate.observation_cov, static_argnums=(0, 3, 4))  # op by op: seconds
    want = np.asarray(jax_cov("lmc", jnp.asarray(vec), jnp.asarray(x), n, m))
    got = evaluate.observation_cov("lmc", _t(vec), _t(x), n, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    want_ll = np.asarray(jevaluate.chain_conditional_loglik("lmc", hist, x, y))
    got_ll = evaluate.chain_conditional_loglik("lmc", hist, x, y, device="cpu")
    assert got_ll.shape == (s, n * m)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-8)


@pytest.mark.parametrize("n,m", [(30, 2), (24, 3)])
def test_predict_map_matches_jax(rng, n, m):
    x, y, vec = subject(rng, n, m)
    grid = np.linspace(0.0, 1.0, 37)
    want = jax.jit(lambda v, xx, yy, gg: jpred.predict_map(v, JFullData(xx, yy), gg))(
        jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    gram_kernels.reset_launches()
    got = pred.predict_map(vec, FullData(x, y), grid, device="cpu")
    assert got.mean.shape == (37, m) and got.mean.dtype == T64
    for f in ("percentiles", "mean", "std"):
        _close(getattr(got, f).numpy(), getattr(want, f), 1e-8)
    assert sum(gram_kernels.launches().values()) == 0


def test_predict_sample_matches_jax_given_its_noise(rng):
    n, m, s, g = 20, 2, 4, 9
    x, y, vec = subject(rng, n, m)
    chain = vec[None, :] + 0.05 * rng.normal(size=(s + 2, vec.size))
    grid = np.linspace(0.05, 0.95, g)
    key = jax.random.PRNGKey(4)
    sample = jax.jit(lambda k, c, xx, yy, gg: jpred.predict_sample(k, c, JFullData(xx, yy), gg, n_sample=s))
    want = np.asarray(sample(key, jnp.asarray(chain), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid)))
    noise = np.array(jax.vmap(lambda k: jax.random.normal(k, (g, m), jnp.float64))(jax.random.split(key, s)))
    got = pred.predict_sample(None, chain, FullData(x, y), grid, n_sample=s, device="cpu", noise=noise)
    assert got.shape == want.shape == (s, g, m)
    _close(got.numpy(), want, 1e-8)
    gen = lambda: torch.Generator().manual_seed(1)
    a = pred.predict_sample(gen(), chain, FullData(x, y), grid, device="cpu")
    assert a.shape == (s + 2, g, m) and torch.equal(a, pred.predict_sample(gen(), chain, FullData(x, y), grid,
                                                                           device="cpu"))


def test_init_builders_match_jax():
    d = jax_sim(jax.random.PRNGKey(2), n=30, m=2)
    x, y = np.asarray(d.x), np.asarray(d.y)
    emp = jempirical.local_estimation(x, y, window_size=8, method="profile")
    pemp = convert.empirical_from_jax(emp)
    lmc_vec = np.asarray(jinit.lmc_from_empirical(emp, 30, 2)) + 0.1 * np.cos(np.arange(6.0))
    cases = [
        (init_mod.lmc_from_empirical(pemp, 30, 2, "cpu"), jinit.lmc_from_empirical(emp, 30, 2)),
        (init_mod.snmgp_from_stationary(_t(lmc_vec), 30, "cpu"), jinit.snmgp_from_stationary(lmc_vec, 30)),
        (init_mod.snmgp_combined(lmc_vec, pemp, 30, 2, "cpu"), jinit.snmgp_combined(lmc_vec, emp, 30, 2)),
    ]
    for got, want in cases:
        assert got.dtype == T64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
