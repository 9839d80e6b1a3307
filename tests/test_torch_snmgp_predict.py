"""The port's SNMGP prediction (``predict/snmgp.py``), its masked objective
gradient and its LOO conditionals against the JAX package on the CPU, in
float64.

The sampling paths are given JAX's own normals through ``noise=``: one key
per draw from ``split(key, S)``, split into three for ℓ̃, σ̃ and y.
Tolerances as in ``test_torch_predict.py``: the kriged ℓ̃ and σ̃ carry the
two kriging solvers' ~1e-7 absolute spread, so everything downstream of
them is held at rtol 1e-6 with a floor of 1e-6 of the scale.  The masked
objective's gradient reaches ~6e4 here and its two sums part at ~1e-8
relative, so it is held at rtol 1e-6, as ``test_torch_models.py`` holds the
unmasked one; the LOO conditionals at rtol 1e-8, as in
``test_torch_loo.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp as jsnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import snmgp as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate
from nonstationary_multivariate_gaussian_process_tpu_torch.models import snmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import latent
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import snmgp as pred

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, S, G = 24, 2, 4, 9
T = M * (M + 1) // 2
#: Non-default latent priors, so that the hyper override is exercised.
HYPER = {"alpha_tilde_l": 2.0, "beta_tilde_l": 0.5, "alpha_tilde_sigma": 1.5, "beta_tilde_sigma": 0.8}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _close(got, want, rtol=1e-6, err_msg=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=err_msg)


def make_subject(rng, n, m):
    """Inputs, observations and a packed SNMGP vector with a σ-process that
    varies over x (so K1's σ on both sides of the cross form matters)."""
    t = m * (m + 1) // 2
    x = np.sort(rng.uniform(size=n))
    y = np.sin(6 * x)[:, None] * np.arange(1, m + 1)[None, :] + 0.1 * rng.normal(size=(n, m))
    tilde_l = np.log(0.15) + 0.3 * np.sin(3 * x) + 0.05 * rng.normal(size=n)
    tilde_sigma = 0.4 * np.cos(4 * x) + 0.05 * rng.normal(size=n)
    vec = np.concatenate([tilde_l, tilde_sigma, 0.4 * rng.normal(size=t), [np.log(2e-2)]])
    return x, y, vec


@pytest.fixture(scope="module")
def subject():
    rng = np.random.default_rng(21)
    x, y, vec = make_subject(rng, N, M)
    chain = vec[None, :] + 0.02 * rng.normal(size=(S + 2, vec.size))
    return x, y, vec, chain, np.linspace(0.02, 0.98, G)


def _jdata(x, y):
    return JFullData(jnp.asarray(x), jnp.asarray(y))


def jax_y_noise(key, s, m=M):
    """JAX's normals per draw: ``(z_l (G,), z_s (G,), z_y (G, M))`` from
    ``split(split(key, s)[i], 3)``."""
    def one(k):
        k_l, k_s, k_y = jax.random.split(k, 3)
        return (jax.random.normal(k_l, (G,), jnp.float64), jax.random.normal(k_s, (G,), jnp.float64),
                jax.random.normal(k_y, (G, m), jnp.float64))
    return tuple(np.array(a) for a in jax.vmap(one)(jax.random.split(key, s)))


@pytest.mark.parametrize("n,m,hyper", [(30, 2, None), (24, 3, HYPER)])
def test_predict_map_matches_jax(rng, n, m, hyper):
    x, y, vec = make_subject(rng, n, m)
    grid = np.linspace(0.0, 1.0, 37)
    want = jax.jit(lambda v, xx, yy, gg: jpred.predict_map(v, JFullData(xx, yy), gg, hyper=hyper))(
        jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    got = pred.predict_map(vec, FullData(x, y), grid, device="cpu", hyper=hyper)
    assert isinstance(got, pred.GridPrediction) and got.percentiles.shape == (37, 3, m)
    assert got.mean.dtype == T64
    for f in ("percentiles", "mean", "std"):
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)


def test_predict_map_sampling_matches_jax_given_its_noise(subject):
    x, y, vec, _, grid = subject
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda k, v, xx, yy, gg: jpred.predict_map_sampling(k, S, v, JFullData(xx, yy), gg,
                                                                       hyper=HYPER))(
        key, jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    got = pred.predict_map_sampling(None, S, vec, FullData(x, y), grid, hyper=HYPER, device="cpu",
                                    noise=jax_y_noise(key, S))
    assert isinstance(got, pred.SampledPrediction) and got.quantiles.shape == (G, 2, M)
    for f in ("quantiles", "mean", "std"):
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)


def test_predict_sample_matches_jax_given_its_noise(subject):
    x, y, _, chain, grid = subject
    key = jax.random.PRNGKey(6)
    want = jax.jit(lambda k, c, xx, yy, gg: jpred.predict_sample(k, c, JFullData(xx, yy), gg, hyper=HYPER,
                                                                 n_sample=S))(
        key, jnp.asarray(chain), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    got = pred.predict_sample(None, chain, FullData(x, y), grid, hyper=HYPER, n_sample=S, device="cpu",
                              noise=jax_y_noise(key, S))
    assert got.shape == want.shape == (G, S, M)
    _close(got.numpy(), want)


def test_sampling_draws_from_a_generator_and_krigs_once_per_call(subject, monkeypatch):
    x, y, vec, chain, grid = subject
    calls = []
    real = latent.krige_proj
    counted = lambda *a: calls.append(a) or real(*a)
    monkeypatch.setattr(pred, "krige_proj", counted)
    monkeypatch.setattr(latent, "krige_proj", counted)
    gen = lambda: torch.Generator().manual_seed(3)
    a = pred.predict_sample(gen(), chain, FullData(x, y), grid, device="cpu")
    assert len(calls) == 2  # one per latent prior, not per draw
    assert a.shape == (G, S + 2, M) and torch.isfinite(a).all()
    assert torch.equal(a, pred.predict_sample(gen(), chain, FullData(x, y), grid, device="cpu"))
    b = pred.predict_map_sampling(gen(), 5, vec, FullData(x, y), grid, device="cpu")
    assert (b.quantiles[:, 0] <= b.quantiles[:, 1]).all()


def test_masked_objective_gradient_matches_jax(subject):
    x, y, vec, _, _ = subject
    mask = np.arange(N) < N - 4
    f = lambda v: -jsnmgp.log_posterior(jsnmgp.unpack(v, N, M), _jdata(x, y), mask=jnp.asarray(mask))[0]
    want_v, want_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(vec))
    v = _t(vec).requires_grad_(True)
    got = -snmgp.log_posterior(snmgp.unpack(v, N, M), FullData(_t(x), _t(y)), mask=torch.tensor(mask))[0]
    (grad,) = torch.autograd.grad(got, v)
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-10)
    _close(grad.numpy(), want_g)


def test_observation_cov_and_loo_conditionals_match_jax(subject):
    x, y, vec, chain, _ = subject
    jax_cov = jax.jit(jevaluate.observation_cov, static_argnums=(0, 3, 4))  # op by op: seconds
    want = np.asarray(jax_cov("snmgp", jnp.asarray(vec), jnp.asarray(x), N, M))
    got = evaluate.observation_cov("snmgp", _t(vec), _t(x), N, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    want_ll = np.asarray(jevaluate.chain_conditional_loglik("snmgp", chain[:3], x, y))
    got_ll = evaluate.chain_conditional_loglik("snmgp", chain[:3], x, y, device="cpu")
    assert got_ll.shape == (3, N * M)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-8)
