"""The sparse GNMGP's predictors (``predict/gnmgp_sparse.py``) and its LOO
conditionals (``evaluate.chain_conditional_loglik_sparse``) against the JAX
package on the CPU, in float64.

Both packages get the same ``SparseOps`` (JAX's, through
``convert.sparse_ops_from_jax``) and the same draws; ``predict_sample``
replays JAX's keys (``split(key, S)``, then ``split(k, 3)`` into the ℓ̃,
L-entry and y normals) as ``noise=``.

Tolerances.  rtol 1e-6 (the acceptance bar) with, for the predictions, a
floor of 1e-6 of the output's scale: the latents at the grid are kriged from
Z by each package's own projection (the port's robust Cholesky on the
device against JAX's ``np.linalg.solve`` on the host; ~1e-8 apart), and a
mean near 0 takes that absolute error.  The LOO conditionals read the
Woodbury factors alone: rtol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_sparse as jsp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import gnmgp_sparse as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp_sparse as pred

from test_torch_sparse import M, M_Z, N, subject

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
T = M * (M + 1) // 2
G, S = 9, 5
RTOL, FLOOR = 1e-6, 1e-6


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _close(got, want, rtol=RTOL, floor=FLOOR, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=floor * np.abs(want).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def case():
    x, y, vec = subject(seed=4)
    jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
    _, jops = jsp.make_objective(jdata, n_inducing=M_Z)
    chain = vec[None, :] + 0.02 * np.random.default_rng(5).normal(size=(S + 2, vec.size))
    grid = np.linspace(0.02, 0.98, G)
    return x, y, vec, chain, grid, jdata, jops, convert.sparse_ops_from_jax(jops, device="cpu")


def _jax_y_noise(key, s):
    """The normals JAX's draws take: ``(z_l (S, G), z_ul (S, T, G), z_y (S,
    G, M))`` from ``split(split(key, s)[i], 3)``."""
    def one(k):
        k_l, k_ul, k_y = jax.random.split(k, 3)
        return (jax.random.normal(k_l, (G,), jnp.float64), jax.random.normal(k_ul, (T, G), jnp.float64),
                jax.random.normal(k_y, (G, M), jnp.float64))
    return tuple(np.array(a) for a in jax.vmap(one)(jax.random.split(key, s)))


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
@pytest.mark.parametrize("masked", [False, True])
def test_predict_map_matches_jax(case, approx, masked):
    x, y, vec, _, grid, jdata, jops, ops = case
    mask = (np.arange(N) < N - 5) if masked else None
    jgrid, jmask = jnp.asarray(grid), None if mask is None else jnp.asarray(mask)  # constants of the program
    # jitted: op by op the first case took ~10 s
    want = jax.jit(lambda v: jpred.predict_map(v, jdata, jops, jgrid, approx=approx, mask=jmask))(jnp.asarray(vec))
    got = pred.predict_map(vec, FullData(x, y), ops, grid, approx=approx,
                           mask=None if mask is None else torch.tensor(mask), device="cpu")
    assert got._fields == want._fields
    for f in got._fields:
        assert tuple(getattr(got, f).shape) == np.asarray(getattr(want, f)).shape
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)


def test_predict_test_matches_jax(case):
    x, y, vec, _, _, jdata, jops, ops = case
    x_test = np.random.default_rng(6).uniform(size=7)
    jx_test = jnp.asarray(x_test)  # a constant of the program, as the grid is below (op by op: ~2 s)
    want = jax.jit(lambda v: jpred.predict_test(v, jdata, jops, jx_test, approx="vfe"))(jnp.asarray(vec))
    got = pred.predict_test(_t(vec), FullData(_t(x), _t(y)), ops, _t(x_test), approx="vfe", device="cpu")
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_predict_sample_with_jax_noise_matches_jax(case):
    """Over the chain's last ``n_sample`` draws (JAX's vmapped draws, jitted:
    op by op they took ~10 s a call)."""
    x, y, _, chain, grid, jdata, jops, ops = case
    key, n_sample = jax.random.PRNGKey(8), 3
    jgrid = jnp.asarray(grid)  # a constant of the program: the kriging reads it on the host
    want = np.asarray(jax.jit(lambda k, c: jpred.predict_sample(k, c, jdata, jops, jgrid, n_sample=n_sample))(
        key, jnp.asarray(chain)))
    s = n_sample
    gram_kernels.reset_launches()
    got = pred.predict_sample(None, chain, FullData(x, y), ops, grid, n_sample=n_sample, device="cpu",
                              noise=_jax_y_noise(key, s))
    assert got.shape == want.shape == (G, s, M)
    _close(got.numpy(), want)
    assert set(gram_kernels.launches().values()) == {0}  # the CPU launches nothing


def test_predict_sample_draws_from_its_generator(case):
    x, y, _, chain, grid, _, _, ops = case
    draws = [pred.predict_sample(torch.Generator().manual_seed(3), chain, FullData(x, y), ops, grid, device="cpu")
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and torch.isfinite(draws[0]).all()


@pytest.fixture(scope="module")
def loo_case(case):
    x, y, _, chain, _, jdata, jops, ops = case
    want = {approx: np.asarray(jevaluate.chain_conditional_loglik_sparse(chain, jdata, jops, approx=approx))
            for approx in ("fitc", "vfe")}
    return want


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
@pytest.mark.parametrize("chunk", [1, 8])
def test_chain_conditional_loglik_sparse_matches_jax(case, loo_case, approx, chunk):
    x, y, _, chain, _, _, _, ops = case
    got = evaluate.chain_conditional_loglik_sparse(chain, FullData(_t(x), _t(y)), ops, approx=approx, chunk=chunk,
                                                   device="cpu")
    assert got.dtype == np.float64 and got.shape == loo_case[approx].shape == (S + 2, N * M)
    np.testing.assert_allclose(got, loo_case[approx], rtol=RTOL)


def test_chain_conditional_loglik_sparse_with_a_mask_matches_jax(case):
    x, y, _, chain, _, jdata, jops, ops = case
    mask = np.arange(N) < N - 4
    want = np.asarray(jevaluate.chain_conditional_loglik_sparse(chain[:3], jdata, jops, mask=jnp.asarray(mask)))
    got = evaluate.chain_conditional_loglik_sparse(chain[:3], FullData(_t(x), _t(y)), ops, mask=torch.tensor(mask),
                                                   device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
    assert (got[:, np.tile(~mask, M)] == 0.0).all()


@pytest.mark.parametrize("kw", [dict(hetero=True, model="snmgp_sparse"), dict(hetero=True, model="lmc_sparse"),
                                dict(model="gp_sparse")])
def test_other_sparse_conditionals_are_refused(case, kw):
    """Every sparse model's conditionals are ported; ``hetero=True`` with a
    separable model's name (JAX refuses it too) and an unknown name are not."""
    x, y, _, chain, _, _, _, ops = case
    with pytest.raises(ValueError, match="GNMGP sparse family only|unknown sparse model"):
        evaluate.chain_conditional_loglik_sparse(chain, FullData(_t(x), _t(y)), ops, device="cpu", **kw)
