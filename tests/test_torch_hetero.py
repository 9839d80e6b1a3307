"""The port's heteroscedastic-noise GNMGP (``models/gnmgp_hetero.py``,
``predict/gnmgp_hetero.py``, ``data/sim.sim_mnts_hetero``) against the JAX
package on the CPU, in float64.

The noise log-variances are ``sim_mnts_hetero``'s truth (rising over x on
task 0, falling on task 1) plus noise, so they differ across both inputs and
tasks: the port's likelihood permutes JAX's task-major noise to K3's
input-major layout, and a layout error there would show.

Tolerances.  The objective sums the same terms in another order and
another Gram layout: value rtol 1e-10, gradient rtol 1e-8 with a floor of
1e-8 of its scale.  ``nlogpos`` factors its GP priors' smooth-RBF Grams
(condition ~1e9) in each package's own robust Cholesky rather than taking
the hoisted factors, and its value (~4.5e5 here, mostly prior) is held at
rtol 1e-8.  The predictions carry the kriging solvers' ~1e-7
absolute spread (``test_torch_predict.py``): rtol 1e-6 with a floor of 1e-6
of the scale.  The LOO conditionals at rtol 1e-8, as in
``test_torch_loo.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu.data import sim as jsim
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_hetero as jhetero
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import gnmgp_hetero as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate
from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_hetero as hetero
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp_hetero as pred

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, S, G = 20, 2, 4, 9
T = M * (M + 1) // 2


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _close(got, want, rtol=1e-6, err_msg=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=err_msg)


def truth_vec(d, rng, scale=0.1):
    """The subject's truth packed as a hetero vector, perturbed."""
    n = d.x.shape[0]
    ul = transforms.lvec_to_ulvec(_t(d.l_vecs).reshape(n, T), M).reshape(-1).numpy()
    vec = np.concatenate([np.log(np.asarray(d.l)), ul, np.asarray(d.tilde_sigma2_err)])
    return vec + scale * rng.normal(size=vec.size)


@pytest.fixture(scope="module")
def subject():
    rng = np.random.default_rng(31)
    d = jsim.sim_mnts_hetero(jax.random.PRNGKey(8), n=N)
    x, y = np.asarray(d.x), np.asarray(d.y)
    vec = truth_vec(d, rng)
    chain = vec[None, :] + 0.02 * rng.normal(size=(S + 2, vec.size))
    return x, y, vec, chain, np.linspace(0.02, 0.98, G)


def test_sim_mnts_hetero_matches_jax_given_its_inputs_and_normals():
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda k: jsim.sim_mnts_hetero(k, n=30))(key)  # op by op: seconds
    k_x, k_y = jax.random.split(key)
    x = np.sort(np.asarray(jax.random.uniform(k_x, (30,), jnp.float64)))
    z = np.asarray(jax.random.normal(k_y, (60,), jnp.float64))
    got = sim.hetero_subject(_t(x), _t(z))
    assert isinstance(got, sim.HeteroSimData) and got.y.shape == (30, 2)
    for f in ("x", "l", "l_vecs", "tilde_sigma2_err", "stds", "cors"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-12, err_msg=f)
    _close(got.y.numpy(), want.y, rtol=1e-10)
    own = sim.sim_mnts_hetero(torch.Generator().manual_seed(0), n=12, device="cpu")
    assert own.y.shape == (12, 2) and torch.isfinite(own.y).all() and own.tilde_sigma2_err.shape == (24,)
    with pytest.raises(ValueError, match="M=2"):
        sim.sim_mnts_hetero(torch.Generator(), n=12, m=3, device="cpu")


@pytest.mark.parametrize("masked", [False, True])
def test_objective_value_and_gradient_match_jax(subject, masked):
    x, y, vec, _, _ = subject
    mask = (np.arange(N) < N - 4) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    f = jhetero.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)), mask=jmask)
    want_v, want_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(vec))
    nlp = hetero.make_objective(FullData(_t(x), _t(y)), mask=None if mask is None else torch.tensor(mask))
    v = _t(vec).requires_grad_(True)
    got = nlp(v)
    (grad,) = torch.autograd.grad(got, v)
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-10)
    _close(grad.numpy(), want_g, rtol=1e-8)
    if not masked:
        jargs = (jnp.asarray(vec), jnp.asarray(y), jnp.asarray(x))
        np.testing.assert_allclose(hetero.nlogpos(_t(vec), _t(y), _t(x)).item(),
                                   float(jax.jit(jhetero.nlogpos)(*jargs)), rtol=1e-8)
        np.testing.assert_allclose(hetero.deviance(_t(vec), _t(y), _t(x)).item(),
                                   float(jax.jit(jhetero.deviance)(*jargs)), rtol=1e-10)


def test_layout_converters_and_warm_start_match_jax(subject):
    x, y, vec, _, _ = subject
    assert hetero.n_params(N, M) == vec.size == N + N * T + N * M
    p = convert.hetero_params_from_jax(vec, N, M, device="cpu")
    np.testing.assert_array_equal(hetero.pack(p).numpy(), vec)
    np.testing.assert_array_equal(p.tilde_sigma2_err.numpy(), vec[-N * M:])
    with pytest.raises(ValueError, match="gnmgp_hetero parameter vector"):
        hetero.unpack(_t(vec[:-1]), N, M)
    gn = vec[: N + N * T + 1]
    np.testing.assert_array_equal(hetero.init_from_gnmgp(_t(gn), N, M).numpy(),
                                  np.asarray(jhetero.init_from_gnmgp(jnp.asarray(gn), N, M)))
    assert hetero.DEFAULT_HYPERS == jhetero.DEFAULT_HYPERS


def test_observation_cov_and_loo_conditionals_match_jax(subject):
    x, y, vec, chain, _ = subject
    jax_cov = jax.jit(jevaluate.observation_cov, static_argnums=(0, 3, 4))  # op by op: seconds
    want = np.asarray(jax_cov("gnmgp_hetero", jnp.asarray(vec), jnp.asarray(x), N, M))
    got = evaluate.observation_cov("gnmgp_hetero", _t(vec), _t(x), N, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    want_ll = np.asarray(jevaluate.chain_conditional_loglik("gnmgp_hetero", chain[:3], x, y))
    got_ll = evaluate.chain_conditional_loglik("gnmgp_hetero", chain[:3], x, y, device="cpu")
    assert got_ll.shape == (3, N * M)
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-8)


def test_predict_map_and_noise_map_match_jax(subject):
    x, y, vec, _, _ = subject
    grid = np.linspace(0.0, 1.0, 37)
    jargs = (jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    want = jax.jit(lambda v, xx, yy, gg: jpred.predict_map(v, JFullData(xx, yy), gg))(*jargs)
    got = pred.predict_map(vec, FullData(x, y), grid, device="cpu")
    assert isinstance(got, pred.GridPredictionHetero) and got.noise_var.shape == (37, M)
    for f in ("percentiles", "mean", "std", "l_vecs", "noise_var"):
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    want_n = jax.jit(lambda v, xx, yy, gg: jpred.predict_noise_map(v, JFullData(xx, yy), gg))(*jargs)
    _close(pred.predict_noise_map(vec, FullData(x, y), grid, device="cpu").numpy(), want_n)


def test_predict_sample_matches_jax_given_its_noise(subject):
    x, y, _, chain, grid = subject
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda k, c, xx, yy, gg: jpred.predict_sample(k, c, JFullData(xx, yy), gg, n_sample=S))(
        key, jnp.asarray(chain), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))

    def one(k):  # JAX's split(k, 4) per draw: ℓ̃, the L-entries, the noise, y
        k_l, k_ul, k_e, k_y = jax.random.split(k, 4)
        return (jax.random.normal(k_l, (G,), jnp.float64), jax.random.normal(k_ul, (T, G), jnp.float64),
                jax.random.normal(k_e, (M, G), jnp.float64), jax.random.normal(k_y, (G, M), jnp.float64))

    noise = tuple(np.array(a) for a in jax.vmap(one)(jax.random.split(key, S)))
    got = pred.predict_sample(None, chain, FullData(x, y), grid, n_sample=S, device="cpu", noise=noise)
    assert got.shape == want.shape == (G, S, M)
    _close(got.numpy(), want)
    gen = lambda: torch.Generator().manual_seed(2)
    a = pred.predict_sample(gen(), chain, FullData(x, y), grid, device="cpu")
    assert a.shape == (G, S + 2, M) and torch.equal(a, pred.predict_sample(gen(), chain, FullData(x, y), grid,
                                                                           device="cpu"))
