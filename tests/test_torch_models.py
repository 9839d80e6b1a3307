"""The port's training-path kernels and objectives against the JAX package on
the CPU, in float64 unless noted.

Inputs are numpy arrays made from a seed and handed to both packages.  On
the CPU the kernel wrappers take their plain versions (a backward's plain
version is autograd through its forward's), which repeat the CUDA kernels'
arithmetic; the kernels themselves are held against those plain versions on
the card by ``chip_smoke.py``.

Tolerances.  The plain Grams repeat the JAX formulas with the squared
distance taken as ``(x_i − x_j)²`` instead of ``x_i² + x_j² − 2 x_i x_j``,
so they agree to a few ulp (rtol 1e-12); their gradients to 1e-10 of the
gradient's scale.  The objectives are held at rtol 1e-6 (values and
gradients, the issue's bar): they run different LAPACK builds on Grams whose
condition reaches ~1e10, and measure ~1e-9 apart.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import dists as jdists
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp as jsnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.ops import chol as jchol
from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels
from nonstationary_multivariate_gaussian_process_tpu.ops import kron as jkron
from nonstationary_multivariate_gaussian_process_tpu.ops import pallas_kernels as pk
from nonstationary_multivariate_gaussian_process_tpu_torch import dists, settings
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp, snmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import chol, gram_kernels, kron

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
JITTER = 1e-6


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=T64, requires_grad=requires_grad)


def _gram_inputs(rng, n, m):
    x = np.sort(rng.uniform(size=n))
    ell = np.exp(3 * (x - 1) ** 3 - 3 + 0.2 * rng.normal(size=n))
    ls = np.tril(rng.normal(size=(n, m, m))) + 2 * np.eye(m)
    return x, ell, ls


@jax.jit
def _jax_input_major(x, ell, ls):
    """JAX's Gram permuted to input-major (jitted: op by op a shape took ~1.5 s)."""
    n, m, _ = ls.shape
    kx = jkernels.nonstationary_rbf_cov(x, ell1=ell)
    return jgnmgp.gram(kx, ls).reshape(m, n, m, n).transpose(1, 0, 3, 2).reshape(n * m, n * m)


def _close(got, want, rtol, err_msg=""):
    """Elementwise rtol with an absolute floor of rtol × the largest |want|."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=err_msg)


# ---------------------------------------------------------------------------
# K3: plain version against the Pallas kernel and the JAX Gram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(100, 2), (37, 3)])
def test_k3_plain_matches_pallas_interpret(rng, n, m):
    x, ell, ls = _gram_inputs(rng, n, m)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    want = np.asarray(pk.svc_gram_fused(f32(x), f32(ell), f32(ls), interpret=True))
    got = gram_kernels.svc_gram_tiled_plain(_t(x), _t(ell), _t(ls), JITTER).numpy()
    # the Pallas kernel is float32-only (tests/test_pallas.py holds it at 2e-5)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n,m", [(100, 2), (37, 3)])
def test_k3_plain_matches_permuted_jax_gram_f64(rng, n, m):
    x, ell, ls = _gram_inputs(rng, n, m)
    want = _jax_input_major(jnp.asarray(x), jnp.asarray(ell), jnp.asarray(ls))
    got = gram_kernels.svc_gram_tiled(_t(x), _t(ell), _t(ls), JITTER)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n,m", [(100, 2), (37, 3)])
def test_k3_plain_equals_k2_input_major(rng, n, m):
    x, ell, ls = (_t(a) for a in _gram_inputs(rng, n, m))
    k3 = gram_kernels.svc_gram_tiled_plain(x, ell, ls, JITTER)
    assert torch.equal(k3, gram_kernels.svc_gram_plain(x, ell, ls, JITTER, layout="input"))


# ---------------------------------------------------------------------------
# Backward plain versions against jax.grad, and the autograd Functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(40, 2), (23, 3), (12, 9)])
def test_k3_backward_plain_matches_jax_grad(rng, n, m):
    x, ell, ls = _gram_inputs(rng, n, m)
    kbar = rng.normal(size=(n * m, n * m))  # not symmetric
    loss = lambda e, l: jnp.sum(jnp.asarray(kbar) * _jax_input_major(jnp.asarray(x), e, l))
    want_e, want_l = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(ell), jnp.asarray(ls))
    got_e, got_l = gram_kernels.svc_gram_tiled_backward(_t(x), _t(ell), _t(ls), _t(kbar), JITTER)
    _close(got_e, want_e, 1e-10)
    _close(got_l, want_l, 1e-10)


@pytest.mark.parametrize("n", [40, 23])
def test_k1_backward_plain_matches_jax_grad(rng, n):
    x = np.sort(rng.uniform(size=n))
    s = rng.uniform(0.5, 2.0, n)
    ell = np.exp(-2 + 0.3 * rng.normal(size=n))
    kbar = rng.normal(size=(n, n))
    loss = lambda sg, e: jnp.sum(
        jnp.asarray(kbar) * jkernels.nonstationary_rbf_cov(jnp.asarray(x), sigma1=sg, ell1=e)
    )
    want_s, want_l = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(s), jnp.asarray(ell))
    got_s, got_l = gram_kernels.gibbs_gram_backward(_t(x), _t(s), _t(ell), _t(kbar), JITTER)
    _close(got_s, want_s, 1e-10)
    _close(got_l, want_l, 1e-10)


def test_gradcheck_k3_function(rng):
    x, ell, ls = _gram_inputs(rng, 8, 2)
    fn = lambda e, l: gram_kernels.svc_gram_tiled(_t(x), e, l, JITTER)
    assert torch.autograd.gradcheck(fn, (_t(ell, True), _t(ls, True)))


def test_gradcheck_k1_function(rng):
    x = np.sort(rng.uniform(size=8))
    fn = lambda s, e: gram_kernels.gibbs_gram(_t(x), s, e, jitter=JITTER)
    assert torch.autograd.gradcheck(fn, (_t(rng.uniform(0.5, 2, 8), True), _t(rng.uniform(0.2, 1, 8), True)))


def test_gradients_that_are_not_ported_raise(rng):
    """The gradients in the inputs that inducing-input refinement takes now
    run (K1 in x and x2, K3 in x, through their backward kernels' plain
    versions); K3 over a batch still refuses one (SMC never moves Z)."""
    x, ell, ls = _gram_inputs(rng, 6, 2)
    assert torch.autograd.gradcheck(lambda a, b: gram_kernels.gibbs_gram(a, _t(ell), _t(ell), b, _t(ell), _t(ell)),
                                    (_t(x, True), _t(x + 0.1, True)))
    assert torch.autograd.gradcheck(lambda a: gram_kernels.gibbs_gram(a, _t(ell), _t(ell), jitter=JITTER),
                                    (_t(x, True),))
    assert torch.autograd.gradcheck(lambda a: gram_kernels.svc_gram_tiled(a, _t(ell), _t(ls), JITTER), (_t(x, True),))
    with pytest.raises(NotImplementedError, match="x is data"):
        gram_kernels.svc_gram_tiled_batched(_t(x, True), _t(ell[None]), _t(ls[None]), JITTER)


def test_forward_without_gradients_skips_the_function(rng):
    """The served path (no gradients) keeps its plain forward and launches nothing."""
    x, ell, ls = (_t(a) for a in _gram_inputs(rng, 6, 2))
    gram_kernels.reset_launches()
    k = gram_kernels.svc_gram_tiled(x, ell, ls, JITTER)
    assert k.grad_fn is None
    assert set(gram_kernels.launches().values()) == {0}


# ---------------------------------------------------------------------------
# Densities and linear algebra
# ---------------------------------------------------------------------------


def test_scalar_densities_match_jax(rng):
    x = rng.uniform(0.1, 3.0, 7)
    pairs = [
        (dists.normal_logpdf(_t(x), 0.3, 2.0), jdists.normal_logpdf(jnp.asarray(x), 0.3, 2.0)),
        (dists.inverse_gamma_logpdf(_t(x), 2.0, 1.5), jdists.inverse_gamma_logpdf(jnp.asarray(x), 2.0, 1.5)),
        (dists.inverse_gamma_logpdf_u(_t(x), 2.0, 1.5), jdists.inverse_gamma_logpdf_u(jnp.asarray(x), 2.0, 1.5)),
        (dists.gamma_logpdf(_t(x), 2.0, 1.5), jdists.gamma_logpdf(jnp.asarray(x), 2.0, 1.5)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def _spd(rng, n):
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def test_mvn_logpdfs_match_jax(rng):
    n = 12
    cov, y, mu = _spd(rng, n), rng.normal(size=n), rng.normal(size=n)
    np.testing.assert_allclose(
        dists.mvn_logpdf_dense_unnorm(_t(y), _t(mu), _t(cov)).item(),
        float(jax.jit(jdists.mvn_logpdf_dense_unnorm)(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(cov))),
        rtol=1e-12)
    c = np.linalg.cholesky(cov)
    ys = rng.normal(size=(3, n))
    want = jax.jit(jax.vmap(lambda r, cc: jdists.mvn_logpdf_chol(r, 0.2, cc), (0, None)))(
        jnp.asarray(ys), jnp.asarray(c))
    np.testing.assert_allclose(dists.mvn_logpdf_chol(_t(ys), 0.2, _t(c)).numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_kron_chol_logdet_quad_matches_jax(rng, masked):
    n, m = 20, 3
    b, k = _spd(rng, m), _spd(rng, n) / n
    y = rng.normal(size=n * m)
    mask = (np.arange(n) < 15) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want = jax.jit(lambda bb, kk, yy: jkron.kron_chol_logdet_quad(bb, kk, 0.3, yy, mask=jm))(
        jnp.asarray(b), jnp.asarray(k), jnp.asarray(y))
    got = kron.kron_chol_logdet_quad(_t(b), _t(k), 0.3, _t(y), mask=None if mask is None else torch.tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-10)


def test_kron_solve_and_mv_match_jax(rng):
    n, m = 15, 2
    b, k, y = _spd(rng, m), _spd(rng, n) / n, rng.normal(size=n * m)
    np.testing.assert_allclose(
        kron.kron_solve(_t(b), _t(k), 0.3, _t(y)).numpy(),
        np.asarray(jax.jit(lambda bb, kk, yy: jkron.kron_solve(bb, kk, 0.3, yy))(
            jnp.asarray(b), jnp.asarray(k), jnp.asarray(y))), rtol=1e-10)
    np.testing.assert_allclose(
        kron.kron_mv(_t(b), _t(k), _t(y)).numpy(),
        np.asarray(jax.jit(jkron.kron_mv)(jnp.asarray(b), jnp.asarray(k), jnp.asarray(y))), rtol=1e-12)


def test_kron_failed_block_turns_nan():
    b = torch.tensor([[1.0, 0.0], [0.0, 1.0]], dtype=T64)
    k = -torch.eye(3, dtype=T64)  # not positive definite
    logdet, quad = kron.kron_chol_logdet_quad(b, k, 0.1, torch.ones(6, dtype=T64))
    assert not torch.isfinite(logdet) and not torch.isfinite(quad)


def test_psd_logdet_quad_and_solve_match_jax(rng):
    n = 30
    a, y = _spd(rng, n), rng.normal(size=n)
    want = jax.jit(jchol.psd_logdet_quad)(jnp.asarray(a), jnp.asarray(y))  # op by op: ~1 s
    got = chol.psd_logdet_quad(_t(a), _t(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-10)
    np.testing.assert_allclose(
        chol.psd_solve(_t(a), _t(y)).numpy(), np.asarray(jax.jit(jchol.psd_solve)(jnp.asarray(a), jnp.asarray(y))),
        rtol=1e-10)


@pytest.mark.parametrize("n", [8, 48, 200])
def test_prior_factors_match_jax(rng, n):
    x = np.sort(rng.uniform(size=n))
    want = jchol.prior_rbf_inv(jnp.asarray(x), 5.0, 1.0)
    got = chol.prior_rbf_inv(_t(x), 5.0, 1.0)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.logdet.item(), float(want.logdet), rtol=1e-12)
    np.testing.assert_allclose(
        chol.prior_rbf_cholesky(_t(x), 5.0, 1.0).numpy(),
        np.asarray(jchol.prior_rbf_cholesky(jnp.asarray(x), 5.0, 1.0)), rtol=1e-12)
    g = 25.0 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 1e-6 * np.eye(n)
    np.testing.assert_allclose(chol.prior_cholesky(_t(g)).numpy(),
                               np.asarray(jchol.prior_cholesky(jnp.asarray(g))), rtol=1e-12)


# ---------------------------------------------------------------------------
# The objectives
# ---------------------------------------------------------------------------


def _gnmgp_case(rng, n, m):
    t = m * (m + 1) // 2
    x = np.sort(rng.uniform(size=n))
    y = np.sin(6 * x)[:, None] * np.arange(1, m + 1)[None, :] + 0.3 * rng.normal(size=(n, m))
    vec = np.concatenate([3 * (x - 1) ** 3 - 2 + 0.1 * rng.normal(size=n),
                          0.3 * rng.normal(size=n * t), [np.log(5e-2)]])
    return x, y, vec


def _value_and_grad(f, vec):
    v = _t(vec, True)
    val = f(v)
    (g,) = torch.autograd.grad(val, v)
    return val.item(), g.numpy()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("n", [8, 48, 200])
def test_gnmgp_objective_matches_jax(rng, n, m, masked):
    x, y, vec = _gnmgp_case(rng, n, m)
    mask = (np.arange(n) < n - max(1, n // 8)) if masked else None
    jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
    jf = jgnmgp.make_objective(jdata, mask=None if mask is None else jnp.asarray(mask))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    # JAX's side as one jitted program: one compile a case
    (want_v, want_g), want_nlp, want_dev = jax.jit(lambda v: (
        jax.value_and_grad(jf)(v), jgnmgp.nlogpos(v, jy, jx), jgnmgp.deviance(v, jy, jx)))(jnp.asarray(vec))
    f = gnmgp.make_objective(FullData(_t(x), _t(y)), mask=None if mask is None else torch.tensor(mask))
    got_v, got_g = _value_and_grad(f, vec)
    np.testing.assert_allclose(got_v, float(want_v), rtol=1e-6)
    _close(got_g, want_g, 1e-6)
    if not masked:
        np.testing.assert_allclose(gnmgp.nlogpos(_t(vec), _t(y), _t(x)).item(), float(want_nlp), rtol=1e-6)
        np.testing.assert_allclose(gnmgp.deviance(_t(vec), _t(y), _t(x)).item(), float(want_dev), rtol=1e-6)


def test_gnmgp_verbose_components_match_jax(rng):
    x, y, vec = _gnmgp_case(rng, 12, 2)
    # jitted: op by op it took ~3.5 s
    want = jax.jit(lambda v, yy, xx: jgnmgp.nlogpos(v, yy, xx, verbose=True))(
        jnp.asarray(vec), jnp.asarray(y), jnp.asarray(x))
    got = gnmgp.nlogpos(_t(vec), _t(y), _t(x), verbose=True)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-8)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("n", [8, 48])
def test_snmgp_objective_matches_jax(rng, n, m):
    t = m * (m + 1) // 2
    x = np.sort(rng.uniform(size=n))
    y = np.cos(5 * x)[:, None] * np.arange(1, m + 1)[None, :] + 0.3 * rng.normal(size=(n, m))
    vec = np.concatenate([3 * (x - 1) ** 3 - 2, 0.2 * rng.normal(size=n),
                          0.5 * rng.normal(size=t), [np.log(5e-2)]])
    jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
    mask = np.arange(n) < n - 2
    jx, jy, jmask = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    # JAX's side as one jitted program: one compile a case (op by op, the
    # masked log-likelihood alone took seconds)
    (want_v, want_g), want_nlp, want_dev, want_ll = jax.jit(lambda v: (
        jax.value_and_grad(jsnmgp.make_objective(jdata))(v), jsnmgp.nlogpos(v, jy, jx), jsnmgp.deviance(v, jy, jx),
        jsnmgp.log_lik(jsnmgp.unpack(v, n, m), jdata, mask=jmask)))(jnp.asarray(vec))
    got_v, got_g = _value_and_grad(snmgp.make_objective(FullData(_t(x), _t(y))), vec)
    np.testing.assert_allclose(got_v, float(want_v), rtol=1e-6)
    _close(got_g, want_g, 1e-6)
    np.testing.assert_allclose(snmgp.nlogpos(_t(vec), _t(y), _t(x)).item(), float(want_nlp), rtol=1e-6)
    np.testing.assert_allclose(snmgp.deviance(_t(vec), _t(y), _t(x)).item(), float(want_dev), rtol=1e-6)
    np.testing.assert_allclose(
        snmgp.log_lik(snmgp.unpack(_t(vec), n, m), FullData(_t(x), _t(y)), mask=torch.tensor(mask)).item(),
        float(want_ll), rtol=1e-6)


def test_models_pack_unpack_roundtrip(rng):
    v = _t(rng.normal(size=gnmgp.n_params(5, 2)))
    assert torch.equal(gnmgp.pack(gnmgp.unpack(v, 5, 2)), v)
    v = _t(rng.normal(size=snmgp.n_params(5, 3)))
    assert torch.equal(snmgp.pack(snmgp.unpack(v, 5, 3)), v)
    with pytest.raises(ValueError, match="snmgp parameter vector"):
        snmgp.unpack(v[:-1], 5, 3)


def test_settings_jitter_is_the_kernels():
    assert settings.jitter == JITTER
