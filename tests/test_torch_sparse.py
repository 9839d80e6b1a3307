"""The port's sparse GNMGP objective (``models/gnmgp_sparse.py``) against the
JAX package on the CPU, in float64.

Inputs are numpy arrays made from a seed.  Where a test feeds both packages
one objective, the JAX ``SparseOps`` (inducing inputs, kriging projections,
prior factors) go to the port through ``convert.sparse_ops_from_jax``, so
both evaluate the same float64 islands; ``make_ops`` itself is held against
JAX's separately.  The JAX references run through fresh ``jax.jit``
closures (the mixed routing is read at trace time).

Tolerances.  Values and gradients at rtol 1e-6 (the acceptance bar; they
agree to ~1e-13 here).  The port's kriging projections solve the prior Gram
at Z by a robust Cholesky on the tensors' device where JAX takes
``np.linalg.solve`` on the host: the two agree to ~1e-8 of the projection's
scale (condition ~1e7 at m_z = 8).  Under ``NMGP_PRECISION=mixed`` values
at rtol 1e-8 against float64 and gradients within 5e-3 of their largest
entry (float32-class by design).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_sparse as jsp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, settings
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import empirical, init
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse as sp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, M_Z = 40, 2, 8
RTOL = 1e-6
MIXED_VALUE_RTOL, MIXED_GRAD_TOL = 1e-8, 5e-3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def subject(seed=0, n=N, m=M, m_z=M_Z):
    """A smooth two-task subject and a packed sparse vector near a fit."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=n))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)][:m], axis=1) + 0.1 * rng.normal(size=(n, m))
    t = m * (m + 1) // 2
    vec = np.concatenate([np.log(0.2) + 0.1 * rng.normal(size=m_z), 0.2 * rng.normal(size=m_z * t), [np.log(0.02)]])
    return x, y, vec


@pytest.fixture(scope="module")
def case():
    x, y, vec = subject()
    jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
    _, jops = jsp.make_objective(jdata, n_inducing=M_Z)
    return x, y, vec, jdata, jops, convert.sparse_ops_from_jax(jops, device="cpu")


MASK = np.arange(N) < N - 6


def _jax_value_and_grad(jdata, jops, approx, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def f(v):
        p = jsp.unpack(v, M_Z, M)
        lp, comps = jsp.log_posterior(p, jdata, jops, approx=approx, mask=jm)
        return -lp, comps

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _port_value_and_grad(vec, data, ops, approx, mask):
    v = _t(vec).requires_grad_(True)
    lp, comps = sp.log_posterior(sp.unpack(v, M_Z, M), data, ops, approx=approx,
                                 mask=None if mask is None else torch.tensor(mask))
    (g,) = torch.autograd.grad(-lp, v)
    return (-lp).item(), {k: c.item() for k, c in comps.items()}, g.numpy()


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
@pytest.mark.parametrize("masked", [False, True])
def test_log_posterior_and_gradient_match_jax(case, approx, masked):
    x, y, vec, jdata, jops, ops = case
    mask = MASK if masked else None
    (want, wcomps), wgrad = _jax_value_and_grad(jdata, jops, approx, mask)(jnp.asarray(vec))
    got, comps, grad = _port_value_and_grad(vec, FullData(_t(x), _t(y)), ops, approx, mask)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    for k, w in wcomps.items():
        np.testing.assert_allclose(comps[k], float(w), rtol=RTOL, err_msg=k)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(grad, wgrad, rtol=RTOL, atol=RTOL * np.abs(wgrad).max())


def test_mask_excludes_the_padded_rows_exactly(case):
    """A masked likelihood equals the likelihood of the real rows alone at
    the same Z (the padded rows of K_nm are zeroed, their Λ is 1)."""
    x, y, vec, _, _, ops = case
    p = sp.unpack(_t(vec), M_Z, M)
    k = int(MASK.sum())
    masked = sp.log_lik(p, FullData(_t(x), _t(y)), ops, mask=torch.tensor(MASK))
    real_ops = ops._replace(proj_l=ops.proj_l[:, :k], proj_ul=ops.proj_ul[:, :k])
    np.testing.assert_allclose(masked.item(), sp.log_lik(p, FullData(_t(x[:k]), _t(y[:k])), real_ops).item(),
                               rtol=1e-10)


def test_objective_on_the_cpu_launches_no_kernel(case):
    x, y, vec, _, _, _ = case
    gram_kernels.reset_launches()
    nlp, _ = sp.make_objective(FullData(_t(x), _t(y)), n_inducing=M_Z)
    v = _t(vec).requires_grad_(True)
    nlp(v).backward()
    assert set(gram_kernels.launches().values()) == {0}
    assert torch.isfinite(v.grad).all()


@pytest.fixture
def mixed_mode(monkeypatch):
    """``NMGP_PRECISION=mixed`` in both packages, with the jitter ladder on
    (a collected module may have set NMGP_ROBUST_CHOL=0 before the settings
    were imported)."""
    for mod in (jsettings, settings):
        monkeypatch.setattr(mod, "robust_cholesky", True)
        monkeypatch.setattr(mod, "mixed_solves", True)


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_mixed_tier_matches_f64_and_jax(case, approx, mixed_mode, monkeypatch):
    x, y, vec, jdata, jops, ops = case
    data = FullData(_t(x), _t(y))
    calls = []
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed

    real = mixed.mixed_logdet_quad
    monkeypatch.setattr(mixed, "mixed_logdet_quad", lambda *a: calls.append(1) or real(*a))
    got, _, grad = _port_value_and_grad(vec, data, ops, approx, None)
    assert calls, "the mixed route was not taken"
    (want_mixed, _), _ = _jax_value_and_grad(jdata, jops, approx, None)(jnp.asarray(vec))
    monkeypatch.setattr(settings, "mixed_solves", False)
    f64, _, grad64 = _port_value_and_grad(vec, data, ops, approx, None)
    np.testing.assert_allclose(got, f64, rtol=MIXED_VALUE_RTOL)
    np.testing.assert_allclose(got, float(want_mixed), rtol=MIXED_VALUE_RTOL)
    assert np.abs(grad - grad64).max() <= MIXED_GRAD_TOL * np.abs(grad64).max()


def test_make_ops_matches_jax(case):
    x, _, _, _, jops, _ = case
    ops = sp.make_ops(_t(x), _t(jops.z))
    np.testing.assert_array_equal(ops.z.numpy(), np.asarray(jops.z))
    for name in ("proj_l", "proj_ul"):
        w = np.asarray(getattr(jops, name))
        np.testing.assert_allclose(getattr(ops, name).numpy(), w, rtol=0, atol=1e-7 * np.abs(w).max(), err_msg=name)
    for name in ("pc_l_z", "pc_ul_z"):
        got, want = getattr(ops, name), getattr(jops, name)
        np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got.logdet.item(), float(want.logdet), rtol=1e-12)


@pytest.mark.parametrize("n,m_z", [(40, 8), (40, 40), (37, 10), (5, 2), (200, 64)])
def test_choose_inducing_matches_jax(n, m_z):
    x = np.random.default_rng(n).uniform(size=n)
    if n == 200:
        x = np.round(x, 1)  # ties: fewer distinct inducing inputs than asked
    got = sp.choose_inducing(_t(x), m_z)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsp.choose_inducing(jnp.asarray(x), m_z)))
    assert got.dtype == T64


@pytest.mark.parametrize("m_z", [1, 41])
def test_choose_inducing_refuses_a_bad_count(m_z):
    with pytest.raises(ValueError, match="need 2 <= m_z <= N"):
        sp.choose_inducing(np.linspace(0, 1, 40), m_z)


def test_latents_at_data_and_cross_gram_match_jax(case):
    x, _, vec, _, jops, ops = case
    jp = jsp.unpack(jnp.asarray(vec), M_Z, M)
    p = convert.sparse_params_from_jax(np.array(jsp.pack(jp)), M_Z, M, device="cpu")
    for got, want in zip(sp.latents_at_data(p, ops, M), jsp.latents_at_data(jp, jops, M)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    lx = sp.chol_factors(sp.latents_at_data(p, ops, M)[1], M)
    lz = sp.chol_factors(p.ul_vecs_z.reshape(M_Z, -1), M)
    k_xz = np.random.default_rng(1).uniform(size=(N, M_Z))
    want = jsp.cross_gram(jnp.asarray(k_xz), jnp.asarray(lx.numpy()), jnp.asarray(lz.numpy()))
    np.testing.assert_allclose(sp.cross_gram(_t(k_xz), lx, lz).numpy(), np.asarray(want), rtol=1e-12)


def test_inducing_gram_is_jaxs_task_major_gram(case):
    """K3's input-major Gram, permuted, is JAX's ``gram(nonstationary_rbf_cov(z,
    ell1=ell_z), lz)``."""
    from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
    from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels

    _, _, vec, _, jops, ops = case
    p = sp.unpack(_t(vec), M_Z, M)
    lz = sp.chol_factors(p.ul_vecs_z.reshape(M_Z, -1), M)
    ell = torch.exp(p.tilde_l_z)
    want = jgnmgp.gram(jkernels.nonstationary_rbf_cov(jops.z, ell1=jnp.asarray(ell.numpy())), jnp.asarray(lz.numpy()))
    np.testing.assert_allclose(sp.inducing_gram(ops.z, ell, lz).numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)


def test_init_from_empirical_matches_jax(case):
    x, y, _, _, jops, ops = case
    emp = empirical.local_estimation(x, y, window_size=10)
    dense = init.gnmgp_from_empirical(emp, N, M, device="cpu")
    jdense = jinit.gnmgp_from_empirical(jempirical.local_estimation(x, y, window_size=10), N, M)
    got = sp.init_from_empirical(dense, N, M_Z, M, _t(x), ops.z)
    want = jsp.init_from_empirical(jdense, N, M_Z, M, jnp.asarray(x), jops.z)
    assert got.shape == (sp.n_params(M_Z, M),)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_pack_inverts_unpack_and_bad_inputs_raise(case):
    x, y, vec, _, _, _ = case
    v = _t(vec)
    assert torch.equal(sp.pack(sp.unpack(v, M_Z, M)), v)
    with pytest.raises(ValueError, match="gnmgp_sparse parameter vector"):
        sp.unpack(v[:-1], M_Z, M)
    with pytest.raises(ValueError, match="approx must be 'fitc' or 'vfe'"):
        sp.make_objective(FullData(_t(x), _t(y)), n_inducing=M_Z, approx="dtc")


@pytest.mark.parametrize("mode", ["f64", "mixed"])
def test_inner_logdet_quad_matches_jax(mode, monkeypatch):
    """The Woodbury inner system's logdet and quadratic form by precision:
    the robust small factor, or ``mixed_logdet_quad`` under mixed."""
    for mod in (jsettings, settings):
        monkeypatch.setattr(mod, "robust_cholesky", True)
        monkeypatch.setattr(mod, "mixed_solves", mode == "mixed")
    rng = np.random.default_rng(9)
    a = rng.normal(size=(16, 80))
    inner, u = np.eye(16) + a @ a.T, a @ rng.normal(size=80)
    want = jax.jit(lambda i, v: jsp._inner_logdet_quad(i, v))(jnp.asarray(inner), jnp.asarray(u))
    got = sp._inner_logdet_quad(_t(inner), _t(u))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-10)
