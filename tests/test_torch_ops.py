"""The port's ops against the JAX package on the CPU, in float64 unless noted.

Inputs are numpy arrays made from a seed and handed to both packages.  On the
CPU the port's kernel wrappers take their plain versions, which repeat the
CUDA kernels' arithmetic; the kernels themselves are held against those plain
versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels
from nonstationary_multivariate_gaussian_process_tpu.ops import pallas_kernels as pk
from nonstationary_multivariate_gaussian_process_tpu.ops import transforms as jtr
from nonstationary_multivariate_gaussian_process_tpu_torch import settings
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import chol, gram_kernels, kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms as tr

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64


def _t(a, dtype=T64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _inputs(rng, n, m):
    x = np.sort(rng.uniform(size=n))
    ell = rng.uniform(0.1, 1.0, n)
    ls = np.tril(rng.normal(size=(n, m, m))) + np.eye(m)
    return x, ell, ls


def test_settings_dtype_and_precision_env():
    assert settings.dtype == T64  # the tests run with NMGP_X64=1
    assert settings.jitter == jsettings.jitter == 1e-6
    assert settings.precision == jsettings.precision
    assert settings.dtype_from_env({"NMGP_X64": "0"}) == torch.float32
    assert settings.dtype_from_env({"NMGP_PRECISION": "F32"}) == torch.float32
    # mixed: float64 arrays, the large PSD solves through ops/mixed.py
    assert settings.dtype_from_env({"NMGP_PRECISION": "mixed"}) == T64
    assert settings.precision_from_env({"NMGP_PRECISION": "MIXED", "NMGP_X64": "0"}) == "mixed"
    assert settings.precision_from_env({"NMGP_X64": "false"}) == "f32"
    assert settings.mixed_solves is (settings.precision_mode == "mixed") is jsettings.mixed_solves
    with pytest.raises(ValueError, match="f64|f32|mixed"):
        settings.dtype_from_env({"NMGP_PRECISION": "bf16"})
    assert settings.default_device() == torch.device("cuda")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_transforms_match_jax(rng, m):
    t = tr.tri_size(m)
    assert t == jtr.tri_size(m)
    np.testing.assert_array_equal(tr.diag_indices_vec(m), jtr.diag_indices_vec(m))
    ul = rng.normal(size=(5, t))
    lv = tr.ulvec_to_lvec(_t(ul), m)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jtr.ulvec_to_lvec(jnp.asarray(ul), m)), rtol=1e-12)
    np.testing.assert_allclose(
        tr.lvec_to_ulvec(lv, m).numpy(),
        np.asarray(jtr.lvec_to_ulvec(jtr.ulvec_to_lvec(jnp.asarray(ul), m), m)),
        rtol=1e-12,
    )
    tril = tr.vec_to_tril(_t(ul), m)
    np.testing.assert_array_equal(tril.numpy(), np.asarray(jtr.vec_to_tril(jnp.asarray(ul), m)))
    np.testing.assert_array_equal(tr.tril_to_vec(tril, m).numpy(), ul)


@pytest.mark.parametrize("n1,n2", [(33, None), (40, 17)])
def test_nonstationary_rbf_cov_matches_jax(rng, n1, n2):
    x1, s1, l1 = rng.uniform(size=n1), rng.uniform(0.5, 2.0, n1), rng.uniform(0.1, 1.0, n1)
    if n2 is None:
        got = kernels.nonstationary_rbf_cov(_t(x1), _t(s1), _t(l1))
        want = jax.jit(jkernels.nonstationary_rbf_cov)(jnp.asarray(x1), jnp.asarray(s1), jnp.asarray(l1))
    else:
        x2, s2, l2 = rng.uniform(size=n2), rng.uniform(0.5, 2.0, n2), rng.uniform(0.1, 1.0, n2)
        got = kernels.nonstationary_rbf_cov(_t(x1), _t(s1), _t(l1), _t(x2), _t(s2), _t(l2))
        want = jax.jit(jkernels.nonstationary_rbf_cov)(
            jnp.asarray(x1), jnp.asarray(s1), jnp.asarray(l1),
            x2=jnp.asarray(x2), sigma2=jnp.asarray(s2), ell2=jnp.asarray(l2),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_rbf_cov_matches_jax(rng):
    x, g = rng.uniform(size=20), rng.uniform(size=7)
    np.testing.assert_allclose(
        kernels.rbf_cov(_t(x), alpha=5.0, beta=0.7).numpy(),
        np.asarray(jax.jit(lambda a: jkernels.rbf_cov(a, alpha=5.0, beta=0.7))(jnp.asarray(x))), rtol=1e-12,
    )
    np.testing.assert_allclose(
        kernels.rbf_cov(_t(x), _t(g), alpha=5.0, beta=0.7).numpy(),
        np.asarray(jax.jit(lambda a, b: jkernels.rbf_cov(a, b, alpha=5.0, beta=0.7))(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-12,
    )


@pytest.mark.parametrize("n", [64, 45])
def test_gibbs_gram_plain_matches_pallas_interpret(rng, n):
    """f32 against the TPU kernel in interpret mode, at test_pallas.py's tolerance."""
    x, s, ell = np.sort(rng.uniform(size=n)), rng.uniform(0.5, 2.0, n), rng.uniform(0.1, 1.0, n)
    f32 = torch.float32
    got = gram_kernels.gibbs_gram(_t(x, f32), _t(s, f32), _t(ell, f32), jitter=settings.jitter)
    assert got.dtype == f32
    want = pk.gibbs_gram_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(ell), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


def test_gibbs_gram_cross_form_rejects_jitter(rng):
    x = _t(rng.uniform(size=4))
    with pytest.raises(ValueError, match="self form"):
        gram_kernels.gibbs_gram(x, x, x, x, x, x, jitter=1e-6)


def test_svc_gram_plain_input_layout_matches_pallas_interpret(rng):
    n, m = 40, 2
    x, ell, ls = _inputs(rng, n, m)
    f32 = torch.float32
    got = gram_kernels.svc_gram_plain(_t(x, f32), _t(ell, f32), _t(ls, f32), settings.jitter, layout="input")
    want = pk.svc_gram_fused2d(
        jnp.asarray(x, jnp.float32), jnp.asarray(ell, jnp.float32), jnp.asarray(ls, jnp.float32),
        tile=32, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@jax.jit
def _jax_task_gram(x, ell, ls):
    """JAX's task-major Gram (jitted: op by op a shape took ~1.5 s)."""
    return jgnmgp.gram(jkernels.nonstationary_rbf_cov(x, ell1=ell), ls)


@pytest.mark.parametrize("layout", ["task", "input"])
@pytest.mark.parametrize("n,m", [(24, 2), (17, 3)])
def test_svc_gram_matches_jax_gram(rng, layout, n, m):
    """Both layouts against the JAX Gram in f64; "input" is its permutation."""
    x, ell, ls = _inputs(rng, n, m)
    got = gram_kernels.svc_gram(_t(x), _t(ell), _t(ls), settings.jitter, layout=layout).numpy()
    want = np.asarray(_jax_task_gram(jnp.asarray(x), jnp.asarray(ell), jnp.asarray(ls)))  # task-major
    if layout == "input":
        want = want.reshape(m, n, m, n).transpose(1, 0, 3, 2).reshape(n * m, n * m)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_model_gram_is_task_major_and_jitter_rides_every_task_pair(rng):
    n, m = 12, 2
    x, ell, ls = _inputs(rng, n, m)
    k = gnmgp.gram(_t(x), _t(ell), _t(ls)).numpy().reshape(m, n, m, n)
    k0 = gram_kernels.svc_gram(_t(x), _t(ell), _t(ls), 0.0).numpy().reshape(m, n, m, n)
    b = np.einsum("nab,ncb->nac", ls, ls)  # (L_n L_nᵀ)[a, c]
    for a in range(m):
        for c in range(m):
            np.testing.assert_allclose(
                np.diagonal(k[a, :, c, :] - k0[a, :, c, :]), settings.jitter * b[:, a, c],
                rtol=1e-8, atol=1e-15,
            )


def test_params_pack_unpack_roundtrip_matches_jax(rng):
    n, m = 6, 3
    vec = rng.normal(size=gnmgp.n_params(n, m))
    p = gnmgp.unpack(_t(vec), n, m)
    jp = jgnmgp.unpack(jnp.asarray(vec), n, m)
    for got, want in zip(p, jp):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gnmgp.pack(p).numpy(), vec)
    np.testing.assert_allclose(
        gnmgp.chol_process(p.ul_vecs, n, m).numpy(),
        np.asarray(jgnmgp.chol_process(jp.ul_vecs, n, m)), rtol=1e-12,
    )
    with pytest.raises(ValueError, match="length"):
        gnmgp.unpack(_t(vec[:-1]), n, m)


class TestCholLadder:
    """The global switch ``settings.robust_cholesky`` is set explicitly in
    every test here: it is read from NMGP_ROBUST_CHOL at import, and
    importing ``bench.py`` (as tests/test_bench_*.py do while the suite is
    collected) sets that variable to 0 for the whole process."""

    @pytest.mark.parametrize("how", ["switch_on", "force_robust"])
    def test_semidefinite_escalates_in_closed_form(self, rng, monkeypatch, how):
        """A rank-deficient PSD matrix fails the plain factor; the retry's
        factor reproduces a + fallback·mean(diag)·I (closed-form check)."""
        v = rng.normal(size=(30, 3))
        a = _t(v @ v.T)
        assert torch.linalg.cholesky_ex(a)[1] != 0
        monkeypatch.setattr(settings, "robust_cholesky", how == "switch_on")
        c = chol.safe_cholesky(a, force_robust=how == "force_robust")
        jit = chol.FALLBACK_REL_F64 * torch.mean(torch.diagonal(a))
        assert torch.isfinite(c).all()
        np.testing.assert_allclose(
            (c @ c.T).numpy(), (a + jit * torch.eye(30, dtype=T64)).numpy(), rtol=1e-10, atol=1e-12
        )

    def test_positive_definite_takes_plain_factor(self, rng):
        v = rng.normal(size=(20, 20))
        a = _t(v @ v.T + 20 * np.eye(20))
        np.testing.assert_array_equal(chol.safe_cholesky(a).numpy(), torch.linalg.cholesky(a).numpy())

    def test_failure_after_retry_surfaces_as_nan(self, monkeypatch):
        monkeypatch.setattr(settings, "robust_cholesky", True)
        a = -torch.eye(4, dtype=T64)
        assert torch.isnan(chol.safe_cholesky(a)).all()

    def test_switch_off_takes_no_retry(self, rng, monkeypatch):
        monkeypatch.setattr(settings, "robust_cholesky", False)
        v = rng.normal(size=(10, 2))
        assert torch.isnan(chol.safe_cholesky(_t(v @ v.T))).all()

    def test_solves_and_logdet(self, rng):
        v = rng.normal(size=(15, 15))
        a = _t(v @ v.T + 15 * np.eye(15))
        b = _t(rng.normal(size=(15, 4)))
        c = chol.safe_cholesky(a)
        np.testing.assert_allclose((a @ chol.chol_solve(c, b)).numpy(), b.numpy(), atol=1e-10)
        np.testing.assert_allclose((a @ chol.chol_solve(c, b[:, 0])).numpy(), b[:, 0].numpy(), atol=1e-10)
        np.testing.assert_allclose((c @ chol.tri_solve(c, b)).numpy(), b.numpy(), atol=1e-10)
        np.testing.assert_allclose((c.T @ chol.tri_solve(c, b, trans=True)).numpy(), b.numpy(), atol=1e-10)
        np.testing.assert_allclose(chol.chol_logdet(c).item(), np.linalg.slogdet(a.numpy())[1], rtol=1e-12)


def test_wrappers_refuse_unsupported_devices(rng):
    x = torch.zeros(4, dtype=T64, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        gram_kernels.gibbs_gram(x, x, x)
    with pytest.raises(ValueError, match="layout"):
        gram_kernels.svc_gram(_t(np.zeros(2)), _t(np.ones(2)), _t(np.ones((2, 1, 1))), 0.0, layout="bad")


def _k3_terms(x, ell, ls, w):
    return lambda e: torch.sum(gram_kernels.svc_gram_tiled(x, e, ls, 1e-6) * w)


def _k3_plain_terms(x, ell, ls, w):
    return lambda e: torch.sum(gram_kernels.svc_gram_tiled_plain(x, e, ls, 1e-6) * w)


def _k1_terms(x, ell, ls, w):
    s = torch.ones_like(ell)
    return lambda e: torch.sum(gram_kernels.gibbs_gram(x, s, e, jitter=1e-6) * w[: len(x), : len(x)])


def _mixed_terms(x, ell, ls, w):
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed

    def f(e):
        a = gram_kernels.svc_gram_tiled_plain(x, e, ls, 1e-2)
        return mixed.mixed_logdet_quad(a, torch.ones(a.shape[0], dtype=T64))[0]

    return f


@pytest.mark.parametrize("terms", [_k3_terms, _k1_terms, _mixed_terms], ids=["svc_gram_tiled", "gibbs_gram",
                                                                            "mixed_logdet_quad"])
def test_second_derivative_through_a_kernel_backward_raises(rng, terms):
    """``f = Σ(Gram ∘ W) + Σℓ³``: the kernels' backward (and the mixed
    solve's) is not part of a graph, so a Hessian with ``create_graph=True``
    must raise rather than return only the ℓ³ term; through the plain
    version the Gram's terms are there."""
    n, m = 6, 2
    x = _t(np.sort(rng.uniform(size=n)))
    ell = _t(0.3 + rng.uniform(size=n))
    ls = _t(np.tril(rng.normal(size=(n, m, m))) + 2.0 * np.eye(m))
    w = _t(rng.normal(size=(n * m, n * m)))
    f = lambda g: lambda e: g(e) + torch.sum(e ** 3)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.functional.hessian(f(terms(x, ell, ls, w)), ell, create_graph=True)
    h_plain = torch.autograd.functional.hessian(f(_k3_plain_terms(x, ell, ls, w)), ell, create_graph=True)
    h_cubic = torch.diag(6.0 * ell)
    assert torch.isfinite(h_plain).all() and not torch.allclose(h_plain, h_cubic)
