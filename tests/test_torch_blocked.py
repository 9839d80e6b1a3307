"""The port's blocked and loop-free factors (``ops/blocked.py``) and the
routes of ``ops/chol.py`` that use them, against the JAX package's
``ops/blocked.py`` on the CPU, in float64.

Inputs are numpy arrays made from a seed and handed to both packages.  Each
function and backward is held at the tolerances of ``tests/test_blocked.py``
(the same float64 arithmetic in another order): factors and solves at atol
1e-12, ``A x = b`` at 1e-10, values at rtol 1e-13, gradients at atol 1e-12
(1e-11 through the unrolled factor).  The GNMGP objective and
``predict_map`` at MN = 512 run with ``NMGP_BLOCKED_CHOL`` on in both
packages (``chol._BLOCKED_ENABLED``, switched with ``monkeypatch``; the JAX
side traced afresh): the objective's value at rtol 1e-10 and its gradient
at rtol 1e-8 with a floor of 1e-8 of its scale, the prediction at the
tolerances of ``tests/test_torch_predict.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.ops import blocked as jblocked
from nonstationary_multivariate_gaussian_process_tpu.ops import chol as jchol
from nonstationary_multivariate_gaussian_process_tpu.predict import gnmgp as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch import settings, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import blocked, chol
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred

from test_torch_predict import KRIGE_ATOL, make_subject

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _spd(rng, n):
    a = rng.normal(size=(n, n))
    return a @ a.T / n + 2.0 * np.eye(n)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("n", [100, 256, 300])
def test_blocked_cholesky_matches_jax_and_the_factor(rng, n):
    spd = _spd(rng, n)
    l = blocked.blocked_cholesky(_t(spd), 128)
    _close(l, jblocked.blocked_cholesky(jnp.asarray(spd), 128), 1e-12)
    _close(l, np.linalg.cholesky(spd), 1e-12)


def test_blocked_cholesky_failed_tile_is_nan(monkeypatch):
    """A tile that does not factor gives NaNs where JAX's factor has them,
    and ``safe_cholesky``'s ladder over the blocked route retries with
    jitter."""
    a = np.ones((300, 300))  # rank 1: the second diagonal tile fails
    l = blocked.blocked_cholesky(_t(a), 128)
    jl = np.asarray(jblocked.blocked_cholesky(jnp.asarray(a), 128))
    np.testing.assert_array_equal(torch.isnan(l).numpy(), np.isnan(jl))
    assert torch.isnan(torch.diagonal(l)).all()
    monkeypatch.setattr(chol, "_BLOCKED_ENABLED", True)
    monkeypatch.setattr(settings, "robust_cholesky", True)  # a collected module may have turned it off
    n = chol.BLOCKED_MIN_N
    l = chol.safe_cholesky(_t(np.ones((n, n))))
    _close(l, np.linalg.cholesky(np.ones((n, n)) + chol.FALLBACK_REL_F64 * np.eye(n)), 1e-9)


@pytest.mark.parametrize("trans", [False, True])
def test_blocked_trsm_matches_jax(rng, trans):
    n = 300
    l = np.linalg.cholesky(_spd(rng, n))
    b = rng.normal(size=(n, 5))
    got = blocked.blocked_trsm(_t(l), _t(b), trans, 128)
    _close(got, jblocked.blocked_trsm(jnp.asarray(l), jnp.asarray(b), trans, 128), 1e-12)
    want = np.linalg.solve(l.T if trans else l, b)
    _close(got, want, 1e-12)
    # a vector right-hand side round-trips the squeeze
    _close(blocked.blocked_trsm(_t(l), _t(b[:, 0]), trans, 128), want[:, 0], 1e-12)


def test_blocked_chol_solve_matches_jax(rng):
    n = 260
    spd = _spd(rng, n)
    b = rng.normal(size=n)
    l = blocked.blocked_cholesky(_t(spd), 128)
    x = blocked.blocked_chol_solve(l, _t(b), 128)
    _close(_t(spd) @ x, b, 1e-10)
    jl = jblocked.blocked_cholesky(jnp.asarray(spd), 128)
    _close(x, jblocked.blocked_chol_solve(jl, jnp.asarray(b), 128), 1e-10)


def test_blocked_cholesky_backward_matches_jax(rng):
    """The Murray pullback with blocked solves, through logdet + quad."""
    n = 200
    spd, y = _spd(rng, n), rng.normal(size=n)

    def f(a):
        l = blocked.blocked_cholesky(a, 64)
        z = blocked.blocked_trsm(l, _t(y), False, 64)
        return 2.0 * torch.sum(torch.log(torch.diagonal(l))) + torch.sum(z * z)

    def f_jax(a):
        l = jblocked.blocked_cholesky(a, 64)
        z = jblocked.blocked_trsm(l, jnp.asarray(y), False, 64)
        return 2.0 * jnp.sum(jnp.log(jnp.diag(l))) + jnp.sum(z * z)

    a = _t(spd).requires_grad_(True)
    val = f(a)
    (g,) = torch.autograd.grad(val, a)
    jval, jg = jax.jit(jax.value_and_grad(f_jax))(jnp.asarray(spd))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-13)
    _close(g, jg, 1e-12)


@pytest.mark.parametrize("trans", [False, True])
def test_blocked_trsm_backward_both_arguments_match_jax(rng, trans):
    n = 150
    l0 = np.linalg.cholesky(_spd(rng, n))
    b = rng.normal(size=(n, 3))
    lm, bm = _t(l0).requires_grad_(True), _t(b).requires_grad_(True)
    gl, gb = torch.autograd.grad(torch.sum(torch.sin(blocked.blocked_trsm(torch.tril(lm), bm, trans, 64))),
                                 (lm, bm))
    f_jax = lambda l_, b_: jnp.sum(jnp.sin(jblocked.blocked_trsm(jnp.tril(l_), b_, trans, 64)))
    jgl, jgb = jax.jit(jax.grad(f_jax, (0, 1)))(jnp.asarray(l0), jnp.asarray(b))
    _close(gl, jgl, 1e-12)
    _close(gb, jgb, 1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 128, 130])
def test_unrolled_cholesky_and_inverse_match_jax(rng, n):
    spd = _spd(rng, n)
    l = blocked.unrolled_cholesky(_t(spd))
    _close(l, np.linalg.cholesky(spd), 1e-12)
    w = blocked.unrolled_tri_inv(l)
    _close(w @ l, np.eye(n), 1e-10)
    if n <= 16:  # JAX's recursion compiles O(n log n) nodes: the small sizes
        jl = jax.jit(jblocked.unrolled_cholesky)(jnp.asarray(spd))
        _close(l, jl, 1e-12)
        _close(w, jax.jit(jblocked.unrolled_tri_inv)(jl), 1e-12)


def test_unrolled_backwards_match_jax(rng):
    """Both explicit-inverse backwards through a logdet + quad composite."""
    n = 48
    spd, y = _spd(rng, n), rng.normal(size=n)

    def f(a):
        l = blocked.unrolled_cholesky(a)
        z = blocked.unrolled_tri_inv(l) @ _t(y)
        return 2.0 * torch.sum(torch.log(torch.diagonal(l))) + torch.sum(z * z)

    def f_jax(a):
        l = jblocked.unrolled_cholesky(a)
        z = jblocked.unrolled_tri_inv(l) @ jnp.asarray(y)
        return 2.0 * jnp.sum(jnp.log(jnp.diag(l))) + jnp.sum(z * z)

    a = _t(spd).requires_grad_(True)
    val = f(a)
    (g,) = torch.autograd.grad(val, a)
    jval, jg = jax.jit(jax.value_and_grad(f_jax))(jnp.asarray(spd))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-13)
    _close(g, jg, 1e-11)
    # against autograd through LAPACK's factor and solve
    a_ref = _t(spd).requires_grad_(True)
    l_ref = torch.linalg.cholesky(a_ref)
    z_ref = torch.linalg.solve_triangular(l_ref, _t(y)[:, None], upper=False)
    (g_ref,) = torch.autograd.grad(2.0 * torch.sum(torch.log(torch.diagonal(l_ref))) + torch.sum(z_ref**2), a_ref)
    _close(g, g_ref, 1e-11)


def test_small_factor_routes(monkeypatch):
    """``safe_cholesky_unrolled`` recovers a rank-deficient Gram through the
    jitter rung, as JAX's does; ``robust_cholesky_small`` and
    ``tri_solve_small`` take the loop-free kernels where ``use_unrolled``
    says so (``NMGP_UNROLLED_CHOL=1``), and ``auto`` keeps LAPACK here."""
    v = np.linspace(0.0, 1.0, 12)[:, None]
    low_rank = v @ v.T
    l = chol.safe_cholesky_unrolled(_t(low_rank))
    _close(l, jax.jit(jchol.safe_cholesky_unrolled)(jnp.asarray(low_rank)), 1e-12)
    assert torch.isfinite(l).all()
    spd = _spd(np.random.default_rng(3), 12)
    b = np.random.default_rng(4).normal(size=(12, 3))
    monkeypatch.setattr(chol, "_UNROLLED", "auto")
    assert not chol.use_unrolled(_t(spd))  # LAPACK on the CPU
    monkeypatch.setattr(chol, "_UNROLLED", "1")
    assert chol.use_unrolled(_t(spd)) and not chol.use_unrolled(_t(spd).float())
    assert not chol.use_unrolled(_t(_spd(np.random.default_rng(5), chol.UNROLLED_MAX_N + 1)))
    calls = []
    monkeypatch.setattr(blocked, "unrolled_cholesky", lambda a: calls.append("chol") or blocked._chol_rec(a))
    monkeypatch.setattr(blocked, "unrolled_tri_inv", lambda a: calls.append("inv") or blocked._tri_inv_rec(a))
    l = chol.robust_cholesky_small(_t(spd))
    _close(l, np.linalg.cholesky(spd), 1e-12)
    _close(chol.tri_solve_small(l, _t(b)), np.linalg.solve(np.linalg.cholesky(spd), b), 1e-12)
    assert calls == ["chol", "inv"]


# ---------------------------------------------------------------------------
# The GNMGP objective and predict_map with the blocked route on (MN = 512)
# ---------------------------------------------------------------------------


@pytest.fixture
def blocked_on(monkeypatch):
    """NMGP_BLOCKED_CHOL=1 in both packages; counts the blocked factors."""
    monkeypatch.setattr(jchol, "_BLOCKED_ENABLED", True)
    monkeypatch.setattr(chol, "_BLOCKED_ENABLED", True)
    calls = {"jax": 0, "port": 0}

    def spy(side, fn):
        def wrapped(*args, **kwargs):
            calls[side] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jblocked, "blocked_cholesky", spy("jax", jblocked.blocked_cholesky))
    monkeypatch.setattr(blocked, "blocked_cholesky", spy("port", blocked.blocked_cholesky))
    return calls


def test_blocked_route_objective_matches_jax(monkeypatch, blocked_on):
    n, m = 256, 2  # MN = 512 = BLOCKED_MIN_N
    x, y, vec = make_subject(np.random.default_rng(11), n, m)
    jnlp = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    jval, jgrad = jax.jit(jax.value_and_grad(lambda v: jnlp(v)))(jnp.asarray(vec))
    nlp = gnmgp.make_objective(FullData(_t(x), _t(y)))
    v = _t(vec).requires_grad_(True)
    val = nlp(v)
    (grad,) = torch.autograd.grad(val, v)
    assert blocked_on["jax"] >= 1 and blocked_on["port"] >= 1
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
    w = np.asarray(jgrad)
    np.testing.assert_allclose(grad.numpy(), w, rtol=1e-8, atol=1e-8 * np.abs(w).max())
    # the route changes the order of the arithmetic only
    monkeypatch.setattr(chol, "_BLOCKED_ENABLED", False)
    v0 = _t(vec).requires_grad_(True)
    val0 = nlp(v0)
    (grad0,) = torch.autograd.grad(val0, v0)
    np.testing.assert_allclose(val.item(), val0.item(), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), grad0.numpy(), rtol=1e-8, atol=1e-8 * grad0.abs().max().item())


def test_blocked_route_predict_map_matches_jax(blocked_on):
    n, m = 256, 2
    x, y, vec = make_subject(np.random.default_rng(12), n, m)
    grid = np.linspace(0.0, 1.0, 37)
    want = jax.jit(lambda v, xx, yy, gg: jpred.predict_map(v, JFullData(xx, yy), gg))(
        jnp.asarray(vec), jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    got = pred.predict_map(vec, FullData(x, y), grid, device="cpu")
    assert blocked_on["jax"] >= 1 and blocked_on["port"] >= 1
    np.testing.assert_allclose(got.l_vecs.numpy(), np.asarray(want.l_vecs), rtol=1e-8, atol=KRIGE_ATOL)
    for field in ("mean", "std", "percentiles"):
        w = np.asarray(getattr(want, field))
        np.testing.assert_allclose(getattr(got, field).numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=field)


def test_run_subject_with_the_blocked_route_matches_the_default(monkeypatch, blocked_on):
    """GNMGP at N=256, M=2 (MN = 512) through MAP, HMC, DIC, LOO and grid
    prediction with the blocked route on and off, the same seed: the
    route reorders the float64 arithmetic only, so the runs agree."""
    x, y, _ = make_subject(np.random.default_rng(13), 256, 2)
    cfg = workflows.PipelineConfig(n_opt=4, do_hmc=True, do_loo=True, n_hmc=2, hmc_leapfrog=2, loo_draws=2)
    on = workflows.run_subject(x, y, cfg, device="cpu")
    assert blocked_on["port"] >= 1
    monkeypatch.setattr(chol, "_BLOCKED_ENABLED", False)
    off = workflows.run_subject(x, y, cfg, device="cpu")
    for key in ("map_vec", "hmc_samples"):
        w = off[key].numpy()
        np.testing.assert_allclose(on[key].numpy(), w, rtol=1e-8, atol=1e-8 * np.abs(w).max(), err_msg=key)
    np.testing.assert_allclose([on["dic"], on["loo"]["elpd_loo"]], [off["dic"], off["loo"]["elpd_loo"]], rtol=1e-8)
    w = off["pred_grid"].mean.numpy()
    np.testing.assert_allclose(on["pred_grid"].mean.numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max())
