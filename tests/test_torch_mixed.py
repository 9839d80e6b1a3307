"""The port's mixed-precision tier (``NMGP_PRECISION=mixed``: ``ops/mixed.py``
and the gates of ``ops/chol.psd_logdet_quad`` and
``ops/kron.kron_chol_logdet_quad``) against the JAX package on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages.  Each
test switches ``settings.mixed_solves`` (and, where the f32 jitter rung
matters, ``settings.robust_cholesky``) in both packages with ``monkeypatch``,
and runs the JAX side un-jitted or through a fresh ``jax.jit`` closure, so no
trace made under another setting is reused.

Tolerances.  Values are float64-accurate by design: the port, JAX and the
exact float64 factor agree within rtol 1e-8 (the f32 factors of the two
packages differ in their last bits; the corrections remove that).
Gradients are float32-class by design (``G = WᵀW ≈ A⁻¹``): the A-gradient
within 5e-3 of its largest entry, the y-gradient (``2q̄z``, z refined to
float64) within rtol 1e-6.  A batch member equals its own unbatched call
within rtol 1e-10.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_hetero as jhetero
from nonstationary_multivariate_gaussian_process_tpu.models import lmc as jlmc
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp as jsnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.ops import chol as jchol
from nonstationary_multivariate_gaussian_process_tpu.ops import kron as jkron
from nonstationary_multivariate_gaussian_process_tpu.ops import mixed as jmixed
from nonstationary_multivariate_gaussian_process_tpu_torch import models, settings, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.data import preprocess, sim
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp, gnmgp_hetero, lmc, snmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import chol, kron, mixed, transforms

from test_torch_hadamard_models import hadamard_subject, model_vec

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64


def _t(a, dtype=T64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _gnmgp_gram(rng, n, m=2, s2=-4.0):
    """A GNMGP MN×MN covariance (the inputs of JAX's ``tests/test_mixed.py``,
    assembled by the port) and an observation vector, as numpy."""
    x = _t(np.sort(rng.uniform(size=n)))
    t = m * (m + 1) // 2
    vec = _t(np.concatenate([-1.0 + 0.1 * rng.normal(size=n), 0.3 * rng.normal(size=n * t), [s2]]))
    p = gnmgp.unpack(vec, n, m)
    cov = gnmgp.gram(x, torch.exp(p.tilde_l), gnmgp.chol_process(p.ul_vecs, n, m))
    cov = cov + torch.exp(p.tilde_sigma2_err) * torch.eye(n * m, dtype=T64)
    return cov.numpy(), rng.normal(size=n * m)


def _exact(cov, y):
    """logdet and quadratic form by the float64 Cholesky (numpy)."""
    l = np.linalg.cholesky(cov)
    sol = np.linalg.solve(l, y)
    return 2.0 * np.sum(np.log(np.diag(l))), float(sol @ sol)


@pytest.fixture
def robust(monkeypatch):
    """The two-rung jitter ladder on in both packages (a collected module may
    have set NMGP_ROBUST_CHOL=0 before the settings were imported)."""
    monkeypatch.setattr(jsettings, "robust_cholesky", True)
    monkeypatch.setattr(settings, "robust_cholesky", True)


@pytest.fixture
def mixed_mode(monkeypatch, robust):
    monkeypatch.setattr(jsettings, "mixed_solves", True)
    monkeypatch.setattr(settings, "mixed_solves", True)


@pytest.fixture
def spies(monkeypatch):
    """Counts the calls of each package's ``mixed_logdet_quad`` (JAX's at
    trace time)."""
    calls = {"jax": 0, "port": 0}

    def spy(side, fn):
        def wrapped(*args):
            calls[side] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(jmixed, "mixed_logdet_quad", spy("jax", jmixed.mixed_logdet_quad))
    monkeypatch.setattr(mixed, "mixed_logdet_quad", spy("port", mixed.mixed_logdet_quad))
    return calls


# ---------------------------------------------------------------------------
# mixed_logdet_quad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s2", [-2.0, -4.0, -7.0])
def test_values_match_jax_and_the_exact_f64_factor(rng, robust, s2):
    cov, y = _gnmgp_gram(rng, n=300, s2=s2)
    ld, q = mixed.mixed_logdet_quad(_t(cov), _t(y))
    jld, jq = jax.jit(lambda a, b: jmixed.mixed_logdet_quad(a, b))(jnp.asarray(cov), jnp.asarray(y))
    ld_ref, q_ref = _exact(cov, y)
    np.testing.assert_allclose([ld.item(), q.item()], [float(jld), float(jq)], rtol=1e-8)
    np.testing.assert_allclose([ld.item(), q.item()], [ld_ref, q_ref], rtol=1e-8)


def test_gradients_are_f32_class_and_match_jax(rng, robust):
    cov, y = _gnmgp_gram(rng, n=150)
    a, yy = _t(cov).requires_grad_(True), _t(y).requires_grad_(True)
    ld, q = mixed.mixed_logdet_quad(a, yy)
    ga, gy = torch.autograd.grad(-0.5 * (ld + q), (a, yy))

    a_ref, y_ref = _t(cov).requires_grad_(True), _t(y).requires_grad_(True)
    l = torch.linalg.cholesky(a_ref)
    sol = torch.linalg.solve_triangular(l, y_ref[:, None], upper=False)[:, 0]
    f_ref = -0.5 * (2.0 * torch.sum(torch.log(torch.diagonal(l))) + torch.sum(sol * sol))
    ga_r, gy_r = torch.autograd.grad(f_ref, (a_ref, y_ref))

    def f_jax(am, ym):
        jl, jq = jmixed.mixed_logdet_quad(am, ym)
        return -0.5 * (jl + jq)

    ga_j, gy_j = jax.jit(jax.grad(f_jax, (0, 1)))(jnp.asarray(cov), jnp.asarray(y))
    assert torch.isfinite(ga).all() and torch.isfinite(gy).all()
    scale = ga_r.abs().max().item()
    assert (ga - ga_r).abs().max().item() < 5e-3 * scale
    assert np.abs(ga.numpy() - np.asarray(ga_j)).max() < 5e-3 * scale
    for want in (gy_r.numpy(), np.asarray(gy_j)):
        np.testing.assert_allclose(gy.numpy(), want, rtol=1e-6, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("check_every", [1, 4, 20])
def test_batch_members_equal_their_own_calls(monkeypatch, robust, check_every):
    """Members with other conditioning stop refining at other sweeps; each
    equals its unbatched call, for every spacing of the host's exit check."""
    monkeypatch.setattr(mixed, "IR_CHECK_EVERY", check_every)
    rng = np.random.default_rng(5)
    covs, ys = zip(*(_gnmgp_gram(rng, n=120, s2=s2) for s2 in (-2.0, -4.0, -7.0)))
    a, y = _t(np.stack(covs)), _t(np.stack(ys))
    sweeps = mixed._forward(a, y)[4]
    assert len(set(sweeps.tolist())) > 1  # the members stop apart
    lds, qs = mixed.mixed_logdet_quad(a, y)
    for i in range(3):
        ld_i, q_i = mixed.mixed_logdet_quad(a[i], y[i])
        np.testing.assert_allclose([lds[i].item(), qs[i].item()], [ld_i.item(), q_i.item()], rtol=1e-10)


def test_f32_jitter_rung(monkeypatch, rng, robust):
    """A PSD matrix whose f32 cast does not factor: the mixed kernel retries
    with 1e-3 of the mean f32 diagonal, and its values are those of
    ``A + jit·I`` (JAX's ``test_robust_jitter_matches_f64_semantics``).
    Without the ladder the values are NaN, as JAX's are."""
    n = 128
    u = np.linalg.qr(rng.normal(size=(n, n)))[0]
    w = np.concatenate([np.full(n - 3, 1.0), np.full(3, 1e-9)])
    a = u @ np.diag(w) @ u.T
    a = 0.5 * (a + a.T)
    y = rng.normal(size=n)
    assert torch.linalg.cholesky_ex(_t(a, torch.float32)).info.item() > 0
    # a fresh jit a call: JAX reads the settings at trace time (op by op it took ~3 s)
    jf = lambda: jax.jit(lambda aa, yy: jmixed.mixed_logdet_quad(aa, yy))(jnp.asarray(a), jnp.asarray(y))
    ld, q = mixed.mixed_logdet_quad(_t(a), _t(y))
    jld, jq = jf()
    jit = (mixed.FALLBACK_REL * torch.mean(torch.diagonal(_t(a, torch.float32)))).item()  # f32 product
    ld_ref, q_ref = _exact(a + jit * np.eye(n), y)
    np.testing.assert_allclose([ld.item(), q.item()], [ld_ref, q_ref], rtol=1e-8)
    # JAX sums the f32 diagonal in another order: its jitter differs in the
    # last f32 bit, which moves the three 1e-3 directions' quadratic terms
    np.testing.assert_allclose([ld.item(), q.item()], [float(jld), float(jq)], rtol=1e-6)

    monkeypatch.setattr(jsettings, "robust_cholesky", False)
    monkeypatch.setattr(settings, "robust_cholesky", False)
    ld, q = mixed.mixed_logdet_quad(_t(a), _t(y))
    jld, jq = jf()
    assert np.isnan([ld.item(), q.item(), float(jld), float(jq)]).all()


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dtype,y_cols,on,routed", [
    (192, "float64", 0, True, True),     # the gate's lower edge
    (191, "float64", 0, True, False),    # below MIXED_MIN_N
    (192, "float32", 0, True, False),    # f32 arrays keep the factor
    (192, "float64", 2, True, False),    # a matrix right-hand side
    (192, "float64", 0, False, False),   # mixed_solves off
])
def test_psd_logdet_quad_routes_where_jax_does(monkeypatch, spies, robust, n, dtype, y_cols, on, routed):
    monkeypatch.setattr(jsettings, "mixed_solves", on)
    monkeypatch.setattr(settings, "mixed_solves", on)
    rng = np.random.default_rng(n)
    cov, _ = _gnmgp_gram(rng, n=n // 2 + 1)
    cov = cov[:n, :n]
    y = rng.normal(size=(n, y_cols) if y_cols else n)
    ld, q = chol.psd_logdet_quad(_t(cov, getattr(torch, dtype)), _t(y, getattr(torch, dtype)))
    jld, jq = jax.jit(lambda a, b: jchol.psd_logdet_quad(a, b))(jnp.asarray(cov, dtype), jnp.asarray(y, dtype))
    assert spies == {"jax": int(routed), "port": int(routed)}
    rtol = 1e-8 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), rtol=rtol)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=rtol)


@pytest.mark.parametrize("masked", [False, True])
def test_kron_mixed_path_matches_jax_and_the_factor_path(monkeypatch, rng, spies, mixed_mode, masked):
    """One batched call over the M rotated blocks, with the padded slots'
    logdet correction under a mask (JAX's ``TestMixedKronPath``)."""
    n, m = 256, 2
    x = np.sort(rng.uniform(size=n))
    a = rng.normal(size=(m, m))
    b = a @ a.T + np.eye(m)
    k = np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.1) ** 2) + 1e-6 * np.eye(n)
    y = rng.normal(size=m * n)
    mask = np.arange(n) < n - 17 if masked else None
    tmask = None if mask is None else torch.tensor(mask)
    ld, q = kron.kron_chol_logdet_quad(_t(b), _t(k), 0.01, _t(y), mask=tmask)
    jmask = None if mask is None else jnp.asarray(mask)
    jld, jq = jax.jit(lambda bb, kk, yy: jkron.kron_chol_logdet_quad(bb, kk, 0.01, yy, mask=jmask))(
        jnp.asarray(b), jnp.asarray(k), jnp.asarray(y))
    assert spies == {"jax": 1, "port": 1}
    np.testing.assert_allclose([ld.item(), q.item()], [float(jld), float(jq)], rtol=1e-8)
    monkeypatch.setattr(settings, "mixed_solves", False)
    ld0, q0 = kron.kron_chol_logdet_quad(_t(b), _t(k), 0.01, _t(y), mask=tmask)
    np.testing.assert_allclose([ld.item(), q.item()], [ld0.item(), q0.item()], rtol=1e-10)


# ---------------------------------------------------------------------------
# The dense objectives under mixed
# ---------------------------------------------------------------------------


def dense_subject(model: str, n: int, seed: int):
    """A ``sim_mnts`` subject (``sim_mnts_hetero`` for the hetero model) at
    M=2 with its truth packed as ``model``'s vector, as numpy."""
    gen = torch.Generator().manual_seed(seed)
    if model == "gnmgp_hetero":
        d = sim.sim_mnts_hetero(gen, n=n, device="cpu", dtype=T64)
        ul = transforms.lvec_to_ulvec(d.l_vecs.reshape(n, 3), 2).reshape(-1)
        return d.x.numpy(), d.y.numpy(), torch.cat([torch.log(d.l), ul, d.tilde_sigma2_err]).numpy()
    d = sim.sim_mnts(gen, n=n, m=2, device="cpu", dtype=T64)
    ul = transforms.lvec_to_ulvec(d.l_vecs.reshape(n, 3), 2).numpy()
    ll, s2 = np.log(d.l.numpy()), np.log([d.sigma2_err])
    if model == "gnmgp":
        return d.x.numpy(), d.y.numpy(), np.concatenate([ll, ul.reshape(-1), s2])
    if model == "snmgp":
        return d.x.numpy(), d.y.numpy(), np.concatenate([ll, np.zeros(n), ul.mean(0), s2])
    return d.x.numpy(), d.y.numpy(), np.concatenate([[ll.mean(), 0.0], ul.mean(0), s2])


#: model: (port module, JAX module, N).  GNMGP and hetero at MN = 200, LMC
#: and SNMGP at N = 200 (each Kronecker block N×N): all past MIXED_MIN_N.
DENSE = {"gnmgp": (gnmgp, jgnmgp, 100), "gnmgp_hetero": (gnmgp_hetero, jhetero, 100),
         "lmc": (lmc, jlmc, 200), "snmgp": (snmgp, jsnmgp, 200)}


@pytest.mark.parametrize("model", list(DENSE))
def test_dense_objectives_under_mixed_match_jax(monkeypatch, spies, mixed_mode, model):
    mod, jmod, n = DENSE[model]
    x, y, vec = dense_subject(model, n, seed=3)
    unpack = (lambda m_, v: m_.unpack(v, 2)) if model == "lmc" else (lambda m_, v: m_.unpack(v, n, 2))
    jdata = JFullData(jnp.asarray(x), jnp.asarray(y))
    jnlp = jmod.make_objective(jdata)
    jval, jll = jax.jit(lambda v: (jnlp(v), jmod.log_lik(unpack(jmod, v), jdata)))(jnp.asarray(vec))
    data = FullData(_t(x), _t(y))
    v = _t(vec).requires_grad_(True)
    val = mod.make_objective(data)(v)
    (grad,) = torch.autograd.grad(val, v)
    ll = mod.log_lik(unpack(mod, _t(vec)), data)
    assert spies["jax"] >= 1 and spies["port"] >= 1
    np.testing.assert_allclose([val.item(), ll.item()], [float(jval), float(jll)], rtol=1e-8)
    # against the port's float64 factor path at the same point
    monkeypatch.setattr(settings, "mixed_solves", False)
    v0 = _t(vec).requires_grad_(True)
    val0 = mod.make_objective(data)(v0)
    (grad0,) = torch.autograd.grad(val0, v0)
    ll0 = mod.log_lik(unpack(mod, _t(vec)), data)
    np.testing.assert_allclose([val.item(), ll.item()], [val0.item(), ll0.item()], rtol=1e-8)
    assert (grad - grad0).abs().max().item() < 5e-3 * grad0.abs().max().item()


@pytest.mark.parametrize("model", ["lmc", "snmgp", "gnmgp"])
def test_hadamard_objectives_under_mixed_match_jax(spies, mixed_mode, model):
    x, indx, y = hadamard_subject(160, 2, seed=5)
    n, m = x.shape[0], 2
    assert n >= chol.MIXED_MIN_N
    vec = model_vec(model, n, m, np.random.default_rng(1))
    jmod = {"lmc": jlmc, "snmgp": jsnmgp, "gnmgp": jgnmgp}[model]
    mod = {"lmc": lmc, "snmgp": snmgp, "gnmgp": gnmgp}[model]
    jargs = (jnp.asarray(x), jnp.asarray(indx, jnp.int32), jnp.asarray(y))
    want = jax.jit(lambda v: jmod.nlogpos_hadamard(v, *jargs, m, verbose=True))(jnp.asarray(vec))
    got = mod.nlogpos_hadamard(_t(vec), _t(x), torch.tensor(indx), _t(y), m, verbose=True)
    assert spies["jax"] >= 1 and spies["port"] >= 1
    # the value and each component (the likelihood second)
    np.testing.assert_allclose([g.item() for g in got], [float(w) for w in want], rtol=1e-8)
    data = models.as_hadamard_data(x, indx, y, device="cpu")
    v = _t(vec).requires_grad_(True)
    val = mod.make_objective_hadamard(data, m)(v)
    (grad,) = torch.autograd.grad(val, v)
    np.testing.assert_allclose(val.item(), float(want[0]), rtol=1e-8)
    assert torch.isfinite(grad).all()


# ---------------------------------------------------------------------------
# run_subject under mixed (the port alone)
# ---------------------------------------------------------------------------

#: The final MAP objective of the mixed run against the f64 run's: the
#: float32-class gradients steer L-BFGS along another path.  Measured on this
#: subject: 1.0e-11 relative (the MAP vectors 4.5e-9 apart); held at 1e-9.
MAP_RTOL = 1e-9


def test_run_subject_under_mixed_runs_every_stage(monkeypatch):
    """GNMGP at N=100, M=2 (MN = 200, past the gate) through MAP, HMC, DIC,
    LOO and prediction, under mixed and under f64 with the same seed, hence
    the same momenta and uniforms."""
    x, y, _ = dense_subject("gnmgp", 100, seed=4)
    cfg = workflows.PipelineConfig(n_opt=8, do_hmc=True, do_loo=True, n_hmc=4, hmc_leapfrog=4, loo_draws=4)
    monkeypatch.setattr(settings, "robust_cholesky", True)
    runs = {}
    for on in (True, False):
        monkeypatch.setattr(settings, "mixed_solves", on)
        runs[on] = workflows.run_subject(x, y, cfg, device="cpu")
    got, ref = runs[True], runs[False]
    for key in ("map_vec", "hmc_samples", "dic", "loo", "pred_grid", "latent_summary", "deviance"):
        assert key in got, key
    assert torch.isfinite(got["hmc_samples"]).all() and np.isfinite(got["loo"]["elpd_loo"])
    assert got["hmc_samples"].shape == ref["hmc_samples"].shape == (4, got["map_vec"].shape[0])
    np.testing.assert_allclose(got["target_hist"][-1], ref["target_hist"][-1], rtol=MAP_RTOL)
    # the objective along the mixed run's path equals the f64 objective there
    nlp = gnmgp.make_objective(FullData(_t(x), _t(y)))
    points = torch.cat([got["map_vec"][None], got["hmc_samples"]])
    values = {}
    for on in (True, False):
        monkeypatch.setattr(settings, "mixed_solves", on)
        with torch.no_grad():
            values[on] = [nlp(p).item() for p in points]
    np.testing.assert_allclose(values[True], values[False], rtol=1e-8)


def test_run_subject_hadamard_under_mixed_runs_every_stage(monkeypatch):
    """GNMGP in the Hadamard layout (about 220 training observations, past
    the gate) through MAP, HMC, LOO and the held-out scores under mixed; the
    objective at the run's MAP and draws equals the f64 objective there."""
    x, indx, y = hadamard_subject(200, 2, seed=9)
    cfg = workflows.PipelineConfig(model="gnmgp", n_opt=5, do_hmc=True, do_loo=True, n_hmc=3, hmc_leapfrog=3,
                                   loo_draws=3, test_size=0.2)
    monkeypatch.setattr(settings, "robust_cholesky", True)
    monkeypatch.setattr(settings, "mixed_solves", True)
    res = workflows.run_subject_hadamard(x, indx, y, 2, cfg, device="cpu")
    for key in ("map_vec", "hmc_samples", "loo", "pred_grid", "test_rmse", "test_sample_lpd"):
        assert key in res, key
    assert np.isfinite(res["loo"]["elpd_loo"]) and np.isfinite(res["test_sample_lpd"])
    # the training half as run_subject_hadamard splits and sorts it
    x_tr, _, i_tr, _, y_tr, _ = preprocess.data_split_non(x, indx, y, test_size=cfg.test_size)
    order = np.argsort(x_tr)
    data = models.as_hadamard_data(x_tr[order], i_tr[order], y_tr[order], device="cpu")
    assert res["n"] == data.y.shape[0] >= chol.MIXED_MIN_N
    nlp = gnmgp.make_objective_hadamard(data, 2)
    points = torch.cat([res["map_vec"][None], res["hmc_samples"]])
    values = {}
    for on in (True, False):
        monkeypatch.setattr(settings, "mixed_solves", on)
        with torch.no_grad():
            values[on] = [nlp(p).item() for p in points]
    np.testing.assert_allclose(values[True], values[False], rtol=1e-8)
