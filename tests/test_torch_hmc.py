"""The port's HMC slice against the JAX package on the CPU, in float64.

Covers the warmup schedule, the diagnostics, the sampler's drivers draw by
draw, the chain summaries, the DIC and ``run_subject(do_hmc=True)``.

The two packages cannot share a PRNG, so the sampler is held against JAX
with JAX's own noise: the test replays JAX's key threading (one key per
draw, split into a momentum key and an acceptance key) and hands the
normals and uniforms to the port as ``noise=``.  Given the same noise, the
chains take the same accept decisions and differ only by rounding.

Tolerances.  On a Gaussian potential both packages do the same arithmetic
in another order, so draws, potentials, acceptance probabilities and step
sizes agree to ~1e-15 and are held at rtol 1e-10.  Dual averaging feeds each
draw's acceptance back into the next step size, and once the step settles
that loop amplifies rounding differences by a factor of a few per draw
(measured on this potential with windowed warmup: ~1e-15 at draw 10, ~1e-11
at draw 20, ~1e-9 at draw 50, ~1e-3 at draw 100), so the adaptive cases run
25 draws or fewer.  On the GNMGP objective
the value and gradient of one evaluation differ by ~1e-12 relative (two
Cholesky and Gram implementations), and a draw chains 5 of them, so draws
are held at rtol 1e-8.  The chain summaries take the same numpy steps
(rtol 1e-12); the DIC sums deviances of ~1e2 with another reduction order
(rtol 1e-9).  ``run_subject``'s chain cannot be replayed (the stage draws
from its own generator), so it is held to where JAX's chain stays.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.data import sim as jsim
from nonstationary_multivariate_gaussian_process_tpu.inference import diagnostics as jdiagnostics
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import hmc as jhmc
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.inference import map as jmap
from nonstationary_multivariate_gaussian_process_tpu.inference import warmup as jwarmup
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.postprocess import analysis as janalysis
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import diagnostics, hmc, warmup
from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.postprocess import analysis
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each


#: The JAX simulator, jitted: op by op it compiled its operations anew in
#: every module (~3.5 s a subject). Both packages take the same draw; the
#: other port test files import it from here.
jax_sim = jax.jit(jsim.sim_mnts, static_argnames=("n", "m"))

T64 = torch.float64
FIELDS = ("samples", "potentials", "accept_prob", "step_size")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


@jax.jit
def _jax_draw_noise(keys, p_dummy):
    """JAX's per-draw noise for ``keys`` (n_total, 2): the momentum normal
    and the acceptance uniform, as ``hmc._run``'s step draws them."""
    def one(k):
        k_mom, k_acc = jax.random.split(k)
        return (jax.random.normal(k_mom, p_dummy.shape, jnp.float64),
                jax.random.uniform(k_acc, dtype=jnp.float64))
    return jax.vmap(one)(keys)


def jax_noise(key, n_total: int, p: int):
    """``(z (n_total, P), u (n_total,))`` that JAX's sampler draws from ``key``."""
    z, u = _jax_draw_noise(jax.random.split(key, n_total), jnp.zeros(p))
    return np.array(z), np.array(u)


def _memoized(fn, key=lambda *a, **k: (a, tuple(sorted(k.items())))):
    """``fn`` returning one object per ``key`` of its arguments."""
    made = {}

    def once(*args, **kwargs):
        k = key(*args, **kwargs)
        if k not in made:
            made[k] = fn(*args, **kwargs)
        return made[k]

    return once


def jit_jax_map(mp):
    """Put the JAX MAP stage's objective on ``jax.jit`` (``fit_map`` and
    ``multi_start_map`` score each start's last iterate op by op), one
    wrapper and one optimizer a setting: ``fit_map``'s chunk takes both as
    static arguments, so a fresh one a start compiles the same program
    again."""
    multi, fit = jmap.multi_start_map, jmap.fit_map
    for name in ("lbfgs", "scale_by_adam", "scale"):
        mp.setattr(optax, name, _memoized(getattr(optax, name)))
    mp.setattr(optax, "chain", _memoized(optax.chain, lambda *ts: tuple(map(id, ts))))  # of the memoized parts
    mp.setattr(jmap, "_scale_by_vector", _memoized(jmap._scale_by_vector,
                                                   lambda v: (np.shape(v), np.asarray(v).tobytes())))
    jitted = _memoized(jax.jit)
    once = lambda objective: objective if hasattr(objective, "lower") else jitted(objective)  # not jitted twice
    mp.setattr(jmap, "multi_start_map", lambda objective, inits, **kw: multi(once(objective), inits, **kw))
    mp.setattr(jmap, "fit_map", lambda objective, v0, **kw: fit(once(objective), v0, **kw))


def jit_jax_stages(mp, model: str = "gnmgp"):
    """Put a JAX ``run_subject``'s evaluations of ``model``'s objective,
    deviance (the MAP's, AIC's, BIC's and DIC's) and plug-in predictor on
    ``jax.jit``.  Op by op every primitive compiles on its first call in each
    test module, hundreds of small compiles a run; jitted, each program
    compiles once.  The values agree with the op-by-op ones to rounding."""
    mod, pred = jworkflows._MODELS[model], jworkflows._PREDICT[model]
    jit_jax_map(mp)
    once = _memoized(jax.jit)
    for name in ("get_aic", "get_bic", "get_dic"):
        mp.setattr(jevaluate, name, functools.partial(
            lambda orig, first, fn, *a, **k: orig(first, once(fn), *a, **k), getattr(jevaluate, name)))
    hetero_sparse = model == "gnmgp_hetero_sparse"
    if model.endswith("_sparse"):
        for name in ("log_lik_hetero",) if hetero_sparse else ("log_lik",):
            mp.setattr(mod, name, _jitted_log_lik(getattr(mod, name)))
    else:
        mp.setattr(mod, "deviance", jax.jit(mod.deviance))
    for name in ("predict_map_hetero",) if hetero_sparse else ("predict_map",):
        mp.setattr(pred, name, functools.partial(
            lambda orig, vec, *a, **kw: jax.jit(lambda v: orig(v, *a, **kw))(vec), getattr(pred, name)))


def _jitted_log_lik(log_lik):
    """``log_lik(p, data, ops, approx, hyper, mask)`` jitted once per
    approximation and hyper set (the sparse deviance's)."""
    cache = {}

    def jitted(p, data, ops, approx="fitc", hyper=None, mask=None):
        if mask is not None:
            return log_lik(p, data, ops, approx=approx, hyper=hyper, mask=mask)
        key = (approx, repr(sorted((hyper or {}).items())))
        if key not in cache:
            cache[key] = jax.jit(lambda p_, d_, o_: log_lik(p_, d_, o_, approx=approx, hyper=hyper))
        return cache[key](p, data, ops)

    return jitted


def assert_chains_match(got, want, rtol, fields=FIELDS):
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    for f in fields:
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=f)


# ---------------------------------------------------------------------------
# Warmup schedule and diagnostics (host code in both packages)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_warmup", [0, 1, 10, 150, 1000])
def test_window_schedule_matches_jax(n_warmup):
    got, want = warmup.window_schedule(n_warmup), jwarmup.window_schedule(n_warmup)
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def chain():
    """One seeded, autocorrelated chain (S=400, P=4) and two more for the
    multi-chain diagnostics."""
    rng = np.random.default_rng(11)
    c = np.zeros((3, 400, 4))
    for t in range(1, 400):
        c[:, t] = 0.8 * c[:, t - 1] + rng.normal(size=(3, 4))
    return c + np.arange(4.0)


def test_regularized_variance_matches_jax(chain):
    s = chain[0]
    mean, m2 = s.mean(0), ((s - s.mean(0)) ** 2).sum(0)
    for count in (1, 7.0, 400):
        want = np.asarray(jwarmup.regularized_variance(count, jnp.asarray(mean), jnp.asarray(m2)))
        np.testing.assert_allclose(warmup.regularized_variance(count, _t(mean), _t(m2)).numpy(), want,
                                   rtol=1e-12)
    got = warmup.regularized_variance(torch.tensor(7), _t(mean), _t(m2))
    want = jwarmup.regularized_variance(jnp.asarray(7), jnp.asarray(mean), jnp.asarray(m2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_estimate_mass_matrix_matches_jax(chain):
    want = np.asarray(jhmc.estimate_mass_matrix(jnp.asarray(chain[0])))
    got = hmc.estimate_mass_matrix(_t(chain[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


DIAGNOSTICS = {
    "acf": lambda mod, c: mod.acf(c[0, :, 1]),
    "acf_max_lag": lambda mod, c: mod.acf(c[0, :, 1], max_lag=17),
    "ess": lambda mod, c: mod.ess(c[0, :, 2]),
    "ess_multichain": lambda mod, c: mod.ess_multichain(c[:, :, 0]),
    "ess_multichain_raw": lambda mod, c: mod.ess_multichain(c[:, :, 0], rank_normalize=False),
    "rhat": lambda mod, c: mod.rhat(c),
    "chain_diagnostics_single": lambda mod, c: mod.chain_diagnostics(c[0]),
    "chain_diagnostics_multi": lambda mod, c: mod.chain_diagnostics(c, stride=2),
    "summary": lambda mod, c: mod.summary(c[1]),
    "samples2quantiles": lambda mod, c: mod.samples2quantiles(c[2]),
}


@pytest.mark.parametrize("name", list(DIAGNOSTICS))
def test_diagnostics_match_jax(chain, name):
    got, want = DIAGNOSTICS[name](diagnostics, chain), DIAGNOSTICS[name](jdiagnostics, chain)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------------
# The sampler draw by draw on a correlated Gaussian, P = 5
# ---------------------------------------------------------------------------

P = 5
_rng = np.random.default_rng(5)
_B = _rng.normal(size=(P, P))
PREC = np.linalg.inv(_B @ _B.T / P + 0.5 * np.eye(P))
MU = _rng.normal(size=P)
Q0 = MU + _rng.normal(size=P)
DIAG_MASS = 1.0 + _rng.uniform(size=P)
DENSE_MASS = np.linalg.inv(_B @ _B.T / P + 0.5 * np.eye(P))


def jgauss(q):
    d = q - jnp.asarray(MU)
    return 0.5 * d @ jnp.asarray(PREC) @ d


def tgauss(q):
    d = q - _t(MU)
    return 0.5 * d @ _t(PREC) @ d


GAUSS_CASES = {
    "identity": (12, dict(step_size=0.3, n_leapfrog=6)),
    "diagonal": (12, dict(step_size=0.3, n_leapfrog=6, mass_matrix=DIAG_MASS)),
    "dense": (12, dict(step_size=0.3, n_leapfrog=6, mass_matrix=DENSE_MASS)),
    "dual_averaging": (10, dict(step_size=0.05, n_leapfrog=5, n_warmup=15, adapt_step_size=True)),
    "dual_averaging_dense": (8, dict(step_size=1.5, n_leapfrog=4, n_warmup=10, adapt_step_size=True,
                                     mass_matrix=DENSE_MASS)),
    # 12 warmup draws: a step-size draw, a slow window of 10 ending in a
    # metric refresh and a restart of dual averaging, a step-size draw
    "windowed": (6, dict(step_size=0.1, n_leapfrog=4, n_warmup=12, adapt_mass=True)),
    "host": (8, dict(step_size=0.3, n_leapfrog=5, n_warmup=6, adapt_step_size=True, dispatch="host")),
}


@pytest.mark.parametrize("case", list(GAUSS_CASES))
def test_hmc_sample_matches_jax_draw_by_draw(case):
    n_samples, kw = GAUSS_CASES[case]
    key = jax.random.PRNGKey(7)
    want = jhmc.hmc_sample(jgauss, jnp.asarray(Q0), n_samples, key, **kw)
    noise = jax_noise(key, n_samples + kw.get("n_warmup", 0), P)
    got = hmc.hmc_sample(tgauss, _t(Q0), n_samples, noise=noise, **kw)
    assert got.samples.shape == (n_samples, P) and got.samples.dtype == T64
    assert_chains_match(got, want, rtol=1e-10)
    assert got.accepted.any()
    if kw.get("adapt_mass"):
        np.testing.assert_allclose(got.inv_mass.numpy(), np.asarray(want.inv_mass), rtol=1e-10)
    else:
        assert got.inv_mass is None and want.inv_mass is None


@pytest.mark.parametrize("bad", [np.inf, np.nan], ids=["inf", "nan"])
def test_non_finite_potential_is_rejected_as_in_jax(bad):
    """Past q[0] = b the potential is ``bad``: a trajectory that ends there is
    rejected (acceptance 0, state held), the chain goes on, and both packages
    agree draw by draw."""
    b = Q0[0] + 0.3
    jpot = lambda q: jgauss(q) + jnp.where(q[0] > b, bad, 0.0)
    tpot = lambda q: tgauss(q) + torch.where(q[0] > b, bad, 0.0)
    key = jax.random.PRNGKey(3)
    kw = dict(step_size=0.4, n_leapfrog=5)
    want = jhmc.hmc_sample(jpot, jnp.asarray(Q0), 30, key, **kw)
    got = hmc.hmc_sample(tpot, _t(Q0), 30, noise=jax_noise(key, 30, P), **kw)
    assert_chains_match(got, want, rtol=1e-10)
    rejected = torch.nonzero(got.accept_prob == 0).flatten().tolist()
    assert rejected and got.accepted.any()
    for i in rejected:
        assert not got.accepted[i]
        held = got.samples[i - 1] if i > 0 else _t(Q0)
        assert torch.equal(got.samples[i], held)
    assert torch.isfinite(got.samples).all() and torch.isfinite(got.potentials).all()


def test_hmc_sample_chains_match_jax():
    inits = Q0 + np.random.default_rng(2).normal(size=(3, P))
    key = jax.random.PRNGKey(4)
    kw = dict(step_size=0.2, n_leapfrog=4, n_warmup=5, adapt_step_size=True)
    want = jhmc.hmc_sample_chains(jgauss, jnp.asarray(inits), 6, key, **kw)
    per_chain = [jax_noise(k, 11, P) for k in jax.random.split(key, 3)]
    noise = (np.stack([z for z, _ in per_chain]), np.stack([u for _, u in per_chain]))
    got = hmc.hmc_sample_chains(tgauss, _t(inits), 6, noise=noise, **kw)
    assert got.samples.shape == (3, 6, P) and got.step_size.shape == (3,)
    assert_chains_match(got, want, rtol=1e-10)


def test_hmc_sample_chains_draw_from_their_own_generators():
    """Chain c draws from a generator seeded with the c-th of C integers
    drawn from the given one."""
    inits = _t(Q0 + np.random.default_rng(2).normal(size=(2, P)))
    kw = dict(step_size=0.3, n_leapfrog=3)
    got = hmc.hmc_sample_chains(tgauss, inits, 5, torch.Generator().manual_seed(0), **kw)
    seeds = torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(0)).tolist()
    assert seeds[0] != seeds[1]
    for c in range(2):
        one = hmc.hmc_sample(tgauss, inits[c], 5, torch.Generator().manual_seed(seeds[c]), **kw)
        assert torch.equal(got.samples[c], one.samples) and torch.equal(got.accept_prob[c], one.accept_prob)


@pytest.mark.parametrize("kw,match", [
    (dict(dispatch="host", mass_matrix=DIAG_MASS), "identity-mass"),
    (dict(dispatch="host", adapt_mass=True), "identity-mass"),
    (dict(adapt_mass=True, mass_matrix=DIAG_MASS), "drop mass_matrix"),
    (dict(dispatch="scan"), "unknown dispatch"),
])
def test_argument_checks_raise_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jhmc.hmc_sample(jgauss, jnp.asarray(Q0), 2, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match=match):
        hmc.hmc_sample(tgauss, _t(Q0), 2, torch.Generator().manual_seed(0), **kw)


def test_noise_source_is_checked():
    with pytest.raises(ValueError, match="generator"):
        hmc.hmc_sample(tgauss, _t(Q0), 2)
    with pytest.raises(ValueError, match="noise must be"):
        hmc.hmc_sample(tgauss, _t(Q0), 2, noise=(np.zeros((2, P + 1)), np.zeros(2)))


def test_generator_seed_reproduces_its_chain():
    run = lambda seed: hmc.hmc_sample(tgauss, _t(Q0), 20, torch.Generator().manual_seed(seed),
                                      step_size=0.3, n_leapfrog=4)
    a, b, c = run(1), run(1), run(2)
    for f in ("samples", "potentials", "accept_prob", "accepted"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.samples, c.samples)
    # the draw order is z then u from the one generator
    g = torch.Generator().manual_seed(1)
    z, u = [], []
    for _ in range(20):
        z.append(torch.randn(P, generator=g, dtype=T64))
        u.append(torch.rand((), generator=g, dtype=T64))
    d = hmc.hmc_sample(tgauss, _t(Q0), 20, noise=(torch.stack(z), torch.stack(u)), step_size=0.3,
                       n_leapfrog=4)
    assert torch.equal(a.samples, d.samples)


# ---------------------------------------------------------------------------
# The sampler on the GNMGP objective, N=16, M=2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """A sim subject at N=16 (``test_torch_train``'s ``small``), both
    objectives and the empirical init (a MAP-like point)."""
    d = jax_sim(jax.random.PRNGKey(5), n=16, m=2)
    x, y = np.asarray(d.x), np.asarray(d.y)
    emp = jempirical.local_estimation(x, y, window_size=5, method="profile")
    jobj = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    obj = gnmgp.make_objective(FullData(_t(x), _t(y)))
    init = np.asarray(jinit.gnmgp_from_empirical(emp, 16, 2))
    return x, y, jobj, obj, init


GNMGP_CASES = {
    "plain": (4, dict(step_size=1e-3, n_leapfrog=5)),
    # a step of 1 leaves the positive-definite region: the first draws end
    # non-finite and are rejected, dual averaging shrinks the step, later
    # draws are accepted from the held state and gradient
    "leaves_pd_region": (2, dict(step_size=1.0, n_leapfrog=5, n_warmup=6, adapt_step_size=True)),
}


@pytest.mark.parametrize("case", list(GNMGP_CASES))
def test_hmc_sample_on_gnmgp_matches_jax(small, case):
    _, _, jobj, obj, init = small
    n_samples, kw = GNMGP_CASES[case]
    key = jax.random.PRNGKey(9)
    n_total = n_samples + kw.get("n_warmup", 0)
    want = jhmc.hmc_sample(jobj, jnp.asarray(init), n_samples, key, **kw)
    got = hmc.hmc_sample(obj, _t(init), n_samples, noise=jax_noise(key, n_total, init.shape[0]), **kw)
    assert_chains_match(got, want, rtol=1e-8)
    assert got.accepted.any()
    if case == "leaves_pd_region":
        assert got.accept_prob[0] == 0 and not got.accepted[0]
        assert torch.isfinite(got.samples).all()


def test_failed_factor_has_a_non_finite_gradient_as_in_jax(small):
    """An overflowing L-process breaks the Gram's factor: both packages give
    a non-finite value and an all-non-finite gradient."""
    _, _, jobj, obj, init = small
    v = init.copy()
    v[16 + 12] = 800.0
    jv, jg = jax.jit(jax.value_and_grad(jobj))(jnp.asarray(v))
    tv, tg = value_and_grad(obj, _t(v))
    assert not np.isfinite(float(jv)) and not np.isfinite(np.asarray(jg)).any()
    assert not torch.isfinite(tv) and not torch.isfinite(tg).any()


# ---------------------------------------------------------------------------
# Chain summaries and DIC
# ---------------------------------------------------------------------------


def test_latent_summary_and_dic_match_jax(small):
    x, y, _, _, init = small
    hist = init + 0.02 * np.random.default_rng(8).normal(size=(12, init.shape[0]))
    for g, w in zip(analysis.unpack_hist_gnmgp(hist, 16, 2), janalysis.unpack_hist_gnmgp(hist, 16, 2)):
        np.testing.assert_array_equal(g, w)
    got, want = analysis.gnmgp_latent_summary(hist, 16, 2), janalysis.gnmgp_latent_summary(hist, 16, 2)
    assert type(got).__name__ == "LatentSummary" and got._fields == want._fields
    for f, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, err_msg=f)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want_dic = jevaluate.get_dic(jnp.asarray(hist), jax.jit(lambda v: jgnmgp.deviance(v, jy, jx)))
    got_dic = evaluate.get_dic(_t(hist), lambda v: gnmgp.deviance(v, _t(y), _t(x)))
    np.testing.assert_allclose(got_dic, want_dic, rtol=1e-9)


# ---------------------------------------------------------------------------
# run_subject(do_hmc=True) against JAX's
# ---------------------------------------------------------------------------

N_SUBJECT, N_OPT, N_HMC, N_LEAPFROG = 24, 10, 10, 5
#: Where both chains must stay: every draw within this max-abs distance of
#: its MAP (step 1e-4 × 5 leapfrog steps × 10 draws moves a coordinate ~1e-3),
#: and the mean acceptance above this floor (such short trajectories accept
#: nearly always).
CHAIN_RADIUS, ACCEPT_FLOOR = 0.05, 0.5


@pytest.fixture(scope="module")
def hmc_runs(tmp_path_factory):
    """The JAX and the port's run_subject(do_hmc=True) on one subject; the
    port writes to a store."""
    d = jax_sim(jax.random.PRNGKey(6), n=N_SUBJECT, m=2)
    x, y = np.asarray(d.x), np.asarray(d.y)
    # no assertion reads the grid prediction (pred_grid), so neither run makes one
    kw = dict(n_opt=N_OPT, do_hmc=True, n_hmc=N_HMC, hmc_leapfrog=N_LEAPFROG, do_pred_grid=False)
    mp = pytest.MonkeyPatch()
    try:
        jit_jax_stages(mp)
        want = jworkflows.run_subject(x, y, jworkflows.PipelineConfig(**kw))
    finally:
        mp.undo()
    root = str(tmp_path_factory.mktemp("hmc_store"))
    got = workflows.run_subject(x, y, workflows.PipelineConfig(**kw), store=ArtifactStore(root),
                                dataset="sim", device="cpu")
    assert "hmc" in got["timings"] and "hmc" in want["timings"]
    return convert.result_to_numpy(want), convert.result_to_numpy(got), root, (x, y)


def test_run_subject_hmc_map_part_matches_jax(hmc_runs):
    want, got, _, _ = hmc_runs
    assert got["map_init"] == want["map_init"]
    for k in ("map_vec", "target_hist", "deviance", "aic", "bic"):
        w = np.asarray(want[k], float)
        np.testing.assert_allclose(np.asarray(got[k], float), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
    for f in ("tilde_l", "B", "R", "stds"):
        np.testing.assert_allclose(got["map_latents"][f], want["map_latents"][f], rtol=1e-6, atol=1e-9)


def test_run_subject_hmc_chain_stays_where_jax_stays(hmc_runs):
    want, got, _, _ = hmc_runs
    assert got.keys() == want.keys()
    assert got["hmc_samples"].shape == want["hmc_samples"].shape == (N_HMC, got["map_vec"].shape[0])
    for res in (want, got):
        assert np.isfinite(res["hmc_samples"]).all()
        assert np.abs(res["hmc_samples"] - res["map_vec"]).max() < CHAIN_RADIUS
        assert res["hmc_accept"] > ACCEPT_FLOOR
        assert np.isfinite(res["dic"])


def test_run_subject_hmc_summaries_match_jax_on_the_port_chain(hmc_runs):
    _, got, _, (x, y) = hmc_runs
    chain = got["hmc_samples"]
    want = janalysis.gnmgp_latent_summary(chain, N_SUBJECT, 2)
    for f, w in zip(want._fields, want):
        np.testing.assert_allclose(got["latent_summary"][f], np.asarray(w), rtol=1e-12, err_msg=f)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want_dic = jevaluate.get_dic(jnp.asarray(chain), jax.jit(lambda v: jgnmgp.deviance(v, jy, jx)))
    np.testing.assert_allclose(got["dic"], want_dic, rtol=1e-9)


@pytest.mark.parametrize("mass", ["none", "pilot", "window"])
def test_run_subject_writes_the_hmc_artifact(hmc_runs, mass):
    _, got, root, (x, y) = hmc_runs
    store = ArtifactStore(root)
    key = ArtifactStore.key("gnmgp", "sim", 0, "hmc")
    if mass == "none":
        np.testing.assert_array_equal(store.load(key)["samples"], got["hmc_samples"])
        return
    # resumes the stored MAP, so only the sampling stage runs
    cfg = workflows.PipelineConfig(n_opt=N_OPT, do_hmc=True, n_hmc=6, hmc_leapfrog=N_LEAPFROG,
                                   hmc_mass=mass, hmc_warmup=6 if mass == "window" else 0)
    again = workflows.run_subject(x, y, cfg, store=store, dataset="sim", device="cpu")
    assert "map_init" not in again
    samples = again["hmc_samples"]
    assert samples.shape == (6, got["map_vec"].shape[0]) and torch.isfinite(samples).all()
    np.testing.assert_array_equal(store.load(key)["samples"], samples.numpy())
    assert np.abs(samples.numpy() - got["map_vec"]).max() < CHAIN_RADIUS
