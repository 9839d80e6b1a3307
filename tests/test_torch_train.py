"""The port's training path against the JAX package on the CPU, in float64.

Covers the empirical initializer (each method; the native method compares
the two packages' builds of the same C++), the init builders, the
optimizers (Adam iterate by iterate, optax's L-BFGS, the guard,
multi-start), the scalar scores and the whole ``run_subject`` pipeline,
whose store the port's server then serves.

Tolerances.  Adam's arithmetic is optax's, operation by operation, so its
iterates agree to rounding (rtol 1e-8 over 30 steps).  L-BFGS's linesearch
makes host decisions on values and slopes; both packages take the same
branches here, and the iterates agree to ~1e-10, held at 1e-6 over the
first 5 and at 1e-8 on the objective after 30.  The pipeline's outputs are
held at rtol 1e-6; they measure ~1e-11 apart.
"""

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import native as jnative
from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.data import preprocess as jpreprocess
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.inference import map as jmap
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.postprocess import analysis as janalysis
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate, native, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.data import preprocess
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import empirical
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import init as init_mod
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import map as map_mod
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.postprocess import analysis
from nonstationary_multivariate_gaussian_process_tpu_torch.serving import PredictEngine
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_hmc import jax_sim, jit_jax_stages

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each


T64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _sim(n, key=3):
    d = jax_sim(jax.random.PRNGKey(key), n=n, m=2)
    return np.asarray(d.x), np.asarray(d.y)


@pytest.fixture(scope="module")
def small():
    """A sim subject at N=16, its empirical estimate and both objectives."""
    x, y = _sim(16, key=5)
    emp = jempirical.local_estimation(x, y, window_size=5, method="profile")
    # jitted: JAX's optimizers evaluate it outside their own jitted steps too,
    # where op by op each primitive compiles on its first call
    jobj = jax.jit(jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y))))
    obj = gnmgp.make_objective(FullData(_t(x), _t(y)))
    init = np.asarray(jinit.gnmgp_from_empirical(emp, 16, 2))
    return x, y, emp, jobj, obj, init


# ---------------------------------------------------------------------------
# Empirical initializer and init builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["auto", "native", "profile", "curve_fit"])
def test_local_estimation_matches_jax(method):
    if method in ("auto", "native") and not (native.available() and jnative.available()):
        pytest.skip("g++ toolchain unavailable")
    x, y = _sim(60, key=1)
    want = jempirical.local_estimation(x, y, window_size=12, method=method)
    got = empirical.local_estimation(x, y, window_size=12, method=method)
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-12, atol=1e-14, err_msg=name)


def test_native_builds_into_the_port_build_dir():
    if not native.available():
        pytest.skip("g++ toolchain unavailable")
    path = native._lib_path()
    assert path.startswith(native.BUILD_DIR) and path.endswith(".so")
    assert native.BUILD_DIR.endswith("nonstationary_multivariate_gaussian_process_tpu_torch/build")


def test_local_estimation_rejects_unknown_method():
    with pytest.raises(ValueError, match="method must be one of"):
        empirical.local_estimation(np.arange(8.0), np.zeros((8, 2)), method="bogus")


def test_native_method_raises_when_the_build_fails(monkeypatch):
    monkeypatch.setattr(native, "_state", {"lib": None, "tried": True})
    with pytest.raises(RuntimeError, match="native variogram library unavailable"):
        empirical.local_estimation(np.arange(8.0), np.ones((8, 2)), window_size=3, method="native")
    # "auto" keeps the JAX meaning: the numpy profile fit when the build is missing
    est = empirical.local_estimation(np.linspace(0, 1, 8), np.sin(np.arange(16.0)).reshape(8, 2),
                                     window_size=3, method="auto")
    assert np.isfinite(est.est_ls).all()


def test_init_builders_match_jax():
    x, y = _sim(30, key=2)
    emp = jempirical.local_estimation(x, y, window_size=8, method="profile")
    pemp = convert.empirical_from_jax(emp)
    cases = [
        (init_mod.snmgp_from_empirical(pemp, 30, 2, "cpu"), jinit.snmgp_from_empirical(emp, 30, 2)),
        (init_mod.gnmgp_from_empirical(pemp, 30, 2, device="cpu"), jinit.gnmgp_from_empirical(emp, 30, 2)),
        (init_mod.gnmgp_from_empirical(pemp, 30, 2, smooth=True, device="cpu"),
         jinit.gnmgp_from_empirical(emp, 30, 2, smooth=True)),
    ]
    sn = np.asarray(jinit.snmgp_from_empirical(emp, 30, 2)) + 0.1 * np.cos(np.arange(64.0))
    cases.append((init_mod.gnmgp_from_separable(_t(sn), 30, 2, "cpu"), jinit.gnmgp_from_separable(sn, 30, 2)))
    for got, want in cases:
        assert got.dtype == T64 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def test_adam_iterates_match_jax(small):
    x, y, emp, jobj, obj, init = small
    lr_groups = {0: 0.05, 5: 0.01}
    lr_vec = map_mod._build_lr_vec(0.1, init.shape[0], lr_groups, "cpu", T64)
    opt = optax.chain(optax.scale_by_adam(), optax.scale(-1.0),
                      jmap._scale_by_vector(jnp.asarray(lr_vec.numpy())))
    jstep = jax.jit(jmap.guarded_adam_step(jobj, opt))
    v0 = jnp.asarray(init)
    carry = (v0, opt.init(v0), v0, jnp.asarray(jnp.inf))
    v, state, bv, bval = _t(init), map_mod.adam_init(_t(init)), _t(init), torch.tensor(np.inf, dtype=T64)
    for i in range(30):
        carry, jt = jstep(carry, None)
        v, state, bv, bval, t = map_mod.guarded_adam_step(obj, lr_vec, v, state, bv, bval)
        np.testing.assert_allclose(v.numpy(), np.asarray(carry[0]), rtol=1e-8, atol=1e-10,
                                   err_msg=f"iterate {i + 1}")
        np.testing.assert_allclose(t.item(), float(jt), rtol=1e-8)
    np.testing.assert_allclose(bv.numpy(), np.asarray(carry[2]), rtol=1e-8, atol=1e-10)


def test_fit_map_adam_matches_jax(small):
    x, y, emp, jobj, obj, init = small
    seen, jseen = [], []
    want = jmap.fit_map(jobj, jnp.asarray(init), n_iters=30, lr=0.1, chunk=12,
                        checkpoint_fn=lambda v, i: jseen.append((np.asarray(v), i)))
    got = map_mod.fit_map(obj, _t(init), n_iters=30, lr=0.1, chunk=12,
                          checkpoint_fn=lambda v, i: seen.append((v.numpy(), i)))
    assert got.n_iters == want.n_iters == 30 and not got.converged
    np.testing.assert_allclose(got.target_hist.numpy(), np.asarray(want.target_hist), rtol=1e-8)
    np.testing.assert_allclose(got.vec.numpy(), np.asarray(want.vec), rtol=1e-8, atol=1e-10)
    assert [i for _, i in seen] == [i for _, i in jseen] == [12, 24, 30]
    for (g, _), (w, _) in zip(seen, jseen):
        np.testing.assert_allclose(g, w, rtol=1e-8, atol=1e-10)


def test_lbfgs_iterates_match_jax(small):
    x, y, emp, jobj, obj, init = small
    opt = optax.lbfgs(memory_size=10)
    jstep = jax.jit(jmap.guarded_lbfgs_step(jobj, opt))
    v0 = jnp.asarray(init)
    carry = (v0, opt.init(v0), v0, jnp.asarray(jnp.inf))
    v, state, bv, bval = _t(init), map_mod.lbfgs_init(_t(init)), _t(init), np.inf
    for i in range(5):
        carry, jt = jstep(carry, None)
        v, state, bv, bval, t = map_mod.guarded_lbfgs_step(obj, v, state, bv, bval)
        np.testing.assert_allclose(v.numpy(), np.asarray(carry[0]), rtol=1e-6, atol=1e-9,
                                   err_msg=f"iterate {i + 1}")
        np.testing.assert_allclose(float(t), float(jt), rtol=1e-6)


def test_fit_map_lbfgs_final_objective_matches_jax(small):
    x, y, emp, jobj, obj, init = small
    want = jmap.fit_map(jobj, jnp.asarray(init), n_iters=30, method="lbfgs")
    got = map_mod.fit_map(obj, _t(init), n_iters=30, method="lbfgs")
    with torch.no_grad():
        got_val = obj(got.vec).item()
    np.testing.assert_allclose(got_val, float(jobj(want.vec)), rtol=1e-8)
    np.testing.assert_allclose(got.target_hist.numpy(), np.asarray(want.target_hist), rtol=1e-6)


def _nan_beyond(lib, limit):
    """sum((v − 2)²), NaN once any coordinate passes ``limit``."""
    def f(v):
        val = lib.sum((v - 2.0) ** 2)
        return lib.where(lib.max(v) < limit, val, lib.nan * val)
    return f


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_guard_holds_params_on_nan_objective(method):
    init = np.linspace(-1.0, 1.0, 5)
    always_nan = lambda v: torch.sum(v) * float("nan")
    res = map_mod.fit_map(always_nan, _t(init), n_iters=4, method=method)
    assert torch.equal(res.vec, _t(init))
    assert torch.isnan(res.target_hist).all() and res.n_iters == 4
    # a run that walks into the NaN region keeps its best finite point, as in JAX
    want = jmap.fit_map(_nan_beyond(jnp, 1.5), jnp.asarray(init), n_iters=20, lr=0.3, method=method)
    got = map_mod.fit_map(_nan_beyond(torch, 1.5), _t(init), n_iters=20, lr=0.3, method=method)
    np.testing.assert_allclose(got.vec.numpy(), np.asarray(want.vec), rtol=1e-10)
    np.testing.assert_allclose(got.target_hist.numpy(), np.asarray(want.target_hist), rtol=1e-10)
    assert (got.vec < 1.5).all()


def test_fit_map_stops_on_err_opt_like_jax():
    f = lambda lib: (lambda v: lib.sum((v - 0.5) ** 2))
    init = np.array([3.0, -2.0])
    want = jmap.fit_map(f(jnp), jnp.asarray(init), n_iters=100, lr=0.2, chunk=10, err_opt=1e-3)
    got = map_mod.fit_map(f(torch), _t(init), n_iters=100, lr=0.2, chunk=10, err_opt=1e-3)
    assert got.converged == want.converged and got.n_iters == want.n_iters
    np.testing.assert_allclose(got.vec.numpy(), np.asarray(want.vec), rtol=1e-10)


def test_multi_start_map_picks_the_same_start(small):
    x, y, emp, jobj, obj, init = small
    inits = {"empirical": init, "shifted": init + 0.3 * np.sin(np.arange(init.shape[0]))}
    jname, jres, _ = jmap.multi_start_map(jobj, {k: jnp.asarray(v) for k, v in inits.items()},
                                          n_iters=8, method="lbfgs")
    name, res, results = map_mod.multi_start_map(obj, {k: _t(v) for k, v in inits.items()},
                                                 n_iters=8, method="lbfgs")
    assert name == jname and set(results) == set(inits)
    np.testing.assert_allclose(res.vec.numpy(), np.asarray(jres.vec), rtol=1e-6, atol=1e-9)


def test_multi_start_map_records_failed_starts(small):
    x, y, emp, jobj, obj, init = small
    name, _, results = map_mod.multi_start_map(obj, {"bad": _t(init[:-1]), "good": _t(init)}, n_iters=2)
    assert name == "good" and "ValueError" in results["__errors__"]["bad"]
    with pytest.raises(RuntimeError, match="every MAP start failed"):
        map_mod.multi_start_map(obj, {"bad": _t(init[:-1])}, n_iters=2)
    with pytest.raises(ValueError, match="unknown method"):
        map_mod.fit_map(obj, _t(init), method="sgd")


# ---------------------------------------------------------------------------
# Scores, splits, latent analysis
# ---------------------------------------------------------------------------


def test_scores_match_jax(rng):
    a, b, s = rng.normal(size=(9, 2)), rng.normal(size=(9, 2)), rng.uniform(0.5, 2, (9, 2))
    assert evaluate.rmse(_t(a), b) == pytest.approx(float(jevaluate.rmse(a, b)), rel=1e-14)
    assert evaluate.lpd(_t(a), _t(s), b) == pytest.approx(jevaluate.lpd(a, s, b), rel=1e-14)
    assert evaluate.pmse(a, b) == pytest.approx(jevaluate.pmse(a, b), rel=1e-14)
    np.testing.assert_allclose(evaluate.mse(a, b, axis=0), jevaluate.mse(a, b, axis=0), rtol=1e-14)
    vec = rng.normal(size=7)
    dev = lambda v: float(np.sum(np.asarray(v) ** 2))
    assert evaluate.get_aic(_t(vec), dev) == pytest.approx(jevaluate.get_aic(vec, dev), rel=1e-14)
    assert evaluate.get_bic(_t(vec), dev, n_obs=30) == pytest.approx(
        jevaluate.get_bic(vec, dev, n_obs=30), rel=1e-14)


def test_data_split_matches_jax(rng):
    x, y = np.sort(rng.uniform(size=25)), rng.normal(size=(25, 2))
    for g, w in zip(preprocess.data_split(x, y, 0.25), jpreprocess.data_split(x, y, 0.25)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m", [2, 3])
def test_map_latents_and_cov2cor_match_jax(rng, m):
    n = 11
    vec = rng.normal(size=n + n * m * (m + 1) // 2 + 1)
    for g, w in zip(analysis.gnmgp_map_latents(vec, n, m), janalysis.gnmgp_map_latents(vec, n, m)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12)
    s = rng.normal(size=(4, m, m))
    s = s @ np.swapaxes(s, -1, -2) + np.eye(m)
    np.testing.assert_allclose(analysis.cov2cor(s), janalysis.cov2cor(s), rtol=1e-13)


def test_convert_carries_jax_state(rng):
    v = rng.normal(size=2 * 6 + 3 + 1)
    p = convert.snmgp_params_from_jax(v, 6, 2, device="cpu")
    np.testing.assert_array_equal(p.ul_vec.numpy(), v[12:15])
    res = convert.result_to_numpy({"a": torch.ones(2), "b": jnp.zeros(3), "timings": {"x": 1.0},
                                   "c": {"d": torch.zeros(1)}, "e": "gnmgp"})
    assert set(res) == {"a", "b", "c", "e"} and isinstance(res["b"], np.ndarray)
    assert isinstance(res["c"]["d"], np.ndarray) and res["e"] == "gnmgp"


# ---------------------------------------------------------------------------
# The whole slice: run_subject against JAX, then serve what it wrote
# ---------------------------------------------------------------------------

N_SUBJECT, N_OPT = 40, 15


@pytest.fixture(scope="module")
def subject():
    return _sim(N_SUBJECT, key=3)


@pytest.fixture(scope="module", params=[0.0, 0.25], ids=["full", "test_size=0.25"])
def runs(request, subject, tmp_path_factory):
    """The JAX and the port's run_subject on one subject (one JAX call per
    split); the port writes to a store."""
    x, y = subject
    ts = request.param
    mp = pytest.MonkeyPatch()
    try:
        jit_jax_stages(mp)
        want = jworkflows.run_subject(x, y, jworkflows.PipelineConfig(n_opt=N_OPT, test_size=ts))
    finally:
        mp.undo()
    root = str(tmp_path_factory.mktemp("store"))
    got = workflows.run_subject(x, y, workflows.PipelineConfig(n_opt=N_OPT, test_size=ts),
                                store=ArtifactStore(root), dataset="sim", device="cpu")
    return convert.result_to_numpy(want), convert.result_to_numpy(got), root, ts


def test_run_subject_matches_jax(runs):
    want, got, _, ts = runs
    assert got["map_init"] == want["map_init"]
    assert (got["n"], got["m"]) == (want["n"], want["m"])
    keys = ["map_vec", "target_hist", "deviance", "aic", "bic"]
    if ts > 0:
        keys += ["test_rmse", "test_lpd", "test_pmse"]
    for k in keys:
        w = np.asarray(want[k], float)
        np.testing.assert_allclose(np.asarray(got[k], float), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
    for f in ("mean", "std", "percentiles"):
        w = want["pred_grid"][f]
        np.testing.assert_allclose(got["pred_grid"][f], w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=f)
    np.testing.assert_allclose(got["grid"], want["grid"], rtol=1e-14)
    for f in ("tilde_l", "B", "R", "stds"):
        np.testing.assert_allclose(got["map_latents"][f], want["map_latents"][f], rtol=1e-6, atol=1e-9)
    for f in want["empirical"]:
        np.testing.assert_allclose(got["empirical"][f], want["empirical"][f], rtol=1e-12)


def test_run_subject_writes_and_resumes_its_store(runs, subject):
    _, got, root, ts = runs
    store = ArtifactStore(root)
    key = lambda stage: ArtifactStore.key("gnmgp", "sim", 0, stage)
    for stage in ("data", "map", "map_ckpt", "pred_grid") + (("scores",) if ts > 0 else ()):
        assert store.exists(key(stage)), stage
    np.testing.assert_array_equal(store.load(key("map"))["vec"], got["map_vec"])
    x, y = subject
    again = workflows.run_subject(x, y, workflows.PipelineConfig(n_opt=N_OPT, test_size=ts),
                                  store=store, dataset="sim", device="cpu")
    assert "map_init" not in again  # resumed from the stored MAP
    np.testing.assert_array_equal(again["map_vec"].numpy(), got["map_vec"])


def test_engine_serves_the_port_store(runs):
    _, got, root, _ = runs
    engine = PredictEngine(root, dataset="sim", device="cpu")
    assert engine.subject_ids() == ["0"]
    grid = got["grid"]
    out = engine.predict("0", grid)
    np.testing.assert_allclose(out["mean"], got["pred_grid"]["mean"], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out["std"], got["pred_grid"]["std"], rtol=1e-10)


def test_run_subject_without_device_raises_when_cuda_is_absent(subject, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workflows.run_subject(*subject, workflows.PipelineConfig(n_opt=1))


@pytest.mark.parametrize("field,value", [
    ("model", "gnmgp_hetero_sparse_hadamard"), ("sampler", "rmhmc"),
    # SMC runs; its pathfinder reference is what stays refused (the case keeps its id)
    pytest.param("smc_ref", "pathfinder", id="sampler-smc"), ("sampler", "pathfinder"), ("map_method", "sgd")])
def test_pipeline_config_refuses_what_is_not_ported(field, value):
    with pytest.raises(ValueError, match="not yet ported|unknown model|map_method"):
        workflows.PipelineConfig(**{field: value})


def test_pipeline_config_says_why_rmhmc_is_refused():
    with pytest.raises(ValueError, match="second- and third-order derivatives of K1 and K3"):
        workflows.PipelineConfig(sampler="rmhmc")


@pytest.mark.parametrize("sampler", ["hmc", "nuts", "drhmc", "chees", "smc"])
def test_pipeline_config_takes_the_ported_samplers(sampler):
    cfg = workflows.PipelineConfig(sampler=sampler)
    assert (cfg.dr_stages, cfg.dr_reduction, cfg.n_chains) == (3, 4.0, 2)
