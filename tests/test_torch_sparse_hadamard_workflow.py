"""``run_subject_hadamard`` for the sparse models (``gnmgp_sparse``,
``snmgp_sparse``, ``lmc_sparse``) against the JAX package's on the CPU, in
float64, on a subject with channels missing at random: the split, the sort,
the inducing inputs (two of the ``n_inducing`` quantiles fall on one time,
so fewer come back and the vector is sized by them), MAP, the grid
prediction, LOO over a chain and the held-out scores by the MAP and by the
chain; and the ``*_hadamard`` predictors and the LOO conditionals on the
inputs JAX's run gave its own.

One JAX run per model in a module fixture.  The two packages cannot share a
PRNG, so the port runs with JAX's start ``v0`` (``workflows.
_hadamard_start``), the same chain (``workflows._run_chain``, in both runs a
fixed set of draws near the MAP: the sampler is held against JAX's in its
own tests) and the normals JAX draws for the chain-sample scores.  The JAX
run takes Adam, and its MAP objective and predictors run ``jax.jit``ted (op
by op they take seconds each).

Tolerances.  The MAP follows JAX's iterate by iterate, so the MAP vector,
the optimizer history and the scores are held at rtol 1e-6 (each package
kriges with its own projection, ~1e-8 apart); the predictions at rtol 1e-6
with a floor of 1e-6 of the scale; the LOO conditionals at rtol 1e-8.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_sparse as jg
from nonstationary_multivariate_gaussian_process_tpu.models.base import HadamardData as JHadamardData
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import whiten
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import as_hadamard_data

from test_torch_hadamard_models import hadamard_subject
from test_torch_hadamard_predict import close, jax_noise
from test_torch_hmc import jit_jax_map

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

M = 2
MODELS = ("gnmgp_sparse", "snmgp_sparse", "lmc_sparse")
CFG = dict(n_inducing=16, n_opt=10, map_method="adam", test_size=0.25, do_hmc=True, n_hmc=3, do_loo=True,
           loo_draws=3, n_grid=21)
SCORES = ("test_rmse", "test_lpd", "test_sample_rmse", "test_sample_lpd")
LOO_KEYS = ("elpd_loo", "p_loo", "looic", "k_hat_max", "elpd_waic", "p_waic", "waic")
OPS_FROM_JAX = {"gnmgp_sparse": convert.sparse_ops_from_jax, "snmgp_sparse": convert.snmgp_sparse_ops_from_jax,
                "lmc_sparse": convert.lmc_sparse_ops_from_jax}


@pytest.fixture(scope="module")
def subject():
    return hadamard_subject(28, M, seed=21)


def sample_noise(model: str, key, s: int, g: int):
    """The standard normals JAX's ``predict_test_hadamard_sample`` draws from
    ``key`` over ``s`` draws at ``g`` test points, in the port's ``noise=``
    layout: the GNMGP tier's are its grid sampler's ``split(k, 3)``, the
    separable tiers' one (G,) normal a draw."""
    if model == "gnmgp_sparse":
        return jax_noise("gnmgp", key, s, g, M)
    return np.stack([np.asarray(jax.random.normal(k, (g,), jnp.float64)) for k in jax.random.split(key, s)])


def _chain(vec, cfg):
    """The chain both runs take: draws near the MAP."""
    rng = np.random.default_rng(5)
    return np.asarray(vec) + 0.02 * rng.normal(size=(cfg.n_hmc, np.asarray(vec).shape[0]))


def _record_jax_stages(mp, model: str, calls: dict):
    """Put JAX's run on Adam with a jitted objective, its chain in place of
    its sampler, and its predictors jitted with their inputs and outputs
    recorded in ``calls``."""
    pred = jworkflows._PREDICT[model]
    fns = {k: getattr(pred, k) for k in ("predict_map_hadamard", "predict_test_hadamard",
                                         "predict_test_hadamard_sample")}
    jit_jax_map(mp)
    mp.setattr(jworkflows, "_run_chain", lambda nlp, vec, cfg, key, whitener=None: (
        jnp.asarray(_chain(vec, cfg)), 0.5))

    # the kriging projections are built on the host: the inputs stay concrete
    def grid_map(vec, data, ops, m, grid, **kw):
        out = jax.jit(lambda v: fns["predict_map_hadamard"](v, data, ops, m, grid, **kw))(vec)
        calls["map"] = ((vec, data, ops, grid), out)
        return out

    def test_map(vec, data, ops, m, x_test, indx_test, **kw):
        out = jax.jit(lambda v: fns["predict_test_hadamard"](v, data, ops, m, x_test, indx_test, **kw))(vec)
        calls["test"] = ((vec, data, ops, x_test, indx_test), out)
        return out

    def test_sample(key, hist, data, ops, m, x_test, indx_test, **kw):
        out = jax.jit(lambda k, h: fns["predict_test_hadamard_sample"](k, h, data, ops, m, x_test, indx_test, **kw))(
            key, hist)
        calls["sample"] = ((key, hist, data, ops, x_test, indx_test), out)
        return out

    loo = jevaluate.chain_conditional_loglik_sparse_hadamard

    def recorded_loo(*args, **kwargs):
        out = loo(*args, **kwargs)
        calls["loo"] = (args, out)
        return out

    mp.setattr(pred, "predict_map_hadamard", grid_map)
    mp.setattr(pred, "predict_test_hadamard", test_map)
    mp.setattr(pred, "predict_test_hadamard_sample", test_sample)
    mp.setattr(jevaluate, "chain_conditional_loglik_sparse_hadamard", recorded_loo)


@pytest.fixture(scope="module", params=MODELS)
def runs(request, subject):
    """JAX's run_subject_hadamard with its stages recorded, and the port's on
    the same subject with JAX's start, the same chain and JAX's noise."""
    model = request.param
    x, indx, y = subject
    calls: dict = {}
    mp = pytest.MonkeyPatch()
    try:
        _record_jax_stages(mp, model, calls)
        want = jworkflows.run_subject_hadamard(x, indx, y, M, jworkflows.PipelineConfig(model=model, **CFG))
    finally:
        mp.undo()
    key = jax.random.PRNGKey(0)  # JAX's default key for seed 0
    m_z = calls["map"][0][2].z.shape[0]
    v0 = 0.1 * jax.random.normal(key, (workflows.n_params(model, m_z, M),), jnp.float64)
    v0 = np.array(v0.at[-1].set(-2.0))
    pred = workflows._PREDICT[model]
    sampler = pred.predict_test_hadamard_sample

    def with_jax_noise(generator, hist, data, ops, m, x_test, indx_test, **kw):
        noise = sample_noise(model, jax.random.fold_in(key, 9), hist.shape[0], x_test.shape[0])
        return sampler(None, hist, data, ops, m, x_test, indx_test, noise=noise, **kw)

    mp.setattr(workflows, "_hadamard_start", lambda seed, dim, device, dtype: torch.as_tensor(v0, dtype=dtype))
    mp.setattr(workflows, "_run_chain", lambda nlp, v, cfg, gen, whitener=None: (
        torch.as_tensor(_chain(v.detach(), cfg), dtype=v.dtype), 0.5))
    mp.setattr(pred, "predict_test_hadamard_sample", with_jax_noise)
    try:
        got = workflows.run_subject_hadamard(x, indx, y, M, workflows.PipelineConfig(model=model, **CFG),
                                             device="cpu")
    finally:
        mp.undo()
    return model, want, got, calls


def _port_data(data):
    return as_hadamard_data(*map(np.asarray, data), device="cpu")


def test_run_subject_hadamard_matches_jax(runs):
    model, want, got, calls = runs
    assert set(got) == set(want) | {"timings"}
    assert (got["n"], got["m"]) == (want["n"], want["m"])
    m_z = calls["map"][0][2].z.shape[0]
    assert m_z < CFG["n_inducing"]  # two quantiles fell on one time
    assert got["map_vec"].shape == (workflows.n_params(model, m_z, M),)
    close(got["map_vec"].numpy(), want["map_vec"], err_msg="map_vec")
    close(got["target_hist"], want["target_hist"], err_msg="target_hist")
    np.testing.assert_allclose(got["grid"], want["grid"], rtol=1e-12)
    for f in ("percentiles", "mean", "std"):
        assert getattr(got["pred_grid"], f).shape == getattr(want["pred_grid"], f).shape
        close(getattr(got["pred_grid"], f).numpy(), getattr(want["pred_grid"], f), err_msg=f)
    for k in SCORES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for k in LOO_KEYS:
        np.testing.assert_allclose(got["loo"][k], want["loo"][k], rtol=1e-6, err_msg=k)
    assert got["loo"]["n_bad_k"] == want["loo"]["n_bad_k"]
    assert set(got["timings"]) == {"map", "pred_grid", "hmc", "loo", "pred_test", "pred_test_sample"}


def test_map_predictors_match_jax_on_its_inputs(runs):
    model, _, _, calls = runs
    pred = workflows._PREDICT[model]
    (vec, data, ops, grid), want = calls["map"]
    ops = OPS_FROM_JAX[model](ops, device="cpu")
    got = pred.predict_map_hadamard(np.asarray(vec), _port_data(data), ops, M, np.asarray(grid), device="cpu")
    for f in ("percentiles", "mean", "std") + (("l_vecs",) if model == "gnmgp_sparse" else ()):
        close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    (vec, data, _, x_test, i_test), (mean, var) = calls["test"]
    got = pred.predict_test_hadamard(np.asarray(vec), _port_data(data), ops, M, np.asarray(x_test),
                                     np.asarray(i_test), device="cpu")
    assert got[0].shape == got[1].shape == (x_test.shape[0],)
    close(got[0].numpy(), mean, err_msg="test mean")
    close(got[1].numpy(), var, err_msg="test var")


def test_sample_predictor_matches_jax_given_its_noise(runs):
    model, _, _, calls = runs
    (key, hist, data, ops, x_test, i_test), want = calls["sample"]
    noise = sample_noise(model, key, hist.shape[0], x_test.shape[0])
    got = workflows._PREDICT[model].predict_test_hadamard_sample(
        None, np.asarray(hist), _port_data(data), OPS_FROM_JAX[model](ops, device="cpu"), M, np.asarray(x_test),
        np.asarray(i_test), device="cpu", noise=noise)
    assert got.shape == (x_test.shape[0], CFG["n_hmc"])
    close(got.numpy(), want)


def test_loo_conditionals_match_jax_on_its_chain(runs):
    model, _, _, calls = runs
    (hist, data, ops, _), want = calls["loo"]
    assert hist.shape[0] == CFG["loo_draws"]
    got = evaluate.chain_conditional_loglik_sparse_hadamard(hist, _port_data(data), OPS_FROM_JAX[model](ops, "cpu"),
                                                            M, model=model, device="cpu")
    close(got, want, rtol=1e-8)


def test_sampling_stage_whitens_at_the_inducing_inputs(monkeypatch, subject):
    """The port's own chain, whitened with the Hadamard priors at the Z that
    came back (x=Z, n=m_z), its draws of the vector's length."""
    calls = []
    make = whiten.make_whitener

    def spy(model, x, n, m, hyper, **kwargs):
        calls.append((model, x.clone(), n, kwargs.get("hadamard")))
        return make(model, x, n, m, hyper, **kwargs)

    monkeypatch.setattr(whiten, "make_whitener", spy)
    cfg = workflows.PipelineConfig(model="gnmgp_sparse", n_inducing=CFG["n_inducing"], n_opt=3, do_hmc=True,
                                   n_hmc=2, hmc_leapfrog=2, whiten="prior", n_grid=5, test_size=CFG["test_size"],
                                   do_pred_test=False)
    out = workflows.run_subject_hadamard(*subject, M, cfg, device="cpu")
    [(model, z, m_z, hadamard)] = calls
    assert (model, hadamard) == ("gnmgp", True) and m_z == z.shape[0] < CFG["n_inducing"]
    assert out["hmc_samples"].shape == (2, workflows.n_params("gnmgp_sparse", m_z, M))
    assert torch.isfinite(out["hmc_samples"]).all() and "loo" not in out and "test_rmse" not in out


def test_hetero_sparse_and_refinement_are_refused_as_in_jax(subject):
    cfg = workflows.PipelineConfig(model="gnmgp_hetero_sparse")
    with pytest.raises(ValueError) as got:
        workflows.run_subject_hadamard(*subject, M, cfg, device="cpu")
    with pytest.raises(ValueError) as want:
        jworkflows.run_subject_hadamard(*subject, M, jworkflows.PipelineConfig(model="gnmgp_hetero_sparse"))
    assert str(got.value) == str(want.value)
    # refinement itself runs in this layout now; the hetero tier's is refused with JAX's message
    assert workflows.PipelineConfig(model="gnmgp_sparse", refine_z=1).refine_z == 1
    z = np.linspace(0.1, 0.9, 4)
    with pytest.raises(ValueError) as got:
        gnmgp_sparse.refine_inducing(as_hadamard_data(*subject, device="cpu"), z, np.zeros(11), m=M,
                                     model="gnmgp_hetero_sparse")
    with pytest.raises(ValueError) as want:
        jg.refine_inducing(JHadamardData(*(np.asarray(a) for a in subject)), z, np.zeros(11), m=M,
                           model="gnmgp_hetero_sparse")
    assert str(got.value) == str(want.value)
