"""``run_subject_hadamard`` against the JAX package's on the CPU, in float64,
for LMC, SNMGP and GNMGP, on a subject with channels missing at random (so
tied times): the split, the sort, MAP, the grid prediction, a short HMC
chain, LOO and the held-out scores by the MAP and by the chain; and each
predictor of ``predict/hadamard.py`` and the LOO conditionals on the inputs
JAX's run gave its own.

The two packages cannot share a PRNG, so the port runs with JAX's start
``v0`` (``workflows._hadamard_start``), JAX's chain (``workflows._run_chain``)
and the normals JAX draws for the chain-sample scores
(``test_torch_hadamard_predict.jax_noise``) put in place of its own.

Tolerances.  The MAP follows JAX's iterate by iterate (L-BFGS takes the same
host decisions in both), so the MAP vector, the optimizer history and the
scores are held at rtol 1e-6; the predictions at rtol 1e-6 with a floor of
1e-6 of the scale (the kriging solves' spread); the LOO conditionals, a
factor and a solve against I, at rtol 1e-8.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.predict import hadamard as jpred_h
from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import whiten
from nonstationary_multivariate_gaussian_process_tpu_torch.models import as_hadamard_data
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import hadamard as pred_h

from test_torch_hadamard_models import hadamard_subject
from test_torch_hadamard_predict import NAME, close, jax_noise
from test_torch_hmc import jit_jax_map

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

M = 2
CFG = dict(n_opt=10, test_size=0.25, do_hmc=True, n_hmc=4, hmc_leapfrog=2, do_loo=True, loo_draws=3, n_grid=21)
SCORES = ("test_rmse", "test_lpd", "test_sample_rmse", "test_sample_lpd")
LOO_KEYS = ("elpd_loo", "p_loo", "looic", "k_hat_max", "elpd_waic", "p_waic", "waic")


@pytest.fixture(scope="module")
def subject():
    return hadamard_subject(22, M, seed=21)


def _record_jax_stages(mp, model: str, calls: dict):
    """Record the inputs and outputs of the prediction and LOO stages of
    JAX's run in ``calls``.  The MAP objective and the predictors run
    ``jax.jit``ted (op by op they cost seconds), the chain-sample predictor
    as JAX's ``predict_test_sample`` is: the grid draws of
    ``predict_sample``, then each point's own task."""
    name = NAME[model]
    jit_jax_map(mp)

    def spy(mod, fn, stage, jit=False):
        orig = getattr(mod, fn)

        def recorded(*args, **kwargs):
            if jit:  # the vector traced, the rest (the kriging's host inputs among them) closed over
                out = jax.jit(lambda v: orig(v, *args[1:], **kwargs))(args[0])
            else:
                out = orig(*args, **kwargs)
            calls.setdefault(stage, (args, out))  # the workflow's own call, not one inside another
            return out

        mp.setattr(mod, fn, recorded)

    spy(jpred_h, f"{name}_predict_map", "map", jit=True)
    spy(jpred_h, f"{name}_predict_test", "test", jit=True)
    spy(jevaluate, "chain_conditional_loglik_hadamard", "loo")
    sample = getattr(jpred_h, f"{name}_predict_sample")

    def test_sample(key, hist, data, x_test, indx_test, m, **kw):
        ys = jax.jit(lambda k, c, g: sample(k, c, data, g, m, **kw))(key, hist, x_test)
        calls["sample"] = ((key, hist, data, x_test), ys)
        return jpred_h._select_indexed(ys, indx_test)

    mp.setattr(jpred_h, f"{name}_predict_test_sample", test_sample)


@pytest.fixture(scope="module", params=("lmc", "snmgp", "gnmgp"))
def runs(request, subject):
    """JAX's run_subject_hadamard with its stages recorded, and the port's on
    the same subject with JAX's start, chain and noise."""
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
    n_train = x.shape[0] - int(round(x.shape[0] * CFG["test_size"]))
    v0 = 0.1 * jax.random.normal(key, (workflows.n_params(model, n_train, M),), jnp.float64)
    v0 = np.array(v0.at[-1].set(-2.0))
    chain = np.array(want["hmc_samples"])
    name = f"{NAME[model]}_predict_test_sample"
    sampler = getattr(pred_h, name)

    def with_jax_noise(generator, hist, data, x_test, indx_test, m, **kw):
        noise = jax_noise(model, jax.random.fold_in(key, 9), hist.shape[0], x_test.shape[0], m)
        return sampler(None, hist, data, x_test, indx_test, m, noise=noise, **kw)

    mp.setattr(workflows, "_hadamard_start", lambda seed, dim, device, dtype: torch.as_tensor(v0, dtype=dtype))
    mp.setattr(workflows, "_run_chain", lambda nlp, v, cfg, gen, whitener=None: (
        torch.as_tensor(chain, dtype=v.dtype, device=v.device), want["hmc_accept"]))
    mp.setattr(pred_h, name, with_jax_noise)
    try:
        got = workflows.run_subject_hadamard(x, indx, y, M, workflows.PipelineConfig(model=model, **CFG),
                                             device="cpu")
    finally:
        mp.undo()
    return model, want, got, calls


def test_run_subject_hadamard_matches_jax(runs):
    model, want, got, _ = runs
    assert set(got) == set(want) | {"timings"}
    assert (got["n"], got["m"]) == (want["n"], want["m"])
    assert got["map_vec"].shape == (workflows.n_params(model, got["n"], M),)
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
    """JAX's own calls in its run (un-jitted: the kriging solves on the host),
    replayed on the port."""
    model, _, _, calls = runs
    (vec, data, grid, _), want = calls["map"]
    data = as_hadamard_data(*map(np.asarray, data), device="cpu")
    got = getattr(pred_h, f"{NAME[model]}_predict_map")(np.asarray(vec), data, np.asarray(grid), M, device="cpu")
    for f in ("percentiles", "mean", "std"):
        close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    (vec, data, x_test, i_test, _), (mean, std) = calls["test"]
    data = as_hadamard_data(*map(np.asarray, data), device="cpu")
    got = getattr(pred_h, f"{NAME[model]}_predict_test")(np.asarray(vec), data, np.asarray(x_test),
                                                         np.asarray(i_test), M, device="cpu")
    close(got[0].numpy(), mean, err_msg="test mean")
    close(got[1].numpy(), std, err_msg="test std")


def test_sample_predictor_matches_jax_given_its_noise(runs):
    model, _, _, calls = runs
    (key, hist, data, x_test), want = calls["sample"]
    noise = jax_noise(model, key, hist.shape[0], x_test.shape[0], M)
    data = as_hadamard_data(*map(np.asarray, data), device="cpu")
    got = getattr(pred_h, f"{NAME[model]}_predict_sample")(None, np.asarray(hist), data,
                                                          np.asarray(x_test), M, device="cpu", noise=noise)
    assert got.shape == (x_test.shape[0], CFG["n_hmc"], M)
    close(got.numpy(), want)


def test_loo_conditionals_match_jax_on_its_chain(runs):
    model, _, _, calls = runs
    (_, hist, x, indx, y, _), want = calls["loo"]
    assert hist.shape[0] == CFG["loo_draws"]
    got = evaluate.chain_conditional_loglik_hadamard(model, hist, x, indx, y, M, device="cpu")
    close(got, want, rtol=1e-8)


def test_sampling_stage_whitens_with_the_hadamard_priors(monkeypatch, subject):
    """The port's own chain: drawn from its generator, whitened with the
    Hadamard objective's prior defaults."""
    calls = []
    make = whiten.make_whitener

    def spy(*args, **kwargs):
        calls.append(kwargs.get("hadamard"))
        return make(*args, **kwargs)

    monkeypatch.setattr(whiten, "make_whitener", spy)
    cfg = workflows.PipelineConfig(model="gnmgp", n_opt=3, do_hmc=True, n_hmc=2, hmc_leapfrog=2, whiten="prior",
                                   n_grid=5, do_pred_test=False)
    out = workflows.run_subject_hadamard(*subject, M, cfg, device="cpu")
    assert calls == [True]
    assert out["hmc_samples"].shape == (2, workflows.n_params("gnmgp", subject[0].shape[0], M))
    assert torch.isfinite(out["hmc_samples"]).all() and "loo" not in out and "test_rmse" not in out
