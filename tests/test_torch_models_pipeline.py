"""``run_subject``, the engine and the CLI for the LMC, SNMGP and
heteroscedastic GNMGP models, against the JAX package on the CPU, in float64.

For each model the JAX package's ``run_subject`` (MAP, a short HMC chain,
grid and held-out prediction, the scores, DIC and LOO) writes a store; the
port's ``run_subject`` runs on the same data with JAX's chain in place of
its own, since the two packages cannot share a PRNG
(``test_torch_hmc.py`` holds the sampler against JAX given JAX's noise).
The port's engine then serves the JAX store, and the port's CLI runs each
model on its own.

Tolerances.  The MAP follows JAX's iterate by iterate (L-BFGS takes the same
host decisions in both), so the MAP vector, the optimizer history and the
scalar scores are held at rtol 1e-6; the grid prediction, and the served
answers, at rtol 1e-6 with a floor of 1e-6 of the scale (the kriging
solvers' spread, ``test_torch_predict.py``).
"""

import json

import numpy as np
import pytest
import torch
import jax

from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.data import sim as jsim
from nonstationary_multivariate_gaussian_process_tpu.serving import PredictEngine as JaxEngine
from nonstationary_multivariate_gaussian_process_tpu.utils.artifacts import ArtifactStore as JaxStore
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline as cli
from nonstationary_multivariate_gaussian_process_tpu_torch.serving import PredictEngine

from test_torch_hmc import jit_jax_stages

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

MODELS = ("lmc", "snmgp", "gnmgp_hetero")
N = 24
CFG = dict(n_opt=10, test_size=0.25, do_hmc=True, n_hmc=4, hmc_leapfrog=2, do_loo=True, loo_draws=3)
SCORES = ("deviance", "aic", "bic", "dic", "test_rmse", "test_lpd", "test_pmse")
LOO_KEYS = ("elpd_loo", "p_loo", "looic", "elpd_waic", "p_waic", "waic")


def _close(got, want, err_msg=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=err_msg)


@pytest.fixture(scope="module", params=MODELS)
def runs(request, tmp_path_factory):
    """JAX's run_subject into a store, and the port's on the same data with
    JAX's chain."""
    model = request.param
    gen = jsim.sim_mnts_hetero if model == "gnmgp_hetero" else jsim.sim_mnts
    d = jax.jit(lambda k: gen(k, n=N))(jax.random.PRNGKey(5))  # op by op: dozens of compiles
    x, y = np.asarray(d.x), np.asarray(d.y)
    jroot = str(tmp_path_factory.mktemp(f"jax_{model}"))
    mp = pytest.MonkeyPatch()
    try:
        jit_jax_stages(mp, model)
        want = jworkflows.run_subject(x, y, jworkflows.PipelineConfig(model=model, **CFG), store=JaxStore(jroot),
                                      dataset="sim")
    finally:
        mp.undo()
    chain = np.array(want["hmc_samples"])
    mp.setattr(workflows, "_run_chain",
               lambda nlp, v, cfg, gen, whitener=None: (torch.as_tensor(chain, dtype=v.dtype, device=v.device),
                                                        want["hmc_accept"]))
    try:
        got = workflows.run_subject(x, y, workflows.PipelineConfig(model=model, **CFG), dataset="sim", device="cpu")
    finally:
        mp.undo()
    return model, want, got, jroot


def test_run_subject_matches_jax(runs):
    model, want, got, _ = runs
    assert got["model"] == model and got["map_init"] == want["map_init"]
    assert got["map_vec"].shape == (workflows.n_params(model, got["n"], 2),)
    _close(got["map_vec"].numpy(), want["map_vec"], "map_vec")
    _close(got["target_hist"], want["target_hist"], "target_hist")
    for f in ("percentiles", "mean", "std"):
        _close(getattr(got["pred_grid"], f).numpy(), getattr(want["pred_grid"], f), f)
    if model == "gnmgp_hetero":
        _close(got["pred_grid"].noise_var.numpy(), want["pred_grid"].noise_var, "noise_var")
    np.testing.assert_allclose(got["grid"], want["grid"], rtol=1e-12)
    for k in SCORES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for k in LOO_KEYS:
        np.testing.assert_allclose(got["loo"][k], want["loo"][k], rtol=1e-6, err_msg=k)
    assert got["loo"]["n_bad_k"] == want["loo"]["n_bad_k"]
    # the GNMGP latent analysis is the GNMGP's alone
    assert "map_latents" not in got and "map_latents" not in want


def test_engine_serves_the_jax_store_as_jax_does(runs):
    model, _, _, jroot = runs
    eng = PredictEngine(jroot, model=model, device="cpu")
    assert eng.subject_ids() == ["0"]
    xs = np.linspace(0.05, 0.95, 11)
    got = eng.predict("0", xs)
    want = JaxEngine(jroot, model=model).predict("0", xs)
    for k in ("mean", "std", "lower", "upper"):
        assert got[k].shape == (11, 2)
        _close(got[k], want[k], k)
    sample = eng.predict("0", xs, mode="sample", n_sample=3)
    for k in ("mean", "std", "lower", "upper"):
        assert sample[k].shape == (11, 2) and np.isfinite(sample[k]).all(), k
    assert (sample["lower"] <= sample["upper"]).all()
    info = eng.info("0")
    assert info["model"] == model and info["has_chain"] and info["n_draws"] == CFG["n_hmc"]
    subj = convert.subject_from_store(jroot, "0", model, device="cpu")
    assert subj.vec.shape == (workflows.n_params(model, subj.data.x.shape[0], 2),)


@pytest.mark.parametrize("model", MODELS)
def test_cli_runs_each_model_as_run_subject_does(tmp_path, capsys, model):
    args = ["--model", model, "--n", str(N), "--n-opt", "4", "--n-hmc", "3", "--out", str(tmp_path)]
    summary = cli.main(args, device="cpu")
    assert json.loads(capsys.readouterr().out) == summary
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    for stage in ("data", "map", "hmc", "pred_grid", "scores"):
        assert f"{model}__sim__0__{stage}" in manifest, stage
    gen = sim.sim_mnts_hetero if model == "gnmgp_hetero" else sim.sim_mnts
    d = gen(torch.Generator().manual_seed(0), n=N, device="cpu")
    cfg = workflows.PipelineConfig(model=model, n_opt=4, do_hmc=True, n_hmc=3, test_size=0.25)
    res = workflows.run_subject(d.x.numpy(), d.y.numpy(), cfg, dataset="sim", device="cpu")
    want = {k: float(v) for k, v in res.items() if isinstance(v, (int, float)) and np.isfinite(v)}
    assert summary.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(summary[k], w, rtol=1e-10, err_msg=k)
