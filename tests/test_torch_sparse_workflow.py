"""``run_subject(model="gnmgp_sparse", do_hmc=True, do_loo=True)`` against the
JAX package on the CPU, in float64, and the port's engine and CLI on its
store.

One JAX run in the fixture: its result, its store and the key its chain
drew from.  The port's run takes the same subject and config, and its HMC
stage replays JAX's keys (``split(key, n)``, then a normal and a uniform
per draw) as ``noise=``; every other stage is deterministic.

Tolerances.  The port builds its own ``SparseOps`` (its kriging projections
agree with JAX's to ~1e-8 of their scale), so the MAP, the chain and every
score are held at rtol 1e-6 with, for vectors, a floor of 1e-6 of their
largest |entry|.  The engine is held to the port's own predictors on the
same padded grid (rtol 1e-10).
"""

import numpy as np
import pytest
import torch
import jax

from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.utils.artifacts import ArtifactStore as JaxStore
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, viz, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline as cli
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import hmc
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp_sparse as pred
from nonstationary_multivariate_gaussian_process_tpu_torch.serving import engine
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_hmc import jax_noise, jax_sim, jit_jax_stages

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each


T64 = torch.float64
N, M_Z = 40, 8
CFG = dict(model="gnmgp_sparse", n_inducing=M_Z, n_opt=20, do_hmc=True, do_loo=True, n_hmc=4, hmc_leapfrog=3,
           test_size=0.25, n_grid=21)
RTOL = 1e-6
SCALARS = ("deviance", "aic", "bic", "dic", "hmc_accept", "test_rmse", "test_lpd", "test_pmse")
LOO_KEYS = ("elpd_loo", "p_loo", "looic", "k_hat_max", "elpd_waic", "p_waic", "waic")


def _close(got, want, err_msg=""):
    want = np.asarray(want, float)
    np.testing.assert_allclose(np.asarray(got, float), want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's run_subject into a store, and the port's on the same subject
    with JAX's chain noise, into another."""
    d = jax_sim(jax.random.PRNGKey(3), n=N)
    x, y = np.asarray(d.x), np.asarray(d.y)
    jroot = str(tmp_path_factory.mktemp("jax_sparse"))
    mp = pytest.MonkeyPatch()
    try:
        jit_jax_stages(mp, "gnmgp_sparse")
        want = convert.result_to_numpy(jworkflows.run_subject(x, y, jworkflows.PipelineConfig(**CFG),
                                                              store=JaxStore(jroot), dataset="sim"))
    finally:
        mp.undo()
    key = jax.random.PRNGKey(0)  # JAX's HMC stage draws from PRNGKey(cfg.seed)
    sample = hmc.hmc_sample

    def jax_keyed(pot, q0, n, generator, **kw):
        return sample(pot, q0, n, noise=jax_noise(key, n + kw.get("n_warmup", 0), q0.shape[0]), **kw)

    root = str(tmp_path_factory.mktemp("port_sparse"))
    mp.setattr(hmc, "hmc_sample", jax_keyed)
    try:
        got = workflows.run_subject(x, y, workflows.PipelineConfig(**CFG), store=ArtifactStore(root), dataset="sim",
                                    device="cpu")
    finally:
        mp.undo()
    return want, convert.result_to_numpy(got), (x, y), jroot, root


def test_run_subject_returns_jaxs_keys(runs):
    want, got, *_ = runs
    assert got.keys() == want.keys()
    assert got["n_inducing"] == want["n_inducing"] == M_Z
    assert got["sparse_approx"] == want["sparse_approx"] == "fitc"
    assert got["map_init"] == want["map_init"] == "empirical"


def test_map_and_scores_match_jax(runs):
    want, got, *_ = runs
    for k in ("map_vec", "target_hist"):
        _close(got[k], want[k], err_msg=k)
    for k in SCALARS:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    for f in ("tilde_l", "B", "R", "stds", "inputs"):
        _close(got["map_latents"][f], want["map_latents"][f], err_msg=f)


def test_chain_with_jaxs_noise_matches_jax(runs):
    want, got, *_ = runs
    assert got["hmc_samples"].shape == want["hmc_samples"].shape == (CFG["n_hmc"], gnmgp_sparse.n_params(M_Z, 2))
    _close(got["hmc_samples"], want["hmc_samples"], err_msg="hmc_samples")
    assert len(np.unique(got["hmc_samples"], axis=0)) > 1  # the chain moved
    for f, w in want["latent_summary"].items():
        _close(got["latent_summary"][f], w, err_msg=f)


def test_loo_and_predictions_match_jax(runs):
    want, got, *_ = runs
    for k in LOO_KEYS:
        np.testing.assert_allclose(got["loo"][k], want["loo"][k], rtol=RTOL, err_msg=k)
    assert got["loo"]["n_bad_k"] == want["loo"]["n_bad_k"]
    _close(got["loo"]["pointwise"], want["loo"]["pointwise"])
    for stage in ("pred_grid", "pred_test"):
        for f, w in want[stage].items():
            _close(got[stage][f], w, err_msg=f"{stage} {f}")
    np.testing.assert_allclose(got["grid"], want["grid"], rtol=1e-12)


def test_store_keeps_the_inducing_inputs_as_jax_does(runs):
    *_, jroot, root = runs
    key = ArtifactStore.key("gnmgp_sparse", "sim", 0, "map")
    stored, jstored = ArtifactStore(root).load(key), JaxStore(jroot).load(key)
    assert set(stored) == set(jstored) == {"vec", "target_hist", "z", "approx"}
    np.testing.assert_array_equal(stored["z"], jstored["z"])
    assert str(stored["approx"]) == str(jstored["approx"]) == "fitc"
    assert set(ArtifactStore(root)._load_manifest()) == set(JaxStore(jroot)._load_manifest())


def test_run_subject_resumes_the_stored_map(runs):
    _, got, (x, y), _, root = runs
    again = workflows.run_subject(x, y, workflows.PipelineConfig(**{**CFG, "do_hmc": False}),
                                  store=ArtifactStore(root), dataset="sim", device="cpu")
    assert "map_init" not in again
    np.testing.assert_array_equal(again["map_vec"].numpy(), got["map_vec"])
    np.testing.assert_allclose(again["deviance"], got["deviance"], rtol=1e-12)


@pytest.fixture(scope="module")
def served(runs):
    _, got, (x, y), _, root = runs
    eng = engine.PredictEngine(root, model="gnmgp_sparse", seed=0, device="cpu")
    xs = np.linspace(float(x.min()), float(x.max()), 13)
    grid = np.concatenate([xs, np.full(engine._bucket(13) - 13, xs[-1])])  # the engine pads to its bucket
    arrays = ArtifactStore(root).load(ArtifactStore.key("gnmgp_sparse", "sim", 0, "data"))  # the training split
    data = FullData(torch.tensor(arrays["x"]), torch.tensor(arrays["y"]))
    assert data.x.shape == (got["n"],)
    return eng, xs, grid, data, got


def test_engine_map_answer_is_the_predictor_on_the_stored_z(served):
    eng, xs, grid, data, got = served
    assert eng.subject_ids() == ["0"]
    out = eng.predict("0", xs, mode="map")
    ops = gnmgp_sparse.make_ops(data.x, torch.tensor(got["map_latents"]["inputs"]))
    want = pred.predict_map(got["map_vec"], data, ops, grid, device="cpu")
    np.testing.assert_allclose(out["mean"], want.mean[:13].numpy(), rtol=1e-10)
    np.testing.assert_allclose(out["upper"], want.percentiles[:13, 2].numpy(), rtol=1e-10)
    assert out["mean"].shape == (13, 2)


def test_engine_sample_answer_is_the_predictor_over_the_chain(served):
    eng, xs, grid, data, got = served
    out = eng.predict("0", xs, mode="sample", n_sample=3)
    ops = gnmgp_sparse.make_ops(data.x, torch.tensor(got["map_latents"]["inputs"]))
    draws = pred.predict_sample(torch.Generator().manual_seed(0), got["hmc_samples"][-3:], data, ops, grid,
                                device="cpu")[:13]
    np.testing.assert_allclose(out["mean"], draws.mean(dim=1).numpy(), rtol=1e-10)
    assert out["lower"].shape == (13, 2) and np.isfinite(out["std"]).all()


def test_engine_refuses_a_sparse_map_without_its_inducing_inputs(runs, tmp_path):
    _, got, (x, y), *_ = runs
    store = ArtifactStore(str(tmp_path))
    store.save(ArtifactStore.key("gnmgp_sparse", "sim", 5, "data"), x=x, y=y)
    store.save(ArtifactStore.key("gnmgp_sparse", "sim", 5, "map"), vec=got["map_vec"])
    with pytest.raises(KeyError, match="inducing inputs"):
        engine.PredictEngine(str(tmp_path), model="gnmgp_sparse", device="cpu").predict("5", [0.5])


@pytest.mark.parametrize("approx", ["fitc", "vfe"])
def test_cli_runs_the_sparse_model(tmp_path, capsys, monkeypatch, approx):
    monkeypatch.setattr(viz, "plt", None)  # the plain-raster route, as on the card's machine
    out = tmp_path / approx
    summary = cli.main(["--model", "gnmgp_sparse", "--n", "24", "--n-inducing", "6", "--sparse-approx", approx,
                        "--n-opt", "4", "--n-hmc", "2", "--out", str(out)], device="cpu")
    assert summary["n_inducing"] == 6
    assert all(np.isfinite(summary[k]) for k in ("deviance", "aic", "bic", "dic", "test_rmse", "test_lpd"))
    stored = ArtifactStore(str(out)).load(ArtifactStore.key("gnmgp_sparse", "sim", 0, "map"))
    assert stored["z"].shape == (6,) and str(stored["approx"]) == approx
    assert (out / "posterior.png").read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("field,value,match", [
    ("model", "snmgp_sparse_hadamard", "unknown model"), ("model", "lmc_sparse_hadamard", "unknown model"),
    ("refine_z", 2, "K1 in the inputs"), ("sparse_approx", "dtc", "sparse_approx must be"),
])
def test_pipeline_config_refuses_the_rest_of_the_sparse_tier(field, value, match):
    with pytest.raises(ValueError, match=match):
        workflows.PipelineConfig(**{field: value})


def test_hadamard_layout_still_refuses_the_sparse_model():
    """The sparse hetero model has no Hadamard objective (in JAX neither);
    the other sparse models run there (``test_torch_sparse_hadamard_workflow.py``)."""
    x = np.linspace(0, 1, 12)
    with pytest.raises(ValueError, match="gnmgp_hetero_sparse has no Hadamard objective"):
        workflows.run_subject_hadamard(x, np.arange(12) % 2, np.sin(x), 2,
                                       workflows.PipelineConfig(model="gnmgp_hetero_sparse"), device="cpu")


def test_run_subject_reads_a_stored_map_at_its_own_inducing_inputs(runs, tmp_path):
    """A MAP stored with another inducing set (as a refined run writes it) is
    resumed at that set, never reinterpreted at the default quantile Z."""
    _, got, (x, y), _, root = runs
    store = ArtifactStore(str(tmp_path))
    src = ArtifactStore(root)
    for stage in ("data", "map"):
        arrays = src.load(ArtifactStore.key("gnmgp_sparse", "sim", 0, stage))
        if stage == "map":
            arrays["z"] = arrays["z"] + 0.01 * np.sin(np.arange(M_Z))  # moved inputs
        store.save(ArtifactStore.key("gnmgp_sparse", "sim", 0, stage), **arrays)
    moved = store.load(ArtifactStore.key("gnmgp_sparse", "sim", 0, "map"))["z"]
    again = workflows.run_subject(x, y, workflows.PipelineConfig(**{**CFG, "do_hmc": False}), store=store,
                                  dataset="sim", device="cpu")
    np.testing.assert_array_equal(again["map_latents"]["inputs"], moved)
    assert not np.allclose(again["deviance"], got["deviance"], rtol=1e-9)
