"""``run_subject(model=m)`` for the sparse SNMGP, LMC and heteroscedastic
GNMGP against the JAX package on the CPU, in float64, and the port's engine
and CLI on their stores.

One JAX run per model in a module fixture: its result, its store and the
key its chain drew from.  The port's run takes the same subject and config,
and its HMC stage replays JAX's keys (``split(key, n)``, then a normal and a
uniform per draw) as ``noise=``; every other stage is deterministic.  The
MAP takes Adam (JAX compiles its L-BFGS program for 5-14 s a model).  Only
the LMC run samples: the SNMGP and hetero runs stop at the MAP, its
predictions and scores, since their chain, DIC and LOO stages are the code
the LMC run takes with their own Woodbury factors, whose LOO conditionals
``test_torch_sparse_separable.py`` and ``test_torch_sparse_hetero.py`` hold
to JAX's (JAX's chain and DIC cost another 9-14 s of compiling a model).
No test split either: the held-out scores take JAX's predictor once more
(2-5 s a model), and the CLI cases below score one.

Tolerances.  The port builds its own ops (its kriging projections agree
with JAX's to ~1e-8 of their scale), so the MAP, the chain and every score
are held at rtol 1e-6 with, for vectors, a floor of 1e-6 of their largest
|entry|.  The engine is held to the port's own predictors on the same padded
grid (rtol 1e-10).
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
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse, lmc_sparse, snmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp_sparse as pred_gs
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import lmc_sparse as pred_ls
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import snmgp_sparse as pred_ss
from nonstationary_multivariate_gaussian_process_tpu_torch.serving import engine
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_hmc import jax_noise, jax_sim, jit_jax_stages

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

N, M_Z = 40, 8
MODELS = ("snmgp_sparse", "lmc_sparse", "gnmgp_hetero_sparse")
CFG = dict(n_inducing=M_Z, n_opt=10, map_method="adam", do_hmc=True, do_loo=True, n_hmc=4, hmc_leapfrog=3,
           test_size=0.0, n_grid=21)
#: The model whose run_subject here samples (see the module docstring).
CHAINED = ("lmc_sparse",)
RTOL = 1e-6
SCALARS = ("deviance", "aic", "bic", "dic", "hmc_accept")
LOO_KEYS = ("elpd_loo", "p_loo", "looic", "k_hat_max", "elpd_waic", "p_waic", "waic")
#: Each model's packed length at m_z inducing inputs and M = 2 tasks.
N_PARAMS = {"snmgp_sparse": snmgp_sparse.n_params(M_Z, 2), "lmc_sparse": lmc_sparse.n_params(2),
            "gnmgp_hetero_sparse": gnmgp_sparse.n_params_hetero(M_Z, 2)}


def _close(got, want, err_msg=""):
    want = np.asarray(want, float)
    np.testing.assert_allclose(np.asarray(got, float), want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module", params=MODELS)
def runs(request, tmp_path_factory):
    """JAX's run_subject into a store, and the port's on the same subject
    with JAX's chain noise, into another (the hetero model on a
    ``sim_mnts_hetero`` subject, as the CLIs draw it)."""
    from nonstationary_multivariate_gaussian_process_tpu.data import sim as jsim

    model = request.param
    d = (jsim.sim_mnts_hetero(jax.random.PRNGKey(4), n=N) if model == "gnmgp_hetero_sparse"
         else jax_sim(jax.random.PRNGKey(3), n=N))
    x, y = np.asarray(d.x), np.asarray(d.y)
    cfg = dict(CFG, model=model, do_hmc=model in CHAINED)
    jroot = str(tmp_path_factory.mktemp("jax_" + model))
    mp = pytest.MonkeyPatch()
    try:
        jit_jax_stages(mp, model)
        want = convert.result_to_numpy(jworkflows.run_subject(x, y, jworkflows.PipelineConfig(**cfg),
                                                              store=JaxStore(jroot), dataset="sim"))
    finally:
        mp.undo()
    key = jax.random.PRNGKey(0)  # JAX's HMC stage draws from PRNGKey(cfg.seed)
    sample = hmc.hmc_sample

    def jax_keyed(pot, q0, n, generator, **kw):
        return sample(pot, q0, n, noise=jax_noise(key, n + kw.get("n_warmup", 0), q0.shape[0]), **kw)

    root = str(tmp_path_factory.mktemp("port_" + model))
    mp.setattr(hmc, "hmc_sample", jax_keyed)
    try:
        got = workflows.run_subject(x, y, workflows.PipelineConfig(**cfg), store=ArtifactStore(root), dataset="sim",
                                    device="cpu")
    finally:
        mp.undo()
    return model, want, convert.result_to_numpy(got), (x, y), jroot, root


def test_run_subject_returns_jaxs_keys(runs):
    model, want, got, *_ = runs
    assert got.keys() == want.keys()
    assert got["n_inducing"] == want["n_inducing"] == (M_Z if model != "lmc_sparse" else want["n_inducing"])
    assert got["sparse_approx"] == want["sparse_approx"] == "fitc"
    assert got["map_init"] == want["map_init"] == "empirical"
    assert got["map_vec"].shape == (N_PARAMS[model],)


def test_map_and_scores_match_jax(runs):
    model, want, got, *_ = runs
    for k in ("map_vec", "target_hist"):
        _close(got[k], want[k], err_msg=k)
    for k in SCALARS if model in CHAINED else ("deviance", "aic", "bic"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def test_chain_with_jaxs_noise_matches_jax(runs):
    model, want, got, *_ = runs
    if model not in CHAINED:
        assert "hmc_samples" not in got and "hmc_samples" not in want and "loo" not in got
        return
    assert got["hmc_samples"].shape == want["hmc_samples"].shape == (CFG["n_hmc"], N_PARAMS[model])
    _close(got["hmc_samples"], want["hmc_samples"], err_msg="hmc_samples")
    assert len(np.unique(got["hmc_samples"], axis=0)) > 1  # the chain moved


def test_loo_and_predictions_match_jax(runs):
    model, want, got, *_ = runs
    if model in CHAINED:
        for k in LOO_KEYS:
            np.testing.assert_allclose(got["loo"][k], want["loo"][k], rtol=RTOL, err_msg=k)
        assert got["loo"]["n_bad_k"] == want["loo"]["n_bad_k"]
        _close(got["loo"]["pointwise"], want["loo"]["pointwise"])
    assert got["pred_grid"].keys() == want["pred_grid"].keys()
    for f, w in want["pred_grid"].items():
        _close(got["pred_grid"][f], w, err_msg=f"pred_grid {f}")


def test_store_keeps_the_inducing_inputs_as_jax_does(runs):
    model, _, _, _, jroot, root = runs
    key = ArtifactStore.key(model, "sim", 0, "map")
    stored, jstored = ArtifactStore(root).load(key), JaxStore(jroot).load(key)
    assert set(stored) == set(jstored) == {"vec", "target_hist", "z", "approx"}
    np.testing.assert_array_equal(stored["z"], jstored["z"])
    assert set(ArtifactStore(root)._load_manifest()) == set(JaxStore(jroot)._load_manifest())


def _ops(model, x, z):
    return {"snmgp_sparse": snmgp_sparse.make_ops, "lmc_sparse": lmc_sparse.make_ops,
            "gnmgp_hetero_sparse": gnmgp_sparse.make_ops_hetero}[model](x, z)


def test_engine_serves_the_stored_map_and_chain(runs, tmp_path):
    """``mode="map"`` is the model's predictor on the stored Z; ``mode="sample"``
    the chain predictor with the engine's generator (for the SNMGP, whose run
    here did not sample, over a chain written beside a copy of its store),
    except for the hetero model, which serves the MAP only and refuses a
    sample request before it looks for a chain, as JAX's engine does."""
    import shutil

    model, _, got, _, _, root = runs
    if model == "snmgp_sparse":
        root = shutil.copytree(root, tmp_path / "store")
        chain = got["map_vec"] + 0.01 * np.random.default_rng(2).normal(size=(4, got["map_vec"].size))
        ArtifactStore(str(root)).save(ArtifactStore.key(model, "sim", 0, "hmc"), samples=chain)
        got = dict(got, hmc_samples=chain)
    eng = engine.PredictEngine(str(root), model=model, seed=0, device="cpu")
    assert eng.subject_ids() == ["0"]
    xs = np.linspace(0.05, 0.95, 13)
    grid = np.concatenate([xs, np.full(engine._bucket(13) - 13, xs[-1])])  # the engine pads to its bucket
    store = ArtifactStore(str(root))
    arrays = store.load(ArtifactStore.key(model, "sim", 0, "data"))  # the training split
    data = FullData(torch.tensor(arrays["x"]), torch.tensor(arrays["y"]))
    ops = _ops(model, data.x, torch.tensor(store.load(ArtifactStore.key(model, "sim", 0, "map"))["z"]))
    out = eng.predict("0", xs, mode="map")
    predict_map = {"snmgp_sparse": pred_ss.predict_map, "lmc_sparse": pred_ls.predict_map,
                   "gnmgp_hetero_sparse": pred_gs.predict_map_hetero}[model]
    want = predict_map(got["map_vec"], data, ops, grid, device="cpu")
    np.testing.assert_allclose(out["mean"], want.mean[:13].numpy(), rtol=1e-10)
    np.testing.assert_allclose(out["upper"], want.percentiles[:13, 2].numpy(), rtol=1e-10)
    if model == "gnmgp_hetero_sparse":
        with pytest.raises(ValueError, match="serves mode='map' only"):
            eng.predict("0", xs, mode="sample", n_sample=3)
        return
    out = eng.predict("0", xs, mode="sample", n_sample=3)
    pred = pred_ss if model == "snmgp_sparse" else pred_ls
    draws = pred.predict_sample(torch.Generator().manual_seed(0), got["hmc_samples"][-3:], data, ops, grid,
                                device="cpu")[:13]
    np.testing.assert_allclose(out["mean"], draws.mean(dim=1).numpy(), rtol=1e-10)
    assert out["lower"].shape == (13, 2) and np.isfinite(out["std"]).all()


@pytest.mark.parametrize("model", ["snmgp_sparse", "gnmgp_hetero_sparse"])
def test_cli_runs_the_model(tmp_path, capsys, monkeypatch, model):
    monkeypatch.setattr(viz, "plt", None)  # the plain-raster route, as on the card's machine
    summary = cli.main(["--model", model, "--n", "24", "--n-inducing", "6", "--sparse-approx", "vfe", "--n-opt", "3",
                        "--n-hmc", "2", "--out", str(tmp_path)], device="cpu")
    assert summary["n_inducing"] == 6
    assert all(np.isfinite(summary[k]) for k in ("deviance", "aic", "bic", "dic", "test_rmse", "test_lpd"))
    stored = ArtifactStore(str(tmp_path)).load(ArtifactStore.key(model, "sim", 0, "map"))
    assert stored["z"].shape == (6,) and str(stored["approx"]) == "vfe"
    assert (tmp_path / "posterior.png").read_bytes()[:4] == b"\x89PNG"
