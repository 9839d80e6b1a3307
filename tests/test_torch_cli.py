"""The port's single-subject CLI (``…_torch.examples.run_sim_pipeline``) and
its figures, on the CPU.

The CLI is ``run_subject`` plus I/O, so its summary is held, exactly, to
the port's ``run_subject`` on the same data and config (which
``test_torch_train.py`` holds against JAX).
"""

import dataclasses
import json
import pickle
import zlib

import numpy as np
import pytest
import torch

from nonstationary_multivariate_gaussian_process_tpu_torch import viz, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.data import io as data_io
from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline as cli

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

N, N_OPT, N_HMC = 24, 4, 4
ARGS = ["--n", str(N), "--n-opt", str(N_OPT), "--n-hmc", str(N_HMC)]
PNG = b"\x89PNG\r\n\x1a\n"


def _expected_summary(x, y, seed=0):
    cfg = workflows.PipelineConfig(
        n_opt=N_OPT, do_hmc=True, n_hmc=N_HMC, test_size=0.25, seed=seed,
        hyper={"alpha_tilde_l": 10.0, "beta_tilde_l": 1.0, "alpha_L": 10.0, "beta_L": 1.0},
    )
    res = workflows.run_subject(x, y, cfg, dataset="sim", subject=seed, device="cpu")
    return {k: float(v) for k, v in res.items() if isinstance(v, (int, float)) and np.isfinite(v)}


def _check_outputs(out, summary, printed):
    for name in ("posterior.png", "target_trace.png"):
        assert (out / name).read_bytes()[:8] == PNG, name
    manifest = json.loads((out / "manifest.json").read_text())
    for stage in ("data", "map", "hmc", "pred_grid", "scores"):
        assert f"gnmgp__sim__0__{stage}" in manifest, stage
    assert json.loads(printed) == summary
    assert {"n", "m", "deviance", "aic", "bic", "dic", "hmc_accept", "test_rmse", "test_lpd"} <= set(summary)


def test_cli_on_simulated_data_matches_run_subject(tmp_path, capsys):
    out = tmp_path / "sim"
    summary = cli.main(ARGS + ["--out", str(out)], device="cpu")
    d = sim.sim_mnts(torch.Generator().manual_seed(0), n=N, device="cpu")
    _check_outputs(out, summary, capsys.readouterr().out)
    want = _expected_summary(d.x.numpy(), d.y.numpy())
    assert summary.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(summary[k], w, rtol=1e-10, err_msg=k)


def test_cli_on_a_sim_pickle_matches_run_subject(tmp_path, capsys):
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(size=N))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)], axis=1) + 0.1 * rng.normal(size=(N, 2))
    path = tmp_path / "subject.pickle"
    # the reference's layout [x, l, L_vecs, sigma2_err, Y], tensors as it writes them
    with open(path, "wb") as f:
        pickle.dump([torch.tensor(x), np.ones(N), np.ones(3 * N), 1e-2, torch.tensor(y)], f)
    loaded = data_io.load_sim_pickle(str(path))
    assert isinstance(loaded["x"], np.ndarray) and loaded["sigma2_err"] == 1e-2
    np.testing.assert_array_equal(loaded["y"], y)
    out = tmp_path / "pickle"
    summary = cli.main(ARGS + ["--data", str(path), "--out", str(out)], device="cpu")
    _check_outputs(out, summary, capsys.readouterr().out)
    want = _expected_summary(x, y)
    for k, w in want.items():
        np.testing.assert_allclose(summary[k], w, rtol=1e-10, err_msg=k)


@pytest.mark.parametrize("flag,value,rest", [
    # every model is ported: the sparse tiers' cases refuse the samplers that are not;
    # SMC runs, its pathfinder reference does not
    ("--model", "snmgp_sparse", ["--sampler", "pathfinder"]), ("--model", "gnmgp_hetero_sparse", ["--sampler", "rmhmc"]),
    ("--sampler", "rmhmc", []), ("--sampler", "smc", ["--smc-ref", "pathfinder"]),
], ids=["--model-snmgp_sparse", "--model-gnmgp_hetero_sparse", "--sampler-rmhmc", "--sampler-smc"])
def test_cli_refuses_what_is_not_ported(tmp_path, capsys, flag, value, rest):
    with pytest.raises(SystemExit) as ei:
        cli.main(ARGS + [flag, value, *rest, "--out", str(tmp_path)], device="cpu")
    assert ei.value.code != 0
    assert "not yet ported" in capsys.readouterr().err


def test_cli_runs_whitened_nuts(tmp_path, capsys, monkeypatch):
    """``--sampler nuts --whiten prior`` reach ``run_subject`` as JAX's CLI
    passes them: warmup 0, which ``run_subject`` takes as max(100, n_hmc)
    (the CLI has no warmup flag).  The run itself takes 2 warmup draws, to
    stay short."""
    seen = []
    real = workflows.run_subject

    def spy(x, y, cfg, **kw):
        seen.append(cfg)
        return real(x, y, dataclasses.replace(cfg, hmc_warmup=2), **kw)

    monkeypatch.setattr(workflows, "run_subject", spy)
    out = tmp_path / "nuts"
    summary = cli.main(["--n", "16", "--n-opt", "2", "--n-hmc", "1", "--hmc-step-size", "1.0", "--sampler", "nuts",
                        "--whiten", "prior", "--out", str(out)], device="cpu")
    (cfg,) = seen
    assert (cfg.sampler, cfg.whiten, cfg.hmc_warmup, cfg.n_hmc) == ("nuts", "prior", 0, 1)
    assert 0.0 < summary["hmc_accept"] <= 1.0 and "dic" in summary
    assert json.loads(capsys.readouterr().out) == summary
    assert (out / "posterior.png").read_bytes()[:8] == PNG


@pytest.mark.parametrize("sampler", ["drhmc", "chees"])
def test_cli_runs_the_other_samplers(tmp_path, capsys, monkeypatch, sampler):
    """``--sampler drhmc|chees`` reach ``run_subject`` (2 warmup draws here);
    ChEES's pooled record lands in the store as the ``sampling`` artifact."""
    seen = []
    real = workflows.run_subject

    def spy(x, y, cfg, **kw):
        seen.append(cfg)
        return real(x, y, dataclasses.replace(cfg, hmc_warmup=2), **kw)

    monkeypatch.setattr(workflows, "run_subject", spy)
    out = tmp_path / sampler
    summary = cli.main(["--n", "16", "--n-opt", "2", "--n-hmc", "2", "--hmc-step-size", "0.01", "--sampler", sampler,
                        "--out", str(out)], device="cpu")
    (cfg,) = seen
    assert cfg.sampler == sampler and 0.0 <= summary["hmc_accept"] <= 1.0 and "dic" in summary
    assert json.loads(capsys.readouterr().out) == summary
    manifest = json.loads((out / "manifest.json").read_text())
    assert any(k.endswith("__sampling") for k in manifest) == (sampler == "chees")


def test_cli_without_device_raises_when_cuda_is_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(ARGS + ["--out", str(tmp_path)])


def _png_size(path):
    raw = path.read_bytes()
    assert raw[:8] == PNG and raw[12:16] == b"IHDR"
    return int.from_bytes(raw[16:20], "big"), int.from_bytes(raw[20:24], "big")


@pytest.mark.parametrize("renderer", ["matplotlib", "raster"])
def test_figures_are_written_with_and_without_matplotlib(tmp_path, monkeypatch, renderer):
    if renderer == "raster":
        monkeypatch.setattr(viz, "plt", None)
    rng = np.random.default_rng(0)
    grid = np.linspace(0.0, 1.0, 50)
    mean = np.stack([np.sin(6 * grid), np.cos(3 * grid), grid], axis=1)
    pct = np.stack([mean - 0.3, mean, mean + 0.3], axis=1)  # (G, 3, M)
    x = np.sort(rng.uniform(size=12))
    viz.plot_posterior(tmp_path / "post.png", grid, pct, x=x, y=rng.normal(size=(12, 3)),
                       x_test=x[:3], y_test=rng.normal(size=(3, 3)))
    viz.plot_target_trace(tmp_path / "trace.png", np.cumsum(rng.normal(size=40)))
    (pw, ph), (tw, th) = _png_size(tmp_path / "post.png"), _png_size(tmp_path / "trace.png")
    assert min(pw, ph, tw, th) > 0
    if renderer == "raster":
        assert (pw, ph) == (viz._Raster.W, 3 * viz._Raster.H) and (tw, th) == (viz._Raster.W, viz._Raster.H)
        raw = (tmp_path / "post.png").read_bytes()
        idat = raw[raw.index(b"IDAT") + 4 : raw.index(b"IEND") - 8]
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(ph, 1 + 3 * pw)
        assert (rows[:, 0] == 0).all()  # filter byte: none
        pixels = rows[:, 1:].reshape(ph, pw, 3)
        for color in ((255, 128, 128), (0, 0, 255), (0, 0, 0), (0, 128, 0)):  # band, mean, train, test
            assert (pixels == color).all(axis=-1).any(), color
