"""SMC in the port's pipeline on the CPU: ``run_subject(sampler="smc")``
(whitened GNMGP through the batched objective, SNMGP through the row route),
``run_subject_hadamard(sampler="smc")``, the engine's info endpoint, the
config's ``smc_*`` fields, and the CLI's ``--sampler smc``.

The runs are small (N=16, 32 particles, 2 sweeps of 3 leapfrog steps), so
they check the contract, not the posterior: shapes, finiteness, JAX's
``sampling`` keys, which route each objective takes, and that the store
serves the record.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu_torch import settings, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline as cli
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import smc
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp, snmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.serving.engine import PredictEngine
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

N = 16
SMALL = dict(do_hmc=True, sampler="smc", smc_particles=32, n_hmc=16, smc_mutations=2, smc_leapfrog=3, n_opt=20)
#: The keys of JAX's ``_run_chain_smc`` record with the prior reference.
SAMPLING_KEYS = {"sampler", "n_particles", "n_stages", "beta_final", "log_evidence", "final_accept", "step_size"}
SMC_FIELDS = ("smc_particles", "smc_mutations", "smc_leapfrog", "smc_cess", "smc_dr", "smc_polish",
              "smc_resample_ess", "smc_resample", "smc_ref", "smc_waste_free", "smc_metric")


def _subject(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=n))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)], axis=1) + 0.1 * rng.normal(size=(n, 2))
    return x, y


@pytest.fixture(scope="module")
def gnmgp_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("smc")
    x, y = _subject()
    cfg = workflows.PipelineConfig(whiten=True, do_loo=True, **SMALL)
    res = workflows.run_subject(x, y, cfg, store=ArtifactStore(str(root)), dataset="sim", device="cpu")
    return res, root


def test_config_takes_jax_smc_fields_and_defaults():
    ours, theirs = workflows.PipelineConfig(sampler="smc"), jworkflows.PipelineConfig(sampler="smc")
    assert {f: getattr(ours, f) for f in SMC_FIELDS} == {f: getattr(theirs, f) for f in SMC_FIELDS}
    assert "smc" in workflows.SAMPLERS and "smc" not in workflows.UNPORTED_SAMPLERS
    with pytest.raises(ValueError, match="unknown smc_ref"):
        workflows.PipelineConfig(smc_ref="bogus")


def test_run_subject_smc_contract(gnmgp_run):
    res, _ = gnmgp_run
    p = gnmgp.n_params(N, 2)
    samples = res["hmc_samples"]
    assert samples.shape == (16, p) and torch.isfinite(samples).all()
    s = res["sampling"]
    assert set(s) == SAMPLING_KEYS and s["sampler"] == "smc" and s["n_particles"] == 32
    assert s["beta_final"] == 1.0 and np.isfinite(s["log_evidence"]) and 0.0 < res["hmc_accept"] <= 1.0
    assert res["hmc_accept"] == s["final_accept"] and s["n_stages"] >= 1
    assert np.isfinite(res["loo"]["elpd_loo"]) and np.isfinite(res["dic"])
    assert res["latent_summary"].tilde_l_q.shape == (3, N)


def test_engine_info_serves_the_evidence(gnmgp_run):
    res, root = gnmgp_run
    info = PredictEngine(str(root), dataset="sim", device="cpu").info("0")
    assert info["sampling"]["sampler"] == "smc"
    np.testing.assert_allclose(info["sampling"]["log_evidence"], res["sampling"]["log_evidence"], rtol=1e-12)
    assert info["has_chain"] and info["n_draws"] == 16


def test_the_evidence_adds_the_whitener_logdet(monkeypatch):
    """Whitened, ``log_evidence`` is SMC's ``logz`` plus ``Whitener.logdet()``,
    and the samples are the first n_hmc particles mapped back."""
    x, y = _subject()
    data_x = torch.tensor(x)
    cfg = workflows.PipelineConfig(**SMALL)
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import whiten
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    w = whiten.make_whitener("gnmgp", data_x, N, 2)
    data = FullData(data_x, torch.tensor(y))
    nlp, nlp_b = gnmgp.make_objective(data), gnmgp.make_objective_batched(data)
    vec = torch.zeros(gnmgp.n_params(N, 2), dtype=torch.float64)
    samples, _, rec = workflows._run_chain_smc(nlp, vec, cfg, torch.Generator().manual_seed(0), whitener=w,
                                               nlp_batched=nlp_b)
    r = smc.smc_sample(w.wrap(nlp_b), w.n_params, torch.Generator().manual_seed(0), 32, n_mutations=2,
                       n_leapfrog=3, metric="full", potential_batched=True)
    np.testing.assert_allclose(rec["log_evidence"], float(r.logz) + float(w.logdet()), rtol=1e-12)
    assert torch.equal(samples, w.from_white_batch(r.particles)[:16])


@pytest.mark.parametrize("model,mixed,batched", [("gnmgp", False, True), ("gnmgp", True, False),
                                                 ("snmgp", False, False), ("gnmgp_hetero", False, False)])
def test_smc_route_by_objective(monkeypatch, model, mixed, batched):
    """The dense GNMGP's population is one batched evaluation; under mixed,
    and for every other objective, each particle is its own evaluation."""
    seen = []
    monkeypatch.setattr(settings, "mixed_solves", mixed)
    monkeypatch.setattr(smc, "smc_sample", lambda pot, dim, gen, n, **kw: seen.append(kw) or (_ for _ in ()).throw(
        RuntimeError("stop")))
    x, y = _subject()
    with pytest.raises(RuntimeError, match="stop"):
        workflows.run_subject(x, y, workflows.PipelineConfig(model=model, **{**SMALL, "n_opt": 2}), device="cpu")
    assert seen[0]["potential_batched"] is batched
    assert (seen[0]["n_mutations"], seen[0]["n_leapfrog"], seen[0]["metric"]) == (2, 3, "full")


def test_run_subject_snmgp_smc_row_route():
    x, y = _subject(seed=1)
    res = workflows.run_subject(x, y, workflows.PipelineConfig(model="snmgp", whiten="prior", **SMALL),
                                device="cpu")
    assert res["hmc_samples"].shape == (16, snmgp.n_params(N, 2)) and torch.isfinite(res["hmc_samples"]).all()
    assert res["sampling"]["beta_final"] == 1.0 and np.isfinite(res["sampling"]["log_evidence"])


def test_run_subject_hadamard_smc():
    rng = np.random.default_rng(2)
    x = np.repeat(np.sort(rng.uniform(size=12)), 2)
    indx = np.tile([0, 1], 12)
    keep = rng.uniform(size=24) > 0.2
    x, indx = x[keep], indx[keep]
    y = np.sin(5 * x + indx) + 0.1 * rng.normal(size=x.shape[0])
    cfg = workflows.PipelineConfig(model="gnmgp", whiten="prior", do_loo=True, test_size=0.2, **SMALL)
    out = workflows.run_subject_hadamard(x, indx, y, 2, cfg, device="cpu")
    assert out["hmc_samples"].shape[0] == 16 and torch.isfinite(out["hmc_samples"]).all()
    assert 0.0 < out["hmc_accept"] <= 1.0 and np.isfinite(out["loo"]["elpd_loo"])
    assert np.isfinite(out["test_sample_rmse"])


def test_cli_runs_smc(tmp_path, capsys, monkeypatch):
    """``--sampler smc`` reaches ``run_subject`` with JAX's CLI settings (the
    prior reference); the run itself takes a small population."""
    seen = []
    real = workflows.run_subject

    def spy(x, y, cfg, **kw):
        seen.append(cfg)
        return real(x, y, dataclasses.replace(cfg, smc_particles=16, smc_mutations=1, smc_leapfrog=2), **kw)

    monkeypatch.setattr(workflows, "run_subject", spy)
    out = tmp_path / "cli"
    summary = cli.main(["--n", "24", "--n-opt", "5", "--n-hmc", "4", "--sampler", "smc", "--out", str(out)],
                       device="cpu")
    assert (seen[0].sampler, seen[0].smc_ref, seen[0].n_hmc) == ("smc", "prior", 4)
    assert np.isfinite(summary["hmc_accept"]) and (out / "posterior.png").exists()
    capsys.readouterr()
