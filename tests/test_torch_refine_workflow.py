"""Inducing-input refinement in the pipelines: ``run_subject(refine_z=1)`` of
the sparse GNMGP against the JAX package's on the CPU, in float64, and the
other models' wiring in both layouts against the port's own
``refine_inducing`` (which ``tests/test_torch_refine.py`` holds against
JAX's).

One JAX ``run_subject`` in the fixture (no chain; its objective, deviance
and predictor ``jax.jit``ted), the port's on the same subject and config.
For the other models each pipeline's call of ``refine_inducing`` is
recorded: its arguments are the workflow's (rounds, Z-steps, the refit's
``min(max(100, n_opt // 2), 400)`` iterations, ``m`` in the Hadamard
layout), the result carries its refined Z and vector bit for bit, and the
grid prediction is the predictor's at its refined ops.  The runs take Adam:
L-BFGS's linesearch turns the packages' ~1e-8 apart kriging projections
into other branches over the refit's 100 iterations.

Tolerances.  Against JAX at rtol 1e-6, vectors with a floor of 1e-6 of
their largest |entry| (the packages' kriging projections agree to ~1e-8).
"""

import numpy as np
import pytest
import torch
import jax

from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, settings, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_hmc import jit_jax_stages
from test_torch_refine import M, MZ, _hadamard_subject, _subject, jit_jax_objectives

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

RTOL = 1e-6
CFG = dict(n_inducing=MZ, n_opt=8, refine_z=1, refine_z_iters=3, do_hmc=False, do_map_analysis=False, n_grid=21,
           map_method="adam")
SCORES = ("deviance", "aic", "bic")


@pytest.fixture(autouse=True)
def robust_cholesky(monkeypatch):
    """Both packages' Cholesky ladder on (a collected ``bench.py`` turns it
    off with ``NMGP_ROBUST_CHOL=0``)."""
    monkeypatch.setattr(settings, "robust_cholesky", True)
    monkeypatch.setattr(jsettings, "robust_cholesky", True)


def _close(got, want, err_msg=""):
    want = np.asarray(want, float)
    np.testing.assert_allclose(np.asarray(got, float), want, rtol=RTOL, atol=RTOL * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's and the port's ``run_subject(model="gnmgp_sparse", refine_z=1)``;
    the port's into a store."""
    x, y = _subject(seed=3)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jsettings, "robust_cholesky", True)
        jit_jax_stages(mp, "gnmgp_sparse")
        jit_jax_objectives(mp)
        want = jworkflows.run_subject(x, y, jworkflows.PipelineConfig(model="gnmgp_sparse", **CFG))
    finally:
        mp.undo()
    root = str(tmp_path_factory.mktemp("refine"))
    got = workflows.run_subject(x, y, workflows.PipelineConfig(model="gnmgp_sparse", **CFG), store=ArtifactStore(root),
                                dataset="sim", device="cpu")
    stages = (set(want["timings"]), set(got["timings"]))
    return convert.result_to_numpy(want), convert.result_to_numpy(got), (x, y), root, stages


def test_run_subject_refines_z_as_jax_does(runs):
    want, got, _, _, (want_stages, got_stages) = runs
    assert got.keys() == want.keys() and "refined_z" in got
    assert got_stages == want_stages and "refine_z" in got_stages
    _close(got["refined_z"], want["refined_z"], "refined_z")
    _close(got["map_vec"], want["map_vec"], "map_vec")
    for k in SCORES:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    for f, w in want["pred_grid"].items():
        _close(got["pred_grid"][f], w, err_msg=f"pred_grid {f}")


def test_refined_run_stores_and_resumes_its_inducing_inputs(runs):
    """The MAP artifact keeps the refined Z, and a run on the same store reads
    the MAP at those inputs without refining again."""
    _, got, (x, y), root, _ = runs
    stored = ArtifactStore(root).load(ArtifactStore.key("gnmgp_sparse", "sim", 0, "map"))
    np.testing.assert_array_equal(stored["z"], got["refined_z"])
    again = workflows.run_subject(x, y, workflows.PipelineConfig(model="gnmgp_sparse", **CFG),
                                  store=ArtifactStore(root), dataset="sim", device="cpu")
    assert "refined_z" not in again and "refine_z" not in again["timings"]
    again = convert.result_to_numpy(again)
    np.testing.assert_array_equal(again["map_vec"], got["map_vec"])
    for f, w in got["pred_grid"].items():
        np.testing.assert_array_equal(again["pred_grid"][f], w)


@pytest.mark.parametrize("model,hadamard", [("snmgp_sparse", False), ("lmc_sparse", False),
                                            ("gnmgp_hetero_sparse", False), ("gnmgp_sparse", True),
                                            ("snmgp_sparse", True), ("lmc_sparse", True)])
def test_pipelines_refine_every_sparse_model(model, hadamard, monkeypatch):
    calls = []
    refine = gnmgp_sparse.refine_inducing

    def recorded(data, z0, vec0, **kw):
        out = refine(data, z0, vec0, **kw)
        calls.append((data, z0, kw, out))
        return out

    monkeypatch.setattr(gnmgp_sparse, "refine_inducing", recorded)
    cfg = workflows.PipelineConfig(model=model, **CFG)
    if hadamard:
        x, indx, y = _hadamard_subject(seed=5)
        res = workflows.run_subject_hadamard(x, indx, y, M, cfg, device="cpu")
    else:
        res = workflows.run_subject(*_subject(seed=5), cfg, device="cpu")
    ((data, z0, kw, (z, vec, ops, final)),) = calls
    assert kw == dict(n_rounds=1, z_iters=3, vec_iters=100, lr_vec=cfg.lr, hyper={}, approx="fitc", method="adam",
                      model=model, **({"m": M} if hadamard else {}))
    assert z0.shape == (MZ,) and not torch.equal(z, z0)
    np.testing.assert_array_equal(res["refined_z"], z.numpy())
    assert torch.equal(res["map_vec"], vec)
    assert res["timings"]["refine_z"] > 0 and np.isfinite(final)
    # the grid prediction conditions on the refined ops
    grid = torch.as_tensor(res["grid"], dtype=torch.float64)
    if hadamard:
        want = workflows._hadamard_predictors(cfg, ops)[0](vec, data, grid, M, device="cpu", dtype=torch.float64)
    else:
        want = workflows._predict_map(cfg, vec, data, grid, "cpu", torch.float64, ops)
    assert all(torch.equal(g, w) for g, w in zip(res["pred_grid"], want))
