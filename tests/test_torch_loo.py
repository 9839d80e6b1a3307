"""The port's WAIC and PSIS-LOO against the JAX package on the CPU, in float64.

Covers PSIS (``inference/pathfinder.psis_smooth``, ``_gpd_fit``), the dense
LOO conditionals (``evaluate.observation_cov``,
``pointwise_conditional_loglik``, ``chain_conditional_loglik``), the two
criteria (``waic``, ``psis_loo``) and ``run_subject(do_hmc=True,
do_loo=True)``.

Tolerances.  PSIS and the criteria are the same numpy code on both sides
(rtol 1e-12).  The observation covariance sums the same terms with another
Gram assembly (rtol 1e-10).  A conditional takes a Cholesky factor and a
solve against I of that covariance, whose condition number at these sizes is
~1e4-1e6, so the conditionals are held at rtol 1e-8.  The pipeline's MAP
follows JAX's to ~1e-11 (``test_torch_train.py``); its LOO block reads JAX's
chain, so the criteria are held at rtol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.inference import pathfinder as jpathfinder
from nonstationary_multivariate_gaussian_process_tpu.utils.artifacts import ArtifactStore as JaxStore
from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import pathfinder
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_hmc import jax_sim, jit_jax_stages

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each


T64 = torch.float64
LOO_KEYS = ("elpd_loo", "p_loo", "looic", "n_bad_k", "k_hat_max", "elpd_waic", "p_waic", "waic")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def _log_weights(kind, r, seed):
    rng = np.random.default_rng(seed)
    if kind == "light":
        return rng.normal(size=r)
    if kind == "heavy":
        return np.log(rng.pareto(0.8, size=r) + 1e-3)
    if kind == "two_inf":  # still enough finite weights
        lw = rng.normal(size=r)
        lw[:2] = -np.inf
        return lw
    if kind == "few_finite":  # fewer than 5 finite weights: k̂ = ∞
        lw = np.full(r, -np.inf)
        lw[:4] = rng.normal(size=4)
        return lw
    if kind == "small_r":  # a tail of fewer than 5 draws: k̂ = 0
        return rng.normal(size=r)
    if kind == "spread":  # one draw dominates by more than e^700: k̂ = ∞
        lw = rng.normal(size=r)
        lw[3] = 900.0
        return lw
    if kind == "ties":  # every exceedance 0, floored at 1e-300
        return np.zeros(r)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,r", [("light", 400), ("heavy", 400), ("heavy", 60), ("two_inf", 100),
                                    ("few_finite", 100), ("small_r", 20), ("spread", 100),
                                    ("ties", 50)])
def test_psis_smooth_matches_jax(kind, r):
    lw = _log_weights(kind, r, seed=r)
    got, k = pathfinder.psis_smooth(lw)
    want, wk = jpathfinder.psis_smooth(lw)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert k == wk or np.isclose(k, wk, rtol=1e-12)
    expected = {"few_finite": np.inf, "small_r": 0.0, "spread": np.inf}
    if kind in expected:
        assert k == expected[kind]


@pytest.mark.parametrize("x", [np.sort(np.random.default_rng(1).exponential(size=40)),
                               np.sort(np.random.default_rng(2).pareto(1.5, size=80)),
                               np.zeros(10), np.ones(4)])
def test_gpd_fit_matches_jax(x):
    got = pathfinder._gpd_fit(x)
    want = jpathfinder._gpd_fit(x)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _draws(rng, n, m, s, scale=0.05):
    """A small chain of packed GNMGP vectors around a plausible centre."""
    center = np.concatenate([np.full(n, np.log(0.3)) + 0.1 * rng.normal(size=n),
                             0.2 * rng.normal(size=n * m * (m + 1) // 2), [np.log(0.05)]])
    return center[None, :] + scale * rng.normal(size=(s, center.size))


#: JAX's observation covariance, jitted (op by op it took 3.5 s a shape).
_jax_observation_cov = jax.jit(jevaluate.observation_cov, static_argnums=(0, 3, 4))


@pytest.mark.parametrize("n,m", [(12, 2), (9, 3), (8, 5)])
def test_observation_cov_matches_jax(rng, n, m):
    x = np.sort(rng.uniform(size=n))
    vec = _draws(rng, n, m, 1)[0]
    want = np.asarray(_jax_observation_cov("gnmgp", jnp.asarray(vec), jnp.asarray(x), n, m))
    got = evaluate.observation_cov("gnmgp", _t(vec), _t(x), n, m)
    assert got.shape == (n * m, n * m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("model,match", [
    # a sparse model's covariance is never formed, in either package: its LOO
    # conditionals come from chain_conditional_loglik_sparse
    ("snmgp_sparse", "chain_conditional_loglik_sparse"), ("lmc_sparse", "chain_conditional_loglik_sparse"),
    ("gnmgp_hetero_sparse", "chain_conditional_loglik_sparse"), ("gp", "unknown model"),
])
def test_observation_cov_refuses_other_models(model, match):
    with pytest.raises(ValueError, match=match):
        evaluate.observation_cov(model, torch.zeros(3, dtype=T64), torch.zeros(1, dtype=T64), 1, 1)
    with pytest.raises(ValueError, match="unknown model"):
        jevaluate.observation_cov(model, jnp.zeros(3), jnp.zeros(1), 1, 1)


def _brute_force(cov, y, keep):
    """log p(y_i | y_{kept, ≠ i}) by the partitioned Gaussian, per kept i."""
    out = np.zeros(len(y))
    for i in np.flatnonzero(keep):
        rest = np.flatnonzero(keep & (np.arange(len(y)) != i))
        c_rr = cov[np.ix_(rest, rest)]
        w = np.linalg.solve(c_rr, cov[rest, i])
        mu = w @ y[rest]
        var = cov[i, i] - cov[i, rest] @ w
        out[i] = -0.5 * np.log(2 * np.pi * var) - 0.5 * (y[i] - mu) ** 2 / var
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_pointwise_conditional_loglik_matches_jax_and_brute_force(rng, masked):
    n, m = 10, 2
    x = np.sort(rng.uniform(size=n))
    vec = _draws(rng, n, m, 1)[0]
    y_tm = rng.normal(size=n * m)
    cov = np.asarray(_jax_observation_cov("gnmgp", jnp.asarray(vec), jnp.asarray(x), n, m))
    mask = np.tile(np.arange(n) < n - 3, m) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jax.jit(lambda c, yy: jevaluate.pointwise_conditional_loglik(c, yy, jmask))(
        jnp.asarray(cov), jnp.asarray(y_tm)))
    got = evaluate.pointwise_conditional_loglik(_t(cov), _t(y_tm), None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)
    keep = np.ones(n * m, bool) if mask is None else mask
    np.testing.assert_allclose(got.numpy(), _brute_force(cov, y_tm, keep), rtol=1e-8, atol=1e-12)
    if masked:
        assert (got.numpy()[~mask] == 0.0).all()


def test_failed_factor_gives_nan_conditionals_as_in_jax():
    cov = -np.eye(4)
    y = np.arange(4.0)
    got = evaluate.pointwise_conditional_loglik(_t(cov), _t(y)).numpy()
    want = np.asarray(jax.jit(jevaluate.pointwise_conditional_loglik)(jnp.asarray(cov), jnp.asarray(y)))
    assert np.isnan(got).all() and np.isnan(want).all()


@pytest.fixture(scope="module")
def chain_ll():
    rng = np.random.default_rng(3)
    n, m, s = 10, 2, 11
    x = np.sort(rng.uniform(size=n))
    y = rng.normal(size=(n, m))
    hist = _draws(rng, n, m, s)
    want = np.asarray(jevaluate.chain_conditional_loglik("gnmgp", hist, x, y, chunk=4))
    return x, y, hist, want


@pytest.mark.parametrize("chunk", [1, 4, 8, 32])
def test_chain_conditional_loglik_matches_jax_at_any_chunk(chain_ll, chunk):
    x, y, hist, want = chain_ll
    gram_kernels.reset_launches()
    got = evaluate.chain_conditional_loglik("gnmgp", hist, x, y, chunk=chunk, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape == (11, 20)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert gram_kernels.launches()["svc_gram"] == 0  # the CPU takes the plain Gram
    if chunk != 8:
        np.testing.assert_array_equal(
            got, evaluate.chain_conditional_loglik("gnmgp", hist, x, y, device="cpu"))


def test_chain_conditional_loglik_with_a_mask_matches_jax(chain_ll):
    x, y, hist, _ = chain_ll
    mask = np.arange(10) < 8
    want = np.asarray(jevaluate.chain_conditional_loglik("gnmgp", hist, x, y, mask=mask))
    got = evaluate.chain_conditional_loglik("gnmgp", _t(hist), _t(x), _t(y), mask=mask, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-14)
    assert (got[:, np.tile(~mask, 2)] == 0.0).all()


def test_chain_conditional_loglik_without_device_raises_when_cuda_is_absent(chain_ll, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, hist, _ = chain_ll
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.chain_conditional_loglik("gnmgp", hist, x, y)


@pytest.mark.parametrize("source", ["chain", "heavy"])
def test_psis_loo_and_waic_match_jax(chain_ll, source):
    if source == "chain":
        ll = chain_ll[3]
    else:  # a few draws far out in the tails: large k̂ on some coordinates
        rng = np.random.default_rng(5)
        ll = rng.normal(size=(60, 7))
        ll[:3] -= 40.0 * rng.uniform(size=(3, 7))
    got_l, want_l = evaluate.psis_loo(ll), jevaluate.psis_loo(ll)
    got_w, want_w = evaluate.waic(ll), jevaluate.waic(ll)
    assert got_l.keys() == want_l.keys() and got_w.keys() == want_w.keys()
    for got, want in ((got_l, want_l), (got_w, want_w)):
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-12, err_msg=k)
    assert got_l["n_bad_k"] == want_l["n_bad_k"]
    np.testing.assert_allclose(evaluate._logsumexp(ll, axis=0), jevaluate._logsumexp(ll, axis=0), rtol=1e-15)
    assert evaluate._logsumexp(ll) == jevaluate._logsumexp(ll)


#: JAX's own pipeline test (tests/test_loo.py, test_run_subject_do_loo).
LOO_CFG = dict(model="gnmgp", n_opt=40, do_hmc=True, do_loo=True, n_hmc=8, loo_draws=6,
               hmc_step_size=1e-4, hmc_leapfrog=2, do_pred_grid=False, do_map_analysis=False)


@pytest.fixture(scope="module")
def loo_runs(tmp_path_factory):
    """JAX's run_subject(do_hmc=True, do_loo=True) into a store, and the
    port's on the same data with JAX's chain in place of its own."""
    d = jax_sim(jax.random.PRNGKey(3), n=16)
    x, y = np.asarray(d.x), np.asarray(d.y)
    jroot = str(tmp_path_factory.mktemp("jax_loo"))
    mp = pytest.MonkeyPatch()
    try:
        jit_jax_stages(mp)
        want = jworkflows.run_subject(x, y, jworkflows.PipelineConfig(**LOO_CFG), store=JaxStore(jroot))
    finally:
        mp.undo()
    chain = np.array(want["hmc_samples"])

    def jax_chain(nlp, map_vec, cfg, generator, whitener=None):
        return torch.as_tensor(chain, dtype=map_vec.dtype, device=map_vec.device), want["hmc_accept"]

    root = str(tmp_path_factory.mktemp("port_loo"))
    mp.setattr(workflows, "_run_chain", jax_chain)
    try:
        got = workflows.run_subject(x, y, workflows.PipelineConfig(**LOO_CFG), store=ArtifactStore(root),
                                    device="cpu")
    finally:
        mp.undo()
    return want, got, jroot, root


def test_run_subject_loo_matches_jax_on_its_chain(loo_runs):
    want, got, _, _ = loo_runs
    assert set(got["loo"]) == set(want["loo"]) == set(LOO_KEYS) | {"pointwise"}
    for k in LOO_KEYS:
        np.testing.assert_allclose(got["loo"][k], want["loo"][k], rtol=1e-6, err_msg=k)
        assert np.isfinite(got["loo"][k])
    np.testing.assert_allclose(got["loo"]["pointwise"], want["loo"]["pointwise"], rtol=1e-6)
    assert got["loo"]["pointwise"].shape == (32,)
    np.testing.assert_allclose(got["dic"], want["dic"], rtol=1e-6)


def test_run_subject_writes_the_loo_artifact_as_jax_does(loo_runs):
    _, got, jroot, root = loo_runs
    key = ArtifactStore.key("gnmgp", "data", 0, "loo")
    stored, jstored = ArtifactStore(root).load(key), JaxStore(jroot).load(key)
    assert set(stored) == set(jstored) == set(LOO_KEYS)
    for k in LOO_KEYS:
        assert stored[k] == got["loo"][k]
        np.testing.assert_allclose(stored[k], jstored[k], rtol=1e-6, err_msg=k)


def test_loo_thins_the_chain_as_jax_does(loo_runs, monkeypatch):
    want, _, _, _ = loo_runs
    seen = []
    real = evaluate.chain_conditional_loglik

    def spy(model, hist, *args, **kwargs):
        seen.append(hist.numpy().copy())
        return real(model, hist, *args, **kwargs)

    monkeypatch.setattr(evaluate, "chain_conditional_loglik", spy)
    chain = torch.tensor(np.asarray(want["hmc_samples"]), dtype=T64)
    monkeypatch.setattr(workflows, "_run_chain", lambda *a, whitener=None: (chain, 1.0))
    d = jax_sim(jax.random.PRNGKey(3), n=16)
    cfg = workflows.PipelineConfig(**{**LOO_CFG, "n_opt": 2})
    workflows.run_subject(np.asarray(d.x), np.asarray(d.y), cfg, device="cpu")
    idx = np.linspace(0, 7, 6).astype(int)
    np.testing.assert_array_equal(seen[0], chain.numpy()[idx])


def test_loo_needs_a_chain_and_the_evaluation_stage(loo_runs):
    _, _, _, root = loo_runs
    store = ArtifactStore(root)  # resumes the stored MAP
    data = store.load(ArtifactStore.key("gnmgp", "data", 0, "data"))
    x, y = data["x"], data["y"]
    for kw in (dict(do_hmc=False), dict(do_evaluation=False)):
        res = workflows.run_subject(x, y, workflows.PipelineConfig(**{**LOO_CFG, **kw}), store=store,
                                    device="cpu")
        assert "loo" not in res
