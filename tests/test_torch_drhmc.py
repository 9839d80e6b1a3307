"""The port's delayed-rejection HMC against the JAX package on the CPU, in
float64, and ``run_subject(sampler="drhmc")``.

The two packages cannot share a PRNG, so the port replays JAX's noise: one
key per draw, split into a momentum key (a normal of length P) and an
acceptance key (``n_stages`` uniforms), handed to the port as ``noise=``.
Given the same noise both chains accept at the same stages and differ only
by rounding.

Tolerances.  On the analytic potentials (a correlated Gaussian and Neal's
funnel) both packages do the same arithmetic in another order, so draws,
potentials, stage-1 acceptance and step size are held at rtol 1e-10; the
adaptive cases run 22 draws or fewer (dual averaging amplifies rounding by a few per
draw once the step settles, ``test_torch_hmc``).  On the GNMGP objective one
evaluation differs by ~1e-12 relative, and a draw chains up to 3
trajectories of 5, so it is held at rtol 1e-8.  Each JAX case is compiled
once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.inference import drhmc as jdrhmc
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import drhmc
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import init as init_mod
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

from test_torch_hmc import jax_sim

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each


T64 = torch.float64
FIELDS = ("samples", "potentials", "accept_prob1", "step_size")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def jax_noise(key, n_total: int, p: int, n_stages: int):
    """``(z (n_total, P), u (n_total, n_stages))`` that JAX's DRHMC draws from
    ``key``: ``split(key, n_total)``, then per draw ``k_mom, k_acc = split(k)``."""
    def one(k):
        k_mom, k_acc = jax.random.split(k)
        return (jax.random.normal(k_mom, (p,), jnp.float64),
                jax.random.uniform(k_acc, (n_stages,), jnp.float64))
    z, u = jax.jit(jax.vmap(one))(jax.random.split(key, n_total))
    return np.array(z), np.array(u)


# -- the potentials -----------------------------------------------------------

P = 5
_rng = np.random.default_rng(5)
_B = _rng.normal(size=(P, P))
PREC = np.linalg.inv(_B @ _B.T / P + 0.5 * np.eye(P))
MU = _rng.normal(size=P)
Q0 = MU + _rng.normal(size=P)
DIAG_MASS = 1.0 + _rng.uniform(size=P)
_MU_T, _PREC_T = _t(MU), _t(PREC)


def jgauss(q):
    d = q - jnp.asarray(MU)
    return 0.5 * d @ jnp.asarray(PREC) @ d


def tgauss(q):
    d = q - _MU_T
    return 0.5 * d @ _PREC_T @ d


def jfunnel(q):
    """Neal's funnel: v = q[0] ~ N(0, 9), q[1:] | v ~ N(0, e^v)."""
    return q[0] ** 2 / 18.0 + 0.5 * jnp.sum(q[1:] ** 2) * jnp.exp(-q[0]) + 0.5 * (q.shape[0] - 1) * q[0]


def tfunnel(q):
    return q[0] ** 2 / 18.0 + 0.5 * torch.sum(q[1:] ** 2) * torch.exp(-q[0]) + 0.5 * (q.shape[0] - 1) * q[0]


FUNNEL_Q0 = np.array([1.0, 0.5, -0.3, 0.8])


@pytest.fixture(scope="module")
def gnmgp_subject():
    """A sim subject at N=12, M=2, both objectives and the empirical init."""
    d = jax_sim(jax.random.PRNGKey(5), n=12, m=2)
    x, y = np.asarray(d.x), np.asarray(d.y)
    emp = jempirical.local_estimation(x, y, window_size=4, method="profile")
    init = np.asarray(jinit.gnmgp_from_empirical(emp, 12, 2))
    # the port's start from JAX's estimate, carried over by convert
    start = init_mod.gnmgp_from_empirical(convert.empirical_from_jax(emp), 12, 2, device="cpu", dtype=T64)
    np.testing.assert_allclose(start.numpy(), init, rtol=1e-12)
    jobj = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    obj = gnmgp.make_objective(FullData(_t(x), _t(y)))
    return jobj, obj, init


#: name -> (potential pair or fixture name, q0, n_samples, kwargs, rtol)
CASES = {
    "gauss_one_stage": ((jgauss, tgauss), Q0, 12,
                        dict(step_size=0.6, n_leapfrog=5, n_stages=1, adapt_step_size=False), 1e-10),
    "gauss_three_stages_diag_mass_adaptive": ((jgauss, tgauss), Q0, 10,
                                              dict(step_size=1.2, n_leapfrog=4, n_stages=3, n_warmup=12,
                                                   mass_matrix=DIAG_MASS), 1e-10),
    "funnel_three_stages": ((jfunnel, tfunnel), FUNNEL_Q0, 15,
                            dict(step_size=0.9, n_leapfrog=5, n_stages=3, adapt_step_size=False), 1e-10),
    # dual averaging from a step at the edge of stability
    "gnmgp_two_stages_adaptive": ("gnmgp_subject", None, 3,
                                  dict(step_size=0.002, n_leapfrog=4, n_stages=2, n_warmup=3), 1e-8),
}
#: The accepting stages each of these cases must show (0: every stage rejected).
STAGES_SEEN = {"funnel_three_stages": {0, 1, 2, 3}, "gnmgp_two_stages_adaptive": {0, 1, 2}}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """JAX's chain and the port's on JAX's noise, for one case."""
    pots, q0, n_samples, kw, rtol = CASES[request.param]
    if isinstance(pots, str):
        jpot, tpot, q0 = request.getfixturevalue(pots)
    else:
        jpot, tpot = pots
    key = jax.random.PRNGKey(1)
    want = jdrhmc.drhmc_sample(jpot, jnp.asarray(q0), n_samples, key, **kw)
    noise = jax_noise(key, n_samples + kw.get("n_warmup", 0), len(q0), kw["n_stages"])
    got = drhmc.drhmc_sample(tpot, _t(q0), n_samples, noise=noise, **kw)
    return request.param, want, got, rtol


def test_drhmc_sample_matches_jax(case):
    name, want, got, rtol = case
    np.testing.assert_array_equal(got.accept_stage.numpy(), np.asarray(want.accept_stage))
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=f)
    assert got.samples.dtype == T64 and got.samples.shape == np.asarray(want.samples).shape
    assert STAGES_SEEN.get(name, set()) <= set(got.accept_stage.tolist())


@pytest.mark.parametrize("a", [-np.inf, -50.0, -1.0, np.log(0.5), -0.3, -1e-13, 0.0, 0.7, np.nan])
def test_log1m_exp_matches_jax(a):
    want = float(jdrhmc._log1m_exp(jnp.float64(a)))
    got = float(drhmc._log1m_exp(torch.tensor(a, dtype=T64)))
    np.testing.assert_allclose(got, want, rtol=1e-14)


@pytest.mark.parametrize("n", [0, 1, 2, 3, -1, -2, -3, -5])
def test_integer_pow_is_laxs(n):
    x = 3.7
    want = float(jax.lax.integer_pow(jnp.float64(x), n))
    assert float(drhmc._integer_pow(torch.tensor(x, dtype=T64), n)) == want


def test_gradients_per_draw_follow_the_stage_tree():
    """A stage-k test costs 2**(k-1) trajectories of n_leapfrog + 1 gradients
    (each proposal recomputes its entry gradient); the start costs one
    value."""
    calls = {"n": 0}

    def counted(q):
        calls["n"] += 1
        return tfunnel(q)

    kw = dict(step_size=0.9, n_leapfrog=5, n_stages=3, adapt_step_size=False)
    res = drhmc.drhmc_sample(counted, _t(FUNNEL_Q0), 15, torch.Generator().manual_seed(3), **kw)
    tried = [s if s > 0 else 3 for s in res.accept_stage.tolist()]
    assert calls["n"] == 1 + sum(2 ** t - 1 for t in tried) * (kw["n_leapfrog"] + 1)


@pytest.mark.parametrize("kw,match", [
    (dict(n_stages=0), "n_stages"),
    (dict(mass_matrix=np.eye(P)), "diagonal"),
])
def test_argument_checks_raise_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        jdrhmc.drhmc_sample(jgauss, jnp.asarray(Q0), 2, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match=match):
        drhmc.drhmc_sample(tgauss, _t(Q0), 2, torch.Generator().manual_seed(0), **kw)


def test_noise_source_and_generator():
    with pytest.raises(ValueError, match="generator"):
        drhmc.drhmc_sample(tgauss, _t(Q0), 2)
    with pytest.raises(ValueError, match="noise must be"):
        drhmc.drhmc_sample(tgauss, _t(Q0), 2, noise=(np.zeros((2, P)), np.zeros((2, 2))))
    kw = dict(step_size=0.6, n_leapfrog=3, n_stages=2)
    run = lambda seed: drhmc.drhmc_sample(tgauss, _t(Q0), 8, torch.Generator().manual_seed(seed), **kw)
    a, b = run(1), run(1)
    assert torch.equal(a.samples, b.samples) and torch.equal(a.accept_stage, b.accept_stage)
    # the draw order is z then the stage uniforms, from the one generator
    g = torch.Generator().manual_seed(1)
    z, u = zip(*[(torch.randn(P, generator=g, dtype=T64), torch.rand(2, generator=g, dtype=T64))
                 for _ in range(8)])
    c = drhmc.drhmc_sample(tgauss, _t(Q0), 8, noise=(torch.stack(z), torch.stack(u)), **kw)
    assert torch.equal(a.samples, c.samples)


def test_run_subject_drhmc_routes_every_stage(tmp_path):
    """Port-only: ``run_subject(sampler="drhmc")`` runs the chain, DIC, LOO,
    grid and test prediction and writes the ``hmc`` artifact."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    d = sim.sim_mnts(torch.Generator().manual_seed(2), n=32, device="cpu")
    cfg = workflows.PipelineConfig(model="lmc", n_opt=4, do_hmc=True, do_loo=True, sampler="drhmc", n_hmc=3,
                                   hmc_warmup=2, hmc_leapfrog=3, hmc_step_size=0.05, dr_stages=2,
                                   test_size=0.25, n_grid=11)
    store = ArtifactStore(str(tmp_path))
    res = workflows.run_subject(d.x.numpy(), d.y.numpy(), cfg, store=store, dataset="sim", device="cpu")
    assert res["hmc_samples"].shape == (3, workflows.n_params("lmc", res["n"], 2))
    assert torch.isfinite(res["hmc_samples"]).all() and 0.0 <= res["hmc_accept"] <= 1.0
    assert np.isfinite([res["dic"], res["loo"]["elpd_loo"], res["test_rmse"]]).all()
    assert res["pred_grid"].percentiles.shape[0] == 11 and "sampling" not in res
    assert store.exists(store.key("lmc", "sim", 0, "hmc"))
