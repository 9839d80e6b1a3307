"""The port's ChEES-HMC and multichain starts against the JAX package
on the CPU, in float64, and ``sampler="chees"`` through ``run_subject``,
``run_subject_hadamard`` and the engine.

The port replays JAX's noise: for a (P,) start, ``k_init, key =
split(key)`` and the (K, P) start jitter from ``k_init``; then one key per
draw, split into the (K, P) momentum normals and the K accept uniforms.
Given the same noise both packages take the same leapfrog counts and accept
decisions and differ only by rounding.

Tolerances.  On the correlated Gaussian both do the same arithmetic in
another order (the K chains' gradients one after another in the port, a
``vmap`` in JAX): draws, potentials, accept probabilities, step size,
trajectory length and inverse mass at rtol 1e-10.  The adaptive runs stay
within 35 draws: dual averaging and Adam on log T feed each draw's rounding
into the next.  On the GNMGP objective (N=12, M=2) one evaluation differs by
~1e-12 relative, so it is held at rtol 1e-8.  The leapfrog counts, which
``ceil`` takes from ``tau / eps``, must be equal.  Each JAX case is compiled
once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.data import sim as jsim
from nonstationary_multivariate_gaussian_process_tpu.inference import chees as jchees
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import chees
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import init as init_mod
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.serving.engine import PredictEngine
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
FIELDS = ("samples", "potentials", "accept_prob", "step_size", "trajectory_length", "inv_mass")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def jax_noise(key, n_total: int, k: int, p: int, jittered: bool):
    """``(jitter (K, P) or None, z (n_total, K, P), u (n_total, K))`` that
    JAX's ``chees_sample`` draws from ``key``."""
    jit = None
    if jittered:
        k_init, key = jax.random.split(key)
        jit = np.array(jax.random.normal(k_init, (k, p), jnp.float64))

    def one(kk):
        k_mom, k_acc = jax.random.split(kk)
        return jax.random.normal(k_mom, (k, p), jnp.float64), jax.random.uniform(k_acc, (k,), jnp.float64)

    z, u = jax.jit(jax.vmap(one))(jax.random.split(key, n_total))
    return jit, np.array(z), np.array(u)


P = 5
_rng = np.random.default_rng(5)
_B = _rng.normal(size=(P, P))
PREC = np.linalg.inv(_B @ _B.T / P + 0.5 * np.eye(P))
MU = _rng.normal(size=P)
Q0 = MU + _rng.normal(size=P)
STARTS2 = Q0 + 0.3 * _rng.normal(size=(2, P))
# chain 2 starts ~20 standard deviations out, more than 10·P nats above the others
STRANDED = np.stack([Q0, Q0 + 0.2, MU + 20.0])
INV_MASS = 1.0 + np.arange(P) / 5.0
_MU_T, _PREC_T = _t(MU), _t(PREC)


def jgauss(q):
    d = q - jnp.asarray(MU)
    return 0.5 * d @ jnp.asarray(PREC) @ d


def tgauss(q):
    d = q - _MU_T
    return 0.5 * d @ _PREC_T @ d


@pytest.fixture(scope="module")
def gnmgp_subject():
    """A sim subject at N=12, M=2, both objectives and two starts around the
    empirical init."""
    d = jsim.sim_mnts(jax.random.PRNGKey(5), n=12, m=2)
    x, y = np.asarray(d.x), np.asarray(d.y)
    emp = jempirical.local_estimation(x, y, window_size=4, method="profile")
    init = np.asarray(jinit.gnmgp_from_empirical(emp, 12, 2))
    starts = init + 0.01 * np.random.default_rng(3).normal(size=(2, init.shape[0]))
    jobj = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    return jobj, gnmgp.make_objective(FullData(_t(x), _t(y))), starts


#: name -> (potential pair or fixture name, q0, n_samples, kwargs, rtol)
CASES = {
    # 25 warmup draws: the within-chain metric takes over at the 20th
    "gauss_k3_jittered_adapt_mass": ((jgauss, tgauss), Q0, 10,
                                     dict(n_chains=3, step_size=0.2, n_warmup=25), 1e-10),
    "gauss_k2_starts_diag_inv_mass": ((jgauss, tgauss), STARTS2, 10,
                                      dict(step_size=0.3, n_warmup=8, inv_mass=INV_MASS), 1e-10),
    "gauss_k3_stranded_start": ((jgauss, tgauss), STRANDED, 6,
                                dict(step_size=0.3, n_warmup=6, adapt_mass=False), 1e-10),
    "gnmgp_k2": ("gnmgp_subject", None, 3, dict(step_size=1e-3, n_warmup=3, max_leapfrog=8), 1e-8),
}


@pytest.fixture(scope="module")
def runs(request):
    """``get(name)``: JAX's chains and the port's on JAX's noise for one
    case, each run once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            pots, q0, n_samples, kw, rtol = CASES[name]
            if isinstance(pots, str):
                jpot, tpot, q0 = request.getfixturevalue(pots)
            else:
                jpot, tpot = pots
            q0 = np.asarray(q0)
            key = jax.random.PRNGKey(3)
            want = jchees.chees_sample(jpot, jnp.asarray(q0), n_samples, key, **kw)
            k = kw.get("n_chains", 16) if q0.ndim == 1 else q0.shape[0]
            noise = jax_noise(key, n_samples + kw["n_warmup"], k, q0.shape[-1], q0.ndim == 1)
            got = chees.chees_sample(tpot, _t(q0), n_samples, noise=noise, **kw)
            cache[name] = (tpot, q0, noise, want, got)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_chees_sample_matches_jax(runs, name):
    _, _, _, want, got = runs(name)
    rtol = CASES[name][4]
    np.testing.assert_array_equal(got.n_leapfrog.numpy(), np.asarray(want.n_leapfrog))
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        assert tuple(getattr(got, f).shape) == w.shape, f
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=f)
    if name == "gauss_k3_jittered_adapt_mass":
        # the metric was adapted, and the trajectory length moved
        assert not np.allclose(got.inv_mass.numpy(), 1.0)
        assert float(got.trajectory_length) != pytest.approx(20 * 0.2)


def test_stranded_start_is_pulled_back_to_chain_0(runs):
    name = "gauss_k3_stranded_start"
    tpot, q0, noise, _, got = runs(name)
    _, _, n_samples, kw, _ = CASES[name]
    assert float(tgauss(_t(q0[2]))) > float(tgauss(_t(q0[0]))) + 10 * P
    pulled = q0.copy()
    pulled[2] = q0[0]
    again = chees.chees_sample(tpot, _t(pulled), n_samples, noise=noise, **kw)
    assert torch.equal(again.samples, got.samples) and torch.equal(again.n_leapfrog, got.n_leapfrog)


def test_halton_matches_jax():
    np.testing.assert_array_equal(chees._halton_base2(37), jchees._halton_base2(37))


@pytest.mark.parametrize("q0,kw,match", [
    (Q0, dict(n_chains=1), "2 chains"),
    (np.zeros((2, 2, P)), {}, "q0 must be"),
    (STARTS2, dict(inv_mass=np.ones(P + 1)), "inv_mass"),
])
def test_argument_checks_raise_as_in_jax(q0, kw, match):
    with pytest.raises(ValueError, match=match):
        jchees.chees_sample(jgauss, jnp.asarray(q0), 2, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match=match):
        chees.chees_sample(tgauss, _t(q0), 2, torch.Generator().manual_seed(0), **kw)


def test_generator_draw_order():
    """The start jitter, then per draw the momenta and the uniforms, from
    the one generator."""
    kw = dict(n_chains=2, step_size=0.3, n_warmup=2)
    a = chees.chees_sample(tgauss, _t(Q0), 3, torch.Generator().manual_seed(4), **kw)
    g = torch.Generator().manual_seed(4)
    jit = torch.randn(2, P, generator=g, dtype=T64)
    z, u = zip(*[(torch.randn(2, P, generator=g, dtype=T64), torch.rand(2, generator=g, dtype=T64))
                 for _ in range(5)])
    b = chees.chees_sample(tgauss, _t(Q0), 3, noise=(jit, torch.stack(z), torch.stack(u)), **kw)
    assert torch.equal(a.samples, b.samples)
    with pytest.raises(ValueError, match="start jitter"):
        chees.chees_sample(tgauss, _t(Q0), 3, noise=(None, torch.stack(z), torch.stack(u)), **kw)


# ---------------------------------------------------------------------------
# The multichain starts
# ---------------------------------------------------------------------------

B_INF = Q0[0] + 1.0


def jwall(q):
    return jgauss(q) + jnp.where(q[0] > B_INF, jnp.inf, 0.0)


def twall(q):
    return tgauss(q) + torch.where(q[0] > B_INF, torch.inf, 0.0)


@pytest.mark.parametrize("kw", [dict(descent_iters=20), dict(descent_iters=15, include_center=False, lr=0.05),
                                dict(descent_iters=0), dict(descent_iters=10, jitter=2.0)],
                         ids=["default", "no_center", "no_descent", "wall"])
def test_multichain_starts_match_jax(kw):
    """The "wall" case jitters past a wall of +inf: a start stranded there
    holds under the guard and falls back to the center."""
    jpot, tpot = (jwall, twall) if kw.get("jitter") == 2.0 else (jgauss, tgauss)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jinit.multichain_starts(jpot, jnp.asarray(Q0), 4, key, **kw))
    k_init, _ = jax.random.split(key)
    z = np.array(jax.random.normal(k_init, (4, P), jnp.float64))
    got = init_mod.multichain_starts(tpot, _t(Q0), 4, noise=z, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    if kw.get("include_center", True):
        np.testing.assert_array_equal(got[0], Q0)
    if kw.get("jitter") == 2.0:
        assert any(np.array_equal(row, Q0) for row in got[1:])


def test_adam_descent_matches_jax():
    q0 = Q0 + 1.5
    want = np.asarray(jinit.adam_descent(jgauss, jnp.asarray(q0), 25, lr=0.2))
    got = init_mod.adam_descent(tgauss, _t(q0), 25, lr=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_random_inits_follow_jax_layout():
    for got, want, fixed in (
        (init_mod.lmc_random(torch.Generator().manual_seed(0), 3, device="cpu", dtype=T64),
         jinit.lmc_random(jax.random.PRNGKey(0), 3), [0, 1, -1]),
        (init_mod.gnmgp_random(torch.Generator().manual_seed(0), 5, 2, device="cpu", dtype=T64),
         jinit.gnmgp_random(jax.random.PRNGKey(0), 5, 2), list(range(5))),
    ):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == T64
        np.testing.assert_allclose(got.numpy()[fixed], want[fixed], rtol=1e-15)
        assert np.isfinite(got.numpy()).all()


# ---------------------------------------------------------------------------
# sampler="chees" through the workflows (port only)
# ---------------------------------------------------------------------------


def test_run_subject_chees_whitened_with_loo_reaches_the_engine(tmp_path):
    d = sim.sim_mnts(torch.Generator().manual_seed(3), n=28, device="cpu")
    x, y = d.x.numpy(), d.y.numpy()
    cfg = workflows.PipelineConfig(n_opt=3, do_hmc=True, do_loo=True, sampler="chees", whiten=True, n_hmc=3,
                                   hmc_warmup=2, n_grid=11, test_size=0.25)
    store = ArtifactStore(str(tmp_path))
    res = workflows.run_subject(x, y, cfg, store=store, dataset="sim", device="cpu")
    n = res["n"]
    assert res["hmc_samples"].shape == (2 * 3, gnmgp.n_params(n, 2))
    assert torch.isfinite(res["hmc_samples"]).all()
    rec = res["sampling"]
    assert set(rec) == {"sampler", "chains", "min_ess", "max_rhat", "accept", "step_size", "trajectory_length",
                        "mean_leapfrog"}
    assert rec["sampler"] == "chees" and rec["chains"] == 2 and rec["accept"] == res["hmc_accept"]
    assert np.isfinite([res["dic"], res["loo"]["elpd_loo"], res["test_rmse"], rec["step_size"]]).all()
    assert "latent_summary" in res and res["pred_grid"].percentiles.shape[0] == 11
    info = PredictEngine(str(tmp_path), device="cpu").info("0")
    assert info["n_draws"] == 6 and info["sampling"]["sampler"] == "chees"
    assert info["sampling"]["trajectory_length"] == pytest.approx(rec["trajectory_length"])


def test_run_subject_hadamard_chees_runs_every_stage():
    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(size=20))
    x, indx = np.repeat(t, 2), np.tile([0, 1], 20)
    keep = rng.uniform(size=40) > 0.25
    y = np.where(indx == 0, np.sin(6 * x), np.cos(4 * x)) + 0.1 * rng.normal(size=40)
    cfg = workflows.PipelineConfig(model="lmc", n_opt=3, do_hmc=True, do_loo=True, sampler="chees", n_hmc=3,
                                   hmc_warmup=2, n_chains=3, n_grid=11, test_size=0.2)
    res = workflows.run_subject_hadamard(x[keep], indx[keep], y[keep], 2, cfg, device="cpu")
    assert res["hmc_samples"].shape == (3 * 3, workflows.n_params("lmc", res["n"], 2))
    assert torch.isfinite(res["hmc_samples"]).all() and 0.0 <= res["hmc_accept"] <= 1.0
    assert np.isfinite([res["loo"]["elpd_loo"], res["test_sample_lpd"]]).all()
