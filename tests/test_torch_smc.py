"""The port's tempered SMC against the JAX package on the CPU, in float64.

The port replays JAX's noise through its ``noise=`` hook: ``key, k_init =
split(key)`` and the initial normals; a stage ``key, k_res, k_mut =
split(key, 3)``, the resampler's uniform(s) from ``k_res``,
``split(k_mut, n_sweeps)`` and ``k_mom, k_acc = split(k)`` a sweep; the
truncation resample's uniform(s) from the carried key.  Given the same noise
both packages take the same schedule, resampling and accept decisions and
differ only by rounding.

Tolerances.  Resampled indices are equal; ESS fractions within 1e-12; every
field of ``SMCResult`` at rtol 1e-8 on a correlated Gaussian in 4
dimensions (64 particles, 32 on the row route; at most 12 stages).  Each JAX run is its own
compile of the host-dispatched stage (~1 s).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.inference import smc as jsmc
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import smc

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
DIM, N_PART = 4, 64


class JaxNoise:
    """The ``noise=`` object that replays JAX's ``smc_sample`` key threading."""

    def __init__(self, seed: int):
        self.key, self.k_init = jax.random.split(jax.random.PRNGKey(seed))

    def init(self, n, dim):
        return np.array(jax.random.normal(self.k_init, (n, dim), jnp.float64))

    def stage(self, i, res_shape, n_sweeps, mom_shape, acc_shape):
        self.key, k_res, k_mut = jax.random.split(self.key, 3)
        sweeps = []
        for k in jax.random.split(k_mut, n_sweeps):
            k_mom, k_acc = jax.random.split(k)
            sweeps.append((np.array(jax.random.normal(k_mom, mom_shape, jnp.float64)),
                           np.array(jax.random.uniform(k_acc, acc_shape, jnp.float64))))
        return np.array(jax.random.uniform(k_res, res_shape, jnp.float64)), sweeps

    def final(self, res_shape):
        return np.array(jax.random.uniform(self.key, res_shape, jnp.float64))


class GeneratorNoise:
    """The generator's draws in the documented order, made by hand."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def _r(self, shape):
        return torch.rand(shape, generator=self.gen, dtype=T64)

    def init(self, n, dim):
        return torch.randn((n, dim), generator=self.gen, dtype=T64)

    def stage(self, i, res_shape, n_sweeps, mom_shape, acc_shape):
        u = self._r(res_shape)
        drawn = []

        class Lazy:
            def __getitem__(_, j):
                while len(drawn) <= j:
                    drawn.append((torch.randn(mom_shape, generator=self.gen, dtype=T64), self._r(acc_shape)))
                return drawn[j]

        return u, Lazy()

    def final(self, res_shape):
        return self._r(res_shape)


_rng = np.random.default_rng(0)
_A = _rng.normal(size=(DIM, DIM))
PREC = 40.0 * (_A @ _A.T / DIM + np.eye(DIM))  # a correlated Gaussian well inside the prior
MU = 2.0 * _rng.normal(size=DIM)
PREC_T, MU_T = torch.tensor(PREC), torch.tensor(MU)


def jpot(q):
    d = q - MU
    return 0.5 * d @ (PREC @ d)


def jpot_batched(qs):
    d = qs - MU
    return 0.5 * jnp.sum(d * (d @ PREC.T), axis=-1)


def tpot(q):
    d = q - MU_T
    return 0.5 * d @ (PREC_T @ d)


def tpot_batched(qs):
    d = qs - MU_T
    return 0.5 * torch.sum(d * (d @ PREC_T.T), dim=-1)


def _close(got, want, rtol, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got.astype(float), np.asarray(want, float), rtol=rtol, atol=0, err_msg=name)


# ---------------------------------------------------------------------------
# Population math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_out", [None, 16])
@pytest.mark.parametrize("scheme", sorted(smc._RESAMPLERS))
def test_resamplers_match_jax(scheme, n_out):
    """Each scheme's indices, on the uniforms JAX draws from the same key."""
    rng = np.random.default_rng(3)
    lw = rng.normal(size=N_PART) * 3.0
    key = jax.random.PRNGKey(5)
    n = N_PART if n_out is None else n_out
    u = jax.random.uniform(key, smc._res_shape(scheme, n), jnp.float64)
    want = np.asarray(jsmc._RESAMPLERS[scheme](key, jnp.asarray(lw), n_out))
    got = smc._RESAMPLERS[scheme](torch.tensor(np.array(u)), torch.tensor(lw), n_out)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ess_fractions_match_jax():
    rng = np.random.default_rng(4)
    lw, dlw = rng.normal(size=N_PART) * 2.0, rng.normal(size=N_PART)
    _close(smc._ess_fraction(torch.tensor(lw)), jsmc._ess_fraction(jnp.asarray(lw)), 1e-12, "ess")
    _close(smc._cess_fraction(torch.tensor(lw), torch.tensor(dlw)),
           jsmc._cess_fraction(jnp.asarray(lw), jnp.asarray(dlw)), 1e-12, "cess")


def test_ess_estimate_matches_jax():
    runs = np.random.default_rng(6).normal(size=(4, 32, 15))
    assert smc.smc_ess_estimate(torch.tensor(runs)) == jsmc.smc_ess_estimate(runs)
    assert smc.smc_ess_estimate(runs, slots=[0, 3]) == jsmc.smc_ess_estimate(runs, slots=[0, 3])


@pytest.mark.parametrize("kw", [
    dict(waste_free=1), dict(waste_free=3, init_particles=np.zeros((N_PART, DIM))), dict(resample_ess=0.0),
    dict(resample_ess=1.5), dict(resample="bogus"), dict(metric="bogus"), dict(dispatch="bogus"),
    dict(adapt_mutations=True, waste_free=4), dict(resample_ess=0.5, waste_free=4),
], ids=["waste_free=1", "waste_free=3-init", "resample_ess=0", "resample_ess=1.5", "resample", "metric", "dispatch",
        "adapt-waste_free", "gated-waste_free"])
def test_argument_errors_match_jax(kw):
    """The port raises where JAX raises, with JAX's message."""
    with pytest.raises(ValueError) as want:
        jsmc.smc_sample(jpot, DIM, 0, N_PART, max_stages=1, **kw)
    with pytest.raises(ValueError) as got:
        smc.smc_sample(tpot, DIM, torch.Generator().manual_seed(0), N_PART, max_stages=1, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_smc_sample_needs_noise():
    with pytest.raises(ValueError, match="torch.Generator"):
        smc.smc_sample(tpot, DIM, None, N_PART, device="cpu")


# ---------------------------------------------------------------------------
# smc_sample against JAX, replayed noise
# ---------------------------------------------------------------------------

BASE = dict(max_stages=12, n_mutations=2, n_leapfrog=3, step_size=0.3)
#: Every option set on the batched potential (both packages), and the row
#: route (a per-vector potential) on two of them.
CASES = {
    "diag": dict(metric="diag"),
    "full": dict(metric="full"),
    "dr": dict(dr_reduction=2.0),
    "waste_free": dict(waste_free=4, metric="full"),
    "adapt_mutations": dict(adapt_mutations=True, n_mutations=4),
    "polish": dict(n_polish=2, metric="full"),
    **{f"gated_{r}": dict(resample_ess=0.5, resample=r) for r in ("systematic", "stratified", "residual",
                                                                  "multinomial")},
    "gated_truncated": dict(resample_ess=0.5, max_stages=2),
    "rows_diag": dict(potential_batched=False, metric="diag", n=32),
    "rows_dr": dict(potential_batched=False, dr_reduction=2.0, metric="full", n=32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_smc_sample_matches_jax(case):
    kw = {**BASE, "potential_batched": True, **CASES[case]}
    n = kw.pop("n", N_PART)
    batched = kw["potential_batched"]
    want = jsmc.smc_sample(jpot_batched if batched else jpot, DIM, 3, n, dispatch="host", **kw)
    got = smc.smc_sample(tpot_batched if batched else tpot, DIM, None, n, noise=JaxNoise(3), device="cpu",
                         dtype=T64, **kw)
    assert int(got.n_stages) == int(want.n_stages) and got.betas.shape == (kw["max_stages"],)
    for f in smc.SMCResult._fields:
        _close(getattr(got, f), getattr(want, f), 1e-8, f)
    if case == "gated_truncated":
        assert float(got.beta_final) < 1.0
    else:
        assert float(got.beta_final) == 1.0 and int(got.n_stages) >= 3


@pytest.mark.parametrize("kw", [dict(metric="full"), dict(dr_reduction=2.0, resample_ess=0.5, max_stages=3,
                                                          resample="stratified"),
                                dict(adapt_mutations=True, n_mutations=4, n_polish=1)],
                         ids=["full", "dr-gated-truncated", "adapt-polish"])
def test_generator_draw_order(kw):
    """A generator's run equals one whose noise is drawn by hand in the
    order the module docstring states."""
    kw = {**BASE, "potential_batched": True, **kw}
    a = smc.smc_sample(tpot_batched, DIM, torch.Generator().manual_seed(11), N_PART, **kw)
    b = smc.smc_sample(tpot_batched, DIM, None, N_PART, noise=GeneratorNoise(11), device="cpu", **kw)
    for f in smc.SMCResult._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_progress_and_dispatch():
    """``dispatch="host"`` and ``"device"`` give the same draws; ``progress``
    sees each stage, then each polish stage."""
    seen = {}
    runs = {d: smc.smc_sample(tpot_batched, DIM, torch.Generator().manual_seed(2), N_PART, dispatch=d, n_polish=1,
                              potential_batched=True, progress=seen.setdefault(d, []).append, **BASE)
            for d in ("device", "host")}
    for f in smc.SMCResult._fields:
        assert torch.equal(getattr(runs["device"], f), getattr(runs["host"], f)), f
    stages = seen["host"]
    assert len(stages) == int(runs["host"].n_stages) and stages[-1] == {**stages[-1], "polish": 1}
    assert [s["stage"] for s in stages[:-1]] == list(range(1, len(stages)))


def test_smc_sample_runs_shapes():
    r = smc.smc_sample_runs(tpot_batched, DIM, torch.Generator().manual_seed(1), 2, 32, potential_batched=True,
                            **BASE)
    assert r.particles.shape == (2, 32, DIM) and r.betas.shape == (2, BASE["max_stages"])
    assert r.logz.shape == r.n_stages.shape == r.beta_final.shape == (2,) and r.potentials.shape == (2, 32)
    assert not torch.equal(r.particles[0], r.particles[1])
    est = smc.smc_ess_estimate(r.particles)
    assert est["n_runs"] == 2 and est["n_particles"] == 32
