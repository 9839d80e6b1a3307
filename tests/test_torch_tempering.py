"""The port's replica-exchange HMC against the JAX package on the CPU, in
float64.

The port replays JAX's noise: one key per draw, split into a transition key
and a swap key; the transition key splits into one key per replica, each
split into a momentum normal (P,) and an accept uniform; the swap key gives
the K - 1 swap uniforms.  Given the same noise both packages take the same
accept and swap decisions and differ only by rounding.

Tolerances.  On the correlated Gaussian (with the default standard-normal
reference) draws, potentials, acceptance and swap rates and step sizes are
held at rtol 1e-10; on the GNMGP objective (N=12, M=2) at rtol 1e-8.  The
adaptive runs stay within 22 draws (each replica's dual averaging feeds its
rounding into the next step).  Each JAX case is compiled once, in a
module-scoped fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.data import sim as jsim
from nonstationary_multivariate_gaussian_process_tpu.inference import empirical as jempirical
from nonstationary_multivariate_gaussian_process_tpu.inference import init as jinit
from nonstationary_multivariate_gaussian_process_tpu.inference import tempering as jtempering
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import tempering
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
FIELDS = ("samples", "potentials", "accept_stat", "swap_accept", "step_sizes", "betas")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=T64)


def jax_noise(key, n_total: int, k: int, p: int):
    """``(z (n_total, K, P), u (n_total, K), u_swap (n_total, K - 1))`` that
    JAX's ``tempered_hmc_sample`` draws from ``key``."""
    def one(kk):
        k_trans, k_swap = jax.random.split(kk)

        def replica(kr):
            k_mom, k_acc = jax.random.split(kr)
            return jax.random.normal(k_mom, (p,), jnp.float64), jax.random.uniform(k_acc, dtype=jnp.float64)

        z, u = jax.vmap(replica)(jax.random.split(k_trans, k))
        return z, u, jax.random.uniform(k_swap, (k - 1,), jnp.float64)

    return tuple(np.array(a) for a in jax.jit(jax.vmap(one))(jax.random.split(key, n_total)))


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


def jref(q):
    return 0.25 * jnp.sum((q - 1.0) ** 2)


def tref(q):
    return 0.25 * torch.sum((q - 1.0) ** 2)


@pytest.fixture(scope="module")
def gnmgp_subject():
    """A sim subject at N=12, M=2, both objectives and the empirical init."""
    d = jsim.sim_mnts(jax.random.PRNGKey(5), n=12, m=2)
    x, y = np.asarray(d.x), np.asarray(d.y)
    emp = jempirical.local_estimation(x, y, window_size=4, method="profile")
    init = np.asarray(jinit.gnmgp_from_empirical(emp, 12, 2))
    jobj = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    return jobj, gnmgp.make_objective(FullData(_t(x), _t(y))), init


#: name -> (potential pair or fixture name, n_samples, jax kwargs, port kwargs, rtol)
CASES = {
    "gauss_ladder_k4": ((jgauss, tgauss), 12, dict(n_replicas=4, beta_min=0.1, step_size=0.3, n_leapfrog=4,
                                                    n_warmup=10), {}, 1e-10),
    "gauss_betas_diag_mass_reference": ((jgauss, tgauss), 9,
                                        dict(betas=np.array([1.0, 0.5, 0.2]), step_size=0.4, n_leapfrog=3,
                                             n_warmup=4, mass_matrix=DIAG_MASS),
                                        dict(jax=dict(reference_fn=jref), port=dict(reference_fn=tref)), 1e-10),
    "gnmgp_k3": ("gnmgp_subject", 2, dict(n_replicas=3, beta_min=0.3, step_size=1e-3, n_leapfrog=3,
                                          n_warmup=2), {}, 1e-8),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    pots, n_samples, kw, per_side, rtol = CASES[request.param]
    if isinstance(pots, str):
        jpot, tpot, q0 = request.getfixturevalue(pots)
    else:
        (jpot, tpot), q0 = pots, Q0
    key = jax.random.PRNGKey(2)
    want = jtempering.tempered_hmc_sample(jpot, jnp.asarray(q0), n_samples, key, **kw, **per_side.get("jax", {}))
    k = len(kw["betas"]) if "betas" in kw else kw["n_replicas"]
    noise = jax_noise(key, n_samples + kw["n_warmup"], k, len(q0))
    got = tempering.tempered_hmc_sample(tpot, _t(q0), n_samples, noise=noise, **kw, **per_side.get("port", {}))
    return want, got, rtol


def test_tempered_hmc_sample_matches_jax(case):
    want, got, rtol = case
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        assert tuple(getattr(got, f).shape) == w.shape, f
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=f)
    assert got.samples.dtype == T64


def test_swaps_happen_on_the_gaussian_ladder():
    """Both sweeps propose and accept swaps; a swapped-in cold draw carries
    its potential (read off the sweep's values, not recomputed)."""
    kw = dict(n_replicas=4, beta_min=0.1, step_size=0.3, n_leapfrog=4, n_warmup=0)
    res = tempering.tempered_hmc_sample(tgauss, _t(Q0), 20, torch.Generator().manual_seed(1), **kw)
    assert (res.swap_accept > 0).all() and (res.swap_accept <= 1).all()
    np.testing.assert_allclose(res.potentials.numpy(), [float(tgauss(q)) for q in res.samples], rtol=1e-14)


@pytest.mark.parametrize("n,beta_min", [(1, 0.5), (4, 0.1), (8, 0.05)])
def test_geometric_ladder_matches_jax(n, beta_min):
    want = np.asarray(jtempering.geometric_ladder(n, beta_min, jnp.float64))
    got = tempering.geometric_ladder(n, beta_min, T64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0] == 1.0


def test_generator_draw_order_and_checks():
    """Per draw: each replica's normal and uniform, then the swap uniforms."""
    kw = dict(n_replicas=3, beta_min=0.2, step_size=0.3, n_leapfrog=2, n_warmup=1)
    a = tempering.tempered_hmc_sample(tgauss, _t(Q0), 3, torch.Generator().manual_seed(5), **kw)
    g = torch.Generator().manual_seed(5)
    zs, us, ss = [], [], []
    for _ in range(4):
        pairs = [(torch.randn(P, generator=g, dtype=T64), torch.rand((), generator=g, dtype=T64)) for _ in range(3)]
        zs.append(torch.stack([z for z, _ in pairs]))
        us.append(torch.stack([u for _, u in pairs]))
        ss.append(torch.rand(2, generator=g, dtype=T64))
    b = tempering.tempered_hmc_sample(tgauss, _t(Q0), 3, noise=(torch.stack(zs), torch.stack(us), torch.stack(ss)),
                                      **kw)
    assert torch.equal(a.samples, b.samples) and torch.equal(a.swap_accept, b.swap_accept)
    with pytest.raises(ValueError, match="generator"):
        tempering.tempered_hmc_sample(tgauss, _t(Q0), 3, **kw)
    with pytest.raises(ValueError, match="noise must be"):
        tempering.tempered_hmc_sample(tgauss, _t(Q0), 3, noise=(torch.stack(zs), torch.stack(us), torch.stack(zs)),
                                      **kw)
