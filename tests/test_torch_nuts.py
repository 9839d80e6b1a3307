"""The port's NUTS sampler (``inference/nuts.py``) and the whitened and NUTS
branches of ``run_subject`` against the JAX package on the CPU, in float64.

The two packages cannot share a PRNG, so the sampler is held against JAX
with JAX's own noise: the test replays JAX's key threading (one key per
draw, split into a momentum key and a tree key; per doubling
``split(fold_in(k_tree, depth), 3)`` into a direction, a subtree and a merge
key, the leaf uniforms at ``fold_in(k_sub, leaf)``) and hands the normals,
directions and uniforms to the port as ``noise=``.  Given the same noise,
both chains build the same trees and differ only by rounding.

Tolerances.  On a Gaussian potential the packages do the same arithmetic in
another order: draws, potentials, acceptance statistics, step sizes and
inverse metrics at rtol 1e-10; tree depths, leaf counts and divergence flags
equal.  Dual averaging amplifies rounding by a factor of a few per draw once
the step settles (``test_torch_hmc.py``), so the adaptive cases run 20
draws or fewer.  On the GNMGP objective one gradient differs by ~1e-12
relative between the packages, and a draw chains tens of them: rtol 1e-8.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.inference import nuts as jnuts
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import nuts
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
P = 5
_rng = np.random.default_rng(0)
_A = _rng.normal(size=(P, P))
PREC = np.linalg.inv(_A @ _A.T / P + 0.3 * np.eye(P))
MU = _rng.normal(size=P)
Q0 = MU + _rng.normal(size=P)
MASS = np.exp(_rng.normal(size=P) * 0.5)


def jgauss(q):
    d = q - MU
    return 0.5 * d @ jnp.asarray(PREC) @ d


def tgauss(q):
    d = q - torch.as_tensor(MU)
    return 0.5 * d @ torch.as_tensor(PREC) @ d


def _t(a):
    return torch.tensor(np.array(a), dtype=T64)


#: The deepest tree any test builds; a shallower one reads a prefix of its
#: noise (a doubling's keys do not depend on max_depth).
MAX_DEPTH = 8


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_draw_noise(k, dim):
    """One draw's noise from its key ``k``, as ``nuts._transition`` derives it."""
    k_mom, k_tree = jax.random.split(k)

    def doubling(d):
        k_dir, k_sub, k_merge = jax.random.split(jax.random.fold_in(k_tree, d), 3)
        leaf = lambda i: jax.random.uniform(jax.random.fold_in(k_sub, i), dtype=jnp.float64)
        leaves = jax.vmap(leaf)(jnp.arange(2 ** (MAX_DEPTH - 1), dtype=jnp.int32))
        return jax.random.bernoulli(k_dir), leaves, jax.random.uniform(k_merge, dtype=jnp.float64)

    go_right, u_leaf, u_merge = jax.vmap(doubling)(jnp.arange(MAX_DEPTH, dtype=jnp.int32))
    return jax.random.normal(k_mom, (dim,), dtype=jnp.float64), go_right, u_leaf, u_merge


def jax_noise(key, n_total: int, dim: int, max_depth: int = MAX_DEPTH):
    """``(z, go_right, u_leaf, u_merge)`` that JAX's sampler draws from
    ``key``: ``split(key, n_total)``, one key a draw."""
    draws = [_jax_draw_noise(k, dim) for k in jax.random.split(key, n_total)]
    z, go_right, u_leaf, u_merge = (np.stack([np.asarray(d[i]) for d in draws]) for i in range(4))
    return z, go_right[:, :max_depth], u_leaf[:, :max_depth, : 2 ** (max_depth - 1)], u_merge[:, :max_depth]


def assert_chains_match(got, want, rtol):
    for f in ("tree_depth", "n_leapfrog", "diverging"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("samples", "potentials", "accept_stat", "step_size", "inv_mass"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=f)


def test_leaf_checkpoints_match_jax():
    leaves = np.arange(300, dtype=np.int32)
    want = jax.jit(jax.vmap(jnuts._leaf_ckpt_idxs))(jnp.asarray(leaves))
    got = np.array([nuts._leaf_ckpt_idxs(int(n)) for n in leaves])
    np.testing.assert_array_equal(got, np.stack([np.asarray(w) for w in want], axis=1))


def test_is_turning_matches_jax_and_batches():
    rng = np.random.default_rng(3)
    m_inv, r_r = np.exp(rng.normal(size=P)), rng.normal(size=P)
    r_l, rho = rng.normal(size=(64, P)), rng.normal(size=(64, P))
    want = [bool(jnuts._is_turning(m_inv, r_l[i], r_r, rho[i])) for i in range(64)]
    got = nuts._is_turning(_t(m_inv), _t(r_l), _t(r_r), _t(rho))
    assert got.shape == (64,) and got.tolist() == want and 0 < sum(want) < 64


#: (kept draws, nuts_sample keywords): the identity metric with steps too
#: short to turn within max_depth, a seeded fixed mass with dual averaging,
#: and windowed adaptation of step and metric.
GAUSS_CASES = {
    "identity-max-depth": (6, dict(step_size=0.01, n_warmup=0, max_depth=4, adapt_mass=False)),
    "mass-dual-averaging": (8, dict(step_size=0.3, n_warmup=6, adapt_mass=False, mass_matrix=MASS)),
    "windowed": (6, dict(step_size=0.3, n_warmup=14)),
}


@pytest.mark.parametrize("case", list(GAUSS_CASES))
def test_nuts_sample_matches_jax_draw_by_draw(case):
    n_samples, kw = GAUSS_CASES[case]
    key = jax.random.PRNGKey(7)
    want = jnuts.nuts_sample(jgauss, jnp.asarray(Q0), n_samples, key, **kw)
    max_depth = kw.get("max_depth", MAX_DEPTH)
    noise = jax_noise(key, n_samples + kw["n_warmup"], P, max_depth)
    got = nuts.nuts_sample(tgauss, _t(Q0), n_samples, noise=noise, **kw)
    assert got.samples.shape == (n_samples, P) and got.samples.dtype == T64
    assert_chains_match(got, want, rtol=1e-10)
    if case == "identity-max-depth":
        assert (got.tree_depth == max_depth).all() and (got.n_leapfrog == 2**max_depth - 1).all()
        assert torch.equal(got.inv_mass, torch.ones(P, dtype=T64))
    else:
        assert (got.tree_depth < max_depth).any()


def test_diverging_leaves_match_jax():
    """Past q[0] = b the potential is inf and below q[1] = c NaN: a leaf
    there diverges (ΔH = inf, NaN taken as inf), its subtree's proposal is
    discarded, the trajectory stops, and both packages agree draw by draw."""
    b, c = Q0[0] + 2.0, Q0[1] - 2.0
    jpot = lambda q: jgauss(q) + jnp.where(q[0] > b, jnp.inf, 0.0) + jnp.where(q[1] < c, jnp.nan, 0.0)
    tpot = lambda q: tgauss(q) + torch.where(q[0] > b, torch.inf, 0.0) + torch.where(q[1] < c, torch.nan, 0.0)
    key = jax.random.PRNGKey(3)
    kw = dict(step_size=0.4, n_warmup=0, adapt_mass=False, max_depth=6)
    want = jnuts.nuts_sample(jpot, jnp.asarray(Q0), 20, key, **kw)
    got = nuts.nuts_sample(tpot, _t(Q0), 20, noise=jax_noise(key, 20, P, 6), **kw)
    assert_chains_match(got, want, rtol=1e-10)
    assert got.diverging.any() and not got.diverging.all()
    assert torch.isfinite(got.samples).all() and torch.isfinite(got.potentials).all()
    assert (got.samples[:, 0] <= b).all() and (got.samples[:, 1] >= c).all()


def test_nuts_sample_chains_replay_and_generators():
    inits = _t(Q0 + np.random.default_rng(2).normal(size=(2, P)))
    kw = dict(step_size=0.3, n_warmup=3, max_depth=5)
    per_chain = [jax_noise(k, 7, P, 5) for k in jax.random.split(jax.random.PRNGKey(4), 2)]
    noise = tuple(np.stack([c[i] for c in per_chain]) for i in range(4))
    got = nuts.nuts_sample_chains(tgauss, inits, 4, noise=noise, **kw)
    assert got.samples.shape == (2, 4, P) and got.step_size.shape == (2,)
    for c in range(2):
        one = nuts.nuts_sample(tgauss, inits[c], 4, noise=per_chain[c], **kw)
        for f in nuts.NUTSResult._fields:
            assert torch.equal(getattr(got, f)[c], getattr(one, f)), f
    runs = [nuts.nuts_sample_chains(tgauss, inits, 4, torch.Generator().manual_seed(5), **kw) for _ in range(2)]
    assert torch.equal(runs[0].samples, runs[1].samples) and torch.isfinite(runs[0].samples).all()
    assert not torch.equal(runs[0].samples[0], runs[0].samples[1])
    with pytest.raises(ValueError, match="torch.Generator"):
        nuts.nuts_sample(tgauss, inits[0], 4, **kw)
    with pytest.raises(ValueError, match="noise must be"):
        nuts.nuts_sample(tgauss, inits[0], 4, noise=per_chain[0][:1] + per_chain[0][1:3] + per_chain[0][2:3], **kw)


# ---------------------------------------------------------------------------
# run_subject's whitened NUTS stage (n=16, GNMGP)
# ---------------------------------------------------------------------------

N, M = 16, 2
#: The chains held against JAX: one warmup draw, steps short enough that
#: no trajectory leaves the region where both packages' Cholesky factors
#: succeed (longer ones flip tree decisions on rounding).  The end-to-end
#: runs, held to nothing but themselves, take long steps and short trees.
CHAIN_CFG = dict(model="gnmgp", do_hmc=True, sampler="nuts", n_hmc=1, hmc_warmup=1, pncp_pilot=2,
                 hmc_step_size=0.05)
RUN_CFG = dict(CHAIN_CFG, n_hmc=3, hmc_warmup=2, hmc_step_size=1.0)


@pytest.fixture(scope="module")
def gnmgp_subject():
    rng = np.random.default_rng(8)
    x = np.sort(rng.uniform(size=N))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)], axis=1) + 0.3 * rng.normal(size=(N, M))
    vec = np.concatenate([np.full(N, -1.0), np.zeros(3 * N), [-2.0]]) + 0.02 * rng.normal(size=gnmgp.n_params(N, M))
    return x, y, vec


def _replay(monkeypatch, queue):
    """Make the port's ``nuts_sample`` replay ``queue``'s noise, one entry a
    chain, in place of the generator ``_run_chain`` hands it."""
    real = nuts.nuts_sample

    def replay(pot, q0, n_samples, generator=None, **kw):
        assert isinstance(generator, torch.Generator)
        return real(pot, q0, n_samples, noise=queue.pop(0), **kw)

    monkeypatch.setattr(nuts, "nuts_sample", replay)


@pytest.mark.parametrize("whiten", ["prior", "pncp"])
def test_whitened_nuts_chain_matches_jax(gnmgp_subject, monkeypatch, whiten):
    """JAX ``_make_sampling_whitener`` against the port's: for "pncp" its
    pilot chain (``_run_chain`` in the eig-mode prior-whitened space,
    replaying ``fold_in(key, 11)``'s noise) and the map retuned from it; for
    "prior" the prior factors and then the whitened chain of ``_run_chain``
    (``key``'s noise), held draw by draw.  The pncp main chain is the same
    whitened ``_run_chain`` on another map (run end to end below)."""
    x, y, vec = gnmgp_subject
    key = jax.random.PRNGKey(1)
    jcfg = jworkflows.PipelineConfig(whiten=whiten, **CHAIN_CFG)
    jnlp = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    jw = jworkflows._make_sampling_whitener(jnlp, jnp.asarray(vec), jcfg, key, jnp.asarray(x), N, M)

    p = gnmgp.n_params(N, M)
    queue = [jax_noise(key, CHAIN_CFG["n_hmc"] + CHAIN_CFG["hmc_warmup"], p)]
    if whiten == "pncp":
        queue = [jax_noise(jax.random.fold_in(key, 11), CHAIN_CFG["pncp_pilot"] + CHAIN_CFG["hmc_warmup"], p)]
    _replay(monkeypatch, queue)
    cfg = workflows.PipelineConfig(whiten=whiten, **CHAIN_CFG)
    nlp = gnmgp.make_objective(FullData(_t(x), _t(y)))
    tw = workflows._make_sampling_whitener(nlp, _t(vec), cfg, _t(x), N, M)
    for tb, jb in zip(tw.blocks, jw.blocks):
        for f in ("l", "basis", "scale"):
            if getattr(jb, f) is not None:
                np.testing.assert_allclose(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)), rtol=1e-8, err_msg=f)
    if whiten == "pncp":
        assert not queue
        np.testing.assert_allclose(tw.raw_scale.numpy(), np.asarray(jw.raw_scale), rtol=1e-8)
        return
    want, want_accept = jworkflows._run_chain(jnlp, jnp.asarray(vec), jcfg, key, whitener=jw)
    got, accept = workflows._run_chain(nlp, _t(vec), cfg, torch.Generator().manual_seed(0), whitener=tw)
    assert not queue
    assert got.shape == (CHAIN_CFG["n_hmc"], p) and got.dtype == T64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-8 * np.abs(want).max())
    np.testing.assert_allclose(accept, want_accept, rtol=1e-8)


@pytest.mark.parametrize("whiten", [True, "pncp"])
def test_run_subject_nuts_whitened_end_to_end(gnmgp_subject, tmp_path, whiten):
    """``run_subject(sampler="nuts", whiten=...)`` on the CPU, resuming a
    stored MAP: natural-space draws, the hmc and loo artifacts, DIC and
    LOO."""
    x, y, vec = gnmgp_subject
    store = ArtifactStore(str(tmp_path))
    store.save(ArtifactStore.key("gnmgp", "sim", 0, "map"), vec=vec, target_hist=np.zeros(1))
    cfg = workflows.PipelineConfig(whiten=whiten, do_loo=True, n_grid=11, **RUN_CFG)
    res = workflows.run_subject(x, y, cfg, store=store, dataset="sim", device="cpu", dtype=T64)
    samples = res["hmc_samples"]
    assert samples.shape == (cfg.n_hmc, gnmgp.n_params(N, M)) and samples.device.type == "cpu"
    assert torch.isfinite(samples).all() and 0.0 < res["hmc_accept"] <= 1.0
    assert "map" not in res["timings"] and np.isfinite(res["dic"])
    assert {"elpd_loo", "p_loo", "looic", "n_bad_k", "k_hat_max", "elpd_waic", "p_waic", "waic"} <= set(res["loo"])
    stored = store.load(ArtifactStore.key("gnmgp", "sim", 0, "hmc"))["samples"]
    np.testing.assert_array_equal(stored, samples.numpy())
    assert store.exists(ArtifactStore.key("gnmgp", "sim", 0, "loo"))
    # the chain moved in the natural space: not all draws at the MAP
    assert not torch.equal(samples[-1], _t(vec))


def test_unknown_whiten_setting_is_refused(gnmgp_subject):
    x, y, vec = gnmgp_subject
    cfg = workflows.PipelineConfig(whiten="svd", **CHAIN_CFG)
    with pytest.raises(ValueError, match="unknown whiten setting 'svd'"):
        workflows._make_sampling_whitener(None, _t(vec), cfg, _t(x), N, M)
