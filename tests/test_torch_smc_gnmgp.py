"""The batched GNMGP objective, K3 over a batch and the batched jitter ladder,
against the JAX package and the per-member versions on the CPU, in float64;
and tempered SMC on the whitened GNMGP potential, the batched route against
JAX's ``smc_sample`` on replayed noise and against the row route.

Tolerances.  The batched objective against ``jax.vmap`` of JAX's objective
and of its gradient at rtol 1e-9 (gradients with a floor of 1e-12 of the
row's largest entry), with a member whose plain factor fails and takes the
jitter rung in both packages (every ``L_n = [[1, 0], [1, e^-40]]``: its
Gram's rows (n, 0) and (n, 1) are equal bit for bit) and one whose factor
fails on both rungs (lengthscales ``e^1000``), NaN alone.  The batched K3
and its backward equal the per-member plain versions exactly (the CPU runs
them).  SMC at rtol 1e-8 against JAX; the row route equals the batched
route to 1e-10.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.inference import smc as jsmc
from nonstationary_multivariate_gaussian_process_tpu.inference import whiten as jwhiten
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu_torch import settings
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import smc, whiten
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import chol
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

from test_torch_smc import JaxNoise

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, B = 10, 2, 6


@pytest.fixture(scope="module", autouse=True)
def jitter_ladder():
    """The jitter ladder on in both packages for this module's tests and
    their JAX traces (a collected module may have set NMGP_ROBUST_CHOL=0
    before the settings were imported)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsettings, settings):
            mp.setattr(mod, "robust_cholesky", True)
        yield


def _subject(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=n))
    y = np.stack([np.sin(6 * x), np.cos(4 * x)], axis=1) + 0.1 * rng.normal(size=(n, 2))
    return x, y


def _population(n, b, seed):
    """B vectors near a plausible point; row 1 the jitter-rung member, row 2
    the failing one."""
    rng = np.random.default_rng(seed)
    p = gnmgp.n_params(n, M)
    v = 0.2 * rng.normal(size=(b, p))
    v[:, :n] += -1.5
    v[:, -1] = -3.0
    v[1] = 0.0
    v[1, n : 4 * n] = np.tile([0.0, 1.0, -40.0], n)
    v[1, -1] = -60.0
    v[2, :n] = 1000.0
    return v


@pytest.fixture(scope="module")
def objective():
    x, y = _subject(N, 0)
    v = _population(N, B, 1)
    jn = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    want_v = np.asarray(jax.jit(jax.vmap(jn))(jnp.asarray(v)))
    want_g = np.asarray(jax.jit(jax.vmap(jax.grad(jn)))(jnp.asarray(v)))
    data = FullData(torch.tensor(x), torch.tensor(y))
    return x, y, v, data, want_v, want_g


def _value_and_grad(f, v):
    vs = torch.tensor(v, requires_grad=True)
    val = f(vs)
    (g,) = torch.autograd.grad(val.sum(), vs)
    return val.detach().numpy(), g.numpy()


def _held(got, want, name):
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12 * np.max(np.abs(want)), err_msg=name)


def test_batched_objective_matches_jax_vmap(objective):
    x, y, v, data, want_v, want_g = objective
    got_v, got_g = _value_and_grad(gnmgp.make_objective_batched(data), v)
    for i in range(B):
        if i == 2:
            assert np.isnan(got_v[2]) and np.isnan(want_v[2])
            assert np.isnan(got_g[2]).all() and np.isnan(want_g[2]).all()
            continue
        assert np.isfinite(got_v[i]) and np.isfinite(got_g[i]).all()
        _held(got_v[i], want_v[i], f"value {i}")
        _held(got_g[i], want_g[i], f"gradient {i}")


def test_the_jitter_member_takes_the_rung_in_both_packages(objective):
    """Member 1's plain factor fails in JAX (NaNs) and in the port (info)."""
    x, y, v, data, _, _ = objective
    p = gnmgp.unpack(torch.tensor(v[1]), N, M)
    ls = gnmgp.chol_process(p.ul_vecs, N, M)
    cov = gk.svc_gram_tiled(data.x, torch.exp(p.tilde_l), ls, settings.jitter)
    cov = torch.diagonal_scatter(cov, torch.diagonal(cov) + torch.exp(p.tilde_sigma2_err))
    assert int(torch.linalg.cholesky_ex(cov)[1]) != 0
    # JAX's own Gram of the member (task-major), its plain factor; jitted (op by op: ~60 compiles)
    def jax_factor(vec):
        jp = jgnmgp.unpack(vec, N, M)
        jls = jgnmgp.chol_process(jp.ul_vecs, N, M)
        jcov = jgnmgp.gram(jgnmgp.kernels.nonstationary_rbf_cov(jnp.asarray(x), ell1=jnp.exp(jp.tilde_l)), jls)
        return jnp.linalg.cholesky(jcov + jnp.exp(jp.tilde_sigma2_err) * jnp.eye(N * M))

    assert not np.isfinite(np.asarray(jax.jit(jax_factor)(jnp.asarray(v[1])))).all()


def test_batched_objective_equals_the_per_vector_one(objective):
    """Row by row, the per-vector objective: values and gradients."""
    _, _, v, data, _, _ = objective
    f = gnmgp.make_objective(data)
    got_v, got_g = _value_and_grad(gnmgp.make_objective_batched(data), v)
    for i in (0, 1, 3):
        vs = torch.tensor(v[i], requires_grad=True)
        val = f(vs)
        (g,) = torch.autograd.grad(val, vs)
        np.testing.assert_allclose(got_v[i], val.item(), rtol=1e-12)
        np.testing.assert_allclose(got_g[i], g.numpy(), rtol=1e-9, atol=1e-12 * np.abs(g.numpy()).max())


def test_batched_objective_in_chunks(objective, monkeypatch):
    """A population cut into chunks (each chunk's gradient recomputed in the
    backward pass) gives the same rows."""
    _, _, v, data, _, _ = objective
    f = gnmgp.make_objective_batched(data)
    whole_v, whole_g = _value_and_grad(f, v)
    monkeypatch.setattr(gnmgp, "batch_rows", lambda b, nm, dtype, device: 2)
    got_v, got_g = _value_and_grad(f, v)
    np.testing.assert_allclose(got_v, whole_v, rtol=1e-12)
    np.testing.assert_allclose(got_g, whole_g, rtol=1e-9, atol=1e-12 * np.nanmax(np.abs(whole_g)))
    with torch.no_grad():
        np.testing.assert_allclose(f(torch.tensor(v)).numpy(), whole_v, rtol=1e-12)


def test_batch_rows_sizes_chunks_from_the_budget():
    per = gnmgp.BATCH_COPIES * 400 * 400 * 8
    assert gnmgp.batch_rows(256, 400, T64, torch.device("cpu")) == min(256, gnmgp.CPU_BATCH_BYTES // per)
    assert gnmgp.batch_rows(3, 400, T64, torch.device("cpu")) == 3
    assert gnmgp.batch_rows(5, 10**6, T64, torch.device("cpu")) == 1


def test_batched_objective_refuses_a_wrong_shape(objective):
    data = objective[3]
    f = gnmgp.make_objective_batched(data)
    with pytest.raises(ValueError, match=r"\(B, 41\)"):
        f(torch.zeros(41, dtype=T64))
    with pytest.raises(ValueError, match=r"\(B, 41\)"):
        f(torch.zeros(2, 40, dtype=T64))


def test_safe_cholesky_batched_is_the_ladder_per_member():
    """Each member as ``safe_cholesky`` alone: the plain factor, the jitter
    rung, NaN; and the gradient of each member as alone."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(4, 6, 6))
    spd = a @ a.transpose(0, 2, 1) + 6 * np.eye(6)
    v = rng.normal(size=(6, 1))
    spd[1] = v @ v.T  # rank one: the plain factor fails, the jitter rung succeeds
    spd[2] = -np.eye(6)  # fails on both rungs
    at = torch.tensor(spd, requires_grad=True)
    got = chol.safe_cholesky_batched(at)
    assert torch.isnan(got[2]).all() and torch.isfinite(got[[0, 1, 3]]).all()
    w = torch.tensor(rng.normal(size=(6, 6)))
    (g,) = torch.autograd.grad(torch.sum(torch.nan_to_num(got[[0, 1, 3]]) * w), at)
    for i in (0, 1, 3):
        ai = torch.tensor(spd[i], requires_grad=True)
        li = chol.safe_cholesky(ai)
        assert torch.equal(got[i].detach(), li.detach())
        (gi,) = torch.autograd.grad(torch.sum(li * w), ai)
        np.testing.assert_allclose(g[i].numpy(), gi.numpy(), rtol=1e-12, atol=1e-14)
    logdet, quad = chol.psd_logdet_quad_batched(at.detach()[[0, 1, 3]], torch.tensor(v[:, 0]))
    for k, i in enumerate((0, 1, 3)):
        ld, q = chol.psd_logdet_quad(torch.tensor(spd[i]), torch.tensor(v[:, 0]))
        np.testing.assert_allclose([logdet[k].item(), quad[k].item()], [ld.item(), q.item()], rtol=1e-12)


@pytest.mark.parametrize("n,m,b", [(7, 2, 3), (5, 3, 2), (4, 9, 2)])
def test_batched_k3_equals_the_per_member_plain_versions(n, m, b):
    gen = torch.Generator().manual_seed(n * m)
    x = torch.sort(torch.rand(n, generator=gen, dtype=T64)).values
    ell = torch.exp(-1.0 + 0.3 * torch.randn(b, n, generator=gen, dtype=T64))
    ls = torch.tril(torch.randn(b, n, m, m, generator=gen, dtype=T64)) + 2.0 * torch.eye(m, dtype=T64)
    kbar = torch.randn(b, n * m, n * m, generator=gen, dtype=T64)
    got = gk.svc_gram_tiled_batched(x, ell, ls, settings.jitter)
    assert torch.equal(got, torch.stack([gk.svc_gram_tiled_plain(x, ell[i], ls[i], settings.jitter)
                                         for i in range(b)]))
    e_, l_ = ell.clone().requires_grad_(True), ls.clone().requires_grad_(True)
    ge, gl = torch.autograd.grad(gk.svc_gram_tiled_batched(x, e_, l_, settings.jitter), (e_, l_), kbar)
    for i in range(b):
        we, wl = gk.svc_gram_tiled_backward_plain(x, ell[i], ls[i], settings.jitter, kbar[i])
        assert torch.equal(ge[i], we) and torch.equal(gl[i], wl)
    with pytest.raises(NotImplementedError, match="x is data"):
        gk.svc_gram_tiled_batched(x.clone().requires_grad_(True), ell, ls, settings.jitter)


def test_batched_wrappers_launch_their_entry_points(monkeypatch):
    """The kernel branch, on tensors with no storage ("meta"), the launch
    recorded: each batched wrapper launches its entry point once for the
    batch with the batched schedule, and counts there."""
    calls = []
    monkeypatch.setattr(gk, "_KERNEL_DEVICE_TYPES", ("cuda", "meta"))
    monkeypatch.setattr(gk, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "_launch", lambda name, dtype, device, *args: calls.append((name, args)))
    for fn in gk._WRAPPERS.values():
        monkeypatch.setattr(fn, "launches", 0)
    meta = lambda *shape: torch.zeros(shape, dtype=T64, device="meta")
    x, ell, ls, kbar = meta(200), meta(256, 200), meta(256, 200, 2, 2), meta(256, 400, 400)
    out = gk.svc_gram_tiled_batched(x, ell, ls, 1e-6)
    ell_bar, ls_bar = gk.svc_gram_tiled_batched_backward(x, ell, ls, kbar, 1e-6)
    assert out.shape == (256, 400, 400) and ell_bar.shape == (256, 200) and ls_bar.shape == (256, 200, 2, 2)
    fs = gk.k3_forward_schedule(200, 2, T64, 132, batch=256)
    bs = gk.k3_backward_schedule(200, 2, 132, batch=256)
    assert [name for name, _ in calls] == ["svc_gram_tiled_batched", "svc_gram_tiled_batched_backward"]
    assert all(len(args) == len(gk._ENTRY_POINTS[name][1]) for name, args in calls)  # ctypes' declared arguments
    assert calls[0][1][3:11] == (200, 2, 256, 1e-6, fs.vec, fs.rows, fs.warps, fs.grid)
    assert calls[1][1][3:7] == (200, 2, 256, 1e-6) and calls[1][1][8:10] == (bs.tile, bs.grid)
    assert {k: v for k, v in gk.launches().items() if v} == {"svc_gram_tiled_batched": 1,
                                                            "svc_gram_tiled_batched_backward": 1}
    assert bs.partial_numel == 256 * gk.k3_backward_schedule(200, 2, 132).partial_numel
    assert fs.grid * 256 <= 16 * 132 + 256 and gk.k3_forward_schedule(200, 2, T64, 132).grid > fs.grid


# ---------------------------------------------------------------------------
# SMC on the whitened GNMGP potential
# ---------------------------------------------------------------------------

SMC_N, SMC_PART = 8, 32
SMC_KW = dict(max_stages=3, n_mutations=2, n_leapfrog=3, metric="full")


@pytest.fixture(scope="module")
def whitened():
    x, y = _subject(SMC_N, 3)
    jw = jwhiten.make_whitener("gnmgp", jnp.asarray(x), SMC_N, M)
    jn = jgnmgp.make_objective(JFullData(jnp.asarray(x), jnp.asarray(y)))
    # the potential jitted: op by op its evaluations compiled ~140 programs
    want = jsmc.smc_sample(jax.jit(jw.wrap(jn)), jw.n_params, 4, SMC_PART, dispatch="host", **SMC_KW)
    data = FullData(torch.tensor(x), torch.tensor(y))
    w = whiten.make_whitener("gnmgp", data.x, SMC_N, M)
    return w, data, want


def test_whitened_gnmgp_smc_matches_jax(whitened):
    w, data, want = whitened
    got = smc.smc_sample(w.wrap(gnmgp.make_objective_batched(data)), w.n_params, None, SMC_PART,
                         noise=JaxNoise(4), device="cpu", potential_batched=True, **SMC_KW)
    assert int(got.n_stages) == 3 and np.all(np.asarray(want.betas) > 0)
    for f in smc.SMCResult._fields:
        np.testing.assert_allclose(getattr(got, f).numpy().astype(float), np.asarray(getattr(want, f), float),
                                   rtol=1e-8, err_msg=f)


def test_whitened_gnmgp_row_route_equals_the_batched_route(whitened):
    w, data, _ = whitened
    rows = smc.smc_sample(w.wrap(gnmgp.make_objective(data)), w.n_params, None, SMC_PART, noise=JaxNoise(4),
                          device="cpu", **SMC_KW)
    batched = smc.smc_sample(w.wrap(gnmgp.make_objective_batched(data)), w.n_params, None, SMC_PART,
                             noise=JaxNoise(4), device="cpu", potential_batched=True, **SMC_KW)
    for f in smc.SMCResult._fields:
        np.testing.assert_allclose(getattr(rows, f).numpy().astype(float), getattr(batched, f).numpy().astype(float),
                                   rtol=1e-10, err_msg=f)
