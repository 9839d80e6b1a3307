"""The port's sampling prediction against the JAX package on the CPU, in float64.

Covers ``predict_sample`` (prediction over a chain), the three returns of
``predict_map_sampling`` and ``mode="sample"`` through the engine and
``POST /predict``.

The two packages cannot share a PRNG, so the port is given JAX's own
normals through ``noise=``: the test replays JAX's key threading (one key
per draw from ``split(key, S)``; for a y draw that key splits into three,
for ℓ̃, the L-entries and y).  Tolerances as in ``test_torch_predict.py``:
the kriged ℓ̃ and L-entries carry the two kriging solvers' ~1e-7 absolute
spread (held at 5e-7 absolute), everything downstream rtol 1e-6 with a
matching small absolute floor.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import gnmgp as jpred
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import latent
from nonstationary_multivariate_gaussian_process_tpu_torch.serving import PredictEngine, serve
from nonstationary_multivariate_gaussian_process_tpu_torch.serving.engine import _bucket
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_predict import KRIGE_ATOL, make_subject

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

N, M, S, G = 20, 2, 5, 9
T = M * (M + 1) // 2
HYPER = {"alpha_tilde_l": 10.0, "beta_tilde_l": 1.0, "alpha_L": 10.0, "beta_L": 1.0}


def _close(got, want, err_msg=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=err_msg)


@pytest.fixture(scope="module")
def subject():
    rng = np.random.default_rng(11)
    x, y, vec = make_subject(rng, N, M)
    chain = vec[None, :] + 0.02 * rng.normal(size=(S + 2, vec.size))
    grid = np.linspace(0.02, 0.98, G)
    return x, y, vec, chain, grid


def jax_y_noise(key, s):
    """The normals JAX's y draws take from ``key``: per draw
    ``(z_l (G,), z_ul (T, G), z_y (G, M))`` from ``split(split(key, s)[i], 3)``."""
    def one(k):
        k_l, k_ul, k_y = jax.random.split(k, 3)
        return (jax.random.normal(k_l, (G,), jnp.float64), jax.random.normal(k_ul, (T, G), jnp.float64),
                jax.random.normal(k_y, (G, M), jnp.float64))
    return tuple(np.array(a) for a in jax.vmap(one)(jax.random.split(key, s)))


def jax_noise(key, s, shape):
    """Normals of ``shape`` per draw from ``split(key, s)``."""
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float64))(jax.random.split(key, s)))


def _jdata(x, y):
    return JFullData(jnp.asarray(x), jnp.asarray(y))


def test_predict_sample_matches_jax_given_its_noise(subject):
    x, y, _, chain, grid = subject
    key = jax.random.PRNGKey(4)
    # jitted: JAX's vmapped draws run op by op otherwise (~12 s here)
    jax_sample = jax.jit(lambda k, c, d, g: jpred.predict_sample(k, c, d, g, hyper=HYPER, n_sample=S))
    want = np.asarray(jax_sample(key, jnp.asarray(chain), _jdata(x, y), jnp.asarray(grid)))
    got = pred.predict_sample(None, chain, FullData(x, y), grid, hyper=HYPER, n_sample=S, device="cpu",
                              noise=jax_y_noise(key, S))
    assert got.shape == want.shape == (G, S, M) and got.dtype == torch.float64
    _close(got.numpy(), want)


def _jax_map_sampling(**kw):
    """JAX's predict_map_sampling over S draws, jitted (op by op its
    vmapped draws took seconds a call)."""
    return jax.jit(lambda k, v, d, g: jpred.predict_map_sampling(k, S, v, d, g, hyper=HYPER, **kw))


def test_predict_map_sampling_smoothness_matches_jax(subject):
    x, y, vec, _, grid = subject
    key = jax.random.PRNGKey(5)
    want = np.asarray(_jax_map_sampling(pred_smoothness=True)(key, jnp.asarray(vec), _jdata(x, y),
                                                               jnp.asarray(grid)))
    got = pred.predict_map_sampling(None, S, vec, FullData(x, y), grid, hyper=HYPER, pred_smoothness=True,
                                    device="cpu", noise=jax_noise(key, S, (G,)))
    assert got.shape == want.shape == (G, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=KRIGE_ATOL)


def test_predict_map_sampling_cov_matches_jax(subject):
    x, y, vec, _, grid = subject
    key = jax.random.PRNGKey(6)
    want = np.asarray(_jax_map_sampling(pred_cov=True)(key, jnp.asarray(vec), _jdata(x, y), jnp.asarray(grid)))
    got = pred.predict_map_sampling(None, S, vec, FullData(x, y), grid, hyper=HYPER, pred_cov=True,
                                    device="cpu", noise=jax_noise(key, S, (T, G)))
    assert got.shape == want.shape == (G, S, M, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=KRIGE_ATOL)
    assert (np.triu(got.numpy(), 1) == 0).all() and (np.diagonal(got.numpy(), axis1=-2, axis2=-1) > 0).all()


def test_predict_map_sampling_y_matches_jax(subject):
    x, y, vec, _, grid = subject
    key = jax.random.PRNGKey(7)
    want = _jax_map_sampling()(key, jnp.asarray(vec), _jdata(x, y), jnp.asarray(grid))
    got = pred.predict_map_sampling(None, S, vec, FullData(x, y), grid, hyper=HYPER, device="cpu",
                                    noise=jax_y_noise(key, S))
    assert isinstance(got, pred.SampledPrediction) and got.quantiles.shape == (G, 2, M)
    for f in ("quantiles", "mean", "std"):
        _close(getattr(got, f).numpy(), getattr(want, f), err_msg=f)


def test_kriging_projection_is_computed_once_per_call(subject, monkeypatch):
    x, y, _, chain, grid = subject
    calls = []
    real = latent.krige_proj
    counted = lambda *a: calls.append(a) or real(*a)
    monkeypatch.setattr(pred, "krige_proj", counted)
    monkeypatch.setattr(latent, "krige_proj", counted)
    pred.predict_sample(torch.Generator().manual_seed(0), chain, FullData(x, y), grid, device="cpu")
    assert len(calls) == 2  # one per latent prior, not per draw
    calls.clear()
    pred.predict_map(chain[0], FullData(x, y), grid, device="cpu")
    assert len(calls) == 2


def test_n_sample_takes_the_last_draws_and_a_seed_fixes_the_draws(subject):
    x, y, _, chain, grid = subject
    gen = lambda seed: torch.Generator().manual_seed(seed)
    data = FullData(x, y)
    first = pred.predict_sample(gen(1), chain, data, grid, n_sample=3, device="cpu")
    assert first.shape == (G, 3, M)
    torch.testing.assert_close(first, pred.predict_sample(gen(1), chain[-3:], data, grid, device="cpu"),
                               rtol=0, atol=0)
    assert not torch.equal(first, pred.predict_sample(gen(2), chain[-3:], data, grid, device="cpu"))
    g1, g2 = gen(3), gen(3)
    a = pred.predict_map_sampling(g1, 4, chain[0], data, grid, device="cpu")
    b = pred.predict_map_sampling(g2, 4, chain[0], data, grid, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_sampling_without_device_raises_when_cuda_is_absent(subject, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, vec, chain, grid = subject
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pred.predict_sample(torch.Generator(), chain, FullData(x, y), grid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pred.predict_map_sampling(torch.Generator(), 2, vec, FullData(x, y), grid)


@pytest.fixture(scope="module")
def chain_store(subject, tmp_path_factory):
    x, y, vec, chain, _ = subject
    root = str(tmp_path_factory.mktemp("chain_store"))
    store = ArtifactStore(root)
    key = lambda sid, stage: ArtifactStore.key("gnmgp", "sim", sid, stage)
    for sid in ("0", "1"):
        store.save(key(sid, "data"), x=x, y=y)
        store.save(key(sid, "map"), vec=vec)
    store.save(key("0", "hmc"), samples=chain)
    return root


def _stats(draws):
    """JAX's engine's statistics over (G, S, M) draws, in numpy."""
    return {"mean": draws.mean(axis=1), "std": draws.std(axis=1),
            "lower": np.percentile(draws, 2.5, axis=1), "upper": np.percentile(draws, 97.5, axis=1)}


def _engine_reference(subject, xs, n_sample, seed, calls=1):
    """predict_sample on the engine's padded grid from a generator with the
    engine's seed, after ``calls - 1`` earlier requests of the same size."""
    x, y, _, chain, _ = subject
    g = len(xs)
    grid = np.concatenate([xs, np.full(_bucket(g) - g, xs[-1])])
    gen = torch.Generator().manual_seed(seed)
    for _ in range(calls):
        draws = pred.predict_sample(gen, chain[-n_sample:], FullData(x, y), grid, device="cpu")
    return _stats(draws[:g].numpy())


def test_engine_sample_mode_equals_predict_sample(subject, chain_store):
    xs = np.linspace(0.05, 0.95, 7)
    eng = PredictEngine(chain_store, seed=3, device="cpu")
    info = eng.info("0")
    assert info["has_chain"] and info["n_draws"] == S + 2
    assert not eng.info("1")["has_chain"]
    gram_kernels.reset_launches()
    for calls in (1, 2):  # the engine's generator moves on between requests
        got = eng.predict("0", xs, mode="sample", n_sample=4)
        want = _engine_reference(subject, xs, 4, seed=3, calls=calls)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == (7, M)
            np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=1e-14, err_msg=k)
    assert gram_kernels.launches() == dict.fromkeys(gram_kernels.launches(), 0)  # the CPU launches nothing
    with pytest.raises(KeyError, match="no stored HMC chain"):
        eng.predict("1", xs, mode="sample")
    with pytest.raises(ValueError, match="unknown mode"):
        eng.predict("0", xs, mode="median")


def test_http_sample_mode_equals_predict_sample(subject, chain_store):
    httpd = serve(chain_store, port=0, warm=False, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_port}"

    def post(body):
        req = urllib.request.Request(f"{base}/predict", data=json.dumps(body).encode(), method="POST")
        return json.load(urllib.request.urlopen(req, timeout=60))

    try:
        xs = [0.1, 0.3, 0.5, 0.7, 0.9]
        out = post({"subject": "0", "x": xs, "mode": "sample", "n_sample": 3})
        want = _engine_reference(subject, np.asarray(xs), 3, seed=0)
        for k, w in want.items():
            np.testing.assert_allclose(np.asarray(out[k]), w, rtol=1e-12, atol=1e-14, err_msg=k)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"subject": "1", "x": xs, "mode": "sample"})
        assert ei.value.code == 404 and "no stored HMC chain" in json.load(ei.value)["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
