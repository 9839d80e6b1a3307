"""The port's serving layer against the JAX package's, on the CPU in float64.

The store is written with the JAX package's ``ArtifactStore`` from a
hand-made MAP vector (no fit), so both engines serve the same numbers.  The
JAX engine runs its ``jit`` path (robust-Cholesky kriging); see
``test_torch_predict.py`` for why the comparison carries a small absolute
floor besides rtol 1e-6.
"""

import ast
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nonstationary_multivariate_gaussian_process_tpu.serving import PredictEngine as JaxEngine
from nonstationary_multivariate_gaussian_process_tpu.utils.artifacts import ArtifactStore as JaxStore
from nonstationary_multivariate_gaussian_process_tpu_torch import convert
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.serving import PredictEngine, serve
from nonstationary_multivariate_gaussian_process_tpu_torch.serving.engine import _bucket
from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

from test_torch_predict import make_subject

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "nonstationary_multivariate_gaussian_process_tpu_torch")


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_store"))
    store = JaxStore(root)
    rng = np.random.default_rng(7)
    for sid, (n, m) in {"0": (48, 2), "1": (40, 3)}.items():
        x, y, vec = make_subject(rng, n, m)
        store.save(JaxStore.key("gnmgp", "sim", sid, "data"), x=x, y=y)
        store.save(JaxStore.key("gnmgp", "sim", sid, "map"), vec=vec)
    return root


def _close(got, want):
    for k in ("mean", "std", "lower", "upper"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_bucket_matches_jax_engine():
    from nonstationary_multivariate_gaussian_process_tpu.serving import engine as jengine

    for g in (1, 7, 32, 33, 201, 1000, 1025, 3000):
        assert _bucket(g) == jengine._bucket(g)


def test_store_written_by_jax_loads_unchanged(store_root):
    subj = convert.subject_from_store(store_root, "1", device="cpu")
    raw = JaxStore(store_root).load(JaxStore.key("gnmgp", "sim", "1", "map"))["vec"]
    assert subj.data.x.shape == (40,) and subj.data.y.shape == (40, 3)
    np.testing.assert_array_equal(subj.vec.numpy(), raw)
    p = convert.params_from_jax(raw, 40, 3, device="cpu")
    np.testing.assert_array_equal(gnmgp.pack(p).numpy(), raw)
    assert ArtifactStore(store_root)._load_manifest() == JaxStore(store_root)._load_manifest()
    with pytest.raises(KeyError):
        convert.subject_from_store(store_root, "9", device="cpu")


@pytest.mark.parametrize("sid", ["0", "1"])
def test_engine_matches_jax_engine(store_root, sid):
    xs = np.linspace(0.05, 0.95, 7)  # both engines pad 7 -> 32 and crop
    eng = PredictEngine(store_root, device="cpu")
    assert eng.subject_ids() == ["0", "1"]
    got = eng.predict(sid, xs)
    _close(got, JaxEngine(store_root).predict(sid, xs))
    m = {"0": 2, "1": 3}[sid]
    assert got["mean"].shape == (7, m)
    assert np.all(got["lower"] <= got["mean"]) and np.all(got["mean"] <= got["upper"])
    info = eng.info(sid)
    assert info["n"] == {"0": 48, "1": 40}[sid] and info["m"] == m and not info["has_chain"]


def test_engine_errors_name_what_is_not_ported(store_root):
    eng = PredictEngine(store_root, device="cpu")
    with pytest.raises(KeyError, match="no stored HMC chain"):
        eng.predict("0", [0.5], mode="sample")
    with pytest.raises(ValueError, match="unknown model 'lmc_sparse_hadamard'"):  # every model of JAX's engine serves
        PredictEngine(store_root, model="lmc_sparse_hadamard", device="cpu")
    with pytest.raises(KeyError):
        eng.predict("nope", [0.5])
    with pytest.raises(ValueError, match="1-D"):
        eng.predict("0", [[0.5, 0.1]])


def test_concurrent_first_requests_load_the_subject_once(store_root, monkeypatch):
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import engine as engine_mod

    loads = []
    real = engine_mod.subject_from_store

    def slow_load(*args, **kwargs):
        loads.append(args[1])
        time.sleep(0.05)  # widen the window in which a second thread could enter
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_mod, "subject_from_store", slow_load)
    eng = PredictEngine(store_root, device="cpu")
    xs = np.linspace(0.1, 0.9, 5)
    calls = [lambda: eng.predict("1", xs)] * 3 + [lambda: eng.info("1")] * 2
    threads = [threading.Thread(target=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert loads == ["1"]


def test_engine_without_device_raises_when_cuda_is_absent(store_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictEngine(store_root)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(store_root, port=0)


def test_http_server_matches_jax_engine(store_root):
    httpd = serve(store_root, port=0, warm=False, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_port}"

    def post(body):
        req = urllib.request.Request(f"{base}/predict", data=json.dumps(body).encode(), method="POST")
        return json.load(urllib.request.urlopen(req, timeout=60))

    try:
        health = json.load(urllib.request.urlopen(f"{base}/health", timeout=60))
        assert health == {"status": "ok", "model": "gnmgp", "dataset": "sim", "subjects": 2}
        assert json.load(urllib.request.urlopen(f"{base}/subjects", timeout=60)) == {"subjects": ["0", "1"]}
        info = json.load(urllib.request.urlopen(f"{base}/subjects/0", timeout=60))
        assert info["n"] == 48 and info["m"] == 2
        xs = [0.1, 0.3, 0.5, 0.7, 0.9, 0.95, 0.99]
        out = {k: np.asarray(v) for k, v in post({"subject": "0", "x": xs}).items()}
        _close(out, JaxEngine(store_root).predict("0", np.asarray(xs)))
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"subject": "0", "x": [0.5], "mode": "sample"})
        assert ei.value.code == 404 and "no stored HMC chain" in json.load(ei.value)["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"subject": "42", "x": [0.5]})
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


FORBIDDEN = ("jax", "jaxlib", "optax", "nonstationary_multivariate_gaussian_process_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    """Absolute module names a file imports, including importlib calls."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args and isinstance(node.args[0], ast.Constant)
        ):
            yield node.args[0].value


def test_forbidden_prefix_match_is_exact():
    assert _forbidden("jax.numpy") and _forbidden("nonstationary_multivariate_gaussian_process_tpu.ops")
    assert not _forbidden("nonstationary_multivariate_gaussian_process_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_port_and_chip_smoke_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(PORT_PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for new in ("inference/pathfinder.py", "viz.py", "data/io.py", "examples/run_sim_pipeline.py",
                "predict/hadamard.py", "data/preprocess.py", "ops/mixed.py", "ops/blocked.py"):
        assert os.path.join(PORT_PKG, new) in files, new
    bad = {f: sorted({n for n in _imports(f) if _forbidden(n)}) for f in files}
    assert {f: n for f, n in bad.items() if n} == {}


def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``main`` runs only as a script)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_chip_smoke_check_grad_floors_a_subnormal_scale(dtype_name):
    """Where the autograd reference's largest |entry| is subnormal, a relative
    bound falls under one subnormal step: a pair a few steps apart, which the
    old rule (``GRAD_TOL · scale``) refused, passes against the floor of
    ``GRAD_TINY`` smallest normals; a pair at a normal scale off by more than
    the relative bound is refused by both rules."""
    smoke = _chip_smoke()
    dtype = getattr(torch, dtype_name)
    tiny, step = torch.finfo(dtype).tiny, torch.finfo(dtype).smallest_normal * torch.finfo(dtype).eps
    want = torch.tensor([3 * step, -step, 0.0], dtype=dtype)
    got = torch.tensor([5 * step, -2 * step, step], dtype=dtype)
    diff, scale = (got - want).abs().max().item(), want.abs().max().item()
    assert 0 < scale < tiny and diff > smoke.GRAD_TOL[dtype_name] * scale  # the old rule refused it
    assert smoke.check_grad(torch, "subnormal", [got], [want], dtype_name) == diff
    want = torch.tensor([1.0, -0.5], dtype=dtype)
    got = want + torch.tensor([30 * smoke.GRAD_TOL[dtype_name], 0.0], dtype=dtype)
    assert (got - want).abs().max().item() > smoke.GRAD_TOL[dtype_name] * 1.0  # the old rule refused it too
    with pytest.raises(AssertionError, match="off by"):
        smoke.check_grad(torch, "normal", [got], [want], dtype_name)
