"""Inducing-input refinement: the backward kernels' gradient in the inputs,
the traced sparse ops, the gradient in Z of every sparse model's traced
objective and ``gnmgp_sparse.refine_inducing``, against the JAX package on
the CPU, in float64.

The subject is the JAX package's own refinement subject
(``tests/test_refine_z.py``: N=48, M=2, m_z=8); the Hadamard one drops each
(time, channel) cell at random.  Each JAX reference runs ``jax.jit``ted (op
by op it takes seconds), and its refinement at a few steps: ``z_iters`` 4,
``vec_iters`` 8.

Tolerances.  A plain backward's x̄ against ``torch.autograd.grad`` through
the plain forward at 1e-12 relative (the same arithmetic, so they agree to
rounding); outputs that a launch shares with one not asked for x̄ are equal
bit for bit.  The traced ops, the Z-gradients and the refined ``(z, vec,
final_nlp)`` at rtol 1e-6, vectors with a floor of 1e-6 of their largest
|entry|: the packages' factors and solves round apart (~1e-10 here).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import settings as jsettings
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_sparse as jg
from nonstationary_multivariate_gaussian_process_tpu.models import lmc_sparse as jl
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp_sparse as js
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.models.base import HadamardData as JHadamardData
from nonstationary_multivariate_gaussian_process_tpu_torch import settings
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse, lmc_sparse, snmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData, HadamardData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, MZ = 48, 2, 8
RTOL, KERNEL_RTOL = 1e-6, 1e-12
Z_ITERS, VEC_ITERS = 4, 8
MODELS = ("gnmgp_sparse", "gnmgp_hetero_sparse", "snmgp_sparse", "lmc_sparse")
HADAMARD_MODELS = ("gnmgp_sparse", "snmgp_sparse", "lmc_sparse")


@pytest.fixture(autouse=True)
def robust_cholesky(monkeypatch):
    """Both packages' Cholesky ladder on (a collected ``bench.py`` turns it
    off with ``NMGP_ROBUST_CHOL=0``)."""
    monkeypatch.setattr(settings, "robust_cholesky", True)
    monkeypatch.setattr(jsettings, "robust_cholesky", True)


def jit_jax_objectives(mp):
    """Put the objectives that JAX's ``refine_inducing`` rebuilds at each
    refined Z (its refit's and its closing value's) on ``jax.jit``: op by op
    every primitive compiles on its first call, hundreds of small compiles
    a module.  The values agree with the op-by-op ones to rounding."""
    for mod in (jg, js, jl):
        for name in ("make_objective", "make_objective_hadamard", "make_objective_hetero"):
            if hasattr(mod, name):
                mp.setattr(mod, name, lambda *a, _f=getattr(mod, name), **k: (lambda nlp, ops: (jax.jit(nlp), ops))(
                    *_f(*a, **k)))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=T64, requires_grad=grad)


def _close(got, want, rtol=RTOL, err_msg=""):
    want = np.asarray(want, float)
    np.testing.assert_allclose(np.asarray(got, float), want, rtol=rtol, atol=rtol * np.abs(want).max(),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# The backward kernels' gradient in the inputs (plain versions on the CPU)
# ---------------------------------------------------------------------------


def _gibbs_inputs(rng, n):
    return (np.sort(rng.uniform(size=n)), rng.uniform(0.5, 2.0, n), np.exp(rng.uniform(-2.5, -0.5, n)))


def _backward_cases(rng):
    """(label, backward(input_grad), the inputs, the plain forward of them)."""
    x, s, l = (_t(a) for a in _gibbs_inputs(rng, 40))
    x2, s2, l2 = (_t(a) for a in _gibbs_inputs(rng, 9))
    cases = [("k1", lambda ig, kb: gk.gibbs_gram_backward(x, s, l, kb, 1e-6, input_grad=ig), (x, s, l),
              lambda x_, s_, l_: gk.gibbs_gram_plain(x_, s_, l_, x_, s_, l_, 1e-6), (40, 40)),
             ("k1x", lambda ig, kb: gk.gibbs_gram_cross_backward(x, s, l, x2, s2, l2, kb, input_grad=ig),
              (x, s, l, x2, s2, l2), gk.gibbs_gram_plain, (40, 9))]
    for n, m in ((30, 2), (7, 9)):
        xk, ek = _t(np.sort(rng.uniform(size=n))), _t(np.exp(rng.uniform(-2.5, -0.5, n)))
        lk = _t(np.tril(rng.normal(size=(n, m, m))) + 2.0 * np.eye(m))
        cases.append((f"k3 M={m}", lambda ig, kb, a=(xk, ek, lk): gk.svc_gram_tiled_backward(*a, kb, 1e-6,
                                                                                             input_grad=ig),
                      (xk, ek, lk), lambda x_, e_, l_: gk.svc_gram_tiled_plain(x_, e_, l_, 1e-6), (n * m, n * m)))
    return cases


@pytest.mark.parametrize("case", ["k1", "k1x", "k3 M=2", "k3 M=9"])
def test_backward_input_gradient_is_autograd_of_the_plain_forward(case):
    rng = np.random.default_rng(2201)
    label, backward, args, forward, shape = next(c for c in _backward_cases(rng) if c[0] == case)
    kbar = _t(rng.normal(size=shape))  # not symmetric
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(True) for a in args]
        want = torch.autograd.grad(forward(*leaves), leaves, kbar)
    got, base = backward(True, kbar), backward(False, kbar)
    n_base = len(base)
    # the inputs' x̄ come after the others: x (K1 self, K3), x1 and x2 (K1 cross)
    want_x = [want[i] for i in ((0, 3) if label == "k1x" else (0,))]
    for g, w in zip(got[n_base:], want_x):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=KERNEL_RTOL, atol=KERNEL_RTOL * w.abs().max().item())
    for i in range(n_base):
        assert torch.equal(got[i], base[i])  # what a launch without x̄ returns, bit for bit
    # without x̄ the backward is today's: autograd in σ and ℓ alone, x detached
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_(i not in ((0, 3) if label == "k1x" else (0,)))
                  for i, a in enumerate(args)]
        today = torch.autograd.grad(forward(*leaves), [a for a in leaves if a.requires_grad], kbar)
    assert all(torch.equal(g, w) for g, w in zip(base, today))


def test_functions_take_the_gradient_in_the_inputs():
    """The autograd Functions hand x̄ to whichever input asks for it."""
    rng = np.random.default_rng(2202)
    x, s, l = _gibbs_inputs(rng, 12)
    z, sz, lz = _gibbs_inputs(rng, 5)
    assert torch.autograd.gradcheck(lambda a, b: gk.gibbs_gram(a, _t(s), b, jitter=1e-6), (_t(x, True), _t(l, True)))
    assert torch.autograd.gradcheck(lambda b: gk.gibbs_gram(_t(x), _t(s), _t(l), b, _t(sz), _t(lz)), (_t(z, True),))
    assert torch.autograd.gradcheck(lambda a, b: gk.gibbs_gram(a, _t(s), _t(l), b, _t(sz), _t(lz)),
                                    (_t(x, True), _t(z, True)))
    ls = _t(np.tril(rng.normal(size=(5, 2, 2))) + 2.0 * np.eye(2))
    assert torch.autograd.gradcheck(lambda a: gk.svc_gram_tiled(a, _t(lz), ls, 1e-6), (_t(z, True),))
    with pytest.raises(NotImplementedError, match="never the inducing inputs"):
        gk.svc_gram_tiled_batched(_t(z, True), _t(lz[None]), ls[None], 1e-6)


def test_wrappers_pass_the_input_gradient_to_one_launch(monkeypatch):
    """The kernel branch on tensors with no storage ("meta"), the launch
    recorded: with ``input_grad`` one launch with x̄'s pointers and scratch
    sized for its slots; without, null pointers and today's scratch."""
    calls = []
    monkeypatch.setattr(gk, "_KERNEL_DEVICE_TYPES", ("cuda", "meta"))
    monkeypatch.setattr(gk, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "_launch", lambda name, dtype, device, *args: calls.append((name, args)))
    monkeypatch.setattr(gk, "_tickets", {})
    empty = torch.empty

    def sized(*shape, **kw):
        calls.append(("alloc", shape))
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", sized)
    meta = lambda *shape: torch.zeros(shape, dtype=T64, device="meta")
    for ig in (False, True):
        calls.clear()
        out = gk.gibbs_gram_backward(meta(1000), meta(1000), meta(1000), meta(1000, 1000), input_grad=ig)
        sched = gk.k1_backward_schedule(1000)
        assert len(out) == 2 + ig and calls[-1][0] == "gibbs_gram_backward"
        assert len(calls[-1][1]) == len(gk._ENTRY_POINTS["gibbs_gram_backward"][1])
        assert (calls[-1][1][-1] is None) == (not ig)
        assert ("alloc", (sched.partial_numel + ig * sched.n_tiles * 1000,)) in calls
        calls.clear()
        out = gk.gibbs_gram_cross_backward(*(meta(1000),) * 3, *(meta(256),) * 3, meta(1000, 256), input_grad=ig)
        xs = gk.k1_cross_backward_schedule(1000, 256)
        assert xs.col_groups == 4 and len(out) == 4 + 2 * ig
        assert len(calls[-1][1]) == len(gk._ENTRY_POINTS["gibbs_gram_cross_backward"][1])
        assert (calls[-1][1][-2:] == (None, None)) == (not ig)
        slots = xs.n_strips * 256 * 2 + 4 * 1000 * 2
        assert ("alloc", (slots + ig * (xs.n_strips * 256 + 4 * 1000),)) in calls
        for n, m in ((1000, 2), (1000, 9)):
            calls.clear()
            out = gk.svc_gram_tiled_backward(meta(n), meta(n), meta(n, m, m), meta(n * m, n * m), 1e-6, input_grad=ig)
            ks = gk.k3_backward_schedule(n, m)
            assert len(out) == 2 + ig and (calls[-1][1][-1] is None) == (not ig)
            assert len(calls[-1][1]) == len(gk._ENTRY_POINTS["svc_gram_tiled_backward"][1])
            extra = ks.n_tiles * (ks.n_bblocks * n * m if m > gk.K3_MAX_M else n)
            assert ("alloc", (ks.partial_numel + ig * extra,)) in calls


# ---------------------------------------------------------------------------
# The traced ops, the gradient in Z, refine_inducing
# ---------------------------------------------------------------------------


def _subject(seed=0):
    """``tests/test_refine_z.py``'s subject."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=N))
    y = np.sin(6 * x)[:, None] * np.array([1.0, 0.6]) + 0.1 * rng.normal(size=(N, M))
    return x, y


def _hadamard_subject(seed=4):
    """The full subject with each (time, channel) cell dropped at random."""
    x, y = _subject(seed)
    keep = np.random.default_rng(seed).uniform(size=(N, M)) > 0.3
    xs, ind = np.nonzero(keep)
    order = np.argsort(x[xs], kind="stable")
    return x[xs][order], ind[order], y[xs, ind][order]


def _data(hadamard):
    if hadamard:
        x, ind, y = _hadamard_subject()
        return (HadamardData(_t(x), torch.as_tensor(ind), _t(y)),
                JHadamardData(jnp.asarray(x), jnp.asarray(ind), jnp.asarray(y)))
    x, y = _subject()
    return FullData(_t(x), _t(y)), JFullData(jnp.asarray(x), jnp.asarray(y))


def _vec(model, rng):
    t = M * (M + 1) // 2
    parts = {"gnmgp_sparse": [-1.0 + 0.1 * rng.normal(size=MZ), 0.3 * rng.normal(size=MZ * t), [-3.0]],
             "gnmgp_hetero_sparse": [-1.0 + 0.1 * rng.normal(size=MZ), 0.3 * rng.normal(size=MZ * t),
                                     -3.0 + 0.1 * rng.normal(size=MZ * M)],
             "snmgp_sparse": [-1.0 + 0.1 * rng.normal(size=MZ), 0.1 * rng.normal(size=MZ),
                              0.3 * rng.normal(size=t), [-3.0]],
             "lmc_sparse": [[-1.0, 0.0], 0.3 * rng.normal(size=t), [-3.0]]}[model]
    return np.concatenate(parts)


def _z0(x):
    """m_z quantile inputs, nudged off the data so no Gram is degenerate."""
    return np.sort(np.quantile(x, np.linspace(0.02, 0.98, MZ)) + 1e-3 * np.sin(np.arange(MZ)))


def test_traced_ops_match_jax():
    x, _ = _subject()
    z = _z0(x)
    # JAX's three as one jitted program: one compile
    wants = jax.jit(lambda x_, z_: (jg.make_ops_traced(x_, z_), js.make_ops_traced(x_, z_),
                                    jg.make_ops_traced_hetero(x_, z_)))(jnp.asarray(x), jnp.asarray(z))
    gots = (gnmgp_sparse.make_ops_traced(_t(x), _t(z)), snmgp_sparse.make_ops_traced(_t(x), _t(z)),
            gnmgp_sparse.make_ops_traced_hetero(_t(x), _t(z)))
    for got, want in zip(gots, wants):
        flat_g, flat_w = jax.tree_util.tree_leaves(tuple(got)), jax.tree_util.tree_leaves(tuple(want))
        assert len(flat_g) == len(flat_w)
        for i, (g, w) in enumerate(zip(flat_g, flat_w)):
            _close(g.numpy(), w, err_msg=f"{type(got).__name__} leaf {i}")


Z_CASES = ([(m, False, a) for m, a in zip(MODELS, ("fitc", "vfe") * 2)]
           + [(m, True, a) for m, a in zip(HADAMARD_MODELS, ("vfe", "fitc", "vfe"))])


def _jax_nlp_z(model, data, m, approx):
    """JAX's ``refine_inducing`` objective in Z (its ``nlp_z``)."""
    hadamard = isinstance(data, JHadamardData)
    hypers, traced, unpack, logpost, _ = jg._refine_builders(model, hadamard)

    def nlp_z(z, vec):
        res, _ = logpost(unpack(vec, MZ, m), data, traced(data[0], z, hypers), m, approx=approx, hyper=hypers,
                         prior=True, mask=None)
        return -res

    return nlp_z


@pytest.fixture(scope="module")
def jax_z_gradients():
    """JAX's value and gradient in Z of every (model, layout, approximation)
    case, at the Z and vector the tests draw: one jitted program (one
    compile; seven cost ~15% more)."""
    jdata = {h: _data(h)[1] for h in (False, True)}
    zs = [jnp.asarray(_z0(np.asarray(jdata[h].x))) for _, h, _ in Z_CASES]
    vecs = [jnp.asarray(_vec(model, np.random.default_rng(7))) for model, _, _ in Z_CASES]
    fns = [jax.value_and_grad(_jax_nlp_z(model, jdata[h], M, approx)) for model, h, approx in Z_CASES]
    out = jax.jit(lambda zs_, vs: [f(z, v) for f, z, v in zip(fns, zs_, vs)])(zs, vecs)
    return dict(zip(Z_CASES, out))


@pytest.mark.parametrize("model,hadamard,approx", Z_CASES)
def test_gradient_in_z_matches_jax(model, hadamard, approx, jax_z_gradients):
    data, _ = _data(hadamard)
    vec = _vec(model, np.random.default_rng(7))
    z = _z0(data.x.numpy())
    jval, jgrad = jax_z_gradients[model, hadamard, approx]
    _, nlp_z, _ = gnmgp_sparse._z_objective(data, MZ, M if hadamard else None, None, approx, True, None, None, model)
    z_ = _t(z, True)
    val = nlp_z(z_, _t(vec))
    (grad,) = torch.autograd.grad(val, z_)
    np.testing.assert_allclose(val.item(), float(jval), rtol=RTOL)
    _close(grad.numpy(), jgrad)
    assert np.abs(np.asarray(jgrad)).max() > 0  # Z is not at a stationary point


@pytest.mark.parametrize("model,hadamard,approx,method", [("gnmgp_sparse", False, "fitc", "adam"),
                                                          ("snmgp_sparse", False, "vfe", "adam"),
                                                          ("lmc_sparse", True, "fitc", "adam")])
def test_refine_inducing_matches_jax(model, hadamard, approx, method, monkeypatch):
    jit_jax_objectives(monkeypatch)
    data, jdata = _data(hadamard)
    vec = _vec(model, np.random.default_rng(8))
    z = _z0(data.x.numpy())
    kw = dict(n_rounds=1, z_iters=Z_ITERS, vec_iters=VEC_ITERS, lr_vec=0.1, approx=approx, method=method,
              model=model, m=M if hadamard else None)
    jz, jvec, jops, jfinal = jg.refine_inducing(jdata, jnp.asarray(z), jnp.asarray(vec), **kw)
    gz, gvec, ops, final = gnmgp_sparse.refine_inducing(data, _t(z), _t(vec), **kw)
    _close(gz.numpy(), jz, err_msg="z")
    _close(gvec.numpy(), jvec, err_msg="vec")
    np.testing.assert_allclose(final, jfinal, rtol=RTOL)
    assert not np.allclose(gz.numpy(), z)  # Z moved
    assert torch.equal(ops.z, gz)  # the ops are rebuilt at the refined Z
    assert isinstance(ops, {"gnmgp_sparse": gnmgp_sparse, "snmgp_sparse": snmgp_sparse,
                            "lmc_sparse": lmc_sparse}[model].SparseOps)


def test_hetero_refinement_on_hadamard_data_raises_as_in_jax():
    data, jdata = _data(True)
    vec = _vec("gnmgp_hetero_sparse", np.random.default_rng(9))
    z = _z0(data.x.numpy())
    with pytest.raises(ValueError) as want:
        jg.refine_inducing(jdata, jnp.asarray(z), jnp.asarray(vec), m=M, model="gnmgp_hetero_sparse")
    with pytest.raises(ValueError) as got:
        gnmgp_sparse.refine_inducing(data, _t(z), _t(vec), m=M, model="gnmgp_hetero_sparse")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs the task count m"):
        gnmgp_sparse.refine_inducing(data, _t(z), _t(_vec("lmc_sparse", np.random.default_rng(9))),
                                     model="lmc_sparse")
