"""The port's whitened parameterizations (``inference/whiten.py``,
``ops/chol.prior_rbf_eig``) against the JAX package on the CPU, in float64.

Both packages build the prior factors on the host in float64 with the same
numpy and LAPACK calls, so within one process the factors and the
eigenbases are bit-equal; the eigenbasis of the near-degenerate cluster at
the jitter floor is arbitrary, so eig-mode maps are never compared across
processes.  The maps are a few small products and solves: rtol 1e-10.  A
whitened potential differentiates the model's objective through the map,
and the objectives agree at rtol 1e-6 (the port's north star), so its value
and gradient are held there; the JAX gradient is the objective's jitted
gradient pulled back through ``from_white`` with ``jax.vjp``, which is
``jax.grad`` of the wrapped potential, without one compile a whitener.

The JAX side of each model runs as one ``jax.jit``ted program, the
whiteners' arrays its arguments and their block layouts static: op by op,
each first call of a JAX primitive at a new shape compiles, and a compile
a map cost seconds a model.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.inference import whiten as jwhiten
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_hetero as jhetero
from nonstationary_multivariate_gaussian_process_tpu.models import lmc as jlmc
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp as jsnmgp
from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.ops import chol as jchol
from nonstationary_multivariate_gaussian_process_tpu_torch import convert
from nonstationary_multivariate_gaussian_process_tpu_torch.inference import whiten
from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp, gnmgp_hetero, lmc, snmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import chol

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
N, M, S = 10, 2, 6
MODELS = {"gnmgp": (gnmgp, jgnmgp), "snmgp": (snmgp, jsnmgp), "gnmgp_hetero": (gnmgp_hetero, jhetero),
          "lmc": (lmc, jlmc)}
VARIANTS = (("chol", False), ("chol", True), ("eig", False), ("eig", True))
CASES = [(model, mode, hadamard) for model in MODELS for mode, hadamard in VARIANTS]
IDS = [f"{model}-{mode}{'-hadamard' if h else ''}" for model, mode, h in CASES]


def _t(a):
    return torch.tensor(np.array(a), dtype=T64)


def _close(got, want, rtol, err_msg=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=err_msg)


def _n_params(model):
    return MODELS[model][0].n_params(M) if model == "lmc" else MODELS[model][0].n_params(N, M)


_rng = np.random.default_rng(5)
X = np.sort(_rng.uniform(size=N))
Y = np.stack([np.sin(5 * X), np.cos(3 * X)], axis=1) + 0.3 * _rng.normal(size=(N, M))


def _natural(model, seed, shape=()):
    """Natural-space vectors near a plausible posterior: log-scales about
    -0.5, the rest of order 0.3."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (_n_params(model),)) * 0.3 - 0.5


def _inputs(model):
    """The points every map is evaluated at, the natural point of the
    wrapped potential (``vec0``) and two sets of pilot draws."""
    return dict(u=_natural(model, 1), v=_natural(model, 2), us=_natural(model, 3, (S,)), vs=_natural(model, 4, (S,)),
                vec0=_natural(model, 7), d1=_natural(model, 11, (S,)), d2=_natural(model, 12, (S,)))


def _split(w):
    """A JAX whitener as (static layout, arrays), for ``jax.jit``."""
    blocks = tuple(b._replace(l=None, basis=None, scale=None) for b in w.blocks)
    return (blocks, w.n_params), (tuple((b.l, b.basis, b.scale) for b in w.blocks), w.raw_scale)


def _join(static, arrays):
    blocks, n_params = static
    return jwhiten.Whitener(tuple(b._replace(l=l, basis=basis, scale=scale)
                                  for b, (l, basis, scale) in zip(blocks, arrays[0])), n_params, arrays[1])


@functools.lru_cache(maxsize=None)
def _jax_reference(model):
    """Every JAX result the tests of ``model`` need, from one jitted program:
    for each (mode, hadamard) whitener its maps at the inputs, the point
    ``to_white(vec0)`` and the wrapped potential's gradient there (the
    objective's gradient at vec0 pulled back through ``from_white``); the
    objective's value at vec0; and two retunes of the eig-mode whitener.
    Returns ``(whiteners, results)``."""
    ws = {(mode, h): jwhiten.make_whitener(model, jnp.asarray(X), N, M, hadamard=h, mode=mode) for mode, h in VARIANTS}
    static = {var: _split(w)[0] for var, w in ws.items()}
    nlp = MODELS[model][1].make_objective(JFullData(jnp.asarray(X), jnp.asarray(Y)))

    @jax.jit
    def run(arrays, inp):
        value, g = jax.value_and_grad(nlp)(inp["vec0"])
        out = {"value": value, "variants": []}
        for i, var in enumerate(VARIANTS):
            w = _join(static[var], arrays[i])
            u_w = w.to_white(inp["vec0"])
            out["variants"].append((w.from_white(inp["u"]), w.to_white(inp["v"]), w.from_white_batch(inp["us"]),
                      w.to_white_batch(inp["vs"]), w.logdet(), u_w, jax.vjp(w.from_white, u_w)[1](g)[0]))
        w1 = jwhiten.retune(_join(static["eig", False], arrays[VARIANTS.index(("eig", False))]), inp["d1"])
        w2 = jwhiten.retune(w1, inp["d2"], interp=0.5, floor=0.05)
        out["retune"] = [(_split(w)[1], w.from_white(inp["u"]), w.logdet()) for w in (w1, w2)]
        return out

    out = run([_split(ws[var])[1] for var in VARIANTS], {k: jnp.asarray(v) for k, v in _inputs(model).items()})
    return ws, jax.tree_util.tree_map(np.asarray, out)


def test_prior_rbf_eig_matches_jax_bit_for_bit():
    ju, js = jchol.prior_rbf_eig(jnp.asarray(X), 5.0, 1.0)
    tu, ts = chol.prior_rbf_eig(_t(X), 5.0, 1.0)
    assert tu.dtype == T64 and tu.shape == (N, N)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("model,mode,hadamard", CASES, ids=IDS)
def test_whitener_maps_match_jax(model, mode, hadamard):
    ws, ref = _jax_reference(model)
    jw, want = ws[mode, hadamard], ref["variants"][VARIANTS.index((mode, hadamard))]
    tw = whiten.make_whitener(model, _t(X), N, M, hadamard=hadamard, mode=mode)
    assert tw.n_params == jw.n_params == _n_params(model)
    assert len(tw.blocks) == len(jw.blocks) == {"gnmgp": 2, "snmgp": 2, "gnmgp_hetero": 3, "lmc": 0}[model]
    for tb, jb in zip(tw.blocks, jw.blocks):
        assert (tb.start, tb.stop, tb.k, tb.rows, tb.mu) == (jb.start, jb.stop, jb.k, jb.rows, jb.mu)
        for f in ("l", "basis", "scale"):
            j = getattr(jb, f)
            assert (getattr(tb, f) is None) == (j is None)
            if j is not None:  # host float64 factors in both: bit for bit
                np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(j), err_msg=f)
    inp = _inputs(model)
    got = (tw.from_white(_t(inp["u"])), tw.to_white(_t(inp["v"])), tw.from_white_batch(_t(inp["us"])),
           tw.to_white_batch(_t(inp["vs"])), tw.logdet().reshape(1))
    for name, g, w in zip(("from_white", "to_white", "from_white_batch", "to_white_batch", "logdet"), got, want):
        assert g.dtype == T64 and tuple(g.shape) == (w.shape or (1,)), name
        _close(g.numpy(), w.reshape(g.shape), 1e-10, name)
    _close(tw.from_white(tw.to_white(_t(inp["v"]))).numpy(), inp["v"], 1e-10, "round trip")


@pytest.mark.parametrize("model,mode,hadamard", CASES, ids=IDS)
def test_wrapped_potential_matches_jax(model, mode, hadamard):
    """``wrap(nlp)``'s value and gradient in the whitened space (autograd
    through ``from_white``) against JAX's at the objectives' rtol 1e-6."""
    _, ref = _jax_reference(model)
    want = ref["variants"][VARIANTS.index((mode, hadamard))]
    tw = whiten.make_whitener(model, _t(X), N, M, hadamard=hadamard, mode=mode)
    u = tw.to_white(_t(_inputs(model)["vec0"]))
    _close(u.numpy(), want[5], 1e-10, "to_white(vec0)")
    nlp = MODELS[model][0].make_objective(FullData(_t(X), _t(Y)))
    val, grad = value_and_grad(tw.wrap(nlp), u)
    assert torch.isfinite(val) and torch.isfinite(grad).all()
    _close([val.item()], [float(ref["value"])], 1e-6, "value")
    _close(grad.numpy(), want[6], 1e-6, "gradient")


@pytest.mark.parametrize("model", list(MODELS))
def test_retune_matches_jax(model):
    """A retune of a JAX whitener carried across, given the same natural
    draws, twice: from the prior map and again (at interp 0.5, floor 0.05)
    from JAX's retuned map, so that the second starts from a raw scale."""
    ws, ref = _jax_reference(model)
    inp = _inputs(model)
    jw0 = ws["eig", False]
    jw1 = _join(_split(jw0)[0], ref["retune"][0][0])
    for start, draws, kw, (arrays, w_vec, w_logdet) in ((jw0, inp["d1"], {}, ref["retune"][0]),
                                                       (jw1, inp["d2"], dict(interp=0.5, floor=0.05), ref["retune"][1])):
        got = whiten.retune(convert.whitener_from_jax(start, device="cpu", dtype=T64), _t(draws), **kw)
        for tb, (_, basis, scale) in zip(got.blocks, arrays[0]):
            _close(tb.scale.numpy(), scale, 1e-10, "scale")
            np.testing.assert_array_equal(tb.basis.numpy(), basis)
        _close(got.raw_scale.numpy(), arrays[1], 1e-10, "raw_scale")
        _close(got.from_white(_t(inp["u"])).numpy(), w_vec, 1e-10, "from_white")
        _close([got.logdet().item()], [float(w_logdet)], 1e-10, "logdet")
    kept = whiten.retune(convert.whitener_from_jax(jw0, device="cpu", dtype=T64), _t(inp["d1"]), raw=False)
    assert kept.raw_scale is None


def test_retune_refuses_chol_mode_and_bad_draws():
    w = whiten.make_whitener("gnmgp", _t(X), N, M)  # chol mode
    draws = _t(_natural("gnmgp", 3, (S,)))
    with pytest.raises(ValueError, match="eig"):
        whiten.retune(w, draws)
    with pytest.raises(ValueError, match=r"samples must be \(n_draws"):
        whiten.retune(w, draws[:, :-1])


def test_make_whitener_refuses_unknown_mode_and_model():
    with pytest.raises(ValueError, match="mode must be"):
        whiten.make_whitener("gnmgp", _t(X), N, M, mode="svd")
    with pytest.raises(ValueError, match="unknown model"):
        whiten.make_whitener("gp", _t(X), N, M)


def test_from_white_is_differentiable_and_leaves_its_input_alone():
    """Autograd runs through the map (the chain's gradient), and the input
    is not written: the output is assembled, not updated in place."""
    w = whiten.make_whitener("snmgp", _t(X), N, M, mode="eig")
    u = _t(_natural("snmgp", 9)).requires_grad_(True)
    before = u.detach().clone()
    out = w.from_white(u)
    (g,) = torch.autograd.grad(out.sum(), u)
    assert torch.equal(u.detach(), before) and torch.isfinite(g).all()
    # d(sum from_white)/du is the column sums of the map: ones outside the blocks
    outside = np.ones(w.n_params, bool)
    for b in w.blocks:
        outside[b.start : b.stop] = False
    assert torch.equal(g[torch.as_tensor(outside)], torch.ones(int(outside.sum()), dtype=T64))
