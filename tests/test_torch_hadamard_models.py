"""The port's Hadamard layout below the workflow: the three dense Hadamard
objectives, ``mask_dense_gram``, the Hadamard splits and preprocessing,
``hadamard_to_full``, and the named errors of ``run_subject_hadamard`` and
of every entry point without a device, against the JAX package on the CPU,
in float64.

The subjects have one observation per (time, channel) pair with channels
missing at random, so several times carry two or three observations: ``x``
has exact ties, as an ICU subject's does.

Tolerances.  The objectives sum the same terms in another order and factor
the same matrices (their Grams, and the GP priors' ``rbf_cov`` of tied
inputs, singular up to the jitter): value, components and gradient at rtol
1e-6.  Masked against unpadded, and the numpy helpers, are the same
arithmetic: rtol 1e-9 and exact.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import workflows as jworkflows
from nonstationary_multivariate_gaussian_process_tpu.data import io as jio
from nonstationary_multivariate_gaussian_process_tpu.data import preprocess as jpre
from nonstationary_multivariate_gaussian_process_tpu.models import base as jbase
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.models import lmc as jlmc
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp as jsnmgp
from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, models, workflows
from nonstationary_multivariate_gaussian_process_tpu_torch.data import io, preprocess
from nonstationary_multivariate_gaussian_process_tpu_torch.models import base, gnmgp, lmc, snmgp
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import hadamard as pred_h

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
MODELS = ("lmc", "snmgp", "gnmgp")
PORT = {"lmc": lmc, "snmgp": snmgp, "gnmgp": gnmgp}
JAX = {"lmc": jlmc, "snmgp": jsnmgp, "gnmgp": jgnmgp}


def _t(a, dtype=T64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def hadamard_subject(n_times: int, m: int, seed: int, p_drop: float = 0.3):
    """A Hadamard-layout subject: ``n_times`` sorted times, each (time,
    channel) cell kept with probability 1 − ``p_drop``, so times observed in
    several channels repeat in ``x``.  Returns ``(x, indx, y)``, ``x``
    non-decreasing."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(size=n_times))
    keep = rng.random((n_times, m)) >= p_drop
    ti, indx = np.nonzero(keep)
    x = times[ti]
    y = np.sin(2 * np.pi * (indx + 1) * x) + 0.2 * indx + 0.1 * rng.normal(size=x.shape[0])
    return x, indx, y


def model_vec(model: str, n: int, m: int, rng) -> np.ndarray:
    """A packed Hadamard vector near a plausible posterior mode: raw
    L-vectors (the Hadamard objectives apply no exp to their diagonals)."""
    t = transforms.tri_size(m)
    if model == "lmc":
        return np.concatenate([[np.log(0.3), 0.1], 0.6 * rng.normal(size=t), [-2.0]])
    if model == "snmgp":
        return np.concatenate([np.log(0.3) + 0.1 * rng.normal(size=n), 0.1 * rng.normal(size=n),
                               0.6 * rng.normal(size=t), [-2.0]])
    return np.concatenate([np.log(0.3) + 0.1 * rng.normal(size=n), 0.6 * rng.normal(size=n * t), [-2.0]])


@pytest.mark.parametrize("m,n_times", [(2, 20), (3, 14)])
@pytest.mark.parametrize("model", MODELS)
def test_objective_components_and_gradient_match_jax(model, m, n_times):
    x, indx, y = hadamard_subject(n_times, m, seed=m)
    assert len(np.unique(x)) < x.shape[0]  # tied times
    n = x.shape[0]
    vec = model_vec(model, n, m, np.random.default_rng(10 + m))
    jargs = (jnp.asarray(x), jnp.asarray(indx, jnp.int32), jnp.asarray(y))

    def jf(v):
        out = JAX[model].nlogpos_hadamard(v, *jargs, m, verbose=True)
        return out[0], out[1:]

    (jval, jcomps), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(vec))
    targs = (_t(x), torch.tensor(indx), _t(y))
    got = PORT[model].nlogpos_hadamard(_t(vec), *targs, m, verbose=True)
    np.testing.assert_allclose([float(g) for g in got], [float(jval), *map(float, jcomps)], rtol=1e-6)
    # the hoisted closure that run_subject_hadamard trains: value and gradient
    data = models.as_hadamard_data(x, indx, y, device="cpu")
    v = _t(vec).requires_grad_(True)
    val = PORT[model].make_objective_hadamard(data, m)(v)
    (grad,) = torch.autograd.grad(val, v)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6 * np.abs(jgrad).max())


def _padded(model, vec_r, n_real, pad, m):
    """``vec_r`` with its per-observation blocks extended over ``pad``
    padded slots by repeating the last real entry."""
    t = transforms.tri_size(m)
    if model == "lmc":
        return vec_r
    rep = lambda block, k: np.concatenate([block, np.tile(block[-k:], pad)])
    if model == "snmgp":
        return np.concatenate([rep(vec_r[:n_real], 1), rep(vec_r[n_real:2 * n_real], 1), vec_r[2 * n_real:]])
    return np.concatenate([rep(vec_r[:n_real], 1), rep(vec_r[n_real:n_real + n_real * t], t), vec_r[-1:]])


@pytest.mark.parametrize("model", MODELS)
def test_masked_likelihood_equals_unpadded(model):
    """Padded observations leave the likelihood exactly (the JAX package's
    ``TestHadamardMaskedLikelihood``), for the closure and the parity API."""
    rng = np.random.default_rng(7)
    n_real, pad, m = 14, 5, 2
    x_r = np.sort(rng.uniform(size=n_real))
    i_r = rng.integers(0, m, size=n_real)
    y_r = rng.normal(size=n_real)
    x_p = np.concatenate([x_r, x_r[-1] + np.mean(np.diff(x_r)) * np.arange(1, pad + 1)])
    i_p = np.concatenate([i_r, np.zeros(pad, int)])
    y_p = np.concatenate([y_r, np.zeros(pad)])
    mask = np.concatenate([np.ones(n_real, bool), np.zeros(pad, bool)])
    vec_r = 0.3 * model_vec(model, n_real, m, rng)
    vec_p = _padded(model, vec_r, n_real, pad, m)
    mod = PORT[model]
    unpack = (lambda v, k: mod.unpack(_t(v), m)) if model == "lmc" else (lambda v, k: mod.unpack(_t(v), k, m))
    dr = base.HadamardData(_t(x_r), torch.tensor(i_r), _t(y_r))
    dp = base.HadamardData(_t(x_p), torch.tensor(i_p), _t(y_p))
    ll_r, _ = mod.log_posterior_hadamard(unpack(vec_r, n_real), dr, m, prior=False)
    ll_p, _ = mod.log_posterior_hadamard(unpack(vec_p, n_real + pad), dp, m, prior=False, mask=torch.tensor(mask))
    np.testing.assert_allclose(ll_p.item(), ll_r.item(), rtol=1e-9)
    lik = lambda v, d, msk: mod.make_objective_hadamard(d, m, mask=msk, prior=False)(_t(v))
    np.testing.assert_allclose(lik(vec_p, dp, torch.tensor(mask)).item(), -ll_r.item(), rtol=1e-9)


def test_mask_dense_gram_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(7, 7))
    gram, y = a @ a.T, rng.normal(size=7)
    mask = np.array([1, 1, 0, 1, 0, 1, 1], bool)
    cov, ym = base.mask_dense_gram(_t(gram), torch.tensor(0.3, dtype=T64), _t(y), torch.tensor(mask))
    jcov, jym = jbase.mask_dense_gram(jnp.asarray(gram), 0.3, jnp.asarray(y), jnp.asarray(mask))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jcov))
    np.testing.assert_array_equal(ym.numpy(), np.asarray(jym))


@pytest.mark.parametrize("split", ["non", "non_shuffle_off", "chunk", "chunk_fix", "extrapolation"])
def test_splits_hold_out_the_same_points_as_jax(split):
    x, indx, y = hadamard_subject(30, 3, seed=5)
    if split == "non":
        args, fn = ((x, indx, y), dict(test_size=0.3, seed=4)), "data_split_non"
    elif split == "non_shuffle_off":
        args, fn = ((x, indx, y), dict(shuffle=False)), "data_split_non"
    elif split == "chunk":
        args, fn = ((x, indx, y), dict(chunk_size=0.25, seed=9)), "data_split_non_chunk"
    elif split == "chunk_fix":
        args, fn = ((x, indx, y), dict(fix=True)), "data_split_non_chunk"
    else:
        args, fn = ((x, np.stack([y, -y], 1)), dict(size=4)), "data_split_extrapolation"
    got = getattr(preprocess, fn)(*args[0], **args[1])
    want = getattr(jpre, fn)(*args[0], **args[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_standardization_round_trips_as_jax():
    rng = np.random.default_rng(1)
    y = rng.normal(loc=3.0, scale=2.0, size=(25, 3))
    for g, w in zip(preprocess.orig2adj(y), jpre.orig2adj(y)):
        np.testing.assert_array_equal(g, w)
    adj, trend, scale = preprocess.orig2adj(y)
    np.testing.assert_allclose(preprocess.adj2orig(adj, trend, scale), y, rtol=1e-13)
    series = [rng.normal(size=k) + k for k in (5, 9, 7)]
    got, want = preprocess.orig2adj_non(series), jpre.orig2adj_non(series)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.concatenate([np.ravel(a) for a in g]),
                                      np.concatenate([np.ravel(a) for a in w]))
    back = preprocess.adj2orig_non(*got)
    np.testing.assert_allclose(np.concatenate(back), np.concatenate(series), rtol=1e-13)


def test_hadamard_to_full_and_its_errors():
    rng = np.random.default_rng(2)
    times = np.sort(rng.uniform(size=6))
    y_full = rng.normal(size=(6, 3))
    perm = rng.permutation(18)
    x, indx = np.repeat(times, 3)[perm], np.tile(np.arange(3), 6)[perm]
    y = y_full.reshape(-1)[perm]
    got, want = io.hadamard_to_full(x, indx, y, 3), jio.hadamard_to_full(x, indx, y, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], y_full)
    for args, match in [((x[1:], indx[1:], y[1:]), "obs != 6 times x 3 tasks"),
                        ((x, np.where(np.arange(18) == 0, (indx[0] + 1) % 3, indx), y), "cells missing")]:
        for fn in (io.hadamard_to_full, jio.hadamard_to_full):
            with pytest.raises(ValueError, match=match):
                fn(*args, 3)


BAD_INPUTS = [
    ("lengths", lambda x, i, y: (x, i[:5], y), "lengths differ"),
    ("indices_high", lambda x, i, y: (x, i + 5, y), "task indices"),
    ("indices_negative", lambda x, i, y: (x, i - 1, y), "task indices"),
    ("too_few", lambda x, i, y: (x[:3], i[:3], y[:3]), "at least 4"),
    ("non_finite", lambda x, i, y: (x, i, y * np.nan), "non-finite"),
    ("two_d", lambda x, i, y: (x[:, None], i, y), "1-D"),
]


@pytest.mark.parametrize("name,bad,match", BAD_INPUTS, ids=[b[0] for b in BAD_INPUTS])
def test_validation_messages_match_jax(name, bad, match):
    x, indx, y = np.linspace(0, 1, 10), np.zeros(10, int), np.zeros(10)
    args = bad(x, indx, y)
    msgs = []
    for fn in (workflows._validate_hadamard, jworkflows._validate_hadamard):
        with pytest.raises(ValueError, match=match) as ei:
            fn(*args, 2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match=match):
        workflows.run_subject_hadamard(*args, 2, workflows.PipelineConfig(model="lmc", n_opt=5), device="cpu")


@pytest.mark.parametrize("model", ["gnmgp_hetero", "gnmgp_hetero_sparse"])
def test_models_without_a_ported_hadamard_objective_are_refused_by_name(model):
    x, indx, y = hadamard_subject(10, 2, seed=0)
    with pytest.raises(ValueError, match="not yet ported|no Hadamard(-layout)? objective"):
        workflows.run_subject_hadamard(x, indx, y, 2, workflows.PipelineConfig(model=model), device="cpu")


ENTRY_POINTS = {
    "run_subject_hadamard": lambda x, i, y: workflows.run_subject_hadamard(x, i, y, 2, workflows.PipelineConfig(
        model="lmc", n_opt=2)),
    "as_hadamard_data": lambda x, i, y: models.as_hadamard_data(x, i, y),
    "predict_map": lambda x, i, y: pred_h.lmc_predict_map(np.zeros(6), base.HadamardData(x, i, y), x, 2),
    "predict_test_sample": lambda x, i, y: pred_h.svc_predict_test_sample(
        None, np.zeros((1, 4 * x.shape[0] + 1)), base.HadamardData(x, i, y), x, i, 2),
    "loo_conditionals": lambda x, i, y: evaluate.chain_conditional_loglik_hadamard(
        "snmgp", np.zeros((1, 2 * x.shape[0] + 4)), x, i, y, 2),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_without_a_device_raise_when_cuda_is_absent(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, indx, y = hadamard_subject(8, 2, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](x, indx, y)


def test_hadamard_data_holds_long_task_indices_on_its_device():
    d = models.as_hadamard_data([0.1, 0.2], np.array([0, 1], np.int32), [1.0, 2.0], device="cpu",
                                dtype=torch.float32)
    assert d.indx.dtype == torch.long and d.x.dtype == torch.float32 and d.y.device.type == "cpu"
