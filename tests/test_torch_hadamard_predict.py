"""The Hadamard layout's prediction and LOO helpers outside a workflow run:
``evaluate.observation_cov_hadamard`` for each model and the masked
``chain_conditional_loglik_hadamard`` against the JAX package on the CPU, in
float64, on a subject with tied times; the sample predictors' generator
path; and :func:`jax_noise`, which replays the normals JAX's sample
predictors draw: JAX splits its key into one key a chain draw, and each of
those into three for the SNMGP and GNMGP (ℓ̃ at the grid, σ̃ or the L-entry
processes, y) or uses it for y alone (LMC).  Every predictor is held against
JAX's on the inputs of JAX's own workflow run in
``test_torch_hadamard_workflow.py``.

Tolerances.  The observation covariances are the same products: rtol 1e-12.
The LOO conditionals take a factor and a solve against I: rtol 1e-8.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate
from nonstationary_multivariate_gaussian_process_tpu_torch.models import HadamardData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import hadamard as pred_h

from test_torch_hadamard_models import hadamard_subject, model_vec

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
M = 2
MODELS = ("lmc", "snmgp", "gnmgp")
#: The predictor family name of each model in both packages' ``predict.hadamard``.
NAME = {"lmc": "lmc", "snmgp": "snmgp", "gnmgp": "svc"}
S = 3


def close(got, want, rtol=1e-6, err_msg=""):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=err_msg)


def jax_noise(model: str, key, s: int, g: int, m: int):
    """The standard normals JAX's ``<model>_predict_sample`` draws from
    ``key`` over ``s`` chain draws at ``g`` points, in the port's ``noise=``
    layout."""
    keys = jax.random.split(key, s)
    normal = lambda k, shape: np.asarray(jax.random.normal(k, shape, jnp.float64))
    if model == "lmc":
        return np.stack([normal(k, (g, m)) for k in keys])
    shapes = ((g,), (g,), (g, m)) if model == "snmgp" else ((g,), (transforms.tri_size(m), g), (g, m))
    split = [jax.random.split(k, 3) for k in keys]
    return tuple(np.stack([normal(ks[i], shape) for ks in split]) for i, shape in enumerate(shapes))


@pytest.fixture(scope="module")
def subject():
    x, indx, y = hadamard_subject(20, M, seed=11)
    return x, indx, y


@pytest.mark.parametrize("model", MODELS)
def test_observation_cov_matches_jax(subject, model):
    x, indx, _ = subject
    vec = model_vec(model, x.shape[0], M, np.random.default_rng(13))
    cov = evaluate.observation_cov_hadamard(model, torch.tensor(vec), torch.tensor(x), torch.tensor(indx), M)
    # jitted (op by op the LMC covariance took ~2 s)
    want = jax.jit(lambda v, xx, ii: jevaluate.observation_cov_hadamard(model, v, xx, ii, M))(
        jnp.asarray(vec), jnp.asarray(x), jnp.asarray(indx))
    close(cov.numpy(), want, rtol=1e-12)


def test_masked_loo_conditionals_match_jax(subject):
    """Masked observations leave every draw's conditionals and score 0 (the
    unmasked path is held against JAX's workflow in
    ``test_torch_hadamard_workflow.py``)."""
    x, indx, y = subject
    rng = np.random.default_rng(14)
    chain = model_vec("gnmgp", x.shape[0], M, rng) + 0.02 * rng.normal(size=(S, 4 * x.shape[0] + 1))
    mask = np.arange(x.shape[0]) % 5 != 3
    got = evaluate.chain_conditional_loglik_hadamard("gnmgp", chain, x, indx, y, M, mask=mask, chunk=2,
                                                     device="cpu")
    want = jevaluate.chain_conditional_loglik_hadamard("gnmgp", chain, x, indx, y, M, mask=mask)
    assert got.shape == (S, x.shape[0]) and got.dtype == np.float64
    close(got, want, rtol=1e-8)
    assert (got[:, ~mask] == 0).all()


@pytest.mark.parametrize("model", MODELS)
def test_sample_predictors_draw_from_a_generator(subject, model):
    """Without ``noise=``: the last ``n_sample`` draws of a chain, normals
    from the generator, the same draws from the same seed."""
    x, indx, y = subject
    rng = np.random.default_rng(15)
    vec = model_vec(model, x.shape[0], M, rng)
    chain = vec + 0.02 * rng.normal(size=(4, vec.shape[0]))
    grid, i_grid = np.linspace(0, 1, 6), np.arange(6) % M
    draw = lambda seed: getattr(pred_h, f"{NAME[model]}_predict_test_sample")(
        torch.Generator().manual_seed(seed), chain, HadamardData(x, indx, y), grid, i_grid, M, n_sample=3,
        device="cpu")
    ys = draw(0)
    assert ys.shape == (6, 3) and torch.isfinite(ys).all()
    assert torch.equal(ys, draw(0)) and not torch.equal(ys, draw(1))
