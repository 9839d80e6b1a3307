"""The sparse models in the Hadamard layout (``make_objective_hadamard`` of
``models/gnmgp_sparse.py``, ``models/snmgp_sparse.py`` and
``models/lmc_sparse.py``, their Woodbury factors, the separable tiers'
``_loglik_separable_hadamard`` and ``evaluate.
chain_conditional_loglik_sparse_hadamard``) against the JAX package on the
CPU, in float64.

The subject has channels missing at random, so times repeat in ``x``, and
``N_INDUCING`` quantiles of its 35 observations fall twice on one time: the
inducing set that comes back is shorter, and every vector is sized by it.
Each model's JAX references run in one ``jax.jit``ted function (op by op
they take seconds each): both approximations' values and gradients, the
Woodbury factors and the LOO conditionals of each draw, and for the
separable tiers the Khatri-Rao likelihood and the assembled one.  For the
factors both packages take JAX's ``SparseOps`` (``convert``); the
objectives build their own.

Tolerances.  Values and gradients at rtol 1e-6 (each package kriges with
its own projection, ~1e-8 apart).  On JAX's ops the Woodbury factors at
1e-9 of their scale, the Khatri-Rao likelihood at rtol 1e-9 against JAX's,
and at 1e-6 against JAX's assembled ``_assemble_hadamard`` →
``_woodbury_core`` path: that path puts one ridge on the assembled
``K_mm`` where the factored one puts one on each factor (~1e-7 apart, as
JAX's own test of the two records).  The LOO conditionals at rtol 1e-8.  A
padded ``mask=`` subject against its unpadded self at rtol 1e-9.  Under
``NMGP_PRECISION=mixed`` values at rtol 1e-8 and gradients within 5e-3 of
their largest entry (float32-class by design).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu import evaluate as jevaluate
from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp_sparse as jg
from nonstationary_multivariate_gaussian_process_tpu.models import lmc_sparse as jl
from nonstationary_multivariate_gaussian_process_tpu.models import snmgp_sparse as js
from nonstationary_multivariate_gaussian_process_tpu.models.base import HadamardData as JHadamardData
from nonstationary_multivariate_gaussian_process_tpu_torch import convert, evaluate, settings
from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse, lmc_sparse, snmgp_sparse
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import HadamardData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed

from test_torch_hadamard_models import hadamard_subject

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

M, N_INDUCING, S = 2, 20, 2
RTOL, FACTOR_RTOL, KR_RTOL, LOO_RTOL, PAD_RTOL = 1e-6, 1e-9, 1e-9, 1e-8, 1e-9
MIXED_VALUE_RTOL, MIXED_GRAD_TOL = 1e-8, 5e-3
MODELS = ("gnmgp_sparse", "snmgp_sparse", "lmc_sparse")
APPROXES = ("fitc", "vfe")
JAX_MOD = {"gnmgp_sparse": jg, "snmgp_sparse": js, "lmc_sparse": jl}
MOD = {"gnmgp_sparse": gnmgp_sparse, "snmgp_sparse": snmgp_sparse, "lmc_sparse": lmc_sparse}
OPS_FROM_JAX = {"gnmgp_sparse": convert.sparse_ops_from_jax, "snmgp_sparse": convert.snmgp_sparse_ops_from_jax,
                "lmc_sparse": convert.lmc_sparse_ops_from_jax}
FACTORS = ("c_mm", "a", "c_in", "lam", "d", "corr")


def _close(got, want, rtol=RTOL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max(), err_msg=err_msg)


def _vec(model: str, m_z: int, rng) -> np.ndarray:
    """A packed Hadamard vector near a fit: raw task-Cholesky entries."""
    if model == "gnmgp_sparse":
        return np.concatenate([np.log(0.15) + 0.1 * rng.normal(size=m_z),
                               (np.array([0.8, 0.3, 0.5]) + 0.1 * rng.normal(size=(m_z, 3))).reshape(-1), [-3.0]])
    if model == "snmgp_sparse":
        return np.concatenate([np.log(0.15) + 0.1 * rng.normal(size=m_z), 0.1 * rng.normal(size=m_z),
                               [0.8, 0.3, 0.5], [-3.0]])
    return np.array([np.log(0.15), 0.1, 0.8, 0.3, 0.5, -3.0])


class Tier:
    """One model: both packages' objectives under both approximations, JAX's
    references (one jitted function), a vector and a short chain."""

    def __init__(self, model, x, indx, y, rng):
        self.model, self.jmod, self.mod = model, JAX_MOD[model], MOD[model]
        self.jdata = JHadamardData(jnp.asarray(x), jnp.asarray(indx, jnp.int32), jnp.asarray(y))
        self.data = HadamardData(torch.tensor(x), torch.tensor(indx), torch.tensor(y))
        self.jnlp, self.nlp = {}, {}
        for approx in APPROXES:
            self.jnlp[approx], self.jops = self.jmod.make_objective_hadamard(self.jdata, M, n_inducing=N_INDUCING,
                                                                             approx=approx)
            self.nlp[approx], self.ops = self.mod.make_objective_hadamard(self.data, M, n_inducing=N_INDUCING,
                                                                          approx=approx)
        self.m_z = self.ops.z.shape[0]
        self.ops_j = OPS_FROM_JAX[model](self.jops, device="cpu")  # JAX's ops in the port
        self.vec = _vec(model, self.m_z, rng)
        self.chain = self.vec + 0.02 * rng.normal(size=(S, self.vec.size))
        references = jax.jit(self._references)
        self.want = references(jnp.asarray(self.vec))
        self.want_chain = [references(jnp.asarray(v)) for v in self.chain]

    def junpack(self, v):
        return self.jmod.unpack(v, M) if self.model == "lmc_sparse" else self.jmod.unpack(v, self.m_z, M)

    def unpack(self, v):
        return self.mod.unpack(v, M) if self.model == "lmc_sparse" else self.mod.unpack(v, self.m_z, M)

    def _references(self, v):
        out = {}
        p = self.junpack(v)
        for approx in APPROXES:
            out[f"vg_{approx}"] = jax.value_and_grad(self.jnlp[approx])(v)
            if self.model == "lmc_sparse":
                w = self.jmod._woodbury_hadamard(p, self.jdata, self.jops, M, approx)
            else:
                w = self.jmod._woodbury_hadamard(p, self.jdata, self.jops, M, approx, None)
            out[f"w_{approx}"] = w._replace(mv=None)
            out[f"loo_{approx}"] = jevaluate._loo_from_woodbury(w)
            out[f"loglik_{approx}"] = self.jmod.log_lik_hadamard(p, self.jdata, self.jops, M, approx=approx)
            if self.model != "gnmgp_sparse":
                pieces = (self.jmod._assemble_hadamard(p, self.jdata, self.jops, M) if self.model == "lmc_sparse"
                          else self.jmod._assemble_hadamard(p, self.jdata, self.jops, M, None))
                out[f"dense_{approx}"] = jg._loglik_pieces(pieces, jnp.exp(p.tilde_sigma2_err), approx)
        return out


@pytest.fixture(scope="module")
def subject():
    return hadamard_subject(28, M, seed=21)


@pytest.fixture(scope="module", params=MODELS)
def tier(request, subject):
    return Tier(request.param, *subject, np.random.default_rng(MODELS.index(request.param)))


def _value_and_grad(nlp, vec):
    v = torch.tensor(vec, requires_grad=True)
    val = nlp(v)
    (g,) = torch.autograd.grad(val, v)
    return val.item(), g.numpy()


def test_inducing_inputs_are_jaxs_and_drop_tied_quantiles(tier):
    np.testing.assert_array_equal(tier.ops.z.numpy(), np.asarray(tier.jops.z))
    assert tier.m_z < N_INDUCING  # two quantiles fell on one time
    want = lmc_sparse.n_params(M) if tier.model == "lmc_sparse" else tier.mod.n_params(tier.m_z, M)
    assert tier.vec.size == want


@pytest.mark.parametrize("approx", APPROXES)
def test_objective_value_and_gradient_match_jax(tier, approx):
    val, grad = _value_and_grad(tier.nlp[approx], tier.vec)
    want_val, want_grad = tier.want[f"vg_{approx}"]
    np.testing.assert_allclose(val, float(want_val), rtol=RTOL)
    _close(grad, want_grad, err_msg="gradient")


@pytest.mark.parametrize("approx", APPROXES)
def test_woodbury_factors_match_jax(tier, approx):
    p = tier.unpack(torch.tensor(tier.vec))
    if tier.model == "lmc_sparse":
        w = tier.mod._woodbury_hadamard(p, tier.data, tier.ops_j, M, approx)
    else:
        w = tier.mod._woodbury_hadamard(p, tier.data, tier.ops_j, M, approx, None)
    assert w.mv is None
    for f in FACTORS:
        _close(getattr(w, f).numpy(), getattr(tier.want[f"w_{approx}"], f), rtol=FACTOR_RTOL, err_msg=f)


@pytest.mark.parametrize("approx", APPROXES)
def test_likelihood_matches_jax_on_its_ops(tier, approx):
    """The GNMGP tier's assembled likelihood (``_loglik_pieces``), the
    separable tiers' Khatri-Rao one (``_loglik_separable_hadamard``), each
    against JAX's own; the latter also against JAX's assembled path."""
    got = tier.mod.log_lik_hadamard(tier.unpack(torch.tensor(tier.vec)), tier.data, tier.ops_j, M,
                                    approx=approx).item()
    np.testing.assert_allclose(got, float(tier.want[f"loglik_{approx}"]), rtol=KR_RTOL)
    if tier.model != "gnmgp_sparse":
        np.testing.assert_allclose(got, float(tier.want[f"dense_{approx}"]), rtol=RTOL)


@pytest.mark.parametrize("approx", APPROXES)
def test_loo_conditionals_match_jax(tier, approx):
    got = evaluate.chain_conditional_loglik_sparse_hadamard(tier.chain, tier.data, tier.ops_j, M, approx=approx,
                                                            model=tier.model, chunk=1, device="cpu")
    assert got.shape == (S, tier.data.y.shape[0]) and got.dtype == np.float64
    _close(got, np.stack([np.asarray(w[f"loo_{approx}"]) for w in tier.want_chain]), rtol=LOO_RTOL)


def test_padded_subject_matches_the_unpadded_one(tier, subject):
    """Padded rows (the last time repeated, task 0, y = 0) under ``mask=``
    leave the value and gradient as they are; the default Z is chosen among
    the real rows."""
    x, indx, y = subject
    n, pad = x.shape[0], 5
    padded = HadamardData(torch.tensor(np.concatenate([x, np.full(pad, x[-1])])),
                          torch.tensor(np.concatenate([indx, np.zeros(pad, int)])),
                          torch.tensor(np.concatenate([y, np.zeros(pad)])))
    mask = torch.arange(n + pad) < n
    for approx in APPROXES:
        nlp_p, ops_p = tier.mod.make_objective_hadamard(padded, M, n_inducing=N_INDUCING, approx=approx, mask=mask)
        torch.testing.assert_close(ops_p.z, tier.ops.z, rtol=0, atol=0)
        val_p, grad_p = _value_and_grad(nlp_p, tier.vec)
        val, grad = _value_and_grad(tier.nlp[approx], tier.vec)
        np.testing.assert_allclose(val_p, val, rtol=PAD_RTOL)
        _close(grad_p, grad, rtol=PAD_RTOL)


def test_mixed_tier_matches_f64(tier, monkeypatch):
    """``NMGP_PRECISION=mixed``: the GNMGP tier through ``_loglik_mixed_inner``,
    the separable ones through the inner system's mixed factor."""
    calls = []
    real = mixed.mixed_logdet_quad
    monkeypatch.setattr(mixed, "mixed_logdet_quad", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(settings, "robust_cholesky", True)
    monkeypatch.setattr(settings, "mixed_solves", True)
    val, grad = _value_and_grad(tier.nlp["fitc"], tier.vec)
    assert calls, "the mixed route was not taken"
    monkeypatch.setattr(settings, "mixed_solves", False)
    val64, grad64 = _value_and_grad(tier.nlp["fitc"], tier.vec)
    np.testing.assert_allclose(val, val64, rtol=MIXED_VALUE_RTOL)
    np.testing.assert_allclose(val, float(tier.want["vg_fitc"][0]), rtol=MIXED_VALUE_RTOL)
    assert np.abs(grad - grad64).max() <= MIXED_GRAD_TOL * np.abs(grad64).max()


def test_loo_refuses_a_model_with_no_sparse_hadamard_layout(tier):
    with pytest.raises(ValueError, match="no sparse Hadamard layout"):
        evaluate.chain_conditional_loglik_sparse_hadamard(tier.chain, tier.data, tier.ops, M,
                                                          model="gnmgp_hetero_sparse", device="cpu")
