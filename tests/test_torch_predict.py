"""The port's MAP prediction against the JAX package on the CPU, in float64.

Tolerances.  The kriging projection ``Σ⁻¹ K_cross`` solves the nugget-ed
smooth-RBF prior Gram, whose condition number is about 1e9 at these sizes.
The JAX package's own two kriging paths (numpy LU on the host, robust
Cholesky under ``jit``) already disagree by ~1e-7 absolute (~1e-5 relative
at small entries) on the kriged means, so the port's kriged latents are held
at 5e-7 absolute, a few times that spread, and everything downstream at
rtol 1e-6 with a matching small absolute floor for entries that pass near 0.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from nonstationary_multivariate_gaussian_process_tpu.models.base import FullData as JFullData
from nonstationary_multivariate_gaussian_process_tpu.predict import gnmgp as jpred
from nonstationary_multivariate_gaussian_process_tpu.predict import latent as jlatent
from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred
from nonstationary_multivariate_gaussian_process_tpu_torch.predict import latent

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

KRIGE_ATOL = 5e-7


def make_subject(rng, n, m):
    """Inputs, observations and a packed MAP vector near the sim truth."""
    t = m * (m + 1) // 2
    x = np.sort(rng.uniform(size=n))
    y = np.sin(6 * x)[:, None] * np.arange(1, m + 1)[None, :] + 0.1 * rng.normal(size=(n, m))
    tilde_l = 3 * (x - 1) ** 3 - 3 + 0.1 * rng.normal(size=n)
    ul = 0.3 * rng.normal(size=(n, t))
    vec = np.concatenate([tilde_l, ul.reshape(-1), [np.log(1e-2)]])
    return x, y, vec


@pytest.mark.parametrize("path", ["host", "jit"])
def test_krige_rbf_matches_both_jax_paths(rng, path):
    n = 48
    x, grid = np.sort(rng.uniform(size=n)), np.linspace(0.0, 1.0, 33)
    vals = rng.normal(size=(3, n))
    krige = lambda a, b, c: jlatent.krige_rbf(a, b, c, 0.0, 5.0, 1.0)
    if path == "jit":
        krige = jax.jit(krige)
    want = krige(jnp.asarray(x), jnp.asarray(grid), jnp.asarray(vals))
    got = latent.krige_rbf(torch.tensor(x), torch.tensor(grid), torch.tensor(vals), 0.0, 5.0, 1.0)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=0, atol=KRIGE_ATOL)
    # variances sit at the 1e-6 nugget scale near the data: 1e-13 absolute
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-6, atol=1e-13)
    assert (got.var >= 1e-6).all()


def test_krige_rbf_rejects_2d_inputs():
    with pytest.raises(ValueError, match="1-D"):
        latent.krige_rbf(torch.zeros(3, 2), torch.zeros(4), torch.zeros(3), 0.0, 1.0, 1.0)


@pytest.mark.parametrize("n,m", [(48, 2), (40, 3), (16, 5)])
def test_predict_map_matches_jax(rng, n, m):
    x, y, vec = make_subject(rng, n, m)
    grid = np.linspace(0.0, 1.0, 37)
    # jitted, as the other models' tests run it (op by op: seconds a shape)
    want = jax.jit(lambda v, xx, yy, gg: jpred.predict_map(v, JFullData(xx, yy), gg))(
        *(jnp.asarray(a) for a in (vec, x, y, grid)))
    got = pred.predict_map(vec, FullData(x, y), grid, device="cpu")
    assert got.mean.shape == (37, m) and got.percentiles.shape == (37, 3, m)
    assert got.mean.dtype == torch.float64 and got.mean.device.type == "cpu"
    np.testing.assert_allclose(got.l_vecs.numpy(), np.asarray(want.l_vecs), rtol=1e-8, atol=KRIGE_ATOL)
    for field in ("mean", "std", "percentiles"):
        w = np.asarray(getattr(want, field))
        np.testing.assert_allclose(
            getattr(got, field).numpy(), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=field
        )


def test_predict_map_launch_counts_stay_zero_on_cpu(rng):
    """On the CPU the wrappers take their plain versions and launch nothing."""
    x, y, vec = make_subject(rng, 16, 2)
    gram_kernels.reset_launches()
    pred.predict_map(vec, FullData(x, y), np.linspace(0, 1, 5), device="cpu")
    counts = gram_kernels.launches()
    assert {"gibbs_gram", "svc_gram"} <= set(counts) and set(counts.values()) == {0}


def test_predict_map_f32_tier_tracks_f64(rng):
    """The f32 tier (exact f32 Gram, f64 kriging island) against the f64 result."""
    x, y, vec = make_subject(rng, 32, 2)
    grid = np.linspace(0.0, 1.0, 9)
    g64 = pred.predict_map(vec, FullData(x, y), grid, device="cpu")
    g32 = pred.predict_map(vec, FullData(x, y), grid, device="cpu", dtype=torch.float32)
    assert g32.mean.dtype == torch.float32
    scale = g64.mean.abs().max().item()
    # f32 rounding through the MN×MN Cholesky at σ²=1e-2 gives errors of
    # ~1e-5 of the signal scale on the CPU; held at 1e-4
    np.testing.assert_allclose(g32.mean.double().numpy(), g64.mean.numpy(), atol=1e-4 * scale)
    np.testing.assert_allclose(g32.std.double().numpy(), g64.std.numpy(), rtol=1e-4)


def test_predict_map_without_device_needs_cuda(rng, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, vec = make_subject(rng, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pred.predict_map(vec, FullData(x, y), np.linspace(0, 1, 3))
