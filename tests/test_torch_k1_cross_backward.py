"""K1's cross-form backward: the wrapper, its schedule emulated on the CPU,
and its autograd function, against the JAX package's gradient.

The CUDA kernel (``gibbs_gram_cross_bwd_kernel`` in ``csrc/gibbs_gram.cu``)
runs only on the card, where ``chip_smoke.py`` holds it against autograd
through the plain version.  Here a vectorised torch emulation follows the
kernel's schedule as ``gram_kernels.k1_cross_backward_schedule`` gives it:
block ``b`` takes the row strip ``b·rows ..`` (warp ``w`` its rows ``b·rows
+ w + 8k``), staged with x = 0, σ = 0, ℓ = 1 past N1; the columns go by in
chunks of 32 along the lanes, with x = 0, σ = 0, ℓ = 1 and K̄ = 0 past N2.
Each term is evaluated with one root and no division (q = 1/sqrt(A), r =
q², g = u_i u_j q·exp(−D r) with u = sqrt(√2·ℓ), f = 1/(2ℓ) + ℓ(2Dr − 1)r).
A row's shares are summed per lane over the chunks in order, then over the
32 lanes by the kernel's shuffle tree; a column's over the warp's rows in
order, then over the 8 warps in order, into ``partial[block][column]``,
which the second launch sums in its fixed order (lane j of a column's warp
adds slots j, j + 32, ...; a shuffle tree adds the lanes).

Tolerance: the emulation and the plain version's autograd sum in other
orders than JAX, so they are held at 1e-10 of the gradient's largest
|entry|, in float64, with a K̄ that has no structure.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

from test_torch_k1_backward import _butterfly

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
WARPS = 8
#: The sparse path's K_xz at N=40, m_z=8; ragged strips and chunks; one
#: input a side; more blocks than a warp has lanes (N1 = 600 at 8 rows: 75);
#: the chip's timed shapes.
SHAPES = ((40, 8), (37, 45), (1, 1), (600, 33), (2000, 64), (1000, 256))


def _inputs(rng, n1, n2):
    x1 = np.sort(rng.uniform(size=n1))
    x2 = np.sort(rng.uniform(size=n2))
    ell = lambda x: np.exp(3 * (x - 1) ** 3 - 3 + 0.2 * rng.normal(size=x.shape[0]))
    return (x1, 0.5 + 1.5 * rng.uniform(size=n1), ell(x1), x2, 0.5 + 1.5 * rng.uniform(size=n2), ell(x2),
            rng.normal(size=(n1, n2)))


@jax.jit
def _jax_grad(x1, s1, l1, x2, s2, l2, kbar):
    def loss(s1, l1, s2, l2):
        return jnp.sum(kbar * jkernels.nonstationary_rbf_cov(x1, sigma1=s1, ell1=l1, x2=x2, sigma2=s2, ell2=l2))

    return jax.grad(loss, argnums=(0, 1, 2, 3))(s1, l1, s2, l2)


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a), dtype=T64) for a in arrays)


def emulate(x1, s1, l1, x2, s2, l2, kbar, sms=132):
    """(σ̄1, ℓ̄1, σ̄2, ℓ̄2) by the kernel's schedule, with the count of reads
    of each K̄ element and of writes of each (block, column) partial, and
    every share that a staged input past N1 or N2 gave a real row or
    column."""
    n1, n2 = x1.shape[0], x2.shape[0]
    sched = gk.k1_cross_backward_schedule(n1, n2, sms)
    rows, grid, rpw = sched.rows, sched.grid, sched.rows_per_warp
    n_chunks = -(-n2 // 32)
    n1p, n2p = grid * rows, n_chunks * 32

    def pad(x, s, l, n, npad):
        xs, ss, ls = torch.zeros(npad, dtype=T64), torch.zeros(npad, dtype=T64), torch.ones(npad, dtype=T64)
        xs[:n], ss[:n], ls[:n] = x, s, l
        return xs, ss, ls, 1 / (2 * ls), torch.sqrt(1.4142135623730951 * ls)

    xi, si, li, hi, ui = (a[:, None] for a in pad(x1, s1, l1, n1, n1p))
    xj, sj, lj, hj, uj = (a[None, :] for a in pad(x2, s2, l2, n2, n2p))
    kb = torch.zeros((n1p, n2p), dtype=T64)
    kb[:n1, :n2] = kbar
    d = (xi - xj) ** 2
    rs = torch.rsqrt(li * li + lj * lj)
    ra = rs * rs
    w = kb * ((ui * uj) * rs * torch.exp(-d * ra))
    e = (2 * d * ra - 1) * ra
    wss = w * (si * sj)
    row = torch.stack([w * sj, wss * (li * e + hi)], -1)  # (n1p, n2p, 2)
    col = torch.stack([w * si, wss * (lj * e + hj)], -1)
    real_r, real_c = (torch.arange(n1p) < n1)[:, None], (torch.arange(n2p) < n2)[None, :]
    padded = torch.cat([row[real_r.expand(-1, n2p) & ~real_c].flatten(),
                        col[~real_r & real_c.expand(n1p, -1)].flatten()])
    # which thread reads K̄[i, j]: block b, warp w, k with i = b·rows + w + 8k; chunk and lane with j = c0 + lane
    reads = torch.zeros((n1, n2), dtype=torch.int64)
    for b in range(grid):
        for wp in range(WARPS):
            for k in range(rpw):
                i = b * rows + wp + WARPS * k
                if i < n1:
                    reads[i] += 1
    # rows: per lane over the chunks in order, then the lanes' shuffle tree
    lanes = torch.zeros((n1p, 32, 2), dtype=T64)
    for c in range(n_chunks):
        lanes = lanes + row[:, c * 32:(c + 1) * 32]
    row_sums = _butterfly(lanes.transpose(1, 2))[:n1]  # (n1, 2)
    # columns: over a warp's rows k in order, then over the warps in order
    col_bk = col.reshape(grid, rpw, WARPS, n2p, 2)  # [b, k, w]: row b·rows + 8k + w
    per_warp = col_bk[:, 0]
    for k in range(1, rpw):
        per_warp = per_warp + col_bk[:, k]
    partial = per_warp[:, 0]
    for wp in range(1, WARPS):
        partial = partial + per_warp[:, wp]
    partial = partial[:, :n2]  # (grid, n2, 2): block b writes its real columns once
    writes = torch.ones((grid, n2), dtype=torch.int64)
    # the second launch, one warp per column: lane j adds slots j, j + 32, ...
    slots = torch.zeros((n2, 2, 32), dtype=T64)
    for b in range(grid):
        slots[:, :, b % 32] = slots[:, :, b % 32] + partial[b]
    col_sums = _butterfly(slots)
    return row_sums[:, 0], row_sums[:, 1], col_sums[:, 0], col_sums[:, 1], reads, writes, padded


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    out = {}
    for n1, n2 in SHAPES:
        args = _inputs(rng, n1, n2)
        out[(n1, n2)] = args, tuple(np.asarray(g) for g in _jax_grad(*(jnp.asarray(a) for a in args)))
    return out


def _assert_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-10, atol=1e-10 * np.abs(w).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_schedule_matches_jax_grad(cases, shape):
    args, want = cases[shape]
    _assert_grads(emulate(*_t(*args))[:4], want)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_on_the_cpu_matches_jax_grad(cases, shape):
    """On CPU tensors the wrapper is autograd through the plain version."""
    args, want = cases[shape]
    got = gk.gibbs_gram_cross_backward(*_t(*args))
    assert [g.shape for g in got] == [(shape[0],), (shape[0],), (shape[1],), (shape[1],)]
    _assert_grads(got, want)


@pytest.mark.parametrize("shape", [(40, 8), (37, 45)])
def test_cross_form_gradient_goes_through_the_backward(cases, shape, monkeypatch):
    """``gibbs_gram`` with σ and ℓ requiring gradients on both sides takes the
    autograd function, whose backward is ``gibbs_gram_cross_backward``."""
    args, want = cases[shape]
    x1, s1, l1, x2, s2, l2, kbar = _t(*args)
    seen = []
    backward = gk.gibbs_gram_cross_backward
    monkeypatch.setattr(gk, "gibbs_gram_cross_backward", lambda *a: seen.append(a) or backward(*a))
    leaves = [t.requires_grad_(True) for t in (s1, l1, s2, l2)]
    k = gk.gibbs_gram(x1, s1, l1, x2, s2, l2)
    np.testing.assert_array_equal(k.detach().numpy(), gk.gibbs_gram_plain(*_t(*args[:6])).numpy())
    got = torch.autograd.grad(torch.sum(kbar * k), leaves)
    assert len(seen) == 1
    _assert_grads(got, want)


def test_gradcheck_cross_function(cases):
    args, _ = cases[(37, 45)]
    x1, s1, l1, x2, s2, l2, _ = _t(*args)
    fn = lambda a, b, c, d: gk.gibbs_gram(x1[:7], a, b, x2[:5], c, d)
    leaves = [t[:k].clone().requires_grad_(True) for t, k in ((s1, 7), (l1, 7), (s2, 5), (l2, 5))]
    assert torch.autograd.gradcheck(fn, leaves)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_schedule_reads_kbar_once_and_writes_each_partial_once(cases, shape, sms):
    *_, reads, writes, padded = emulate(*_t(*cases[shape][0]), sms)
    assert torch.equal(reads, torch.ones_like(reads))
    assert torch.equal(writes, torch.ones_like(writes))
    assert bool((padded == 0).all())


def test_staged_inputs_past_n_add_exactly_zero(cases):
    """Ragged strips and chunks are staged whole, with x = 0, σ = 0, ℓ = 1 and
    K̄ = 0 past N1 and N2, and no mask enters the arithmetic: every share
    such an input gives a real row or column is exactly 0."""
    padded = emulate(*_t(*cases[(37, 45)][0]))[6]
    assert padded.numel() > 0 and bool((padded == 0).all())


def test_emulation_does_not_depend_on_the_strip_height(cases):
    """The strip height changes the order of the column sums only."""
    args = _t(*cases[(600, 33)][0])
    one = emulate(*args, sms=1)  # strips of 32 rows
    many = emulate(*args, sms=132)  # strips of 8
    for a, b in zip(one[:4], many[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12 * b.abs().max().item())
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])  # a row never leaves its warp


def test_schedule_at_the_timed_shapes():
    sched = gk.k1_cross_backward_schedule(2000, 64)
    assert (sched.rows_per_warp, sched.rows, sched.grid) == (1, 8, 250)
    assert sched.partial_numel * 8 == 250 * 64 * 2 * 8  # 256 KB of f64 partials against 1 MB of K̄
    assert gk.k1_cross_backward_schedule(1000, 256).grid == 125
    assert gk.k1_cross_backward_schedule(2000, 64, sms=66).rows_per_warp == 2  # from the SM count
    assert gk.k1_cross_backward_schedule(20000, 64).rows_per_warp == 4
    assert gk.k1_cross_backward_schedule(1, 1).grid == 1


def test_second_derivative_raises(cases):
    args, _ = cases[(40, 8)]
    x1, s1, l1, x2, s2, l2, kbar = _t(*args)
    l1.requires_grad_(True)
    l2.requires_grad_(True)
    (g1,) = torch.autograd.grad(torch.sum(kbar * gk.gibbs_gram(x1, s1, l1, x2, s2, l2)), (l1,), create_graph=False)
    assert g1.shape == (40,)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(torch.sum(kbar * gk.gibbs_gram(x1, s1, l1, x2, s2, l2)), (l1, l2), create_graph=True)


@pytest.mark.parametrize("side", [0, 3])
def test_gradient_in_the_inputs_raises(cases, side):
    args = list(_t(*cases[(40, 8)][0][:6]))
    args[side].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient with respect to x"):
        gk.gibbs_gram(*args)


def test_wrapper_launches_its_entry_point(monkeypatch):
    """The wrapper's kernel branch, taken on tensors with no storage ("meta")
    with the launch recorded: the entry point gets its schedule, and the
    launch counts in ``gibbs_gram_cross_backward.launches``."""
    calls = []
    monkeypatch.setattr(gk, "_KERNEL_DEVICE_TYPES", ("cuda", "meta"))
    monkeypatch.setattr(gk, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "_launch", lambda name, dtype, device, *args: calls.append((name, args)))
    monkeypatch.setattr(gk.gibbs_gram_cross_backward, "launches", 0)
    meta = lambda *shape: torch.zeros(shape, dtype=torch.float64, device="meta")
    out = gk.gibbs_gram_cross_backward(meta(2000), meta(2000), meta(2000), meta(64), meta(64), meta(64),
                                       meta(2000, 64))
    assert [o.shape for o in out] == [(2000,), (2000,), (64,), (64,)]
    assert gk.gibbs_gram_cross_backward.launches == 1
    ((name, args),) = calls
    assert name == "gibbs_gram_cross_backward" and (args[3], args[7], args[9], args[10]) == (2000, 64, 1, 250)
    with pytest.raises(ValueError, match="want x1"):
        gk.gibbs_gram_cross_backward(meta(20), meta(20), meta(20), meta(6), meta(6), meta(6), meta(6, 20))


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``gibbs_gram.cu`` that ``emulate`` transcribes: a change
    there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "constexpr int ROWS = RPW * kBwdWarps;",
        "const int i = blockIdx.x * ROWS + warp + k * kBwdWarps;",
        "xi[k] = in ? x1[i] : T(0); si[k] = in ? s1[i] : T(0); li[k] = in ? l1[i] : T(1);",
        "hi[k] = T(1) / (T(2) * li[k]);",
        "ui[k] = gsqrt(T(1.4142135623730951) * li[k]);",
        "for (int c0 = 0; c0 < n2; c0 += 32) { const int j = c0 + lane;",
        "const T xj = col_in ? x2[j] : T(0), sj = col_in ? s2[j] : T(0), lj = col_in ? l2[j] : T(1);",
        "const T kb = col_in && i < n1 ? kbar[static_cast<size_t>(i) * n2 + j] : T(0);",
        "const T rs = grsqrt(fma(li[k], li[k], lj * lj));",
        "const T w = kb * ((ui[k] * uj) * rs * gexp(-d * ra));",
        "const T e = fma(T(2) * d, ra, T(-1)) * ra;",
        "acc_s[k] = fma(w, sj, acc_s[k]); acc_l[k] = fma(wss, fma(li[k], e, hi[k]), acc_l[k]);",
        "col_s = fma(w, si[k], col_s); col_l = fma(wss, fma(lj, e, hj), col_l);",
        "for (int w = 1; w < kBwdWarps; ++w) { cs += red[w][lane][0]; cl += red[w][lane][1]; }",
        "for (int off = 16; off > 0; off >>= 1) {",
        "return launch_reduce<T>(partial, grid, n2, s2_bar, l2_bar, st);",
        "for (int slot = lane; slot < n_slots; slot += 32) {",
    ):
        assert line in src, line


@pytest.mark.parametrize("suffix", ["f32", "f64"])
def test_entry_point_takes_the_arguments_the_wrapper_binds(suffix):
    """``ctypes`` passes what ``_ENTRY_POINTS`` declares, then the stream: the
    C signature must have exactly that many parameters, pointers where the
    wrapper passes pointers."""
    import re

    with open(os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")) as f:
        src = " ".join(f.read().split())
    params = re.search(rf"int gibbs_gram_cross_backward_{suffix}\(([^)]*)\)", src).group(1).split(",")
    _, argtypes = gk._ENTRY_POINTS["gibbs_gram_cross_backward"]
    assert len(params) == len(argtypes) + 1  # the stream last
    for p, t in zip(params, argtypes + [gk._P]):
        assert ("*" in p) == (t is gk._P), p
