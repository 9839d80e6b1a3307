"""K2's kernel: its walks, emulated on the CPU, against the plain version and
the JAX package's Gram; and the input-major layout's route through K3.

The CUDA kernels (``svc_gram_task_kernel`` and ``svc_gram_generic_kernel`` in
``csrc/svc_gram.cu``) run only on the card, where ``chip_smoke.py`` holds
them against the plain version bit for bit.  Here vectorised torch
emulations follow the walks as ``gram_kernels.k2_schedule`` gives them:

* M <= 4: warps walk items of ``rows`` row inputs by a strip of 32·V column
  inputs; lane ``l`` owns column inputs ``p = p0 + l·V ..`` and, for each
  row input ``n`` and task pair ``(a, c)``, stores V values at row ``a·N +
  n``, column ``c·N + p``.
* M > 4 (the generic route): one thread per input pair on blocks of 32 × 8.

The emulations count the writes of every output and check every store's
alignment to its width and that it stays in its row.  The Gibbs term is
taken from the plain version's (N, N) matrix (torch's CPU ``exp`` may round
the tail of a short vector otherwise); the jitter and the task sums are the
emulation's own, in the kernel's order, so the assembled Gram must equal the
plain version bit for bit.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

JITTER = 1e-6
DTYPES = [torch.float64, torch.float32]


def _inputs(rng, n, m, dtype=torch.float64):
    x = np.sort(rng.uniform(size=n))
    ell = np.exp(3 * (x - 1) ** 3 - 3 + 0.2 * rng.normal(size=n))
    ls = np.tril(rng.normal(size=(n, m, m))) + 2 * np.eye(m)
    return tuple(torch.tensor(a, dtype=dtype) for a in (x, ell, ls))


def _kx(x, ell):
    """The plain version's Gibbs term, without the jitter."""
    return gk.svc_gram_plain(x, ell, torch.ones((len(x), 1, 1), dtype=x.dtype), 0.0)


def _assemble(x, ell, ls, jitter, rows, cols, vec):
    """Each store's V values of every task pair: row inputs ``rows`` (S, 1),
    first column inputs ``cols`` (S, 1); ``{(a, c): (S, V)}``."""
    m = ls.shape[1]
    p = cols + torch.arange(vec)
    kx = _kx(x, ell)[rows, p] + (rows == p).to(x.dtype) * jitter
    vals = {}
    for a in range(m):
        for c in range(m):
            bsum = ls[rows, a, 0] * ls[p, c, 0]
            for b in range(1, m):
                bsum = bsum + ls[rows, a, b] * ls[p, c, b]
            vals[a, c] = kx * bsum
    return vals


def _store_all(out, writes, n, rows, cols, vals, vec):
    """The stores of every task pair; whether each was aligned and in its row."""
    ok = True
    nm = out.shape[1]
    for (a, c), v in vals.items():
        r = a * n + rows
        col = c * n + cols + torch.arange(vec)
        ok &= bool(((r * nm + c * n + cols) % vec == 0).all()) and bool((col < (c + 1) * n).all())
        r = r.expand_as(col)
        out[r.flatten(), col.flatten()] = v.flatten()
        writes.index_put_((r.flatten(), col.flatten()), torch.ones(r.numel(), dtype=torch.int64), accumulate=True)
    return ok


def emulate(x, ell, ls, jitter, sched):
    """The task-major Gram by the kernel's walk, the writes of each output,
    the visits of each item (each block on the generic route), and whether
    every store was aligned."""
    n, m = ls.shape[0], ls.shape[1]
    vec = sched.vec
    if sched.route == "generic":
        # blocks (bx, by) of 32 x 8 threads; thread (tx, ty) takes pair (by·8 + ty, bx·32 + tx)
        blocks = torch.arange(sched.grid)
        bx, by = blocks % sched.n_strips, blocks // sched.n_strips
        p = (bx * 32)[:, None, None] + torch.arange(32)
        q = (by * 8)[:, None, None] + torch.arange(8)[:, None]
        live = (p < n) & (q < n)
        rows, cols = q.expand_as(live)[live][:, None], p.expand_as(live)[live][:, None]
        items = blocks
    else:
        items = torch.tensor([i for b in range(sched.grid) for w in range(sched.warps) for i in sched.items(b, w)])
        n0 = (items // sched.n_strips * sched.rows)[:, None, None, None]
        p = (items % sched.n_strips * sched.strip)[:, None, None, None] + torch.arange(32)[:, None] * vec
        r = n0 + torch.arange(sched.rows)[:, None, None]  # (items, rows, 1, 1)
        live = ((r < n) & (p < n))[..., 0]
        rows = r.expand(-1, -1, 32, -1)[live]
        cols = p.expand(-1, sched.rows, -1, -1)[live]
    visits = torch.bincount(items, minlength=sched.n_items)
    out = torch.full((n * m, n * m), float("nan"), dtype=x.dtype)
    writes = torch.zeros((n * m, n * m), dtype=torch.int64)
    aligned = _store_all(out, writes, n, rows, cols, _assemble(x, ell, ls, jitter, rows, cols, vec), vec)
    return out, writes, visits, aligned


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("n", [1, 36, 37, 66])
def test_emulated_walk_writes_each_output_once_and_equals_plain(rng, n, m, dtype):
    x, ell, ls = _inputs(rng, n, m, dtype)
    sched = gk.k2_schedule(n, m, dtype)
    got, writes, visits, aligned = emulate(x, ell, ls, JITTER, sched)
    assert torch.equal(writes, torch.ones_like(writes)) and torch.equal(visits, torch.ones_like(visits))
    assert aligned
    assert torch.equal(got, gk.svc_gram_plain(x, ell, ls, JITTER))


@pytest.mark.parametrize("n,m,rows,warps,grid", [
    (37, 2, 3, 2, 1),   # many items per warp, ragged last row chunk and strip (scalar)
    (72, 4, 5, 3, 2),   # two strips of 64 in float64, the last ragged
    (36, 3, 8, 1, 1),   # one warp walks every item
])
def test_walk_covers_every_output_on_any_grid(rng, n, m, rows, warps, grid):
    for dtype in DTYPES:
        x, ell, ls = _inputs(rng, n, m, dtype)
        sched = dataclasses.replace(gk.k2_schedule(n, m, dtype), rows=rows, warps=warps, grid=grid)
        assert max(len(sched.items(b, w)) for b in range(grid) for w in range(warps)) > 1
        got, writes, _, aligned = emulate(x, ell, ls, JITTER, sched)
        assert torch.equal(writes, torch.ones_like(writes)) and aligned
        assert torch.equal(got, gk.svc_gram_plain(x, ell, ls, JITTER))


@pytest.mark.parametrize("n,m", [(36, 2), (17, 3), (10, 5)])
def test_emulated_walk_matches_jax_gram(rng, n, m):
    x, ell, ls = _inputs(rng, n, m)
    got = emulate(x, ell, ls, JITTER, gk.k2_schedule(n, m, torch.float64))[0]
    kx = jkernels.nonstationary_rbf_cov(jnp.asarray(x.numpy()), ell1=jnp.asarray(ell.numpy()), jitter=JITTER)
    want = np.asarray(jgnmgp.gram(kx, jnp.asarray(ls.numpy())))  # task-major
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("m", range(1, 7))
def test_route_follows_the_alignment_rule(m):
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        for n in (1, 2, 6, 37, 1000):
            sched = gk.k2_schedule(n, m, dtype)
            if m > gk.K2_MAX_M:
                assert (sched.route, sched.vec) == ("generic", 1)
                assert sched.grid == -(-n // 32) * -(-n // 8)
                continue
            # the widest store (at most 16 B) whose width divides N
            want = max(v for v in (1, 2, 4) if n % v == 0 and v * size <= 16)
            assert sched.vec == want and sched.route == ("vector" if want > 1 else "scalar")
            # then every offset (a N + n) N M + c N + p, p a multiple of it, is one too
            assert (n * m) % sched.vec == 0 and n % sched.vec == 0


def test_schedule_at_the_timed_shapes():
    sched = gk.k2_schedule(1000, 2, torch.float64)
    assert (sched.route, sched.vec, sched.strip, sched.rows, sched.warps) == ("vector", 2, 64, 8, 4)
    assert (sched.n_strips, sched.n_items, sched.grid) == (16, 2000, 500)  # one item a warp
    f32 = gk.k2_schedule(1000, 2, torch.float32)
    assert (f32.vec, f32.rows, f32.n_items) == (4, 4, 2000)
    small = gk.k2_schedule(257, 3, torch.float64)
    assert (small.route, small.vec, small.rows) == ("scalar", 1, 2)
    assert small.n_items >= 8 * 132  # every SM gets 8 warps' items
    assert gk.k2_schedule(1, 1, torch.float64).grid == 1
    assert gk.k2_schedule(20000, 2, torch.float64).grid == 16 * 132  # a persistent walk


def test_input_layout_is_k3_bit_for_bit_on_the_cpu(rng):
    x, ell, ls = _inputs(rng, 17, 3)
    got = gk.svc_gram(x, ell, ls, JITTER, layout="input")
    assert torch.equal(got, gk.svc_gram_tiled(x, ell, ls, JITTER))
    task = gk.svc_gram(x, ell, ls, JITTER)
    assert torch.equal(got, task.reshape(3, 17, 3, 17).permute(1, 0, 3, 2).reshape(51, 51))


def test_input_layout_launches_k3_and_counts_there(monkeypatch):
    """The wrappers' kernel branch, taken on tensors with no storage ("meta")
    with the launch recorded: ``layout="input"`` launches K3's forward with
    K3's schedule and counts in ``svc_gram_tiled.launches``; the task-major
    layout launches K2 with its own and counts in ``svc_gram.launches``."""
    calls = []
    monkeypatch.setattr(gk, "_KERNEL_DEVICE_TYPES", ("cuda", "meta"))
    monkeypatch.setattr(gk, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "_launch", lambda name, dtype, device, *args: calls.append((name, args)))
    for fn in (gk.svc_gram, gk.svc_gram_tiled):
        monkeypatch.setattr(fn, "launches", 0)
    x, ell = (torch.zeros(1000, dtype=torch.float64, device="meta") for _ in range(2))
    ls = torch.zeros((1000, 2, 2), dtype=torch.float64, device="meta")
    out = gk.svc_gram(x, ell, ls, JITTER, layout="input")
    assert (out.shape, gk.svc_gram.launches, gk.svc_gram_tiled.launches) == ((2000, 2000), 0, 1)
    gk.svc_gram(x, ell, ls, JITTER)
    assert (gk.svc_gram.launches, gk.svc_gram_tiled.launches) == (1, 1)
    k3 = gk.k3_forward_schedule(1000, 2, torch.float64)
    k2 = gk.k2_schedule(1000, 2, torch.float64)
    assert [name for name, _ in calls] == ["svc_gram_tiled", "svc_gram"]
    assert calls[0][1][3:10] == (1000, 2, JITTER, k3.vec, k3.rows, k3.warps, k3.grid)
    assert calls[1][1][3:10] == (1000, 2, JITTER, k2.vec, k2.rows, k2.warps, k2.grid)


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``svc_gram.cu`` that ``emulate`` transcribes: a change
    there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "constexpr int kMaxM = 4;",
        "constexpr int kGenericX = 32, kGenericY = 8;",
        "for (int item = blockIdx.x * warps + warp; item < n_items; item += gridDim.x * warps) {",
        "const int n0 = item / n_strips * rows;",
        "const int p = item % n_strips * (32 * V) + lane * V;",
        "kx[v] = gibbs(xr, lr, xp[v], lp[v]); if (r == p + v) kx[v] = kx[v] + jitter;",
        "T* row = out + (static_cast<size_t>(a) * n + r) * nm + p;",
        "T bsum = La[0] * Lp[v][c][0];",
        "for (int b = 1; b < M; ++b) bsum = bsum + La[b] * Lp[v][c][b];",
        "val[v] = kx[v] * bsum;",
        "if (live) store_vec<T, V>(row + static_cast<size_t>(c) * n, val);",
        "const int p = blockIdx.x * blockDim.x + threadIdx.x;",
        "const int q = blockIdx.y * blockDim.y + threadIdx.y;",
        "T* row = out + (static_cast<size_t>(a) * n + q) * nm + p;",
        "for (int b = 1; b < m; ++b) bsum = bsum + lq[a * m + b] * lp[c * m + b];",
        "row[static_cast<size_t>(c) * n] = kx * bsum;",
        "return sizeof(T) == 8 ? (n % 2 == 0 ? 2 : 1) : (n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1);",
        "const T a2 = ln * ln + lp * lp; const T b2 = ln * lp; const T dx = xn - xp; const T d = dx * dx;",
        "return gsqrt(T(2) * b2 / a2) * gexp(-d / a2);",
    ):
        assert line in src, line
