"""K1's backward kernel: its schedule, emulated on the CPU, against the JAX
package's gradient.

The CUDA kernel (``gibbs_gram_bwd_kernel`` in ``csrc/gibbs_gram.cu``) runs
only on the card, where ``chip_smoke.py`` holds it against autograd through
the plain version.  Here a vectorised torch emulation follows the kernel's
schedule as ``gram_kernels.k1_backward_schedule`` gives it: block ``b`` takes
the unordered tile pairs (I <= J) ``b, b + grid, ...``; a pair stages K̄[I, J]
and K̄[J, I] (one tile on the diagonal), and the ragged last tile whole with
x = 0, σ = 0, ℓ = 1 and K̄ = 0 past N; each unordered input pair is
evaluated once (q = 1/sqrt(A), r = q², g = u_i u_j q·exp(−D r) with u =
sqrt(√2·ℓ), f = 1/(2ℓ) + ℓ(2Dr − 1)r) and adds its shares to both rows.  Thread t takes column t % T of rows
t / T + k·(256 / T).  A row's shares are summed over its T lanes by the
kernel's shuffle tree; a column's over a thread's rows in order, over the
warp's rows by shuffles, then over the 8 warps in order, into the slots
``partial[partner tile][row]``, which the second launch sums in its fixed
order (lane j of a row's warp adds slots j, j + 32, ...; a shuffle tree adds
the lanes).  N=257 takes 16-input tiles, the others 32; N=600 spans 19
slots, N=1100 35: more than a warp's lanes.  The kernel computes a pair's
(I, J) from its index itself (``tile_pair``); ``_kernel_tile_pair`` is that
loop transcribed, and a test ties it and the staging to the source.

Tolerance: the emulation sums in another order than autograd and JAX, so it
is held at 1e-10 of the gradient's largest |entry|, in float64, with an
asymmetric K̄.
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

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
THREADS, WARPS = 256, 8
SHAPES = (1, 17, 40, 64, 257, 600)


def _inputs(rng, n):
    x = np.sort(rng.uniform(size=n))
    sigma = 0.5 + 1.5 * rng.uniform(size=n)
    ell = np.exp(3 * (x - 1) ** 3 - 3 + 0.2 * rng.normal(size=n))
    kbar = rng.normal(size=(n, n))  # not symmetric
    return x, sigma, ell, kbar


def _jax_grad(x, sigma, ell, kbar):
    def loss(s, e):
        k = jkernels.nonstationary_rbf_cov(jnp.asarray(x), sigma1=s, ell1=e)
        return jnp.sum(jnp.asarray(kbar) * k)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(sigma), jnp.asarray(ell))


def _kernel_tile_pair(q, n_tiles):
    """The kernel's ``tile_pair``: a float32 root, then the two corrections."""
    first = lambda i: i * n_tiles - i * (i - 1) // 2
    f32 = np.float32
    b = f32(2) * f32(n_tiles) + f32(1)
    i = int((b - np.sqrt(max(b * b - f32(8) * f32(q), f32(0)))) * f32(0.5))
    i = max(0, min(i, n_tiles - 1))
    while i > 0 and q < first(i):
        i -= 1
    while i + 1 < n_tiles and q >= first(i + 1):
        i += 1
    return i, i + q - first(i)


def _butterfly(v):
    """The kernel's shuffle tree over the last axis (its lanes, a power of
    two); every lane ends with the same sum, lane 0's is taken."""
    lane = torch.arange(v.shape[-1])
    off = v.shape[-1] // 2
    while off:
        v = v + v[..., lane ^ off]
        off //= 2
    return v[..., 0]


def emulate(x, s, l, kbar, sms=132):
    """(σ̄, ℓ̄) by the kernel's schedule, with the count of reads of each K̄
    element, of writes of each (slot, row) and of visits of each pair, and
    every share that a staged input past N gave a real row."""
    n = x.shape[0]
    sched = gk.k1_backward_schedule(n, sms)
    t = sched.tile
    n_pad = sched.n_tiles * t
    xs, ss, ls = torch.zeros(n_pad, dtype=T64), torch.zeros(n_pad, dtype=T64), torch.ones(n_pad, dtype=T64)
    kbs = torch.zeros((n_pad, n_pad), dtype=T64)
    xs[:n], ss[:n], ls[:n], kbs[:n, :n] = x, s, l, kbar
    hs = 1 / (2 * ls)
    us = torch.sqrt(1.4142135623730951 * ls)
    # the pairs in the blocks' order: block b takes q = b, b + grid, ...
    order = [q for b in range(sched.grid) for q in range(b, sched.n_pairs, sched.grid)]
    visits = torch.bincount(torch.tensor(order), minlength=sched.n_pairs)
    ij = torch.tensor([_kernel_tile_pair(q, sched.n_tiles) for q in order])
    tiles = torch.arange(t)
    rows = ij[:, 0, None] * t + tiles  # (P, t): the inputs of tile I, then of tile J
    cols = ij[:, 1, None] * t + tiles
    diag = (ij[:, 0] == ij[:, 1])[:, None, None]
    # staged: K̄[I, J] and K̄[J, I]; kt[c][r] = K̄[J t + c, I t + r]
    kb = kbs[rows[:, :, None], cols[:, None, :]]
    kt = kbs[cols[:, :, None], rows[:, None, :]]
    xi, si, li, hi, ui = (a[rows][:, :, None] for a in (xs, ss, ls, hs, us))
    xj, sj, lj, hj, uj = (a[cols][:, None, :] for a in (xs, ss, ls, hs, us))
    d = (xi - xj) ** 2
    rs = torch.rsqrt(li * li + lj * lj)
    ra = rs * rs
    g = (ui * uj) * rs * torch.exp(-d * ra)
    w = (kb + kt.transpose(1, 2)) * g
    e = (2 * d * ra - 1) * ra
    wss = w * (si * sj)
    # on a diagonal tile: row <= column on the row side, row < column elsewhere
    r_ = tiles[:, None]
    c_ = tiles[None, :]
    side_row = torch.where(diag, (r_ <= c_).to(T64), torch.ones(1, dtype=T64))
    side_both = torch.where(diag, (r_ < c_).to(T64), torch.ones(1, dtype=T64))
    row = torch.stack([w * sj * side_row, wss * (li * e + hi) * side_both], -1)  # (P, r, c, 2)
    col = torch.stack([w * si * side_both, wss * (lj * e + hj) * side_both], -1)
    real_r, real_c = (rows < n)[:, :, None], (cols < n)[:, None, :]
    padded = torch.cat([
        row[(real_r & ~real_c).expand(-1, -1, t)].flatten(),
        col[(~real_r & real_c).expand(-1, t, -1)].flatten(),
    ])
    rs = _butterfly(row.transpose(2, 3))  # (P, r, 2): over the row's lanes
    step = THREADS // t  # thread (r0, c) takes rows r0 + k step
    per_thread = torch.zeros((len(order), step, t, 2), dtype=T64)
    for k in range(t // step):  # a thread's rows, in order
        per_thread = per_thread + col[:, k * step:(k + 1) * step]
    # the warp's rows r0 by shuffles (none where a warp holds one row), then the warps in order
    per_warp = _butterfly(per_thread.reshape(-1, WARPS, step // WARPS, t, 2).permute(0, 1, 3, 4, 2))
    cs = per_warp[:, 0]
    for wp in range(1, WARPS):
        cs = cs + per_warp[:, wp]
    partial = torch.full((sched.n_tiles, n, 2), float("nan"), dtype=T64)
    writes = torch.zeros((sched.n_tiles, n), dtype=torch.int64)
    reads = torch.zeros((n, n), dtype=torch.int64)
    for p, (i, j) in enumerate(ij.tolist()):
        ri = slice(i * t, min(n, i * t + t))
        rj = slice(j * t, min(n, j * t + t))
        nr, nc = ri.stop - ri.start, rj.stop - rj.start
        reads[ri, rj] += 1
        if i == j:
            partial[i, ri] = rs[p, :nr] + cs[p, :nr]
            writes[i, ri] += 1
        else:
            reads[rj, ri] += 1
            partial[j, ri] = rs[p, :nr]
            writes[j, ri] += 1
            partial[i, rj] = cs[p, :nc]
            writes[i, rj] += 1
    # the second launch, one warp per row: lane j adds slots j, j + 32, ...
    lanes = torch.zeros((n, 2, 32), dtype=T64)
    for slot in range(sched.n_tiles):
        lanes[:, :, slot % 32] = lanes[:, :, slot % 32] + partial[slot]
    out = _butterfly(lanes)
    return out[:, 0], out[:, 1], reads, writes, visits, padded


def _t(*arrays):
    return tuple(torch.tensor(a, dtype=T64) for a in arrays)


@pytest.mark.parametrize("n", SHAPES)
def test_emulated_schedule_matches_jax_grad(rng, n):
    x, s, l, kbar = _inputs(rng, n)
    want = _jax_grad(x, s, l, kbar)
    got = emulate(*_t(x, s, l, kbar))[:2]
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10 * np.abs(w).max())


@pytest.mark.parametrize("n", SHAPES + (1100,))
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_schedule_reads_kbar_once_and_writes_each_slot_once(rng, n, sms):
    *_, reads, writes, visits, _ = emulate(*_t(*_inputs(rng, n)), sms)
    assert torch.equal(reads, torch.ones_like(reads))
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(visits, torch.ones_like(visits))


@pytest.mark.parametrize("n", [n for n in SHAPES if n % 32])
def test_staged_inputs_past_n_add_exactly_zero(rng, n):
    """The ragged last tile is staged whole, with x = 0, σ = 0, ℓ = 1 and
    K̄ = 0 past N, and no mask enters the arithmetic: every share such an
    input gives a real row is exactly 0."""
    past_n = emulate(*_t(*_inputs(rng, n)))[5]
    assert past_n.numel() > 0 and bool((past_n == 0).all())


def test_emulation_does_not_depend_on_the_grid(rng):
    args = _t(*_inputs(rng, 600))
    one = emulate(*args, sms=1)
    for sms in (7, 132):
        many = emulate(*args, sms=sms)
        assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])


@pytest.mark.parametrize("n", (1, 33, 1000, 4000))
def test_kernel_pair_mapping_is_the_schedules_order(n):
    sched = gk.k1_backward_schedule(n)
    assert [_kernel_tile_pair(q, sched.n_tiles) for q in range(sched.n_pairs)] == sched.pairs()


def test_schedule_at_the_timed_shapes():
    sched = gk.k1_backward_schedule(1000)
    assert (sched.tile, sched.n_tiles, sched.n_pairs) == (32, 32, 528)
    assert sched.grid == min(528, 4 * 132)
    assert sched.partial_numel * 8 == 32 * 1000 * 2 * 8  # 0.5 MB of f64 partials against 8 MB of K̄
    assert gk.k1_backward_schedule(1000, sms=66).grid == 4 * 66  # from the SM count
    # N=257: 45 pairs of 32-input tiles would leave SMs idle, so 16-input tiles
    small = gk.k1_backward_schedule(257)
    assert (small.tile, small.n_pairs, small.grid) == (16, 153, 153)
    assert gk.k1_backward_schedule(257, sms=40).tile == 32
    assert gk.k1_backward_schedule(1).grid == 1  # never more blocks than tile pairs


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``gibbs_gram.cu`` that ``emulate`` and
    ``_kernel_tile_pair`` transcribe: a change there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "constexpr int kBwdThreads = 256;",
        "static constexpr int STEP = kBwdThreads / TILE;",
        "static constexpr int ROWS = TILE / STEP;",
        "const int c = tid % TILE, r0 = tid / TILE;",
        "const int r = r0 + k * B::STEP;",
        "for (int off = TILE / 2; off > 0; off >>= 1) {",
        "for (int off = TILE; off < 32; off <<= 1) {",
        "if (tile == 16) return launch_backward_tile<T, 16>(",
        "return i * n_tiles - i * (i - 1) / 2;",
        "const float b = 2.0f * n_tiles + 1.0f;",
        "int i = static_cast<int>((b - sqrtf(fmaxf(b * b - 8.0f * q, 0.0f))) * 0.5f);",
        "i = max(0, min(i, n_tiles - 1));",
        "while (i > 0 && q < first_pair(i, n_tiles)) --i;",
        "while (i + 1 < n_tiles && q >= first_pair(i + 1, n_tiles)) ++i;",
        "J = i + q - first_pair(i, n_tiles);",
        "x = in ? x_[i] : T(0); s = in ? s_[i] : T(0); l = in ? l_[i] : T(1);",
        "st.h[side][e] = T(1) / (T(2) * l);",
        "st.u[side][e] = gsqrt(T(1.4142135623730951) * l);",
        "else dst[r][c] = T(0);",
                "if (!diag || r <= c) {",
        "const T rs = grsqrt(fma(li, li, lj * lj));",
        "const T ra = rs * rs;",
        "const T g = (ui * uj) * rs * gexp(-d * ra);",
        "const T w = (st.kb[0][r][c] + kt[c][r]) * g;",
        "const T e = fma(T(2) * d, ra, T(-1)) * ra;",
        "row_s = w * sj; if (!diag || r != c) { row_l = wss * fma(li, e, hi);",
        "col_s = fma(w, si, col_s); col_l = fma(wss, fma(lj, e, hj), col_l);",
                "for (int w = 1; w < kBwdWarps; ++w) cs += red_col[w][i][v];",
        "if (diag) { if (ri < n) partial[(static_cast<size_t>(I) * n + ri) * 2 + v] = rs + cs;",
        "for (int slot = lane; slot < n_slots; slot += 32) {",
    ):
        assert line in src, line
