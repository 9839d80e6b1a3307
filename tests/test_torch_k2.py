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
* M > 4 (the generic route): blocks walk units (a tile of 64 × 64 input
  pairs, a group of row tasks, a group of column tasks); thread ``(ty, tx)``
  owns 4 rows and 4 columns of the tile, reads L from the block's staged
  ``[task][b][input]`` rows with a pitch of 68 (staged ``b_chunk`` b values
  at a time), and for each task pair ``(a, c)`` stores V values at row
  ``a·N + n``, column ``c·N + p``.

The emulations count the writes of every output and check every store's
alignment to its width and that it stays in its row.  The Gibbs term is
taken from the plain version's (N, N) matrix (torch's CPU ``exp`` may round
the tail of a short vector otherwise); the jitter and the task sums are the
emulation's own, in the kernel's order, so the assembled Gram must equal the
plain version bit for bit.
"""

import dataclasses
import os

import jax
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


#: The generic route's staged row of L (the kernel's kGenPitch) and its tile.
PITCH, TILE = 68, 64


def emulate(x, ell, ls, jitter, sched):
    """The task-major Gram by the kernel's walk, the writes of each output,
    the visits of each item (each unit on the generic route), and whether
    every store was aligned."""
    if sched.route == "generic":
        return emulate_generic(x, ell, ls, jitter, sched)
    n, m = ls.shape[0], ls.shape[1]
    vec = sched.vec
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


def _staged(ls, base, t0, k0, width, off):
    """What the kernel's staging of a b chunk left at offset ``off`` of a
    unit's rows (or columns) of L: ``[j·PITCH + r]`` = the flat value ``k0 +
    j`` of ``L[base + r]`` from task ``t0`` on; inputs past N are not staged
    (NaN here, so a stored output that read one would show).  Every read
    must land in the chunk's staging: ``r`` < 64 (not the pitch's padding)
    and ``j`` < its ``width`` (tasks × the chunk's b values)."""
    n, m = ls.shape[0], ls.shape[1]
    j, r = off // PITCH, off % PITCH
    assert bool((r < TILE).all()) and bool((j < width).all())
    inp = base + r
    flat = ((inp.clamp(max=n - 1) * m + t0) * m + k0 + j).clamp(max=ls.numel() - 1)
    return torch.where(inp < n, ls.reshape(-1)[flat], torch.full((), float("nan"), dtype=ls.dtype))


def emulate_generic(x, ell, ls, jitter, sched):
    """The generic route (M > 4), vectorised over units and threads: block
    ``b`` takes units ``b, b + grid, ...``; a unit stages its rows' and
    columns' L for its task groups ``b_chunk`` b values at a time, its
    threads evaluate their 16 Gibbs terms once, and for each task pair sum
    b = 0..M−1 from the staged L (the first product starts the sum, the sums
    go on across the chunks) and, after the last chunk, store V values at
    once."""
    n, m = ls.shape[0], ls.shape[1]
    vec, size, bc = sched.vec, x.element_size(), sched.b_chunk
    order = [u for b in range(sched.grid) for u in sched.units(b)]
    visits = torch.bincount(torch.tensor(order), minlength=sched.n_units)
    # the staging: a block's rows then its columns, (tasks · b_chunk) rows of PITCH each
    a_tasks, c_tasks = sched.row_tasks, sched.col_tasks
    assert 1 <= bc <= m and (bc == m or a_tasks == c_tasks == 1)
    assert sched.smem_bytes == size * (a_tasks + c_tasks) * bc * PITCH
    assert ((a_tasks * bc - 1) * PITCH + TILE - 1) < a_tasks * bc * PITCH  # the rows' last staged value
    # the columns start at offset a_tasks·b_chunk·PITCH; their last staged value
    assert a_tasks * bc * PITCH + (c_tasks * bc - 1) * PITCH + TILE - 1 < sched.smem_bytes // size
    units = torch.arange(sched.n_units)
    first = torch.tensor([sched.unit(u) for u in range(sched.n_units)]).reshape(-1, 4)
    n0, p0, a0, c0 = (first[:, k] for k in range(4))
    na, nc = (m - a0).clamp(max=a_tasks), (m - c0).clamp(max=c_tasks)
    # thread (ty, tx): rows 4ty + i = 0..63; its stores' first columns lc, V apart
    # (those at or past N in every tile left out first: their stores are all masked)
    lc = torch.tensor([sched.generic_columns(tx, size)[j] for tx in range(16) for j in range(0, 4, vec)])
    lc, r = lc[lc < n], torch.arange(min(TILE, n))
    uu, rr, ss = (t.flatten() for t in torch.meshgrid(units, r, torch.arange(len(lc)), indexing="ij"))
    nn, pp = n0[uu] + rr, p0[uu] + lc[ss]  # row input, first column input
    live = (nn < n) & (pp < n)
    uu, rr, nn, pp, lcs = uu[live], rr[live], nn[live], pp[live], lc[ss][live]
    pv = pp[:, None] + torch.arange(vec)  # (S, V) the store's column inputs
    kxm = _kx(x, ell)
    kx = kxm[nn[:, None], pv] + (nn[:, None] == pv).to(x.dtype) * jitter  # once a unit, in registers
    out = torch.full((n * m, n * m), float("nan"), dtype=x.dtype)
    writes = torch.zeros((n * m, n * m), dtype=torch.int64)
    aligned = True
    acc = {}  # (qa, qc): the sums, kept across the chunks
    span = torch.arange(min(TILE, n))[:, None]
    for k0 in range(0, m, bc):
        kb = min(bc, m - k0)
        for qa in range(a_tasks):
            for qc in range(c_tasks):
                on = (qa < na[uu]) & (qc < nc[uu])
                u, rw, n_, p_, l_ = uu[on], rr[on], nn[on], pv[on], lcs[on]
                # the staged values a unit's threads read for this task pair, each b
                # of the chunk: rows [u, r] at qa·kb·PITCH + b·PITCH + r, columns
                # [u, col] from the columns' first offset (inputs past N are never
                # stored: r, col < N)
                busy = ((qa < na) & (qc < nc)).nonzero()[:, 0]  # the units with this task pair
                at = torch.zeros(sched.n_units, dtype=torch.int64)
                at[busy] = torch.arange(len(busy))
                col2 = lambda t: t[busy, None]
                for b in range(kb):
                    rows_v = _staged(ls, col2(n0), col2(a0), k0, col2(na) * kb, (qa * kb + b) * PITCH + span.T)
                    cols_v = _staged(ls, col2(p0), col2(c0), k0, col2(nc) * kb, (qc * kb + b) * PITCH + span.T)
                    prod = rows_v[at[u], rw][:, None] * cols_v[at[u][:, None], l_[:, None] + torch.arange(vec)]
                    # the sum over b in order, the first product starting it
                    acc[qa, qc] = prod if k0 + b == 0 else acc[qa, qc] + prod
                if k0 + kb < m:
                    continue  # the sums go on in the next chunk
                a, c = a0[u] + qa, c0[u] + qc
                val = kx[on] * acc[qa, qc]
                row = a * n + n_
                col = (c * n)[:, None] + p_
                aligned &= (bool(((row * n * m + col[:, 0]) % vec == 0).all())
                            and bool((col < ((c + 1) * n)[:, None]).all()))
                row = row[:, None].expand_as(col)
                out[row.flatten(), col.flatten()] = val.flatten()
                writes.index_put_((row.flatten(), col.flatten()), torch.ones(row.numel(), dtype=torch.int64),
                                  accumulate=True)
    return out, writes, visits, aligned


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 9, 17])
@pytest.mark.parametrize("n", [1, 36, 37, 66])
def test_emulated_walk_writes_each_output_once_and_equals_plain(rng, n, m, dtype):
    x, ell, ls = _inputs(rng, n, m, dtype)
    sched = gk.k2_schedule(n, m, dtype)
    got, writes, visits, aligned = emulate(x, ell, ls, JITTER, sched)
    assert torch.equal(writes, torch.ones_like(writes)) and torch.equal(visits, torch.ones_like(visits))
    assert aligned
    assert torch.equal(got, gk.svc_gram_plain(x, ell, ls, JITTER))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", [
    (37, 33),   # past the first staging chunk: the row and column tasks split into groups
    (1, 130),   # one input, the largest checked M
    (4, 130),
])
def test_generic_walk_at_large_m(rng, n, m, dtype):
    x, ell, ls = _inputs(rng, n, m, dtype)
    sched = gk.k2_schedule(n, m, dtype)
    assert sched.route == "generic" and (sched.a_groups > 1 or sched.c_groups > 1)
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


def _chunked(sched, b_chunk, dtype):
    """``sched`` with one row and one column task a unit, staged ``b_chunk``
    b values at a time."""
    one = dataclasses.replace(sched, row_tasks=1, col_tasks=1, b_chunk=b_chunk,
                              smem_bytes=2 * b_chunk * PITCH * torch.tensor([], dtype=dtype).element_size())
    return dataclasses.replace(one, grid=min(one.n_units, 2 * 132))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,b_chunk", [
    (1, 214, None),  # the schedule's chunks (106 in float64, 212 in float32), past the M where two
                     # whole tasks fit half an SM in either type
    (3, 45, 16),     # chunks of 16, 16 and 13 b values
    (37, 9, 4),      # chunks of 4, 4 and 1 b values, ragged N
    (66, 17, 5),     # two tiles a side, chunks of 5, 5, 5 and 2
])
def test_generic_walk_stages_b_in_chunks(rng, n, m, b_chunk, dtype):
    x, ell, ls = _inputs(rng, n, m, dtype)
    sched = gk.k2_schedule(n, m, dtype)
    if b_chunk is not None:
        sched = _chunked(sched, b_chunk, dtype)
    assert sched.route == "generic" and sched.b_chunk < m and sched.row_tasks == sched.col_tasks == 1
    got, writes, visits, aligned = emulate(x, ell, ls, JITTER, sched)
    assert torch.equal(writes, torch.ones_like(writes)) and torch.equal(visits, torch.ones_like(visits))
    assert aligned
    assert torch.equal(got, gk.svc_gram_plain(x, ell, ls, JITTER))


@pytest.mark.parametrize("n,m,grid", [
    (130, 9, 5),    # 9 tiles of input pairs (the last row and column ragged) on 5 blocks
    (70, 6, 1),     # one block walks every unit
])
def test_generic_walk_covers_every_output_on_any_grid(rng, n, m, grid):
    for dtype in DTYPES:
        x, ell, ls = _inputs(rng, n, m, dtype)
        sched = dataclasses.replace(gk.k2_schedule(n, m, dtype), grid=grid)
        assert sched.n_tiles > 1 and max(len(sched.units(b)) for b in range(grid)) > 1
        got, writes, visits, aligned = emulate(x, ell, ls, JITTER, sched)
        assert torch.equal(writes, torch.ones_like(writes)) and torch.equal(visits, torch.ones_like(visits))
        assert aligned
        assert torch.equal(got, gk.svc_gram_plain(x, ell, ls, JITTER))


def test_generic_staging_fits_a_block_at_every_m():
    """The generic route's staged L, (row + column tasks)·b_chunk·68·w bytes,
    fits half an SM's shared memory (so a block's 227 KB) at every M up to
    130 and past the M where two whole tasks fit, in both types; every task
    is in a group, and b is chunked only with one task a group."""
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        for m in (*range(gk.K2_MAX_M + 1, 131), 213, 214, 427, 428, 1000, 2896):
            for n in (1, 200, 1000):
                sched = gk.k2_schedule(n, m, dtype)
                assert sched.smem_bytes == size * (sched.row_tasks + sched.col_tasks) * sched.b_chunk * PITCH
                assert sched.smem_bytes <= 115_712 <= 232_448
                assert 1 <= sched.row_tasks <= m and 1 <= sched.col_tasks <= m and 1 <= sched.b_chunk <= m
                assert sched.b_chunk == m or sched.row_tasks == sched.col_tasks == 1
                assert 1 <= sched.grid <= sched.n_units and sched.grid <= 2 * 132


@pytest.mark.parametrize("dtype,largest", [(torch.float64, 106), (torch.float32, 212)])
def test_generic_route_chunks_b_past_two_whole_tasks(dtype, largest):
    """A row and a column task staged whole (2·68·M·w bytes) fit half an SM
    up to ``largest``; past it a unit is one task pair whose b range is
    staged ``largest`` values at a time."""
    whole = gk.k2_schedule(4, largest, dtype)
    assert whole.b_chunk == largest and whole.smem_bytes <= 115_712
    for m in (largest + 1, 3 * largest + 1):
        sched = gk.k2_schedule(4, m, dtype)
        assert (sched.row_tasks, sched.col_tasks, sched.b_chunk) == (1, 1, largest)
        assert sched.smem_bytes == whole.smem_bytes


@jax.jit
def _jax_gram(x, ell, ls):
    """The JAX package's task-major Gram (jitted: op by op it took ~2 s a shape)."""
    return jgnmgp.gram(jkernels.nonstationary_rbf_cov(x, ell1=ell, jitter=JITTER), ls)


@pytest.mark.parametrize("n,m", [(36, 2), (17, 3), (10, 5), (12, 9)])
def test_emulated_walk_matches_jax_gram(rng, n, m):
    x, ell, ls = _inputs(rng, n, m)
    got = emulate(x, ell, ls, JITTER, gk.k2_schedule(n, m, torch.float64))[0]
    want = np.asarray(_jax_gram(jnp.asarray(x.numpy()), jnp.asarray(ell.numpy()), jnp.asarray(ls.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("m", range(1, 7))
def test_route_follows_the_alignment_rule(m):
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        for n in (1, 2, 6, 37, 1000):
            sched = gk.k2_schedule(n, m, dtype)
            # the widest store (at most 16 B) whose width divides N
            want = max(v for v in (1, 2, 4) if n % v == 0 and v * size <= 16)
            assert sched.vec == want
            # then every offset (a N + n) N M + c N + p, p a multiple of it, is one too
            assert (n * m) % sched.vec == 0 and n % sched.vec == 0
            if m > gk.K2_MAX_M:
                # and a thread's column groups (16 B, 16 groups apart) start at multiples of it
                assert sched.route == "generic" and sched.rows == 64 and sched.warps == 8
                assert all(col % sched.vec == 0 for tx in range(16)
                           for col in sched.generic_columns(tx, size)[::sched.vec])
                assert sched.grid == min(sched.n_units, 2 * 132)
                continue
            assert sched.route == ("vector" if want > 1 else "scalar")


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


@pytest.mark.parametrize("n,m,dtype,want", [
    # (vec, row tasks, column tasks, b chunk, units, grid, shared memory): at
    # N=1000 the whole task range in one unit a tile (256 units, two blocks an
    # SM, one wave)
    (1000, 9, torch.float64, (2, 9, 9, 9, 256, 256, 88_128)),
    (1000, 9, torch.float32, (4, 9, 9, 9, 256, 256, 44_064)),
    (1000, 5, torch.float64, (2, 5, 5, 5, 256, 256, 27_200)),
    (1000, 5, torch.float32, (4, 5, 5, 5, 256, 256, 13_600)),
    # fewer tiles than SMs: the groups whose waves of units cost least
    (500, 16, torch.float64, (2, 8, 4, 16, 512, 264, 104_448)),
    (500, 16, torch.float32, (4, 16, 4, 16, 256, 256, 87_040)),
    (200, 32, torch.float64, (2, 4, 2, 32, 2048, 264, 104_448)),
    (200, 32, torch.float32, (4, 8, 4, 32, 512, 264, 104_448)),
    (64, 9, torch.float64, (2, 1, 1, 9, 81, 81, 9_792)),
    (64, 9, torch.float32, (4, 1, 1, 9, 81, 81, 4_896)),
])
def test_generic_schedule_at_the_timed_shapes(n, m, dtype, want):
    sched = gk.k2_schedule(n, m, dtype)
    assert sched.route == "generic"
    assert (sched.vec, sched.row_tasks, sched.col_tasks, sched.b_chunk, sched.n_units, sched.grid,
            sched.smem_bytes) == want


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
        "constexpr int kGenTile = 64;",
        "constexpr int kGenPitch = kGenTile + 4;",
        "constexpr int kGenThreads = 256;",
        "for (int item = blockIdx.x * warps + warp; item < n_items; item += gridDim.x * warps) {",
        "const int n0 = item / n_strips * rows;",
        "const int p = item % n_strips * (32 * V) + lane * V;",
        "kx[v] = gibbs(xr, lr, xp[v], lp[v]); if (r == p + v) kx[v] = kx[v] + jitter;",
        "T* row = out + (static_cast<size_t>(a) * n + r) * nm + p;",
        "T bsum = La[0] * Lp[v][c][0];",
        "for (int b = 1; b < M; ++b) bsum = bsum + La[b] * Lp[v][c][b];",
        "val[v] = kx[v] * bsum;",
        "if (live) store_vec<T, V>(row + static_cast<size_t>(c) * n, val);",
        "return cw * tx + 16 * cw * (j / cw) + j % cw;",
        "for (int u = blockIdx.x; u < n_units; u += gridDim.x) {",
        "const int ic = u % c_groups, ia = u / c_groups % a_groups, tile = u / c_groups / a_groups;",
        "const int n0 = tile / tiles * kGenTile, p0 = tile % tiles * kGenTile;",
        "const int a0 = ia * row_tasks, c0 = ic * col_tasks;",
        "T* Cs = Rs + row_tasks * b_chunk * kGenPitch;",
        "const int rn = min(kGenTile, n - n0), cn = min(kGenTile, n - p0);",
        "for (int i = tid; i < count * width; i += kGenThreads) { const int r = i / width, j = i % width;",
        "S[j * kGenPitch + r] = ls[(static_cast<size_t>(base + r) * m + t0) * m + k0 + j];",
        "k = gibbs(x[r], ell[r], x[p], ell[p]); if (r == p) k = k + jitter;",
        "const double2 r0 = *reinterpret_cast<const double2*>(Ra + 4 * ty);",
        "const double2 c1 = *reinterpret_cast<const double2*>(Cc + 2 * tx + 32);",
        "const float4 c0 = *reinterpret_cast<const float4*>(Cc + 4 * tx);",
        "for (int j = 0; j < 4; ++j) acc[i][j] = FIRST ? r[i] * c[j] : acc[i][j] + r[i] * c[j];",
        # the chunked walk: one task pair a unit, the sums kept across the chunks
        "for (int k0 = 0; k0 < m; k0 += b_chunk) { const int kb = min(b_chunk, m - k0);",
        "gen_stage(Rs, ls, n0, rn, m, a0, k0, kb, tid); gen_stage(Cs, ls, p0, cn, m, c0, k0, kb, tid);",
        "if (k0 == 0) { gen_step<T, true>(Rs, Cs, ty, tx, acc); } else { gen_step<T, false>(Rs, Cs, ty, tx, acc); }",
        "for (int b = 1; b < kb; ++b) gen_step<T, false>(Rs + b * kGenPitch, Cs + b * kGenPitch, ty, tx, acc);",
        "gen_store<T, V>(out + (static_cast<size_t>(a0) * n + n0 + 4 * ty) * nm + static_cast<size_t>(c0) * n + p0, n,",
        # the whole-task walk: every task of the unit staged once
        "const int rw = min(row_tasks, m - a0) * m, cw = min(col_tasks, m - c0) * m;",
        "gen_stage(Rs, ls, n0, rn, m, a0, 0, rw, tid); gen_stage(Cs, ls, p0, cn, m, c0, 0, cw, tid);",
        "const T* Ra = Rs + qa * m * kGenPitch;",
        "const T* Cc = Cs + qc * m * kGenPitch;",
        "gen_step<T, true>(Ra, Cc, ty, tx, acc);",
        "for (int b = 1; b < m; ++b) gen_step<T, false>(Ra + b * kGenPitch, Cc + b * kGenPitch, ty, tx, acc);",
        "T* rows = out + (static_cast<size_t>(a0 + qa) * n + n0 + 4 * ty) * nm + p0;",
        "gen_store<T, V>(rows + static_cast<size_t>(c0 + qc) * n, n, nm, n0, p0, ty, tx, kx, acc);",
        "for (int v = 0; v < V; ++v) val[v] = kx[i][j + v] * acc[i][j + v];",
        "store_vec<T, V>(orow + i * nm + lc, val);",
        "const size_t smem = sizeof(T) * static_cast<size_t>(row_tasks + col_tasks) * b_chunk * kGenPitch;",
        "(b_chunk < m && (row_tasks != 1 || col_tasks != 1))",
        "if (b_chunk < m) return launch_generic<T, V, true>(",
        "return sizeof(T) == 8 ? (n % 2 == 0 ? 2 : 1) : (n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1);",
        "const T a2 = ln * ln + lp * lp; const T b2 = ln * lp; const T dx = xn - xp; const T d = dx * dx;",
        "return gsqrt(T(2) * b2 / a2) * gexp(-d / a2);",
    ):
        assert line in src, line
