"""K1's cross-form backward: the wrapper, its one-launch schedule emulated on
the CPU, and its autograd function, against the JAX package's gradient.

The CUDA kernel (``gibbs_gram_cross_bwd_kernel`` in ``csrc/gibbs_gram.cu``)
runs only on the card, where ``chip_smoke.py`` holds it against autograd
through the plain version.  Here a vectorised torch emulation follows the
kernel's schedule as ``gram_kernels.k1_cross_backward_schedule`` gives it:
block ``b`` takes the row strip ``s = b // G`` (warp ``w`` of 8 its rows
``s·rows + w·rows/8 + k``, evaluated 4 at a time), staged with x = 0, σ = 0,
ℓ = 1 past N1, and the column group ``g = b % G``, a run of chunks of 64
columns, lane ``l`` taking columns ``c0 + l`` and ``c0 + l + 32``, with x =
0, σ = 0, ℓ = 1 and K̄ = 0 past N2.  Each term is evaluated with one root
and no division (q = 1/sqrt(A), r = q², g = u_i u_j q·exp(−D r) with u =
sqrt(√2·ℓ), f = 1/(2ℓ) + ℓ(2Dr − 1)r).  A row's shares are summed over the
lane's two columns, over the 32 lanes (the kernel's halving exchanges pair
the lanes as a shuffle tree does), over the group's chunks in order, then
(with several groups) by the block with the strip's last ticket over the
groups' row slots in group order; a column's over the warp's rows in order,
over the 8 warps in order into the strip's column slot, and the block with
the group's last ticket sums the group's slots in strip order (batches of 32
slots to its thread groups in turn, slot s into its group's accumulator
s % 4, the groups in order, then (a0 + a1) + (a2 + a3)).  The tickets are
emulated with the blocks finishing in several orders.

Tolerance: the emulation and the plain version's autograd sum in other
orders than JAX, so they are held at 1e-10 of the gradient's largest
|entry|, in float64, with a K̄ that has no structure.
"""

import dataclasses
import os
import re

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
WARPS, CHUNK, LANES = 8, 64, 32
#: The sparse path's K_xz at N=40, m_z=8; ragged strips and chunks; one
#: input a side; several row groups a warp (N1 = 600 in strips of 64 on 7
#: SMs); column groups (3 at 500 × 130; 4 of 3 chunks at 1000 × 600); the
#: chip's timed shapes.
SHAPES = ((40, 8), (37, 45), (1, 1), (600, 33), (2000, 64), (1000, 256), (500, 130), (1000, 600), (2000, 128))
#: The N = 20,000 rate's shape, timed on the chip.
BIG = (20000, 64)


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


#: The last block loads this many slots at once; with 2·(its group's
#: columns) values it takes them in this many thread groups (``groups``).
SLOT_BATCH = 32


def groups(n_cols):
    n_vals = 2 * n_cols
    return 1 if n_vals > 128 else 2 if n_vals > 64 else 4 if n_vals > 32 else 8


def group_columns(sched, g):
    """The (column, sum) pairs that a block of group g writes to its column
    slot: thread t of chunk c0 takes column c0 + t // 2, sum t % 2."""
    per = sched.chunks_per_group
    c_, t_ = torch.meshgrid(torch.arange(g * per, min((g + 1) * per, sched.n_chunks)), torch.arange(2 * CHUNK),
                            indexing="ij")
    j, t = (c_ * CHUNK + t_ // 2).flatten(), (t_ % 2).flatten()
    keep = j < sched.n2
    return j[keep], t[keep]


def finish(sched, col_values, row_values, order=None, tickets=None):
    """The tickets (``tickets``, else zeros) with the blocks finishing in
    ``order`` (default: block order).  Block (s, g) writes its column slot's
    group-g columns and, with G > 1 groups, its row slot's strip-s rows,
    then takes group g's ticket and (G > 1) strip s's (``atomicInc``,
    wrapping to 0 after the last).  The block with a group's last ticket
    sums the group's column slots in strip order: batches of 32 slots go to
    its thread groups in turn (batch ``b`` to group ``b % H``), slot ``s``
    to accumulator ``s % 4`` of its group, the groups' accumulators are
    added in group order, then ``(a0 + a1) + (a2 + a3)``; the block with a
    strip's last ticket adds the strip's row slots in group order.  With one
    group a block writes its rows' sums directly.  Returns the four
    gradients, the tickets afterwards, the writes of each (slot, column,
    sum) and of each (group, row, sum), and the gradients' writes.  A slot
    not yet written reads NaN."""
    n_strips, n_g, rows, n1, n2 = sched.n_strips, sched.col_groups, sched.rows, sched.n1, sched.n2
    tickets = torch.zeros(sched.n_tickets, dtype=torch.int64) if tickets is None else tickets.clone()
    cols = torch.full_like(col_values, float("nan"))
    rws = torch.full_like(row_values, float("nan"))
    col_writes = torch.zeros(col_values.shape, dtype=torch.int64)
    row_writes = torch.zeros(row_values.shape, dtype=torch.int64)
    out = {k: torch.full((n,), float("nan"), dtype=T64) for k, n in (("s1", n1), ("l1", n1), ("s2", n2), ("l2", n2))}
    out_writes = {k: torch.zeros(n, dtype=torch.int64) for k, n in (("s1", n1), ("l1", n1), ("s2", n2), ("l2", n2))}
    per = sched.chunks_per_group * CHUNK
    g_cols = [slice(g * per, min((g + 1) * per, n2)) for g in range(n_g)]

    def take(k, n):
        mine = int(tickets[k])
        tickets[k] = 0 if mine >= n - 1 else mine + 1
        return mine == n - 1

    for b in range(sched.grid) if order is None else order:
        s, g = divmod(b, n_g)
        j, r = g_cols[g], slice(s * rows, min((s + 1) * rows, n1))
        cols[s, j] = col_values[s, j]
        col_writes[s, j] += 1
        if n_g == 1:
            for k, c in (("s1", 0), ("l1", 1)):
                out[k][r] = row_values[0, r, c]
                out_writes[k][r] += 1
        else:
            rws[g, r] = row_values[g, r]
            row_writes[g, r] += 1
        if take(g, n_strips):
            n_cols = j.stop - j.start
            h_count = groups(n_cols)
            acc = [[torch.zeros(n_cols, 2, dtype=T64) for _ in range(4)] for _ in range(h_count)]
            for k in range(n_strips):
                h = (k // SLOT_BATCH) % h_count
                acc[h][k % 4] = acc[h][k % 4] + cols[k, j]
            a = acc[0]
            for h in range(1, h_count):
                a = [a[k] + acc[h][k] for k in range(4)]
            total = (a[0] + a[1]) + (a[2] + a[3])
            for k, c in (("s2", 0), ("l2", 1)):
                out[k][j] = total[:, c]
                out_writes[k][j] += 1
        if n_g > 1 and take(n_g + s, n_g):
            total = rws[0, r]
            for gg in range(1, n_g):
                total = total + rws[gg, r]
            for k, c in (("s1", 0), ("l1", 1)):
                out[k][r] = total[:, c]
                out_writes[k][r] += 1
    return out, tickets, col_writes, row_writes, out_writes


def emulate(x1, s1, l1, x2, s2, l2, kbar, sched=None, order=None):
    """(σ̄1, ℓ̄1, σ̄2, ℓ̄2) by the kernel's schedule (``sched``, by default the
    one for 132 SMs), the blocks finishing in ``order`` (default: block
    order), with the count of reads of each K̄ element, of writes of each
    slot value and of each gradient, the tickets afterwards, the slots'
    values, and every share that a staged input past N1 or N2 gave a real
    row or column."""
    n1, n2 = x1.shape[0], x2.shape[0]
    sched = sched or gk.k1_cross_backward_schedule(n1, n2)
    rows, n_strips, n_g, n_chunks, group = sched.rows, sched.n_strips, sched.col_groups, sched.n_chunks, sched.group
    per, per_warp = sched.chunks_per_group, rows // WARPS
    n1p, n2p = n_strips * rows, n_chunks * CHUNK

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
    # which block and thread reads K̄[i, j]: row i = s·rows + w·per_warp + k·group + r of strip s, column
    # j = c0 + 32v + lane of a chunk c0 of column group g (chunks g·per ..)
    s_, w_, k_, r_ = torch.meshgrid(torch.arange(n_strips), torch.arange(WARPS), torch.arange(per_warp // group),
                                    torch.arange(group), indexing="ij")
    i_all = (s_ * rows + w_ * per_warp + k_ * group + r_).flatten()
    j_all = torch.cat([(c * CHUNK + v * LANES + torch.arange(LANES))
                       for g in range(n_g) for c in range(g * per, min((g + 1) * per, n_chunks)) for v in range(2)])
    reads = (torch.bincount(i_all[i_all < n1], minlength=n1)[:, None]
             * torch.bincount(j_all[j_all < n2], minlength=n2)[None, :])
    # rows: a lane's two columns, the 32 lanes, then the group's chunks in order
    per_lane = row.reshape(n1p, n_chunks, 2, LANES, 2)
    per_lane = per_lane[:, :, 0] + per_lane[:, :, 1]  # (n1p, chunk, lane, 2)
    chunk_sums = _butterfly(per_lane.transpose(-1, -2))  # (n1p, chunk, 2)
    row_values = torch.zeros((n_g, n1, 2), dtype=T64)
    for g in range(n_g):
        c_first = g * per
        acc = chunk_sums[:, c_first]
        for c in range(c_first + 1, min(c_first + per, n_chunks)):
            acc = acc + chunk_sums[:, c]
        row_values[g] = acc[:n1]
    # columns: over a warp's rows in order, then over the 8 warps in order
    col_bw = col.reshape(n_strips, WARPS, per_warp, n2p, 2)
    per_warp_sums = col_bw[:, :, 0]
    for k in range(1, per_warp):
        per_warp_sums = per_warp_sums + col_bw[:, :, k]
    col_values = per_warp_sums[:, 0]
    for wp in range(1, WARPS):
        col_values = col_values + per_warp_sums[:, wp]
    col_values = col_values[:, :n2].contiguous()
    out, tickets, col_writes, row_writes, out_writes = finish(sched, col_values, row_values, order)
    # a block's threads: each (column, sum) of its group written by one thread
    threads = torch.zeros((n2, 2), dtype=torch.int64)
    for g in range(n_g):
        j, t = group_columns(sched, g)
        threads.index_put_((j, t), torch.ones_like(j), accumulate=True)
    col_writes = col_writes * threads[None]
    return {**out, "reads": reads, "col_writes": col_writes, "row_writes": row_writes, "out_writes": out_writes,
            "tickets": tickets, "col_values": col_values, "row_values": row_values, "padded": padded}


def _grads(out):
    return out["s1"], out["l1"], out["s2"], out["l2"]


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    out = {}
    for n1, n2 in SHAPES + (BIG,):
        args = _inputs(rng, n1, n2)
        out[(n1, n2)] = args, tuple(np.asarray(g) for g in _jax_grad(*(jnp.asarray(a) for a in args)))
    return out


def _assert_grads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-10, atol=1e-10 * np.abs(w).max())


@pytest.mark.parametrize("shape", SHAPES + (BIG,))
def test_emulated_schedule_matches_jax_grad(cases, shape):
    args, want = cases[shape]
    _assert_grads(_grads(emulate(*_t(*args))), want)


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


def _assert_once(out):
    """K̄ read once, every slot value, ticket and gradient written once, the
    tickets back at 0, and nothing from an input past N1 or N2."""
    assert torch.equal(out["reads"], torch.ones_like(out["reads"]))
    assert torch.equal(out["col_writes"], torch.ones_like(out["col_writes"]))
    assert torch.equal(out["row_writes"], torch.full_like(out["row_writes"], int(out["row_writes"].shape[0] > 1)))
    assert all(torch.equal(w, torch.ones_like(w)) for w in out["out_writes"].values())
    assert not bool(out["tickets"].any())
    assert bool((out["padded"] == 0).all())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_schedule_reads_kbar_once_and_writes_each_partial_once(cases, shape, sms):
    _assert_once(emulate(*_t(*cases[shape][0]), gk.k1_cross_backward_schedule(*shape, sms)))


def test_schedule_at_the_rate_shape_reads_kbar_once_and_writes_each_slot_once(cases):
    _assert_once(emulate(*_t(*cases[BIG][0])))


@pytest.mark.parametrize("shape,col_groups", [((600, 33), 1), ((500, 130), 3), ((1000, 600), 4), ((1000, 600), 10),
                                              ((2000, 128), 2)])
def test_each_slot_written_once_and_the_tickets_return_to_zero(cases, shape, col_groups):
    """Every block writes each of its (slot, column, sum) and (group, row,
    sum) once before its tickets, the blocks with the last tickets read no
    slot unwritten, and the tickets end at 0 after each of several
    launches."""
    args = _t(*cases[shape][0])
    sched = dataclasses.replace(gk.k1_cross_backward_schedule(*shape), col_groups=col_groups)
    out = emulate(*args, sched)
    _assert_once(out)
    assert sched.n_tickets == col_groups + (sched.n_strips if col_groups > 1 else 0)
    tickets = out["tickets"]
    for _ in range(3):  # the tickets carry from one launch to the next
        again, tickets, col_writes, _, _ = finish(sched, out["col_values"], out["row_values"],
                                                  reversed(range(sched.grid)), tickets)
        assert not bool(tickets.any()) and torch.equal(col_writes, torch.ones_like(col_writes))
        assert all(torch.equal(again[k], out[k]) for k in ("s1", "l1", "s2", "l2"))
    _assert_grads(_grads(out), cases[shape][1])


@pytest.mark.parametrize("shape,change", [((600, 33), {}), ((2000, 64), {}), ((1000, 256), {}),
                                          ((2000, 128), {}), ((1000, 600), {}), (BIG, {"rows": 256})])
def test_column_sums_do_not_depend_on_the_finishing_order(cases, shape, change):
    """Rotations of the block order (every one up to 80 blocks, else every
    third: an odd step, so a group's last ticket still goes to each of its
    blocks in turn), and its reverse: the four gradients equal bit for bit,
    whichever block takes a group's or a strip's last ticket (with one
    batch of slots and with several a thread group)."""
    args = _t(*cases[shape][0])
    sched = dataclasses.replace(gk.k1_cross_backward_schedule(*shape), **change)
    out = emulate(*args, sched)
    n = sched.grid
    step = 1 if n <= 80 else 3
    orders = [[(k + r) % n for k in range(n)] for r in range(0, n, step)] + [list(reversed(range(n)))]
    for order in orders:
        got, tickets, _, _, _ = finish(sched, out["col_values"], out["row_values"], order)
        assert not bool(tickets.any()) and all(torch.equal(got[k], out[k]) for k in ("s1", "l1", "s2", "l2")), \
            order[:4]


def test_staged_inputs_past_n_add_exactly_zero(cases):
    """Ragged strips and chunks are staged whole, with x = 0, σ = 0, ℓ = 1 and
    K̄ = 0 past N1 and N2, and no mask enters the arithmetic: every share
    such an input gives a real row or column is exactly 0."""
    padded = emulate(*_t(*cases[(37, 45)][0]))["padded"]
    assert padded.numel() > 0 and bool((padded == 0).all())


def test_emulation_does_not_depend_on_the_strip_height(cases):
    """The strip height changes the order of the column sums only (a row
    never leaves its warp), the column groups that of the row sums only."""
    args = _t(*cases[(1000, 600)][0])
    one = emulate(*args, gk.K1CrossBackwardSchedule(1000, 600, 160, 1))
    many = emulate(*args, gk.K1CrossBackwardSchedule(1000, 600, 32, 1))
    split = emulate(*args, gk.K1CrossBackwardSchedule(1000, 600, 160, 4))
    for a, b, c in zip(_grads(one), _grads(many), _grads(split)):
        for x in (a, c):
            np.testing.assert_allclose(x.numpy(), b.numpy(), rtol=1e-12, atol=1e-12 * b.abs().max().item())
    assert torch.equal(one["s1"], many["s1"]) and torch.equal(one["l1"], many["l1"])
    assert torch.equal(one["s2"], split["s2"]) and torch.equal(one["l2"], split["l2"])


def test_schedule_at_the_timed_shapes():
    sched = gk.k1_cross_backward_schedule(2000, 64)
    assert (sched.rows, sched.col_groups, sched.grid, sched.n_slots, sched.n_chunks) == (32, 1, 63, 63, 1)
    assert sched.slots_numel * 8 == 63 * 64 * 2 * 8  # 64.5 KB of f64 slots against 1 MB of K̄
    assert sched.n_tickets == 1
    assert (sched.rows // WARPS) * 2 * sched.n_chunks == 8  # terms a lane, all at once
    m128 = gk.k1_cross_backward_schedule(2000, 128)  # the sparse path at m_z = 128: the columns in 2 groups
    assert (m128.rows, m128.col_groups, m128.chunks_per_group, m128.grid, m128.n_tickets) == (32, 2, 1, 126, 65)
    assert m128.slots_numel == 63 * 128 * 2 + 2 * 2000 * 2
    wide = gk.k1_cross_backward_schedule(1000, 256)  # 32 strips: 4 column groups fill the card
    assert (wide.rows, wide.col_groups, wide.grid, wide.n_chunks, wide.n_tickets) == (32, 4, 128, 4, 36)
    big = gk.k1_cross_backward_schedule(*BIG)
    assert (big.rows, big.col_groups, big.grid) == (160, 1, 125)  # one wave, a block an SM
    assert (big.rows // WARPS) * 2 == 40  # terms a lane, 8 at once
    assert gk.k1_cross_backward_schedule(2000, 64, sms=33).rows == 64  # from the SM count
    assert gk.k1_cross_backward_schedule(10**7, 64).rows == 256  # the tallest strip; then more blocks
    assert gk.k1_cross_backward_schedule(1, 1).grid == 1
    assert gk.k1_cross_backward_schedule(1000, 600).col_groups == 4  # 10 chunks: 3, 3, 3, 1
    assert [gk.k1x_column_groups(10, w) for w in (0, 1, 3, 4, 5, 6, 10, 99)] == [1, 1, 3, 4, 5, 5, 10, 10]
    for n1 in (1, 15, 16, 17, 2000, 20000, 10**7):
        for n2 in (1, 64, 65, 600):
            s = gk.k1_cross_backward_schedule(n1, n2)
            assert s.rows % (8 * s.group) == 0 and (s.n_strips - 1) * s.rows < n1 <= s.n_strips * s.rows
            assert (s.col_groups - 1) * s.chunks_per_group < s.n_chunks <= s.col_groups * s.chunks_per_group
            assert s.grid <= max(132, s.n_strips) and s.n_tickets <= 133
    assert (groups(64), groups(256), groups(20), groups(1)) == (2, 1, 4, 8)


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
    with the launch recorded: one launch of the entry point with the
    schedule's strip height, column groups and grid, the slots and the
    tickets (per device and stream, kept), counted in
    ``gibbs_gram_cross_backward.launches``."""
    calls = []
    monkeypatch.setattr(gk, "_KERNEL_DEVICE_TYPES", ("cuda", "meta"))
    monkeypatch.setattr(gk, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "_launch", lambda name, dtype, device, *args: calls.append((name, args)))
    monkeypatch.setattr(gk.gibbs_gram_cross_backward, "launches", 0)
    monkeypatch.setattr(gk, "_tickets", {})
    meta = lambda *shape: torch.zeros(shape, dtype=torch.float64, device="meta")
    out = gk.gibbs_gram_cross_backward(meta(2000), meta(2000), meta(2000), meta(64), meta(64), meta(64),
                                       meta(2000, 64))
    assert [o.shape for o in out] == [(2000,), (2000,), (64,), (64,)]
    assert gk.gibbs_gram_cross_backward.launches == 1
    ((name, args),) = calls
    assert name == "gibbs_gram_cross_backward" and len(args) == len(gk._ENTRY_POINTS[name][1])
    assert (args[3], args[7], args[9], args[10], args[11]) == (2000, 64, 32, 1, 63)
    (tickets,) = gk._tickets.values()
    assert tickets.dtype == torch.int32 and tickets.shape == (133,)  # the SMs + 1: any default schedule's
    for n1, n2, want in ((20000, 64, (160, 1, 125)), (1000, 256, (32, 4, 128))):
        gk.gibbs_gram_cross_backward(meta(n1), meta(n1), meta(n1), meta(n2), meta(n2), meta(n2), meta(n1, n2))
        assert tuple(calls[-1][1][9:12]) == want
    assert gk.gibbs_gram_cross_backward.launches == 3 and list(gk._tickets.values()) == [tickets]  # kept
    assert gk._tickets_for(torch.device("meta"), 629).shape == (629,)  # a schedule that takes more
    with pytest.raises(ValueError, match="want x1"):
        gk.gibbs_gram_cross_backward(meta(20), meta(20), meta(20), meta(6), meta(6), meta(6), meta(6, 20))


def _source() -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")) as f:
        return " ".join(f.read().split())


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``gibbs_gram.cu`` that ``emulate`` and the schedule
    transcribe: a change there must be made here too."""
    src = _source()
    for line in (
        "constexpr int kXThreads = 256;",
        "constexpr int kXCols = 2;",
        "constexpr int kXChunk = 32 * kXCols;",
        "constexpr int kXMaxRows = kXThreads;",
        "const int strip = blockIdx.x / col_groups, cgrp = blockIdx.x % col_groups;",
        "const int r0 = strip * rows;",
        "const int per = ((n2 + kXChunk - 1) / kXChunk + col_groups - 1) / col_groups;",
        "const int c_begin = cgrp * per * kXChunk, c_end = min(n2, c_begin + per * kXChunk);",
        "const int per_warp = rows / kXWarps;",
        "const int w0 = warp * per_warp;",
        "const T x_st = st_in ? x1[i_st] : T(0), s_st = st_in ? s1[i_st] : T(0), l_st = st_in ? l1[i_st] : T(1);",
        "sh[tid] = T(1) / (T(2) * l_st);",
        "su[tid] = gsqrt(T(1.4142135623730951) * l_st);",
        "for (int c0 = c_begin; c0 < c_end; c0 += kXChunk) {",
        "constexpr int kXGroup = 4;",
        "for (int g0 = w0; g0 < w0 + per_warp; g0 += kXGroup) {",
        "const int i = i0 + g, j = c0 + lane + 32 * v;",
        "kb[g][v] = i < n1 && j < n2 ? kbar[static_cast<size_t>(i) * n2 + j] : T(0);",
        "cx[v] = in ? x2[j] : T(0); cs[v] = in ? s2[j] : T(0); cl[v] = in ? l2[j] : T(1);",
        "const T rs = grsqrt(fma(li, li, lj2[v]));",
        "const T w = kb[g][v] * ((ui * uj[v]) * rs * gexp(-d * ra));",
        "const T e = fma(T(2) * d, ra, T(-1)) * ra;",
        "ps = fma(w, sj[v], ps); pl = fma(wss, fma(li, e, hi), pl);",
        "col_s[v] = fma(w, si, col_s[v]); col_l[v] = fma(wss, fma(lj[v], e, hj[v]), col_l[v]);",
        "part[2 * g] = ps; part[2 * g + 1] = pl;",
        "for (int k = 0; k < m; ++k) v[k] = (up ? v[m + k] : v[k]) + __shfl_xor_sync(0xffffffffu, up ? v[k] : "
        "v[m + k], o);",
        "for (; o > 0; o /= 2) c += __shfl_xor_sync(0xffffffffu, c, o);",
        "constexpr int kSpread = 32 / (2 * kXGroup);",
        "const int q = lane / kSpread, r = g0 + (q >> 1); T* acc = (q & 1) ? srl : srs; "
        "acc[r] = c0 == c_begin ? sum : acc[r] + sum;",
        "red[warp][2 * (32 * v + lane)] = col_s[v]; red[warp][2 * (32 * v + lane) + 1] = col_l[v];",
        "const int j = c0 + (tid >> 1); if (tid < 2 * kXChunk && j < n2) { T acc = red[0][tid];",
        "for (int w = 1; w < kXWarps; ++w) acc += red[w][tid]; "
        "slots[(static_cast<size_t>(strip) * n2 + j) * 2 + (tid & 1)] = acc;",
        "if (col_groups == 1) { s1_bar[i_st] = srs[tid]; l1_bar[i_st] = srl[tid]; } else { "
        "rslots[(static_cast<size_t>(cgrp) * n1 + i_st) * 2] = srs[tid]; "
        "rslots[(static_cast<size_t>(cgrp) * n1 + i_st) * 2 + 1] = srl[tid]; }",
        'asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;" : "=r"(old) : "l"(ticket), "r"(n - 1) '
        ': "memory"); return old == n - 1;',
        "last_col = take_ticket(tickets + cgrp, n_strips); "
        "last_row = col_groups > 1 && take_ticket(tickets + col_groups + strip, col_groups);",
        "T a = __ldcg(rslots + at); "
        "for (int g = 1; g < col_groups; ++g) a += __ldcg(rslots + static_cast<size_t>(g) * n1 * 2 + at);",
        "constexpr int kXSlotBatch = 32;",
        "const int n_vals = 2 * (c_end - c_begin);",
        "const int groups = n_vals > kXThreads / 2 ? 1 : n_vals > kXThreads / 4 ? 2 : n_vals > kXThreads / 8 ? 4 : 8;",
        "for (unsigned int s = h * kXSlotBatch; s < n_strips; s += groups * kXSlotBatch) {",
        "if (s + k < n_strips) got[k] = __ldcg(src + (s + k) * stride);",
        "for (int k = 0; k < kXSlotBatch; ++k) a[k % 4] += got[k];",
        "for (int g = 1; g < groups; ++g) {",
        "for (int k = 0; k < 4; ++k) a[k] += acc4[(g * 4 + k) * span + tid];",
        "if (h == 0 && p < n_vals) ((p & 1) ? l2_bar : s2_bar)[c_begin + (p >> 1)] = (a[0] + a[1]) + (a[2] + a[3]);",
    ):
        assert line in src, line
    sched = gk.K1CrossBackwardSchedule
    assert (sched.warps, sched.group, sched.chunk, gk._K1X_MAX_ROWS) == (8, 4, 64, 256)


def test_cross_form_takes_one_launch():
    """The cross-form launcher starts the one kernel and no reduction launch
    (the self form keeps its second launch)."""
    src = _source()
    body = src[src.index("int launch_cross_backward("):src.index("} // namespace")]
    assert body.count("<<<") == 1 and "cudaLaunchKernelEx(" not in body
    assert "launch_reduce" not in body and "gibbs_gram_bwd_reduce" not in body
    assert "gibbs_gram_cross_bwd_kernel<T><<<" in body


@pytest.mark.parametrize("suffix", ["f32", "f64"])
def test_entry_point_takes_the_arguments_the_wrapper_binds(suffix):
    """``ctypes`` passes what ``_ENTRY_POINTS`` declares, then the stream: the
    C signature must have exactly that many parameters, pointers where the
    wrapper passes pointers."""
    params = re.search(rf"int gibbs_gram_cross_backward_{suffix}\(([^)]*)\)", _source()).group(1).split(",")
    _, argtypes = gk._ENTRY_POINTS["gibbs_gram_cross_backward"]
    assert len(params) == len(argtypes) + 1  # the stream last
    for p, t in zip(params, argtypes + [gk._P]):
        assert ("*" in p) == (t is gk._P), p
