"""K3's backward kernel: its schedule, emulated on the CPU, against the JAX
package's gradient.

The CUDA kernel (``csrc/svc_gram_tiled.cu``) runs only on the card, where
``chip_smoke.py`` holds it against autograd through the plain version.  Here
a torch emulation follows the kernel's schedule as
``gram_kernels.k3_backward_schedule`` gives it: the unordered tile pairs
(I <= J) in their fixed order, each staging K̄[I, J] and K̄[J, I] (one tile
on the diagonal) and the ragged last tile whole, as the kernel does (x = 0,
ℓ = 1, L = 0, K̄ = 0 past N), evaluating each unordered input pair once and adding its
contributions to both rows, into the partial slots ``[partner tile][row]``,
which are then summed in the second launch's fixed order (lane j of a
row's warp adds slots j, j + 32, ...; a shuffle tree adds the lanes).  A
(40, 2) case spans 3 slots, (600, 1) 38: more than a warp's lanes.  The
kernel computes a pair's (I, J) from its index itself (``tile_pair``);
``_kernel_tile_pair`` is that loop transcribed, and a test holds it to the
schedule's order.

The generic route (M > 8) has its own emulation, ``emulate_generic``: the
same walk over unordered tile pairs, on tiles of 64 rows of the flattened
index (row n·M + a), S formed once a pair, the row side of I walking the
columns of J and (off the diagonal) the column side of J walking the rows
of I, input by input, for each block of ``K3_GENERIC_BB`` b values; the
slots ``partial[slot][k][row]`` (k < M: L̄'s share, M + b block: that
block's ℓ̄ share) and the two summing launches' fixed order.

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

from nonstationary_multivariate_gaussian_process_tpu.models import gnmgp as jgnmgp
from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

T64 = torch.float64
JITTER = 1e-6
SHAPES = [(40, 2), (37, 3), (23, 5), (17, 8), (16, 1), (32, 2), (600, 1)]


def _inputs(rng, n, m):
    x = np.sort(rng.uniform(size=n))
    ell = np.exp(3 * (x - 1) ** 3 - 3 + 0.2 * rng.normal(size=n))
    ls = np.tril(rng.normal(size=(n, m, m))) + 2 * np.eye(m)
    kbar = rng.normal(size=(n * m, n * m))  # not symmetric
    return x, ell, ls, kbar


def _jax_grad(x, ell, ls, kbar):
    n, m, _ = ls.shape

    def loss(e, l):
        kx = jkernels.nonstationary_rbf_cov(jnp.asarray(x), ell1=e)
        k = jgnmgp.gram(kx, l).reshape(m, n, m, n).transpose(1, 0, 3, 2).reshape(n * m, n * m)
        return jnp.sum(jnp.asarray(kbar) * k)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(ell), jnp.asarray(ls))


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


def _staged(x, ell, ls, kbar, t):
    """The inputs as the kernel stages them: past N, up to a whole last tile
    of ``t`` inputs, x = 0, ℓ = 1, L = 0 and K̄ = 0."""
    n, m, _ = ls.shape
    n_pad = -(-n // t) * t
    xs, es = torch.zeros(n_pad, dtype=T64), torch.ones(n_pad, dtype=T64)
    lss, kbs = torch.zeros((n_pad, m, m), dtype=T64), torch.zeros((n_pad * m, n_pad * m), dtype=T64)
    xs[:n], es[:n], lss[:n], kbs[: n * m, : n * m] = x, ell, ls, kbar
    return xs, es, lss, kbs


def emulate(x, ell, ls, kbar, jitter, sms=132):
    """(ℓ̄, L̄) by the kernel's schedule, with the count of reads of each
    K̄ element and of writes of each (slot, row), and every share that a
    staged input past N gave a real row (the kernel relies on their being
    0)."""
    n, m, _ = ls.shape
    sched = gk.k3_backward_schedule(n, m, sms)
    t, mm = sched.tile, m * m
    xs, es, lss, kbs = _staged(x, ell, ls, kbar, t)
    partial = torch.full((sched.n_tiles, n, mm + 1), float("nan"), dtype=T64)
    reads = torch.zeros((n * m, n * m), dtype=torch.int64)
    writes = torch.zeros((sched.n_tiles, n), dtype=torch.int64)
    padded = []
    eye, upper = torch.eye(t, dtype=T64), torch.triu(torch.ones(t, t, dtype=T64))
    for b in range(sched.grid):  # the persistent grid: block b takes q = b, b + grid, ...
        for q in range(b, sched.n_pairs, sched.grid):
            i, j = _kernel_tile_pair(q, sched.n_tiles)
            rows, cols = slice(i * t, i * t + t), slice(j * t, j * t + t)
            real_r, real_c = torch.arange(i * t, i * t + t) < n, torch.arange(j * t, j * t + t) < n
            diag = i == j
            # the K̄ elements copied from memory; the staged rest is 0
            kr = slice(i * t * m, min(n, i * t + t) * m)
            kc = slice(j * t * m, min(n, j * t + t) * m)
            reads[kr, kc] += 1
            if not diag:
                reads[kc, kr] += 1
            ks_r, ks_c = slice(i * t * m, (i + 1) * t * m), slice(j * t * m, (j + 1) * t * m)
            # S[n,a,p,c] = K̄[(n,a),(p,c)] + K̄[(p,c),(n,a)]
            s = kbs[ks_r, ks_c].reshape(t, m, t, m) + kbs[ks_c, ks_r].reshape(t, m, t, m).permute(2, 3, 0, 1)
            xr, xc, lr, lc = xs[rows], xs[cols], es[rows], es[cols]
            lsr, lsc = lss[rows], lss[cols]
            d = (xr[:, None] - xc[None, :]) ** 2
            a2 = lr[:, None] ** 2 + lc[None, :] ** 2
            kx = torch.sqrt(2 * lr[:, None] * lc[None, :] / a2) * torch.exp(-d / a2)
            fn = 1 / (2 * lr[:, None]) - lr[:, None] / a2 + 2 * lr[:, None] * d / a2**2
            fp = 1 / (2 * lc[None, :]) - lc[None, :] / a2 + 2 * lc[None, :] * d / a2**2
            if diag:  # each unordered pair once; n == p on the row side alone, with f = 0
                w_row, w_col = upper, upper - eye
                kxj = kx + jitter * eye
                fn = fn * (1 - eye)
            else:
                w_row = w_col = torch.ones(t, t, dtype=T64)
                kxj = kx
            bsum = torch.einsum("nab,pcb->napc", lsr, lsc)
            gsum = torch.einsum("napc,napc->np", s, bsum)
            # each input pair's shares: [n, p, k] to row n and to column p
            row = torch.cat([
                torch.einsum("napc,np,pcb->npab", s, kxj * w_row, lsc).reshape(t, t, mm),
                (gsum * kx * fn * w_row)[:, :, None],
            ], 2)
            col = torch.cat([
                torch.einsum("napc,np,nab->npcb", s, kxj * w_col, lsr).reshape(t, t, mm),
                (gsum * kx * fp * w_col)[:, :, None],
            ], 2)
            padded += [row[real_r][:, ~real_c].flatten(), col[~real_r][:, real_c].flatten()]
            row, col = row.sum(1)[real_r], col.sum(0)[real_c]
            r_out = slice(i * t, min(n, i * t + t))
            c_out = slice(j * t, min(n, j * t + t))
            if diag:
                partial[i, r_out] = row + col
                writes[i, r_out] += 1
            else:
                partial[j, r_out] = row
                writes[j, r_out] += 1
                partial[i, c_out] = col
                writes[i, c_out] += 1
    # the second launch, one warp per row: lane j adds slots j, j + 32, ...
    # in turn, then a shuffle tree adds the lanes
    lanes = torch.zeros((32, n, mm + 1), dtype=T64)
    for slot in range(sched.n_tiles):
        lanes[slot % 32] = lanes[slot % 32] + partial[slot]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    out = lanes[0]
    return out[:, mm], out[:, :mm].reshape(n, m, m), reads, writes, torch.cat(padded)


@pytest.mark.parametrize("n,m", SHAPES)
def test_emulated_schedule_matches_jax_grad(rng, n, m):
    x, ell, ls, kbar = _inputs(rng, n, m)
    want_e, want_l = _jax_grad(x, ell, ls, kbar)
    got_e, got_l, *_ = emulate(*(torch.tensor(a, dtype=T64) for a in (x, ell, ls, kbar)), JITTER)
    for got, want in ((got_e, want_e), (got_l, want_l)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_schedule_reads_kbar_once_and_writes_each_slot_once(rng, n, m, sms):
    x, ell, ls, kbar = (torch.tensor(a, dtype=T64) for a in _inputs(rng, n, m))
    *_, reads, writes, _ = emulate(x, ell, ls, kbar, JITTER, sms)
    assert torch.equal(reads, torch.ones_like(reads))
    assert torch.equal(writes, torch.ones_like(writes))


@pytest.mark.parametrize("n,m", [s for s in SHAPES if s[0] % gk.k3_backward_schedule(*s).tile])
def test_staged_inputs_past_n_add_exactly_zero(rng, n, m):
    """The ragged last tile is staged whole, with x = 0, ℓ = 1, L = 0 and
    K̄ = 0 past N, and no mask enters the arithmetic: every share such an
    input gives a real row, ℓ̄'s through f and gsum included, is exactly 0.
    Each share carries a factor of S and one of L, so either zero alone
    would do."""
    x, ell, ls, kbar = (torch.tensor(a, dtype=T64) for a in _inputs(rng, n, m))
    past_n = emulate(x, ell, ls, kbar, JITTER)[4]
    assert past_n.numel() > 0 and bool((past_n == 0).all())


@pytest.mark.parametrize("n,m", SHAPES + [(1000, 2), (257, 3)])
def test_kernel_pair_mapping_is_the_schedules_order(n, m):
    sched = gk.k3_backward_schedule(n, m)
    assert [_kernel_tile_pair(q, sched.n_tiles) for q in range(sched.n_pairs)] == sched.pairs()
    assert len(set(sched.pairs())) == sched.n_pairs


@pytest.mark.parametrize("n_tiles", [63, 1000, 4096, 32768])
def test_kernel_pair_mapping_at_row_starts_of_large_grids(n_tiles):
    """Where the float32 root is least exact: the first and last pair of
    each tile row, up to the largest N the launch grid takes."""
    first = [i * n_tiles - i * (i - 1) // 2 for i in range(n_tiles + 1)]
    for i in np.unique(np.linspace(0, n_tiles - 1, 300).astype(int)):
        assert _kernel_tile_pair(first[i], n_tiles) == (i, i)
        assert _kernel_tile_pair(first[i + 1] - 1, n_tiles) == (i, n_tiles - 1)


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``svc_gram_tiled.cu`` that ``_kernel_tile_pair`` and
    ``_staged`` transcribe: a change there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "return i * n_tiles - i * (i - 1) / 2;",
        "const float b = 2.0f * n_tiles + 1.0f;",
        "int i = static_cast<int>((b - sqrtf(fmaxf(b * b - 8.0f * q, 0.0f))) * 0.5f);",
        "i = max(0, min(i, n_tiles - 1));",
        "while (i > 0 && q < first_pair(i, n_tiles)) --i;",
        "while (i + 1 < n_tiles && q >= first_pair(i + 1, n_tiles)) ++i;",
        "J = i + q - first_pair(i, n_tiles);",
        "xs[i] = T(0); es[i] = T(1);",
        "else Ls[r * S::LP + k] = T(0);",
        "else *d = T(0);",
        "if (diag) { if (n0 + l < n) partial[(static_cast<size_t>(I) * n + n0) * K + i] = rs + cs;",
        "for (int slot = lane; slot < n_slots; slot += 32) {",
    ):
        assert line in src, line


def test_schedule_at_the_training_shape():
    sched = gk.k3_backward_schedule(1000, 2)
    assert (sched.tile, sched.n_tiles, sched.n_pairs) == (16, 63, 2016)
    assert sched.grid == 132 * 4
    assert sched.partial_numel * 8 == 63 * 1000 * 5 * 8  # 2.52 MB of f64 partials against 32 MB of K̄
    assert gk.k3_backward_schedule(17, 8).tile == 8
    assert gk.k3_backward_schedule(3, 2).grid == 1  # never more blocks than tile pairs


def test_emulation_does_not_depend_on_the_grid(rng):
    x, ell, ls, kbar = (torch.tensor(a, dtype=T64) for a in _inputs(rng, 37, 3))
    one = emulate(x, ell, ls, kbar, JITTER, sms=1)
    many = emulate(x, ell, ls, kbar, JITTER, sms=132)
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])


def _generic_tables(x, ell, jitter, n0, p0, span=9):
    """The generic route's Gibbs tables of a tile pair: kxj, W of the row
    side (kx·f(ℓ_n; ℓ_p, D)) and of the column side (kx·f(ℓ_p; ℓ_n, D)) for
    the inputs n0 + i, p0 + j (i, j < 9); 0 past N and W = 0 at n == p."""
    n = len(x)
    nn, pp = n0 + torch.arange(span), p0 + torch.arange(span)
    ok = (nn[:, None] < n) & (pp[None, :] < n)
    xi, li = x[nn.clamp(max=n - 1)], ell[nn.clamp(max=n - 1)]
    xj, lj = x[pp.clamp(max=n - 1)], ell[pp.clamp(max=n - 1)]
    ln, lp = li[:, None], lj[None, :]
    d = (xi[:, None] - xj[None, :]) ** 2
    a2 = ln * ln + lp * lp
    kx = torch.sqrt(2 * (ln * lp) / a2) * torch.exp(-d / a2)
    same = nn[:, None] == pp[None, :]
    g = 2 * d / (a2 * a2) - 1 / a2
    kxj = torch.where(ok, kx + jitter * same, 0.0)
    wr = torch.where(ok & ~same, kx * (0.5 / ln + ln * g), 0.0)
    wc = torch.where(ok & ~same, kx * (0.5 / lp + lp * g), 0.0)
    return kxj, wr, wc


def _generic_side(s, lf, m, nm, own0, walk0, kxj, w, bb):
    """One side of a pair for every row e of tile own0 and every b: walking
    the rows of tile walk0 input by input (s[e, w] = S along the walk),
    L̄'s share and each b block's ℓ̄ share.  kxj, w: [own input, walked
    input] tables."""
    t = s.shape[0]
    own = (own0 + torch.arange(t)) // m - own0 // m
    first, wlim = walk0 // m, min(t, nm - walk0)
    acc, lacc = torch.zeros((t, m), dtype=T64), torch.zeros((t, m), dtype=T64)
    w0, seg, end = 0, 0, (walk0 // m + 1) * m - walk0
    while w0 < wlim:  # one walked input a segment
        w1 = min(end, wlim)
        part = s[:, w0:w1] @ lf[walk0 + w0:walk0 + w1]
        acc = acc + kxj[own, seg][:, None] * part
        lacc = lacc + w[own, seg][:, None] * part
        w0, seg, end = w1, seg + 1, end + m
    rows = torch.arange(own0, own0 + t).clamp(max=nm - 1)
    blocks = -(-m // bb)
    lsh = torch.stack([(lf[rows, k * bb:(k + 1) * bb] * lacc[:, k * bb:(k + 1) * bb]).sum(1) for k in range(blocks)], 1)
    return acc, lsh


def emulate_generic(x, ell, ls, kbar, jitter, sms=132):
    """(ℓ̄, L̄) by the generic route's schedule (M > 8), with the count of
    reads of each K̄ element and of writes of each (slot, k, row)."""
    n, m, _ = ls.shape
    nm = n * m
    sched = gk.k3_backward_schedule(n, m, sms)
    t, nt, bb = sched.tile, sched.n_tiles, gk.K3_GENERIC_BB
    nbb = sched.n_bblocks
    ks = m + nbb
    assert sched.partial_numel == nt * ks * nm
    lf = ls.reshape(nm, m)
    kbs = torch.zeros((nt * t, nt * t), dtype=T64)  # staged: 0 past NM
    kbs[:nm, :nm] = kbar
    partial = torch.full((nt, ks, nm), float("nan"), dtype=T64)
    reads = torch.zeros((nm, nm), dtype=torch.int64)
    writes = torch.zeros((nt, ks, nm), dtype=torch.int64)
    for b in range(sched.grid):  # the persistent grid: block b takes q = b, b + grid, ...
        for q in range(b, sched.n_pairs, sched.grid):
            i, j = _kernel_tile_pair(q, nt)
            i0, j0 = i * t, j * t
            reads[i0:i0 + t, j0:j0 + t] += 1
            if i != j:
                reads[j0:j0 + t, i0:i0 + t] += 1
            s = kbs[i0:i0 + t, j0:j0 + t] + kbs[j0:j0 + t, i0:i0 + t].T  # S[I, J], formed once
            kxj, wr, wc = _generic_tables(x, ell, jitter, i0 // m, j0 // m)
            sides = [(s, i0, j0, kxj, wr, j)]  # the rows of I walking J, into slot J
            if i != j:
                sides.append((s.T, j0, i0, kxj.T, wc.T, i))  # the rows of J walking I, into slot I
            for s_, own0, walk0, kt, wt, slot in sides:
                acc, lsh = _generic_side(s_, lf, m, nm, own0, walk0, kt, wt, bb)
                rows = slice(own0, min(nm, own0 + t))
                real = rows.stop - rows.start
                partial[slot, :m, rows] = acc[:real].T
                partial[slot, m:, rows] = lsh[:real].T
                writes[slot, :, rows] += 1
    # the second launch: each (k, row)'s slots in order; the third: ℓ̄'s
    # terms j = a·(b blocks) + b block by one warp an input, lane l adding
    # terms l, l + 32, ..., then a shuffle tree
    sums = torch.zeros((ks, nm), dtype=T64)
    for slot in range(nt):
        sums = sums + partial[slot]
    terms = sums[m:].T.reshape(n, m * nbb)  # [n][a·nbb + b block]
    lanes = torch.zeros((n, 32), dtype=T64)
    for k in range(terms.shape[1]):
        lanes[:, k % 32] = lanes[:, k % 32] + terms[:, k]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ off]
    return lanes[:, 0], sums[:m].T.reshape(n, m, m), reads, writes


GENERIC_SHAPES = [(6, 9), (4, 13), (3, 17), (21, 9), (5, 30), (2, 64)]


def _coupled_inputs(rng, n, m):
    x, _, ls, kbar = _inputs(rng, n, m)
    # lengthscales that couple these few inputs, so that ℓ̄ is not 0 up to rounding
    ell = np.exp(-1 + 0.2 * rng.normal(size=n))
    return x, ell, ls, kbar


@pytest.mark.parametrize("n,m", GENERIC_SHAPES)
def test_generic_route_order_of_work_matches_jax_grad(rng, n, m):
    """M > 8: the generic route's walk against ``jax.grad`` of the JAX
    package's Gram and against autograd of the plain version."""
    x, ell, ls, kbar = _coupled_inputs(rng, n, m)
    want_e, want_l = _jax_grad(x, ell, ls, kbar)
    args = [torch.tensor(a, dtype=T64) for a in (x, ell, ls, kbar)]
    got_e, got_l, *_ = emulate_generic(*args, JITTER)
    plain_e, plain_l = gk.svc_gram_tiled_backward_plain(args[0], args[1], args[2], JITTER, args[3])
    for got, want, plain in ((got_e, want_e, plain_e), (got_l, want_l, plain_l)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("n,m", GENERIC_SHAPES)
@pytest.mark.parametrize("sms", [1, 132])
def test_generic_route_reads_kbar_once_and_writes_each_slot_once(rng, n, m, sms):
    x, ell, ls, kbar = (torch.tensor(a, dtype=T64) for a in _coupled_inputs(rng, n, m))
    *_, reads, writes = emulate_generic(x, ell, ls, kbar, JITTER, sms)
    assert torch.equal(reads, torch.ones_like(reads))
    assert torch.equal(writes, torch.ones_like(writes))


def test_generic_route_does_not_depend_on_the_grid(rng):
    x, ell, ls, kbar = (torch.tensor(a, dtype=T64) for a in _coupled_inputs(rng, 21, 9))
    one = emulate_generic(x, ell, ls, kbar, JITTER, sms=1)
    many = emulate_generic(x, ell, ls, kbar, JITTER, sms=132)
    assert gk.k3_backward_schedule(21, 9, 1).grid == 1 and gk.k3_backward_schedule(21, 9).grid == 6
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])


def test_generic_route_schedule():
    """The A/B shapes: tiles of 64 flattened rows, one block per SM (never
    more than the tile pairs), and the partials in doubles."""
    want = {(200, 9): (29, 435, 132, 5_011_200), (1000, 9): (141, 10_011, 132, 121_824_000),
            (500, 16): (125, 7_875, 132, 176_000_000), (200, 32): (100, 5_050, 132, 220_160_000),
            (64, 9): (9, 45, 45, 497_664)}
    for (n, m), (tiles, pairs, grid, scratch) in want.items():
        sched = gk.k3_backward_schedule(n, m)
        assert (sched.route, sched.tile) == ("generic", 64)
        assert (sched.n_tiles, sched.n_pairs, sched.grid) == (tiles, pairs, grid)
        for dtype in (torch.float64, torch.float32):
            assert sched.partial_dtype(dtype) == torch.float64 and sched.scratch_bytes(dtype) == scratch
    assert gk.k3_backward_schedule(40, 8).route == "tiled"
    assert gk.k3_backward_schedule(40, 8).partial_dtype(torch.float32) == torch.float32


def test_generic_emulation_mirrors_the_kernel_source():
    """The lines of ``svc_gram_tiled.cu`` that ``emulate_generic`` and
    ``_generic_side`` transcribe: a change there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "constexpr int kGenTile = 64;",
        "constexpr int kGenBB = 3;",
        "S[r * kGenKP + c] = static_cast<double>(kb[r * kGenKP + c]) + static_cast<double>(kbt[c * kGenKP + r]);",
        "const int nn = I0 / m + tid / kGenSpan, pp = J0 / m + tid % kGenSpan;",
        "kxj = nn == pp ? kx + static_cast<double>(jitter) : kx;",
        "for (int end = (first + 1) * m - walk0; w < wlim; end += m, ++seg) {",
        "const double s = COL ? S[w * kGenKP + e] : S[e * kGenKP + w];",
        "const int tab = COL ? seg * kGenSpan + own : own * kGenSpan + seg;",
        "gen_bwd_task<T, false>(S, kxj_s, wr_s, LI, LJ, m, nm, k % kGenTile, k / kGenTile, I0, J0, J, ks, partial);",
        "gen_bwd_task<T, true>(S, kxj_s, wc_s, LJ, LI, m, nm, (k - side) % kGenTile, (k - side) / kGenTile, J0, I0, I, ks, partial);",
        "const double v = static_cast<double>(kb[r * kGenKP + c]) + static_cast<double>(kb[c * kGenKP + r]);",
        "dst[static_cast<size_t>(m + bb) * nm] = lsum;",
        "for (int j = 0; j < kGenSlotBatch; ++j) v[j] = src[(s + j) * stride];",
        "for (int j = 0; j < kGenSlotBatch; ++j) acc += v[j];",
        "for (; s < n_slots; ++s) acc += src[s * stride];",
        "if (k < m) ls_bar[row * m + k] = static_cast<T>(acc); else partial[i] = acc;",
        "for (int j = lane; j < m * nbb; j += 32) { const int a = j / nbb, kb = j % nbb;",
        "acc += partial[(m + kb) * nm + w * m + a];",
    ):
        assert line in src, line


def test_generic_route_shared_memory_does_not_grow_with_m():
    """Every M above 8 (9..256 here) takes the generic route, whose shared
    memory is two stages of two 64 x 65 K̄ tiles in the input's type, the
    tiles' 64 rows of L where both stages still fit the H100's 232,448 B a
    block (M <= 47 in float64, 127 in float32; above, L is read through the
    cache and the size no longer grows with M), then S (float32) and three
    9 x 9 tables in double."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "static constexpr int KB = kGenTile * kGenKP;",
        "static constexpr int TAB = kGenSpan * kGenSpan;",
        "static constexpr bool S_IN_PLACE = sizeof(T) == 8;",
        "return 2 * KB + (stage_l ? 2 * kGenTile * m : 0);",
        "return sizeof(T) * 2 * stage(m, stage_l) + sizeof(double) * ((S_IN_PLACE ? 0 : KB) + 3 * TAB);",
        "const bool stage_l = GenBwd<T>::smem(m, true) <= kMaxSmem;",
        "constexpr size_t kMaxSmem = 232448;",
        "constexpr int kGenKP = kGenTile + 1;",
    ):
        assert line in src, line
    for dtype, size, last in ((torch.float64, 8, 47), (torch.float32, 4, 127)):
        staged = [m for m in range(9, 257) if gk.k3_backward_schedule(40, m).l_staged(dtype)]
        assert staged == list(range(9, last + 1))
        for m in range(9, 257):
            sched = gk.k3_backward_schedule(40, m)
            assert sched.route == "generic" and sched.smem_bytes(dtype) <= 232_448
            stage = 2 * 64 * 65 + (2 * 64 * m if m <= last else 0)
            assert sched.smem_bytes(dtype) == size * 2 * stage + 8 * ((0 if size == 8 else 64 * 65) + 3 * 81)
    assert gk.k3_backward_schedule(1000, 9).smem_bytes(torch.float64) == 153_496
