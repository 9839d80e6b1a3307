"""K1's forward kernels: their walks, emulated on the CPU, against the plain
version and the JAX package's Gibbs covariance.

The CUDA kernels (``gibbs_gram_pairs_kernel`` and
``gibbs_gram_threads_kernel`` in ``csrc/gibbs_gram.cu``) run only on the
card, where ``chip_smoke.py`` holds them against the plain version bit for
bit.  Here vectorised torch emulations follow the routes as
``gram_kernels.k1_forward_schedule`` gives them:

* Pairs (the self form at large N): block ``b`` takes the unordered tile
  pairs (I <= J) ``b, b + grid, ...``; thread ``t`` evaluates columns
  ``(t % (32/V))·V ..`` of rows ``t // (32/V) + 8·V·k`` (four terms); tile
  (I, J) is stored from those registers, tile (J, I) from the shared tile
  read transposed, and a diagonal tile evaluates its upper triangle (the
  jitter on i == j) and stores the whole tile once, its lower triangle read
  transposed.
* Threads (the cross form, the self form at small N): one thread per output
  on blocks of 32 columns by 8 rows.

The emulations count the writes of every output and check every store's
alignment to its width and that it stays in its row.  The Gibbs term is
taken from the plain version's matrix, its upper triangle mirrored for the
self form (the kernel evaluates each unordered pair once, and every
operation of the term is commutative in (i, j), so on the card the plain
matrix is symmetric bit for bit; torch's CPU ``exp`` may round the tail of a
short vector otherwise, so CPU symmetry is not assumed and the self form is
held to the plain version at ``KERNEL_TOL``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_k1_backward import _kernel_tile_pair

from nonstationary_multivariate_gaussian_process_tpu.ops import kernels as jkernels
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

torch.set_num_threads(1)  # the suite's workers share the cores: one intra-op thread each

JITTER = 1e-6
DTYPES = [torch.float64, torch.float32]
#: chip_smoke.py's: the same formula in the same order on both sides.
KERNEL_TOL = {torch.float64: (1e-12, 0.0), torch.float32: (2e-6, 1e-7)}
SELF_SIZES = (1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 257)
#: Against JAX: rtol 1e-12 in float64, and an absolute floor below the
#: smallest normal float64 alone, since XLA on the CPU flushes subnormal
#: results (far-apart inputs at N=257) to 0.
JAX_TOL = {"rtol": 1e-12, "atol": 1e-300}


def _inputs(rng, n, dtype=torch.float64):
    x = np.sort(rng.uniform(size=n))
    sigma = 0.5 + 1.5 * rng.uniform(size=n)
    ell = np.exp(3 * (x - 1) ** 3 - 3 + 0.2 * rng.normal(size=n))
    return tuple(torch.tensor(a, dtype=dtype) for a in (x, sigma, ell))


def _store(out, writes, rows, cols, vals, vec):
    """V-wide stores at (rows, cols ..): the first column of each store is
    ``cols``, (..., 1) against ``vals`` (..., V).  Returns whether every store
    was aligned to its width and stayed in its row."""
    n2 = out.shape[1]
    c = cols + torch.arange(vec)
    ok = bool(((rows * n2 + cols) % vec == 0).all()) and bool((c < n2).all())
    r = rows.expand_as(c)
    out[r.flatten(), c.flatten()] = vals.flatten()
    writes.index_put_((r.flatten(), c.flatten()), torch.ones(r.numel(), dtype=torch.int64), accumulate=True)
    return ok


def pairs_schedule(n, dtype, grid=None):
    """The pairs route at any N (the wrapper takes it from N > 735 alone)."""
    sched = gk.k1_pairs_schedule(n, dtype)
    return dataclasses.replace(sched, grid=grid) if grid else sched


def emulate_pairs(x, s, l, jitter, sched):
    """The Gram by the pairs route's walk, the writes of each output, the
    visits of each tile pair, and whether every store was aligned."""
    n, t, v = sched.n, sched.tile, sched.vec
    n_pad = sched.n_tiles * t
    g = torch.full((n_pad, n_pad), float("nan"), dtype=x.dtype)
    g[:n, :n] = gk.gibbs_gram_plain(x, s, l, x, s, l)
    order = [q for b in range(sched.grid) for q in range(b, sched.n_pairs, sched.grid)]
    visits = torch.bincount(torch.tensor(order), minlength=sched.n_pairs)
    ij = torch.tensor([_kernel_tile_pair(q, sched.n_tiles) for q in order])
    big_i, big_j = (ij[:, k, None, None, None] for k in (0, 1))  # (P, 1, 1, 1)
    diag = big_i == big_j
    lanes, threads = t // v, t * t // 4
    tid = torch.arange(threads)[:, None, None]
    r = tid // lanes + torch.arange(4 // v)[:, None] * 8 * v  # (threads, rows, 1): step 8·V
    c0 = tid % lanes * v
    c = c0 + torch.arange(v)  # (threads, 1, V)
    gi, gj = big_i * t + r, big_j * t + c
    computed = ~diag | (r <= c)
    # the upper triangle (i <= j on every computed term), the jitter on i == j
    k = torch.where(computed, g[gi, gj], float("nan"))
    if jitter:
        k = torch.where(diag & (r == c), k + jitter, k)
    tile = torch.full((len(order), t, t), float("nan"), dtype=x.dtype)
    pair = torch.arange(len(order))[:, None, None, None].expand_as(k)
    tile[pair[computed], r.expand_as(k)[computed], c.expand_as(k)[computed]] = k[computed]
    out = torch.full((n, n), float("nan"), dtype=x.dtype)
    writes = torch.zeros((n, n), dtype=torch.int64)
    shape = k.shape[:-1] + (1,)  # one V-wide store per (pair, thread, row)

    def store(live, rows, cols, vals):
        live = live.expand(shape)[..., 0]
        return _store(out, writes, rows.expand(shape)[..., 0][live][:, None],
                      cols.expand(shape)[..., 0][live][:, None], vals[live], v)

    # tile (I, J) from registers, off the diagonal
    cols = big_j * t + c0
    aligned = store(~diag & (gi < n) & (cols < n), gi, cols, k)
    # tile (J, I), or the diagonal tile, from shared memory read transposed
    rows, cols = torch.where(diag, big_i, big_j) * t + r, big_i * t + c0
    val = torch.where(diag & (r <= c), k, tile[pair, c.expand_as(k), r.expand_as(k)])
    aligned &= store((rows < n) & (cols < n), rows, cols, val)
    return out, writes, visits, aligned


def emulate_threads(x1, s1, l1, x2, s2, l2, jitter, sched):
    """The Gram by the threads route (thread (tx, ty) of block (bx, by) takes
    output (by·8 + ty, bx·32 + tx), the jitter on i == j), the writes of each
    output, and the visits of each block."""
    n1, n2 = sched.n, sched.n2
    g = gk.gibbs_gram_plain(x1, s1, l1, x2, s2, l2)
    blocks = torch.arange(sched.grid)
    bx, by = blocks % -(-n2 // 32), blocks // -(-n2 // 32)
    j = (bx * 32)[:, None, None] + torch.arange(32)
    i = (by * 8)[:, None, None] + torch.arange(8)[:, None]
    live = (i < n1) & (j < n2)
    rows, cols = i.expand_as(live)[live][:, None], j.expand_as(live)[live][:, None]
    vals = g[rows, cols]
    if jitter:
        vals = torch.where(rows == cols, vals + jitter, vals)
    out = torch.full((n1, n2), float("nan"), dtype=x1.dtype)
    writes = torch.zeros((n1, n2), dtype=torch.int64)
    aligned = _store(out, writes, rows, cols, vals, 1)
    visits = torch.ones(sched.grid, dtype=torch.int64)  # one block per tile of outputs
    return out, writes, visits, aligned


def _held_to_plain(got, want, dtype):
    rtol, atol = KERNEL_TOL[dtype]
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SELF_SIZES)
def test_pairs_walk_writes_each_output_once_and_is_symmetric(rng, n, dtype):
    x, s, l = _inputs(rng, n, dtype)
    got, writes, visits, aligned = emulate_pairs(x, s, l, JITTER, pairs_schedule(n, dtype))
    assert torch.equal(writes, torch.ones_like(writes)) and torch.equal(visits, torch.ones_like(visits))
    assert aligned
    assert torch.equal(got, got.T)  # exactly symmetric
    _held_to_plain(got, gk.gibbs_gram_plain(x, s, l, x, s, l, JITTER), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", (1, 17, 64, 257))
def test_threads_route_self_form_writes_each_output_once(rng, n, dtype):
    x, s, l = _inputs(rng, n, dtype)
    sched = gk.k1_forward_schedule(n, n, True, dtype)
    assert sched.route == "threads"
    got, writes, _, aligned = emulate_threads(x, s, l, x, s, l, JITTER, sched)
    assert torch.equal(writes, torch.ones_like(writes)) and aligned
    assert torch.equal(got, gk.gibbs_gram_plain(x, s, l, x, s, l, JITTER))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n1,n2", [(37, 45), (1, 1), (5, 64), (70, 256), (200, 7), (33, 130)])
def test_cross_form_writes_each_output_once_and_equals_plain(rng, n1, n2, dtype):
    x1, s1, l1 = _inputs(rng, n1, dtype)
    x2, s2, l2 = _inputs(rng, n2, dtype)
    sched = gk.k1_forward_schedule(n1, n2, False, dtype)
    assert (sched.route, sched.vec, sched.grid) == ("threads", 1, -(-n2 // 32) * -(-n1 // 8))
    got, writes, _, aligned = emulate_threads(x1, s1, l1, x2, s2, l2, 0.0, sched)
    assert torch.equal(writes, torch.ones_like(writes)) and aligned
    assert torch.equal(got, gk.gibbs_gram_plain(x1, s1, l1, x2, s2, l2))


@pytest.mark.parametrize("n,grid", [(65, 1), (100, 7), (600, 3)])
def test_pairs_walk_covers_every_output_on_any_grid(rng, n, grid):
    """A persistent walk with many tile pairs per block."""
    for dtype in DTYPES:
        x, s, l = _inputs(rng, n, dtype)
        got, writes, visits, aligned = emulate_pairs(x, s, l, JITTER, pairs_schedule(n, dtype, grid))
        assert torch.equal(writes, torch.ones_like(writes)) and torch.equal(visits, torch.ones_like(visits))
        assert aligned and torch.equal(got, got.T)


@pytest.mark.parametrize("n", [1, 33, 257])
def test_pairs_walk_matches_jax(rng, n):
    x, s, l = _inputs(rng, n)
    got = emulate_pairs(x, s, l, JITTER, pairs_schedule(n, torch.float64))[0]
    # jitted, as the other references (op by op a shape took ~1 s)
    want = jax.jit(lambda a, b, c: jkernels.nonstationary_rbf_cov(a, sigma1=b, ell1=c, jitter=JITTER))(
        jnp.asarray(x.numpy()), jnp.asarray(s.numpy()), jnp.asarray(l.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    np.testing.assert_allclose(gk.gibbs_gram(x, s, l, jitter=JITTER).numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("n1,n2", [(37, 45), (100, 64)])
def test_cross_form_matches_jax(rng, n1, n2):
    (x1, s1, l1), (x2, s2, l2) = _inputs(rng, n1), _inputs(rng, n2)
    sched = gk.k1_forward_schedule(n1, n2, False, torch.float64)
    got = emulate_threads(x1, s1, l1, x2, s2, l2, 0.0, sched)[0]
    j = lambda t: jnp.asarray(t.numpy())
    want = jax.jit(lambda a, b, c, d, e, f: jkernels.nonstationary_rbf_cov(a, sigma1=b, ell1=c, x2=d, sigma2=e,
                                                                          ell2=f))(j(x1), j(s1), j(l1), j(x2), j(s2), j(l2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_cpu_wrapper_is_the_plain_version(rng):
    x, s, l = _inputs(rng, 40)
    x2, s2, l2 = _inputs(rng, 9)
    assert torch.equal(gk.gibbs_gram(x, s, l, jitter=JITTER), gk.gibbs_gram_plain(x, s, l, x, s, l, JITTER))
    assert torch.equal(gk.gibbs_gram(x, s, l, x2, s2, l2), gk.gibbs_gram_plain(x, s, l, x2, s2, l2))


@pytest.mark.parametrize("n", range(729, 742))
def test_route_follows_the_size_and_alignment_rules(n):
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        sched = gk.k1_forward_schedule(n, n, True, dtype)
        # the pairs route once N² threads would fill more than two waves (2048 a SM, 132 SMs)
        assert sched.route == ("pairs" if n * n > 2 * 2048 * 132 else "threads")
        if sched.route == "pairs":
            # the widest store (at most 16 B) whose width divides N
            assert sched.vec == max(v for v in (1, 2, 4) if n % v == 0 and v * size <= 16)
        assert gk.k1_forward_schedule(n, 7, False, dtype).route == "threads"


def test_schedule_at_the_timed_shapes():
    sched = gk.k1_forward_schedule(1000, 1000, True, torch.float64)
    assert (sched.route, sched.vec, sched.tile) == ("pairs", 2, 32)
    assert (sched.n_pairs, sched.grid) == (528, 528)  # one pair a block, 4 blocks per SM
    assert gk.k1_forward_schedule(1000, 1000, True, torch.float32).vec == 4
    assert gk.k1_forward_schedule(4000, 4000, True, torch.float64).grid == 4 * 132  # a persistent walk
    assert gk.k1_forward_schedule(1000, 1000, True, torch.float64, sms=66).grid == 4 * 66  # from the SM count
    small = gk.k1_forward_schedule(257, 257, True, torch.float64)
    assert (small.route, small.vec, small.grid) == ("threads", 1, 9 * 33)
    cross = gk.k1_forward_schedule(1000, 256, False, torch.float64)
    assert (cross.route, cross.vec, cross.grid) == ("threads", 1, 8 * 125)
    with pytest.raises(ValueError, match="square"):
        gk.k1_forward_schedule(3, 4, True, torch.float64)


@pytest.mark.parametrize("n", (1, 257, 1000, 4000))
def test_kernel_pair_mapping_is_the_schedules_order(n):
    sched = pairs_schedule(n, torch.float64)
    assert [_kernel_tile_pair(q, sched.n_tiles) for q in range(sched.n_pairs)] == sched.pairs()


def test_wrapper_launches_the_forms_entry_points(monkeypatch):
    """The wrapper's kernel branch, taken on tensors with no storage ("meta")
    with the launch recorded: each route's entry point gets its schedule, and
    every launch counts in ``gibbs_gram.launches``."""
    calls = []
    monkeypatch.setattr(gk, "_KERNEL_DEVICE_TYPES", ("cuda", "meta"))
    monkeypatch.setattr(gk, "sm_count", lambda device: 132)
    monkeypatch.setattr(gk, "_launch", lambda name, dtype, device, *args: calls.append((name, args)))
    monkeypatch.setattr(gk.gibbs_gram, "launches", 0)
    meta = lambda n: torch.zeros(n, dtype=torch.float64, device="meta")
    gk.gibbs_gram(meta(1000), meta(1000), meta(1000), jitter=JITTER)
    gk.gibbs_gram(meta(1000), meta(1000), meta(1000), meta(256), meta(256), meta(256))
    gk.gibbs_gram(meta(257), meta(257), meta(257), jitter=JITTER)
    assert gk.gibbs_gram.launches == 3
    (name_s, args_s), (name_c, args_c), (name_t, args_t) = calls
    assert name_s == "gibbs_gram_pairs" and args_s[3:7] == (1000, JITTER, 2, 528)
    assert name_c == "gibbs_gram_threads" and (args_c[3], *args_c[7:10]) == (1000, 256, 0.0, 1000)
    assert name_t == "gibbs_gram_threads" and (args_t[3], *args_t[7:10]) == (257, 257, JITTER, 297)


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``gibbs_gram.cu`` that the emulations transcribe: a
    change there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "static constexpr int TILE = 32;",
        "static constexpr int THREADS = TILE * TILE / 4;",
        "static constexpr int LANES = TILE / V;",
        "static constexpr int STEP = THREADS / LANES;",
        "static constexpr int ROWS = TILE / STEP;",
        "static constexpr int PITCH = TILE + 1;",
        "const int c0 = tid % F::LANES * V; const int r0 = tid / F::LANES;",
        "for (int q = blockIdx.x; q < n_pairs; q += gridDim.x) {",
        "tile_pair(q, n_tiles, I, J);",
        "sx[side][e] = in ? x[i] : T(0); ss[side][e] = in ? s[i] : T(0); sl[side][e] = in ? l[i] : T(1);",
        "const int r = r0 + rr * F::STEP;",
        "if (!diag || r <= c) {",
        "k[rr][v] = gibbs(sx[0][r], ss[0][r], sl[0][r], sx[1][c], ss[1][c], sl[1][c]);",
        "if (diag && r == c && jitter != T(0)) k[rr][v] = k[rr][v] + jitter;",
        "tile[r][c] = k[rr][v];",
        "const int j = J * TILE + c0;",
        "const int i = I * TILE + r0 + rr * F::STEP;",
        "if (i < n && j < n) store_vec<T, V>(out + static_cast<size_t>(i) * n + j, k[rr]);",
        "const int R = diag ? I : J; const int j = I * TILE + c0;",
        "const int i = R * TILE + r;",
        "val[v] = diag && r <= c0 + v ? k[rr][v] : tile[c0 + v][r];",
        "if (i < n && j < n) store_vec<T, V>(out + static_cast<size_t>(i) * n + j, val);",
        "constexpr int kThreadsX = 32, kThreadsY = 8;",
        "const int j = blockIdx.x * blockDim.x + threadIdx.x; const int i = blockIdx.y * blockDim.y + threadIdx.y;",
        "T k = gibbs(x1[i], s1[i], l1[i], x2[j], s2[j], l2[j]); if (jitter != T(0) && i == j) k = k + jitter;",
        "const T a = li * li + lj * lj; const T b = li * lj; const T dx = xi - xj; const T d = dx * dx;",
        "return (si * sj) * gsqrt(T(2) * b / a) * gexp(-d / a);",
        "return sizeof(T) == 8 ? (n % 2 == 0 ? 2 : 1) : (n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1);",
    ):
        assert line in src, line
