"""K3's forward kernel: its schedule, emulated on the CPU, against the plain
version and the JAX package's Gram.

The CUDA kernel (``csrc/svc_gram_tiled.cu``) runs only on the card, where
``chip_smoke.py`` holds it against the plain version and K2's task-major
output, permuted to input-major, bit for bit.  Here a torch emulation
follows the kernel's walk as ``gram_kernels.k3_forward_schedule`` gives
it: warp ``w`` of block ``b`` takes items ``b·warps + w`` and every
``grid·warps``-th after it; an item is ``rows`` row inputs by a strip of
32 column inputs; lane ``l`` stores chunks
``(l + 32k)·vec ..`` of each output row of the strip, all of one column
input, whose Gibbs term comes from its owner lane.  It counts the writes of
every output and checks every store's alignment.  The Gibbs term is taken
from the plain version's (N, N) matrix: torch's CPU ``exp`` may round the
tail of a short vector otherwise, and the walk, not ``exp``, is what the
emulation checks.  The task sums and the jitter are the emulation's own, in
the kernel's order, so the assembled Gram must equal the plain version bit
for bit.

The generic route (M > 8) has its own emulation, ``emulate_generic``: one
block per 64 × 64 tile of the flattened NM × NM output, the tile's L staged
(zero past NM), each sum run b = 0..M−1 in order, and each thread's stores
(rows ``4ty + i``, the columns of ``K3ForwardSchedule.generic_columns``,
``vec`` values at once) counted and checked for alignment.
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
    return gk.svc_gram_plain(x, ell, torch.ones((len(x), 1, 1), dtype=x.dtype), 0.0, "input")


def emulate(x, ell, ls, jitter, sched):
    """The Gram by the kernel's walk, the count of writes of each output, and
    whether every store was aligned to its width."""
    n, m, _ = ls.shape
    nm, vec = n * m, sched.vec
    kx0 = _kx(x, ell)
    out = torch.full((nm, nm), float("nan"), dtype=x.dtype)
    writes = torch.zeros((nm, nm), dtype=torch.int64)
    aligned = True
    lane = torch.arange(32)
    chunks = [(lane + 32 * k) * vec for k in range(m // vec)]  # first element of each chunk
    for b in range(sched.grid):
        for w in range(sched.warps):
            for item in sched.items(b, w):
                n0, p0 = item // sched.n_strips * sched.rows, item % sched.n_strips * 32
                for r in range(n0, min(n, n0 + sched.rows)):
                    for a in range(m):
                        row = r * m + a
                        for e0 in chunks:
                            pl, c0 = e0 // m, e0 % m
                            p = p0 + pl
                            ok = p < n
                            p, c0, e0 = p[ok], c0[ok], e0[ok]
                            # the owner lane's term (a shuffle where vec < M)
                            kx = kx0[r, p] + (p == r).to(x.dtype) * jitter
                            aligned &= bool(((row * nm + p0 * m + e0) % vec == 0).all())
                            for v in range(vec):
                                lp = ls[p, c0 + v]  # (lanes, M)
                                bsum = ls[r, a, 0] * lp[:, 0]
                                for j in range(1, m):
                                    bsum = bsum + ls[r, a, j] * lp[:, j]
                                out[row, p0 * m + e0 + v] = kx * bsum
                                writes[row, p0 * m + e0 + v] += 1
    return out, writes, aligned


def emulate_generic(x, ell, ls, jitter, sched):
    """The generic route's Gram by its walk, the count of writes of each
    output, and whether every store was aligned to its width."""
    n, m, _ = ls.shape
    nm, t, vec = n * m, sched.rows, sched.vec
    kx0 = _kx(x, ell)
    lf = ls.reshape(nm, m)
    out = torch.full((nm, nm), float("nan"), dtype=x.dtype)
    writes = torch.zeros((nm, nm), dtype=torch.int64)
    aligned = True
    # thread (ty, tx): rows 4ty + i, columns generic_columns(tx); a store covers vec of them
    cols = torch.tensor([sched.generic_columns(tx, x.element_size()) for tx in range(16)])
    assert sorted(cols.flatten().tolist()) == list(range(t))  # the 16 x 16 threads cover the tile once
    starts = cols[:, ::vec].flatten()  # the first column of each store
    rows = torch.arange(t)  # 4 ty + i over ty < 16, i < 4
    idx = torch.arange(t)
    for by in range(sched.n_tiles):  # block (x, y) = (column tile, row tile)
        for bx in range(sched.n_tiles):
            r0, c0 = by * t, bx * t
            a, b = (torch.zeros((t, m), dtype=x.dtype) for _ in range(2))
            a[: max(0, min(t, nm - r0))] = lf[r0:r0 + t]  # staged, 0 past NM
            b[: max(0, min(t, nm - c0))] = lf[c0:c0 + t]
            acc = a[:, 0, None] * b[None, :, 0]
            for j in range(1, m):
                acc = acc + a[:, j, None] * b[None, :, j]
            r_ok, c_ok = r0 + rows < nm, c0 + idx < nm
            s_ok = c0 + starts < nm
            aligned &= bool((((r0 + rows[r_ok, None]) * nm + c0 + starts[None, s_ok]) % vec == 0).all())
            rr, cc = r0 + rows[r_ok], c0 + idx[c_ok]
            nr, pc = rr // m, cc // m
            kx = kx0[nr[:, None], pc[None, :]] + (nr[:, None] == pc[None, :]).to(x.dtype) * jitter
            out[rr[:, None], cc[None, :]] = kx * acc[r_ok][:, c_ok]
            writes[rr[:, None], cc[None, :]] += 1
    return out, writes, aligned


GENERIC_SHAPES = [(6, 9), (4, 13), (3, 17), (21, 9), (5, 30), (2, 64)]


@jax.jit
def _jax_gram(x, ell, ls):
    """The JAX package's Gram, permuted to input-major (jitted: op by op it
    takes seconds a shape)."""
    n, m, _ = ls.shape
    kx = jkernels.nonstationary_rbf_cov(x, ell1=ell)
    return jgnmgp.gram(kx, ls).reshape(m, n, m, n).transpose(1, 0, 3, 2).reshape(n * m, n * m)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", GENERIC_SHAPES)
def test_generic_walk_writes_each_output_once_and_equals_plain(rng, n, m, dtype):
    x, ell, ls = _inputs(rng, n, m, dtype)
    sched = gk.k3_forward_schedule(n, m, dtype)
    got, writes, aligned = emulate_generic(x, ell, ls, JITTER, sched)
    assert torch.equal(writes, torch.ones_like(writes))
    assert aligned
    assert torch.equal(got, gk.svc_gram_tiled_plain(x, ell, ls, JITTER))
    if dtype == torch.float64:
        want = _jax_gram(*(jnp.asarray(a.numpy()) for a in (x, ell, ls)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_generic_schedule_at_the_timed_shapes():
    """The A/B shapes: 64 x 64 tiles of the flattened output, 256 threads
    a block, double2 stores where N·M is even (float4 in float32 where N·M
    is divisible by 4)."""
    for (n, m), tiles in {(200, 9): 29, (1000, 9): 141, (500, 16): 125, (200, 32): 100, (64, 9): 9}.items():
        sched = gk.k3_forward_schedule(n, m, torch.float64)
        assert (sched.route, sched.rows, sched.warps, sched.vec) == ("generic", 64, 8, 2)
        assert (sched.n_tiles, sched.grid) == (tiles, tiles * tiles)
        assert gk.k3_forward_schedule(n, m, torch.float32).vec == 4
    assert gk.k3_forward_schedule(21, 9, torch.float64).vec == 1  # N·M = 189
    assert gk.k3_forward_schedule(5, 30, torch.float32).vec == 2  # N·M = 150
    assert gk.k3_forward_schedule(4, 130, torch.float64).grid == 81


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 17, 37])
def test_emulated_walk_writes_each_output_once_and_equals_plain(rng, n, m, dtype):
    x, ell, ls = _inputs(rng, n, m, dtype)
    sched = gk.k3_forward_schedule(n, m, dtype)
    got, writes, aligned = emulate(x, ell, ls, JITTER, sched)
    assert torch.equal(writes, torch.ones_like(writes))
    assert aligned
    assert torch.equal(got, gk.svc_gram_tiled_plain(x, ell, ls, JITTER))


@pytest.mark.parametrize("n,m,rows,warps,grid", [
    (37, 2, 3, 2, 1),   # many items per warp, ragged last row chunk and strip
    (70, 4, 5, 3, 2),   # three strips, the last ragged; float32's widest store
    (33, 6, 8, 1, 1),   # the shared-memory route, one column in the last strip
])
def test_walk_covers_every_output_on_any_grid(rng, n, m, rows, warps, grid):
    """The kernel takes any rows, warps and grid: a persistent walk with many
    items per warp still writes each output once."""
    for dtype in DTYPES:
        x, ell, ls = _inputs(rng, n, m, dtype)
        sched = dataclasses.replace(gk.k3_forward_schedule(n, m, dtype), rows=rows, warps=warps, grid=grid)
        assert max(len(sched.items(b, w)) for b in range(grid) for w in range(warps)) > 1
        got, writes, aligned = emulate(x, ell, ls, JITTER, sched)
        assert torch.equal(writes, torch.ones_like(writes)) and aligned
        assert torch.equal(got, gk.svc_gram_tiled_plain(x, ell, ls, JITTER))


@pytest.mark.parametrize("m", range(1, 12))
def test_route_follows_the_alignment_rule(m):
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        for n in (1, 37, 1000):
            sched = gk.k3_forward_schedule(n, m, dtype)
            if m > gk.K3_MAX_M:
                # the generic route: the widest store that divides N·M
                want = max(v for v in (1, 2, 4) if (n * m) % v == 0 and v * size <= 16)
                assert (sched.route, sched.vec, sched.rows) == ("generic", want, 64)
                continue
            # the widest store (at most 16 B) whose width divides M
            want = max(v for v in (1, 2, 4) if m % v == 0 and v * size <= 16)
            assert sched.vec == want and sched.route == ("vector" if want > 1 else "scalar")
            # then every row offset (n M + a) N M and strip offset p0 M is a multiple of it
            assert (n * m) % sched.vec == 0 and (32 * m) % sched.vec == 0


def test_schedule_at_the_timed_shapes():
    sched = gk.k3_forward_schedule(1000, 2, torch.float64)
    assert (sched.route, sched.vec, sched.rows, sched.warps) == ("vector", 2, 8, 4)
    assert (sched.n_strips, sched.n_items, sched.grid) == (32, 4000, 1000)  # one item a warp
    assert gk.k3_forward_schedule(1000, 2, torch.float32).vec == 2
    small = gk.k3_forward_schedule(257, 3, torch.float64)
    assert (small.route, small.vec, small.rows) == ("scalar", 1, 1)
    assert small.n_items >= 16 * 132  # every SM gets 16 warps' items
    assert gk.k3_forward_schedule(1, 1, torch.float64).grid == 1
    assert gk.k3_forward_schedule(20000, 2, torch.float64).grid == 16 * 132  # a persistent walk


@pytest.mark.parametrize("n,m", [(1, 2), (1, 9), (21, 9), (5, 30)])
def test_svc_gram_tiled_cpu_matches_permuted_jax_gram(rng, n, m):
    x, ell, ls = _inputs(rng, n, m)
    want = _jax_gram(jnp.asarray(x.numpy()), jnp.asarray(ell.numpy()), jnp.asarray(ls.numpy()))  # input-major
    got = gk.svc_gram_tiled(x, ell, ls, JITTER)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_emulation_mirrors_the_kernel_source():
    """The lines of ``svc_gram_tiled.cu`` that ``emulate`` transcribes: a
    change there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "for (int item = blockIdx.x * warps + warp; item < n_items; item += gridDim.x * warps) {",
        "const int n0 = item / n_strips * rows;",
        "const int p0 = item % n_strips * 32;",
        "for (int r = n0; r < n1; ++r) {",
        "if (r == p) kx = kx + jitter;",
        "store_rows<T, M>(out, nm, n, r, p0, kx, ls, st, lane);",
        "const int e = (lane + 32 * k) * F::V; pl[k] = e / M; c0[k] = e % M;",
        "kxk[k] = V == M ? kx : __shfl_sync(0xffffffffu, kx, st.pl[k]);",
        "if (s0 + st.pl[k] >= n) continue;",
        "T bsum = Lr[0] * st.at(lane, k, v, 0);",
        "for (int b = 1; b < M; ++b) bsum = bsum + Lr[b] * st.at(lane, k, v, b);",
        "val[v] = kxk[k] * bsum;",
        "store_vec<T, V>(row + (lane + 32 * k) * V, val);",
        "static constexpr int V = sizeof(T) == 8 ? (M % 2 == 0 ? 2 : 1) : (M % 4 == 0 ? 4 : M % 2 == 0 ? 2 : 1);",
    ):
        assert line in src, line


def test_generic_emulation_mirrors_the_kernel_source():
    """The lines of ``svc_gram_tiled.cu`` that ``emulate_generic`` and
    ``generic_columns`` transcribe: a change there must be made here too."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        src = " ".join(f.read().split())
    for line in (
        "constexpr int kGenTile = 64;",
        "const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;",
        "const int R0 = blockIdx.y * kGenTile, C0 = blockIdx.x * kGenTile;",
        "As[b * kGenPitch + r] = in_b && R0 + r < nm ? ls[static_cast<size_t>(R0 + r) * m + k0 + b] : T(0);",
        "acc[i][j] = FIRST ? a[i] * c[j] : acc[i][j] + a[i] * c[j];",
        "return CW * tx + 16 * CW * (j / CW) + j % CW;",
        "const int lr = 4 * ty + i;",
        "if (r == p) kx = kx + jitter;",
        "for (int j = 0; j < 4; j += V) { const int lc = G::col(tx, j); if (C0 + lc >= nm) continue;",
        "for (int v = 0; v < V; ++v) val[v] = kx_r[cp_s[lc + v]] * acc[i][j + v];",
        "store_vec<T, V>(orow + lc, val);",
        "return sizeof(T) == 8 ? (k % 2 == 0 ? 2 : 1) : (k % 4 == 0 ? 4 : k % 2 == 0 ? 2 : 1);",
    ):
        assert line in src, line


def test_shared_memory_fits_the_card_at_every_m():
    """A block's shared memory, as the schedule computes it from (M, dtype),
    stays under the H100's 232,448 B a block for M = 1..256: the generic
    route (M > 8) stages L 16 task columns at a time, a size that does not
    depend on M."""
    for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
        for m in range(1, 257):
            sched = gk.k3_forward_schedule(1000, m, dtype)
            assert 0 <= sched.smem_bytes <= 232_448
            if m > gk.K3_MAX_M:
                assert sched.smem_bytes == size * (2 * 16 * 68 + 9 * 9) + 4 * 2 * 64
            elif m <= 4:
                assert sched.smem_bytes == 0
            else:
                assert sched.smem_bytes == size * 32 * m * m * sched.warps


def test_shared_memory_formula_mirrors_the_kernel_source():
    """The lines of ``svc_gram_tiled.cu`` that size the forward's shared
    memory: the generic kernel's static arrays, whatever M."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        raw = f.read()
    src = " ".join(raw.split())
    for line in (
        "constexpr int kGenK = 16;",
        "constexpr int kGenPitch = kGenTile + 4;",
        "constexpr int kGenSpan = 9;",
        "__shared__ __align__(16) T As[kGenK * kGenPitch];",
        "__shared__ __align__(16) T Bs[kGenK * kGenPitch];",
        "__shared__ T kx_s[kGenSpan * kGenSpan];",
        "__shared__ int rn_s[kGenTile], cp_s[kGenTile];",
        "static constexpr bool REGS = M <= 4;",
        "static constexpr int STRIP = 32 * MM;",
        "const size_t smem = F::REGS ? 0 : sizeof(T) * F::STRIP * warps;",
    ):
        assert line in src, line
    body = raw[raw.index("svc_gram_tiled_generic_kernel(const T*"):]
    body = body[:body.index("\ntemplate <typename T")]
    assert "extern __shared__" not in body  # nothing sized by M
