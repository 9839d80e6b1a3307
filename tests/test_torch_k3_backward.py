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


def emulate_generic(x, ell, ls, kbar, jitter, threads=256):
    """(ℓ̄, L̄) by the generic route's order of work (M > 8): one block per
    row input n; thread k owns (a, b) = (k / M, k % M), then k + threads,
    ...; for each column input p in order, t[a,b] = Σ_c S[(n,a),(p,c)]·L[p,c,b]
    in c order, L̄ += kxj·t, and the thread's ℓ̄ share += kx·f·L[n,a,b]·t;
    the shares are summed by the block's tree."""
    n, m, _ = ls.shape
    mm = m * m
    d = (x[:, None] - x[None, :]) ** 2
    a2 = ell[:, None] ** 2 + ell[None, :] ** 2
    kx = torch.sqrt(2 * (ell[:, None] * ell[None, :]) / a2) * torch.exp(-d / a2)
    f = 1 / (2 * ell[:, None]) - ell[:, None] / a2 + 2 * ell[:, None] * d / (a2 * a2)
    w = (kx * f).fill_diagonal_(0)
    kxj = kx + jitter * torch.eye(n, dtype=T64)
    kb4 = kbar.reshape(n, m, n, m)
    ls_bar = torch.empty((n, mm), dtype=T64)
    ell_bar = torch.empty(n, dtype=T64)
    a_of, b_of = torch.arange(mm) // m, torch.arange(mm) % m
    for r in range(n):
        acc = torch.zeros(mm, dtype=T64)
        lsh = torch.zeros(mm, dtype=T64)
        for p in range(n):
            t = torch.zeros(mm, dtype=T64)
            for c in range(m):
                t = t + (kb4[r, a_of, p, c] + kb4[p, c, r, a_of]) * ls[p, c, b_of]
            acc = acc + kxj[r, p] * t
            lsh = lsh + w[r, p] * ls[r].reshape(-1) * t
        ls_bar[r] = acc
        # thread k % threads holds the shares of k, k + threads, ...; then the tree
        red = torch.zeros(threads, dtype=T64)
        for k0 in range(0, mm, threads):
            chunk = lsh[k0:k0 + threads]
            red[:chunk.numel()] += chunk
        off = threads // 2
        while off:
            red = red[:off] + red[off:2 * off]
            off //= 2
        ell_bar[r] = red[0]
    return ell_bar, ls_bar.reshape(n, m, m)


@pytest.mark.parametrize("n,m", [(6, 9), (4, 13), (3, 17)])
def test_generic_route_order_of_work_matches_jax_grad(rng, n, m):
    """M > 8: the generic route, at M = 9, 13 and 17 (M² over a block's 256
    threads, so a thread owns two (a, b))."""
    x, _, ls, kbar = _inputs(rng, n, m)
    # lengthscales that couple these few inputs, so that ℓ̄ is not 0 up to rounding
    ell = np.exp(-1 + 0.2 * rng.normal(size=n))
    want_e, want_l = _jax_grad(x, ell, ls, kbar)
    got_e, got_l = emulate_generic(*(torch.tensor(a, dtype=T64) for a in (x, ell, ls, kbar)), JITTER)
    for got, want in ((got_e, want_e), (got_l, want_l)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_generic_route_schedule():
    sched = gk.k3_backward_schedule(40, 9)
    assert (sched.route, sched.tile, sched.grid, sched.partial_numel) == ("generic", 1, 40, 0)
    assert gk.k3_backward_schedule(40, 8).route == "tiled"


def test_generic_route_shared_memory_does_not_grow_with_m():
    """Every M above 8 (9..256 here) takes the generic route, whose only
    shared memory is three double arrays of a block's 256 threads: 6,144 B
    whatever M and the type are, far under the H100's 232,448 B a block."""
    with open(os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")) as f:
        src = f.read()
    body = src[src.index("svc_gram_tiled_bwd_generic_kernel(const T*"):]
    body = body[:body.index("\ntemplate <typename T>")]
    assert "extern __shared__" not in body
    assert [ln.strip() for ln in body.splitlines() if "__shared__" in ln] == [
        "__shared__ double kxj_s[kThreads], w_s[kThreads], red[kThreads];"]
    assert "constexpr int kThreads = 256;" in src
    assert all(gk.k3_backward_schedule(40, m).route == "generic" for m in range(9, 257))
