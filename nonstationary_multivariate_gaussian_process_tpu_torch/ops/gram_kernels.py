"""The hand-written CUDA Gram kernels, their plain versions and launch counts.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

* :func:`gibbs_gram` — kernel K1, ``csrc/gibbs_gram.cu``, replaces
  ``gibbs_gram_pallas``.  The Gibbs kernel of a row strip (x1, σ1, ℓ1) and a
  column strip (x2, σ2, ℓ2); the self form adds the jitter on i == j.  The
  self form walks unordered tile pairs where it fills the card, else one
  thread per output, as the cross form does (:func:`k1_forward_schedule`).
* :func:`svc_gram` — kernel K2, ``csrc/svc_gram.cu``, replaces
  ``svc_gram_fused2d``.  The fused GNMGP Gram
  ``K[(n,a),(p,c)] = (K_x[n,p] + jitter·δ_np)·(L_n L_pᵀ)[a,c]`` in the
  task-major layout (row ``a·N + n``), in warp strips with wide stores
  (:func:`k2_schedule`); its input-major layout (row ``n·M + a``) is K3's.
  Prediction only: nothing differentiates through it.
* :func:`svc_gram_tiled` — kernel K3, ``csrc/svc_gram_tiled.cu``, replaces
  ``svc_gram_fused``.  The same Gram, input-major, written strip by strip
  with wide stores (:func:`k3_forward_schedule`); the Gram of the GNMGP
  likelihood.
* :func:`gibbs_gram_backward`, :func:`gibbs_gram_cross_backward` and
  :func:`svc_gram_tiled_backward` — the backward kernels of K1's self and
  cross forms and of K3 (new: the TPU had none).
* :func:`svc_gram_tiled_batched` and :func:`svc_gram_tiled_batched_backward`
  — K3 and its backward over a batch of B members sharing ``x`` (new: the
  TPU kernel took one Gram), one launch for the batch, each member equal to
  a single launch bit for bit; the Gram of the batched GNMGP objective that
  a population sampler (``inference/smc.py``) evaluates.

Each wrapper takes its plain PyTorch version for a tensor on the CPU, and
launches its kernel for a CUDA tensor, on the current stream (:func:`_launch`),
or raises.  It counts its launches in a plain integer attribute (``gibbs_gram.launches``),
which a run sets to 0 with :func:`reset_launches` to show afterwards that its
path went through the kernels.  The plain versions (:func:`gibbs_gram_plain`,
:func:`svc_gram_plain`, ...) repeat the kernels' arithmetic operation by
operation and serve the CPU, the tests, and the on-card comparison in
``chip_smoke.py``; a backward's plain version is ``torch.autograd.grad``
through its forward's plain version.

Gradients.  When an input of K1 (either form) or of K3 requires a gradient,
the wrapper goes through a ``torch.autograd.Function`` whose forward is the
forward kernel and whose backward is the backward kernel (on the CPU: the
plain versions).  A gradient in the inputs ``x`` (and ``x2``), which the
sparse tiers' inducing-input refinement takes in Z, comes from the same
backward launch (``input_grad=True``: one more sum in the same walk); a
backward not asked for it runs the kernel it ran before (the x̄ sums are a
compile-time variant, or on K3's costliest builds a null pointer tested
where they are needed).  A forward without gradients runs and counts
exactly as before.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import cuda_build

KERNEL_SOURCES = ("gibbs_gram", "svc_gram", "svc_gram_tiled")
LAYOUTS = ("task", "input")

#: Grid rows are blockIdx.y with blocks of 8 rows; CUDA caps gridDim.y (K1's
#: threads route, K2's generic route; K3's kernels and K1's backward keep
#: the same cap).
_MAX_ROWS = 65535 * 8

#: The device types whose tensors go to the kernels (others than the CPU's
#: and these raise).
_KERNEL_DEVICE_TYPES = ("cuda",)

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: Each wrapper's source, ``csrc/<name>.cu``.
SOURCES = {
    "gibbs_gram": "gibbs_gram", "gibbs_gram_backward": "gibbs_gram",
    "gibbs_gram_cross_backward": "gibbs_gram", "svc_gram": "svc_gram",
    "svc_gram_tiled": "svc_gram_tiled", "svc_gram_tiled_backward": "svc_gram_tiled",
    "svc_gram_tiled_batched": "svc_gram_tiled", "svc_gram_tiled_batched_backward": "svc_gram_tiled",
}
#: Each entry point: the wrapper that launches it (and counts its launches),
#: and its arguments before the stream, which every one takes last.
_ENTRY_POINTS = {
    "gibbs_gram_pairs": ("gibbs_gram", [_P, _P, _P, _I, _D, _I, _I, _P]),
    "gibbs_gram_threads": ("gibbs_gram", [_P, _P, _P, _I, _P, _P, _P, _I, _D, _I, _P]),
    "gibbs_gram_backward": ("gibbs_gram_backward", [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P]),
    "gibbs_gram_cross_backward": ("gibbs_gram_cross_backward",
                                  [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    "svc_gram": ("svc_gram", [_P, _P, _P, _I, _I, _D, _I, _I, _I, _I, _I, _I, _I, _P]),
    "svc_gram_tiled": ("svc_gram_tiled", [_P, _P, _P, _I, _I, _D, _I, _I, _I, _I, _P]),
    "svc_gram_tiled_backward": ("svc_gram_tiled_backward", [_P, _P, _P, _I, _I, _D, _P, _I, _I, _P, _P, _P, _P]),
    "svc_gram_tiled_batched": ("svc_gram_tiled_batched", [_P, _P, _P, _I, _I, _I, _D, _I, _I, _I, _I, _P]),
    "svc_gram_tiled_batched_backward": ("svc_gram_tiled_batched_backward",
                                        [_P, _P, _P, _I, _I, _I, _D, _P, _I, _I, _P, _P, _P]),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns: dict = {}  # (name, dtype) -> bound ctypes function


def build() -> None:
    """Compile every kernel source now (in parallel) rather than at first launch."""
    cuda_build.build(KERNEL_SOURCES)


def _kernel_fn(name: str, dtype: torch.dtype):
    key = (name, dtype)
    if key not in _fns:
        wrapper, argtypes = _ENTRY_POINTS[name]
        fn = getattr(cuda_build.load(SOURCES[wrapper]), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = [*argtypes, _P]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _check_cuda(name: str, tensors: dict, ndims: dict) -> tuple[torch.device, torch.dtype]:
    first = next(iter(tensors.values()))
    device, dtype = first.device, first.dtype
    if device.type not in _KERNEL_DEVICE_TYPES:
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {device}")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype must be float32 or float64, got {dtype}")
    for arg, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(
                f"{name}: {arg} is {t.dtype} on {t.device}, expected {dtype} on {device}"
            )
        if t.dim() != ndims[arg]:
            raise ValueError(f"{name}: {arg} must be {ndims[arg]}-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return device, dtype


@functools.cache
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    """Launch entry point ``name`` on the current stream of ``device``;
    raises if the launch fails."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _kernel_fn(name, dtype)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")


def _store_width(k: int, dtype: torch.dtype) -> int:
    """The values a wide store writes where offsets are multiples of ``k``:
    the widest store of at most 16 B whose value count divides ``k``."""
    if dtype == torch.float64:
        return 2 if k % 2 == 0 else 1
    return 4 if k % 4 == 0 else 2 if k % 2 == 0 else 1


def _strip_rows(n_rows: int, n_strips: int, sms: int, warps_per_sm: int) -> int:
    """The row inputs of an item in a strip walk (K2, K3's forward): the
    most of 8, 4, 2 that still gives every SM ``warps_per_sm`` warps'
    items, else 1."""
    return next((r for r in (8, 4, 2) if -(-n_rows // r) * n_strips >= warps_per_sm * sms), 1)


def _strip_grid(n_items: int, warps: int, sms: int, batch: int = 1) -> int:
    """A member's persistent grid: of at most 16 blocks per SM over the
    ``batch`` members, never more blocks than the member's items fill."""
    return max(1, min(-(-n_items // warps), -(-16 * sms // batch)))


class _Strips:
    """A walk of the N x N input pairs in items, each ``rows`` row inputs by
    a strip of ``strip`` column inputs: item ``i`` is row chunk ``i //
    n_strips`` and strip ``i % n_strips``; warp ``w`` of block ``b``
    (``warps`` a block, ``grid`` blocks) takes items ``b·warps + w``, then
    every ``grid·warps``-th."""

    n: int
    strip: int
    rows: int
    warps: int
    grid: int

    @property
    def n_strips(self) -> int:
        return -(-self.n // self.strip)

    @property
    def n_items(self) -> int:
        return -(-self.n // self.rows) * self.n_strips

    def items(self, block: int, warp: int) -> range:
        """The items warp ``warp`` of block ``block`` takes, in its order."""
        return range(block * self.warps + warp, self.n_items, self.grid * self.warps)


# ---------------------------------------------------------------------------
# K1: Gibbs Gram
# ---------------------------------------------------------------------------


def gibbs_gram_plain(x1, s1, l1, x2, s2, l2, jitter: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of kernel K1, in the kernel's order of operations."""
    a = (l1 * l1)[:, None] + (l2 * l2)[None, :]
    b = l1[:, None] * l2[None, :]
    dx = x1[:, None] - x2[None, :]
    d = dx * dx
    k = (s1[:, None] * s2[None, :]) * torch.sqrt(2.0 * b / a) * torch.exp(-d / a)
    if jitter:
        k = k + jitter * torch.eye(k.shape[0], k.shape[1], dtype=k.dtype, device=k.device)
    return k


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gibbs_gram(x1, s1, l1, x2=None, s2=None, l2=None, jitter: float = 0.0) -> torch.Tensor:
    """``K[i,j] = σ1_iσ2_j·sqrt(2ℓ1_iℓ2_j/(ℓ1_i²+ℓ2_j²))·exp(−(x1_i−x2_j)²/(ℓ1_i²+ℓ2_j²))``.

    Self form (``x2 is None``): the column strip is the row strip and
    ``jitter`` is added on the diagonal.  Cross form: ``jitter`` must be 0.
    Returns (n1, n2).  Both forms are differentiable in x, σ and ℓ (through
    :func:`gibbs_gram_backward` and :func:`gibbs_gram_cross_backward`, on
    both sides for the cross form).

    On the card the self form walks the unordered tile pairs and evaluates
    each pair's term once where its outputs fill the card; the cross form,
    and the self form at small N, take one thread per output
    (:func:`k1_forward_schedule`).  Either way the output equals
    :func:`gibbs_gram_plain` bit for bit there, and the self form's is
    exactly symmetric.
    """
    cross = x2 is not None
    if cross and jitter:
        raise ValueError("gibbs_gram: jitter belongs to the self form (x2=None) only")
    if _needs_grad(x1, s1, l1, *((x2, s2, l2) if cross else ())):
        if cross:
            return _GibbsGramCross.apply(x1, s1, l1, x2, s2, l2)
        return _GibbsGramSelf.apply(x1, s1, l1, float(jitter))
    return _gibbs_gram_forward(x1, s1, l1, x2, s2, l2, jitter)


def _gibbs_gram_forward(x1, s1, l1, x2, s2, l2, jitter) -> torch.Tensor:
    self_form = x2 is None
    if self_form:
        x2, s2, l2 = x1, s1, l1
    if x1.device.type == "cpu":
        return gibbs_gram_plain(x1, s1, l1, x2, s2, l2, jitter)
    tensors = {"x1": x1, "s1": s1, "l1": l1, "x2": x2, "s2": s2, "l2": l2}
    device, dtype = _check_cuda("gibbs_gram", tensors, dict.fromkeys(tensors, 1))
    n1, n2 = x1.shape[0], x2.shape[0]
    if s1.shape[0] != n1 or l1.shape[0] != n1 or s2.shape[0] != n2 or l2.shape[0] != n2:
        raise ValueError("gibbs_gram: each strip's x, sigma and ell must have one length")
    if n1 > _MAX_ROWS or n2 >= 2**31:
        raise ValueError(f"gibbs_gram: strips of {n1} x {n2} exceed the launch grid")
    if n1 == 0 or n2 == 0:
        return torch.empty((n1, n2), dtype=dtype, device=device)
    sched = k1_forward_schedule(n1, n2, self_form, dtype, sm_count(device))
    out = _k1_launch(sched, x1, s1, l1, x2, s2, l2, jitter)
    gibbs_gram.launches += 1
    return out


def _k1_launch(sched, x1, s1, l1, x2, s2, l2, jitter) -> torch.Tensor:
    """K1's forward by ``sched`` into a new (n1, n2) tensor (``x2`` is ``x1``
    for the self form); counts nothing."""
    out = torch.empty((sched.n, sched.n2), dtype=x1.dtype, device=x1.device)
    if sched.route == "pairs":
        _launch("gibbs_gram_pairs", x1.dtype, x1.device, x1.data_ptr(), s1.data_ptr(), l1.data_ptr(), sched.n,
                float(jitter), sched.vec, sched.grid, out.data_ptr())
    else:
        _launch("gibbs_gram_threads", x1.dtype, x1.device, x1.data_ptr(), s1.data_ptr(), l1.data_ptr(), sched.n,
                x2.data_ptr(), s2.data_ptr(), l2.data_ptr(), sched.n2, float(jitter), sched.grid, out.data_ptr())
    return out


gibbs_gram.launches = 0


class _TilePairs:
    """The unordered tile pairs ``(I, J)``, ``I <= J``, of ``n`` inputs in
    tiles of ``tile``, in the row-major order that K1's self form and the
    backward kernels walk (each kernel computes a pair from its index
    itself, ``tile_pair``)."""

    n: int
    tile: int

    @property
    def n_tiles(self) -> int:
        return -(-self.n // self.tile)

    @property
    def n_pairs(self) -> int:
        return self.n_tiles * (self.n_tiles + 1) // 2

    def pairs(self) -> list[tuple[int, int]]:
        return [(i, j) for i in range(self.n_tiles) for j in range(i, self.n_tiles)]


@dataclasses.dataclass(frozen=True)
class K1ForwardSchedule(_TilePairs):
    """How K1's forward kernel cuts its work, from (N1, N2, form, dtype) alone.

    ``route`` is ``"pairs"`` or ``"threads"``.  Pairs (the self form only):
    block ``b`` of ``grid`` takes the unordered tile pairs ``b, b + grid,
    ...`` of :meth:`pairs` (tiles of ``tile`` = 32 inputs) with 256 threads:
    thread ``t`` evaluates columns ``(t % (32/vec))·vec ..`` of rows
    ``t // (32/vec) + 8·vec·k``, ``k < 4/vec``, four terms.  Tile (I, J) is
    stored from registers, ``vec`` values at once; tile (J, I), and on the
    diagonal the lower triangle, from the shared tile read transposed.
    ``vec`` is 2 in float64 and 4 or 2 in float32 where N is divisible by it
    (so every row offset ``i·N + j`` is a multiple of it), else 1.  Threads:
    one thread per output on blocks of ``tile`` = 32 columns by 8 rows,
    ``grid`` = ⌈N2/32⌉·⌈N1/8⌉ blocks, scalar stores (``vec`` = 1).
    """

    n: int
    n2: int
    form: str
    route: str
    vec: int
    tile: int
    grid: int


#: K1's self form takes the pairs route where its N² outputs need more than
#: two waves of the threads route (a thread per output, 2048 threads per
#: SM): the routes cross between N = 640 and 704 on an NVIDIA H100 80GB HBM3
#: at 700 W (``PERF.md``).
_THREADS_PER_SM = 2048
_K1_PAIRS_MIN_WAVES = 2
#: K1's pairs route: blocks per SM of its persistent grid.
_K1_PAIRS_BLOCKS_PER_SM = 4


def k1_forward_schedule(n1: int, n2: int, self_form: bool, dtype: torch.dtype,
                        sms: int = 132) -> K1ForwardSchedule:
    """The self form's pairs route where N² > 2 waves of 2048 threads × SMs
    (N > 735 on 132 SMs), with its store width and a grid of 4 blocks per
    SM, never more blocks than tile pairs; else, and for the cross form, the
    threads route (both chosen by measurement: ``PERF.md``)."""
    if self_form and n1 != n2:
        raise ValueError(f"k1_forward_schedule: the self form is square, got {n1} x {n2}")
    if self_form and n1 * n1 > _K1_PAIRS_MIN_WAVES * _THREADS_PER_SM * sms:
        return k1_pairs_schedule(n1, dtype, sms)
    return K1ForwardSchedule(n1, n2, "self" if self_form else "cross", "threads", 1, 32,
                             -(-n2 // 32) * -(-n1 // 8))


def k1_pairs_schedule(n: int, dtype: torch.dtype, sms: int = 132) -> K1ForwardSchedule:
    """The self form's pairs route at any N: its store width and a grid of 4
    blocks per SM, never more blocks than tile pairs."""
    sched = K1ForwardSchedule(n, n, "self", "pairs", _store_width(n, dtype), 32, 1)
    return dataclasses.replace(sched, grid=max(1, min(sched.n_pairs, _K1_PAIRS_BLOCKS_PER_SM * sms)))


@dataclasses.dataclass(frozen=True)
class K1BackwardSchedule(_TilePairs):
    """How K1's backward kernel cuts its work, from N alone.

    Block ``b`` of ``grid`` takes the tile pairs ``b, b + grid, ...`` of
    :meth:`pairs`.  Pair ``(I, J)`` writes the rows of tile ``I`` into slot
    ``J`` and the rows of tile ``J`` into slot ``I`` of
    ``partial[slot][row][2]`` (σ̄'s share, ℓ̄'s); every (slot, row) is
    written once, and a second launch sums each row's slots in one fixed
    order (lane ``j`` of the row's warp adds slots ``j, j + 32, ...``, then a
    shuffle tree), so the result does not depend on ``grid``.
    """

    n: int
    tile: int
    grid: int

    @property
    def partial_numel(self) -> int:
        return self.n_tiles * self.n * 2


def k1_backward_schedule(n: int, sms: int = 132) -> K1BackwardSchedule:
    """32-input tiles, or 16 where 32-input tiles would give fewer pairs
    than SMs, and a persistent grid of 4 blocks per SM, never more blocks
    than tile pairs (both chosen by measurement on an NVIDIA H100 80GB HBM3
    at 700 W: ``PERF.md``)."""
    sched = K1BackwardSchedule(n, 32, 1)
    if sched.n_pairs < sms:
        sched = dataclasses.replace(sched, tile=16)
    return dataclasses.replace(sched, grid=max(1, min(sched.n_pairs, 4 * sms)))


def _grads(f, args, wanted, cotangent):
    """``torch.autograd.grad`` of ``f(*args)`` with respect to the args whose
    ``wanted`` flag is set, the others detached."""
    with torch.enable_grad():
        args = [a.detach().requires_grad_(w) for a, w in zip(args, wanted)]
        return torch.autograd.grad(f(*args), [a for a, w in zip(args, wanted) if w], cotangent)


def gibbs_gram_backward_plain(x, s, l, jitter: float, kbar, input_grad: bool = False):
    """Plain version of K1's self-form backward: ``(σ̄, ℓ̄)`` and, with
    ``input_grad``, ``x̄``, by ``torch.autograd.grad`` through
    :func:`gibbs_gram_plain`."""
    f = lambda x_, s_, l_: gibbs_gram_plain(x_, s_, l_, x_, s_, l_, jitter)
    if input_grad:
        x_bar, s_bar, l_bar = _grads(f, (x, s, l), (True, True, True), kbar)
        return s_bar, l_bar, x_bar
    return _grads(f, (x, s, l), (False, True, True), kbar)


def gibbs_gram_backward(x, s, l, kbar, jitter: float = 0.0, input_grad: bool = False):
    """``(σ̄, ℓ̄)`` of K1's self form for the cotangent ``kbar`` (n, n), which
    need not be symmetric, and with ``input_grad`` ``x̄`` after them (from
    the same launch).  The jitter carries no gradient; it matters only to
    the CPU's plain version, which rebuilds the forward."""
    if x.device.type == "cpu":
        return gibbs_gram_backward_plain(x, s, l, jitter, kbar, input_grad)
    tensors = {"x": x, "s": s, "l": l, "kbar": kbar}
    device, dtype = _check_cuda("gibbs_gram_backward", tensors, {"x": 1, "s": 1, "l": 1, "kbar": 2})
    n = x.shape[0]
    if s.shape[0] != n or l.shape[0] != n or tuple(kbar.shape) != (n, n):
        raise ValueError("gibbs_gram_backward: want x, s, l (N,) and kbar (N, N)")
    if n > _MAX_ROWS:
        raise ValueError(f"gibbs_gram_backward: N={n} exceeds the launch grid")
    s_bar = torch.empty(n, dtype=dtype, device=device)
    l_bar = torch.empty(n, dtype=dtype, device=device)
    x_bar = torch.empty(n, dtype=dtype, device=device) if input_grad else None
    outs = (s_bar, l_bar, x_bar) if input_grad else (s_bar, l_bar)
    if n == 0:
        return outs
    sched = k1_backward_schedule(n, sm_count(device))
    partial = torch.empty(sched.partial_numel + (sched.n_tiles * n if input_grad else 0), dtype=dtype, device=device)
    _launch("gibbs_gram_backward", dtype, device, x.data_ptr(), s.data_ptr(), l.data_ptr(), n,
            kbar.data_ptr(), sched.tile, sched.grid, partial.data_ptr(), s_bar.data_ptr(), l_bar.data_ptr(),
            _ptr(x_bar))
    gibbs_gram_backward.launches += 1
    gibbs_gram_backward.input_grad_launches += input_grad
    return outs


gibbs_gram_backward.launches = gibbs_gram_backward.input_grad_launches = 0


def _ptr(t: torch.Tensor | None):
    """A kernel's pointer argument for ``t``, null for ``None`` (an output
    that is not asked for)."""
    return None if t is None else t.data_ptr()


def first_order_only(backward):
    """Mark an ``autograd.Function``'s backward whose result is not part of a
    graph (a kernel's output, or a product of tensors saved without one): a
    backward pass that builds a graph (``create_graph=True``, as a Hessian
    takes) raises, where it would leave this function's terms out of the
    higher derivative without a word.  ``torch.autograd.function.
    once_differentiable`` does not catch that when the incoming cotangent is
    a constant, as it is for ``Σ(K ∘ W)``."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(
                f"{type(ctx).__name__}: no second derivative through this backward (its result is not part of a "
                "graph), so create_graph=True is refused"
            )
        return backward(ctx, *grads)

    return wrapper


class _GibbsGramSelf(torch.autograd.Function):
    """K1's self form with its backward kernel (on the CPU, autograd of the
    plain version), first order only."""

    @staticmethod
    def forward(ctx, x, s, l, jitter):
        ctx.save_for_backward(x, s, l)
        ctx.jitter = jitter
        return _gibbs_gram_forward(x, s, l, None, None, None, jitter)

    @staticmethod
    @first_order_only
    def backward(ctx, kbar):
        x, s, l = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            s_bar, l_bar, x_bar = gibbs_gram_backward(x, s, l, kbar.contiguous(), ctx.jitter, input_grad=True)
            return x_bar, s_bar, l_bar, None
        s_bar, l_bar = gibbs_gram_backward(x, s, l, kbar.contiguous(), ctx.jitter)
        return None, s_bar, l_bar, None


@dataclasses.dataclass(frozen=True)
class K1CrossBackwardSchedule:
    """How K1's cross-form backward kernel cuts its work, from (N1, N2, SMs)
    alone: one launch of ``grid`` blocks of 8 warps.

    Block ``b`` takes the row strip ``s = b // col_groups``, rows ``s·rows
    .. + rows − 1`` (``rows`` a multiple of 32, at most 256), and the column
    group ``g = b % col_groups``, chunks ``g·per .. g·per + per − 1`` of 64
    columns (``per`` = :attr:`chunks_per_group`).  Warp ``w`` takes its rows
    ``s·rows + w·rows/8 + k`` in groups of ``group`` = 4 rows evaluated at
    once; lane ``l`` of chunk ``c0`` takes columns ``c0 + l`` and ``c0 + l +
    32``.  A row's shares are summed over the lane's two columns, then over
    the 32 lanes (halving exchanges that pair the lanes as a shuffle tree
    over offsets 16, 8, 4, 2, 1 does), then over the group's chunks in
    order; with one column group that is the row's gradient, else it goes to
    row slot ``[g][row][2]`` and the block whose strip ticket comes last adds
    the strip's row slots in group order.  A column's shares are summed over
    the warp's rows in order, then over the 8 warps in order, into column
    slot ``[s][column][2]`` (σ̄2's share, ℓ̄2's), every (slot, column)
    written once.  The block whose group ticket comes last sums the group's
    column slots in strip order: batches of 32 slots go to its thread groups
    in turn (1 group where 2·(the group's columns) > 128, else 2, 4 or 8),
    slot ``s`` to accumulator ``s % 4`` of its group, the groups'
    accumulators are added in group order, then ``(a0 + a1) + (a2 + a3)``;
    so the result does not depend on the order the blocks finish in.  A
    strip past N1 or a chunk past N2 adds exactly 0.  The tickets are int32
    per device and stream (:func:`_tickets_for`), which the kernel leaves
    at 0.
    """

    n1: int
    n2: int
    rows: int
    col_groups: int

    warps = 8
    group = 4
    chunk = 64

    @property
    def n_strips(self) -> int:
        return -(-self.n1 // self.rows)

    @property
    def n_chunks(self) -> int:
        return -(-self.n2 // self.chunk)

    @property
    def chunks_per_group(self) -> int:
        return -(-self.n_chunks // self.col_groups)

    @property
    def grid(self) -> int:
        return self.n_strips * self.col_groups

    @property
    def n_slots(self) -> int:
        """Column slots: one a strip."""
        return self.n_strips

    @property
    def slots_numel(self) -> int:
        """The column slots, then (with several column groups) the row slots."""
        return self.n_strips * self.n2 * 2 + (self.col_groups * self.n1 * 2 if self.col_groups > 1 else 0)

    @property
    def input_slots_numel(self) -> int:
        """With a gradient in the inputs: x̄2's column slots, then (with
        several column groups) x̄1's row slots, after :attr:`slots_numel`."""
        return self.slots_numel // 2

    @property
    def n_tickets(self) -> int:
        """One a column group, then (with several) one a strip."""
        return self.col_groups + (self.n_strips if self.col_groups > 1 else 0)


#: K1's cross-form backward: the tallest strip (a thread stages one row).
_K1X_MAX_ROWS = 256


def k1x_column_groups(n_chunks: int, want: int) -> int:
    """The most column groups up to ``want`` in which ``n_chunks`` chunks
    split evenly but for the last group (none empty)."""
    per = -(-n_chunks // max(1, min(want, n_chunks)))
    return -(-n_chunks // per)


def k1_cross_backward_schedule(n1: int, n2: int, sms: int = 132) -> K1CrossBackwardSchedule:
    """Strips as short as still fill the card once with one block per SM (a
    multiple of 32 rows, at most 256); where they leave SMs idle, the column
    chunks in as many groups as the idle SMs allow (chosen by measurement on
    an NVIDIA H100 80GB HBM3 at 700 W: ``PERF.md``)."""
    unit = K1CrossBackwardSchedule.warps * K1CrossBackwardSchedule.group
    rows = min(unit * max(1, -(-n1 // (unit * sms))), _K1X_MAX_ROWS)
    strips = -(-n1 // rows)
    n_chunks = -(-n2 // K1CrossBackwardSchedule.chunk)
    return K1CrossBackwardSchedule(n1, n2, rows, k1x_column_groups(n_chunks, sms // strips))


def gibbs_gram_cross_backward_plain(x1, s1, l1, x2, s2, l2, kbar, input_grad: bool = False):
    """Plain version of K1's cross-form backward: ``(σ̄1, ℓ̄1, σ̄2, ℓ̄2)`` and,
    with ``input_grad``, ``(x̄1, x̄2)`` after them, by
    ``torch.autograd.grad`` through :func:`gibbs_gram_plain`."""
    if input_grad:
        x1_bar, s1_bar, l1_bar, x2_bar, s2_bar, l2_bar = _grads(gibbs_gram_plain, (x1, s1, l1, x2, s2, l2),
                                                                (True,) * 6, kbar)
        return s1_bar, l1_bar, s2_bar, l2_bar, x1_bar, x2_bar
    return _grads(gibbs_gram_plain, (x1, s1, l1, x2, s2, l2), (False, True, True, False, True, True), kbar)


def gibbs_gram_cross_backward(x1, s1, l1, x2, s2, l2, kbar, input_grad: bool = False):
    """``(σ̄1, ℓ̄1, σ̄2, ℓ̄2)`` of K1's cross form for the cotangent ``kbar``
    (n1, n2): the row strip's gradients (n1,) and the column strip's (n2,);
    with ``input_grad`` also ``(x̄1, x̄2)`` after them, from the same
    launch."""
    if x1.device.type == "cpu":
        return gibbs_gram_cross_backward_plain(x1, s1, l1, x2, s2, l2, kbar, input_grad)
    tensors = {"x1": x1, "s1": s1, "l1": l1, "x2": x2, "s2": s2, "l2": l2, "kbar": kbar}
    device, dtype = _check_cuda("gibbs_gram_cross_backward", tensors, {**dict.fromkeys(tensors, 1), "kbar": 2})
    n1, n2 = x1.shape[0], x2.shape[0]
    if s1.shape[0] != n1 or l1.shape[0] != n1 or s2.shape[0] != n2 or l2.shape[0] != n2 \
            or tuple(kbar.shape) != (n1, n2):
        raise ValueError("gibbs_gram_cross_backward: want x1, s1, l1 (N1,), x2, s2, l2 (N2,) and kbar (N1, N2)")
    if n1 >= 2**31 - 8 * _K1X_MAX_ROWS or n2 >= 2**30:
        raise ValueError(f"gibbs_gram_cross_backward: strips of {n1} x {n2} exceed the launch grid")
    sizes = (n1, n1, n2, n2) + ((n1, n2) if input_grad else ())
    if n1 == 0 or n2 == 0:
        return tuple(torch.zeros(n, dtype=dtype, device=device) for n in sizes)
    outs = _k1x_launch(k1_cross_backward_schedule(n1, n2, sm_count(device)), x1, s1, l1, x2, s2, l2, kbar,
                       input_grad)
    gibbs_gram_cross_backward.launches += 1
    gibbs_gram_cross_backward.input_grad_launches += input_grad
    return outs


def _k1x_launch(sched, x1, s1, l1, x2, s2, l2, kbar, input_grad: bool = False) -> tuple:
    """K1's cross-form backward by ``sched`` into new (σ̄1, ℓ̄1, σ̄2, ℓ̄2) and,
    with ``input_grad``, (x̄1, x̄2); counts nothing."""
    dtype, device = x1.dtype, x1.device
    sizes = (sched.n1, sched.n1, sched.n2, sched.n2) + ((sched.n1, sched.n2) if input_grad else ())
    outs = tuple(torch.empty(n, dtype=dtype, device=device) for n in sizes)
    slots = torch.empty(sched.slots_numel + (sched.input_slots_numel if input_grad else 0), dtype=dtype,
                        device=device)
    _launch("gibbs_gram_cross_backward", dtype, device, x1.data_ptr(), s1.data_ptr(), l1.data_ptr(), sched.n1,
            x2.data_ptr(), s2.data_ptr(), l2.data_ptr(), sched.n2, kbar.data_ptr(), sched.rows, sched.col_groups,
            sched.grid, slots.data_ptr(), _tickets_for(device, sched.n_tickets).data_ptr(),
            *(o.data_ptr() for o in outs[:4]), *(_ptr(o) for o in (outs[4:] or (None, None))))
    return outs


_tickets: dict = {}  # (device, stream) -> the cross-form backward's tickets


def _tickets_for(device: torch.device, n: int) -> torch.Tensor:
    """The cross-form backward's tickets on ``device``'s current stream: int32,
    zeroed once, which every launch leaves at 0 (launches on one stream run
    in turn, so they can share them).  The default schedule takes at most
    one more than the SM count, allocated at first use; a schedule that
    takes more replaces them with as many."""
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    key = (device, stream)
    if key not in _tickets or _tickets[key].numel() < n:
        _tickets[key] = torch.zeros(max(n, sm_count(device) + 1), dtype=torch.int32, device=device)
    return _tickets[key]


gibbs_gram_cross_backward.launches = gibbs_gram_cross_backward.input_grad_launches = 0


class _GibbsGramCross(torch.autograd.Function):
    """K1's cross form with its backward kernel (on the CPU, autograd of the
    plain version), first order only."""

    @staticmethod
    def forward(ctx, x1, s1, l1, x2, s2, l2):
        ctx.save_for_backward(x1, s1, l1, x2, s2, l2)
        return _gibbs_gram_forward(x1, s1, l1, x2, s2, l2, 0.0)

    @staticmethod
    @first_order_only
    def backward(ctx, kbar):
        x1, s1, l1, x2, s2, l2 = ctx.saved_tensors
        args = (x1, s1, l1, x2, s2, l2, kbar.contiguous())
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[3]):
            s1_bar, l1_bar, s2_bar, l2_bar = gibbs_gram_cross_backward(*args)
            return None, s1_bar, l1_bar, None, s2_bar, l2_bar
        s1_bar, l1_bar, s2_bar, l2_bar, x1_bar, x2_bar = gibbs_gram_cross_backward(*args, input_grad=True)
        return (x1_bar if ctx.needs_input_grad[0] else None, s1_bar, l1_bar,
                x2_bar if ctx.needs_input_grad[3] else None, s2_bar, l2_bar)


# ---------------------------------------------------------------------------
# K2: fused SVC Gram
# ---------------------------------------------------------------------------


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")


def svc_gram_plain(x, ell, ls, jitter: float, layout: str = "task") -> torch.Tensor:
    """Plain PyTorch version of kernel K2, in the kernel's order of operations.

    Builds the (N, M, N, M) task product that the kernel never stores.
    """
    _check_layout(layout)
    n, m, _ = ls.shape
    l2 = ell * ell
    a = l2[:, None] + l2[None, :]
    b = ell[:, None] * ell[None, :]
    dx = x[:, None] - x[None, :]
    d = dx * dx
    kx = torch.sqrt(2.0 * b / a) * torch.exp(-d / a)
    kx = kx + jitter * torch.eye(n, dtype=kx.dtype, device=kx.device)
    bsum = ls[:, :, 0][:, :, None, None] * ls[:, :, 0][None, None, :, :]  # [n,a,p,c]
    for j in range(1, m):
        bsum = bsum + ls[:, :, j][:, :, None, None] * ls[:, :, j][None, None, :, :]
    k4 = kx[:, None, :, None] * bsum
    if layout == "task":
        k4 = k4.permute(1, 0, 3, 2)  # [a,n,c,p]
    return k4.reshape(n * m, n * m)


def svc_gram(x, ell, ls, jitter: float, layout: str = "task") -> torch.Tensor:
    """The fused GNMGP Gram ``(K_x + jitter·I)[n,p]·(L_n L_pᵀ)[a,c]``, (NM, NM).

    ``x``, ``ell``: (N,); ``ls``: (N, M, M).  ``layout="task"`` puts entry
    (n, a) at row ``a·N + n`` (``models.gnmgp.gram``): kernel K2, in warp
    strips with V-wide stores for M ≤ 4 and in tiles of input pairs with L
    staged in shared memory above (:func:`k2_schedule`), counted in
    ``svc_gram.launches``.
    ``layout="input"`` puts it at row ``n·M + a`` (``svc_gram_fused2d``'s
    contract): the same matrix bit for bit, computed by K3's forward kernel
    (:func:`svc_gram_tiled`), so the launch is counted in
    ``svc_gram_tiled.launches``.
    """
    _check_layout(layout)
    if layout == "input":
        return _svc_gram_tiled_forward(x, ell, ls, jitter)
    if x.device.type == "cpu":
        return svc_gram_plain(x, ell, ls, jitter, layout)
    device, dtype, n, m = _check_svc("svc_gram", x, ell, ls)
    out = torch.empty((n * m, n * m), dtype=dtype, device=device)
    if n == 0 or m == 0:
        return out
    sched = k2_schedule(n, m, dtype, sm_count(device))
    _k2_launch(sched, x, ell, ls, jitter, out)
    svc_gram.launches += 1
    return out


def _k2_launch(sched, x, ell, ls, jitter, out) -> torch.Tensor:
    """K2 by ``sched`` into ``out``; counts nothing."""
    _launch("svc_gram", x.dtype, x.device, x.data_ptr(), ell.data_ptr(), ls.data_ptr(), sched.n, sched.m,
            float(jitter), sched.vec, sched.rows, sched.warps, sched.grid, sched.row_tasks, sched.col_tasks,
            sched.b_chunk, out.data_ptr())
    return out


svc_gram.launches = 0

#: The largest M with K2's templated (warp-strip) route; above it the
#: generic route, tiles of input pairs with M at run time.
K2_MAX_M = 4

#: K2's generic route (M > 4): tiles of 64 × 64 input pairs, one block of 256
#: threads (4 × 4 pairs each) a unit; L staged [task][b][input] with a pitch
#: of 68 inputs (16-B aligned in either type), within half an SM's 228 KB
#: (less 1 KB a block), so that two blocks share an SM at every M.
K2_GENERIC_TILE, _K2_GEN_PITCH, _K2_GEN_THREADS = 64, 68, 256
_K2_GEN_HALF_SM = 115_712


@dataclasses.dataclass(frozen=True)
class K2Schedule(_Strips):
    """How K2's kernel cuts its work, from (N, M, dtype, SMs) alone.

    ``route`` is ``"vector"`` or ``"scalar"`` (M ≤ 4) or ``"generic"`` (M >
    4).  ``vec`` is the store width: 2 in float64, 4 or 2 in float32, where
    N is divisible by it (then every offset ``(a·N + n)·N·M + c·N + p`` with
    ``p`` a multiple of ``vec`` is one too), else 1.

    For M ≤ 4 the strip walk (:class:`_Strips`): an item is ``rows`` row
    inputs by a strip of 32·``vec`` column inputs, and lane ``l`` owns column
    inputs ``p = p0 + l·vec ..``; for each row input ``n`` and task pair
    ``(a, c)`` it stores ``vec`` values at row ``a·N + n``, column ``c·N +
    p``.  ``row_tasks`` = ``col_tasks`` = 0.

    The generic route walks units: a tile of ``rows`` = 64 × 64 input pairs
    (tile ``t``: row inputs ``64·(t // n_tiles)``.., column inputs ``64·(t %
    n_tiles)``..), a group of ``row_tasks`` row tasks and a group of
    ``col_tasks`` column tasks; unit ``u`` is tile ``u // (a_groups ·
    c_groups)``, row group ``u // c_groups % a_groups``, column group ``u %
    c_groups``.  Block ``b`` of ``grid`` (``warps`` = 8 a block) takes units
    ``b, b + grid, ...``.  Thread ``(ty, tx)`` = ``(t // 16, t % 16)`` owns
    rows ``4ty .. 4ty + 3`` of the tile and the 4 columns
    :meth:`generic_columns` gives.  A unit stages its tasks' L ``b_chunk`` b
    values at a time: ``b_chunk`` = M, or less with one row and one column
    task a unit.  ``smem_bytes`` is a block's staged L, (``row_tasks`` +
    ``col_tasks``)·``b_chunk``·68 values (0 for M ≤ 4).
    """

    n: int
    m: int
    route: str
    vec: int
    rows: int
    warps: int
    grid: int
    row_tasks: int = 0
    col_tasks: int = 0
    b_chunk: int = 0
    smem_bytes: int = 0

    @property
    def strip(self) -> int:
        return 32 * self.vec

    @property
    def n_tiles(self) -> int:
        """The generic route's tiles a side: ⌈N / 64⌉."""
        return -(-self.n // K2_GENERIC_TILE)

    @property
    def a_groups(self) -> int:
        return -(-self.m // self.row_tasks)

    @property
    def c_groups(self) -> int:
        return -(-self.m // self.col_tasks)

    @property
    def n_units(self) -> int:
        return self.n_tiles**2 * self.a_groups * self.c_groups

    def unit(self, u: int) -> tuple[int, int, int, int]:
        """Unit ``u``'s first row input, first column input, first row task
        and first column task."""
        tile, ia, ic = u // (self.a_groups * self.c_groups), u // self.c_groups % self.a_groups, u % self.c_groups
        return (tile // self.n_tiles * K2_GENERIC_TILE, tile % self.n_tiles * K2_GENERIC_TILE,
                ia * self.row_tasks, ic * self.col_tasks)

    def units(self, block: int) -> range:
        """The units block ``block`` takes, in its order."""
        return range(block, self.n_units, self.grid)

    @staticmethod
    def generic_columns(tx: int, size: int) -> list[int]:
        """The 4 columns of a tile that thread column ``tx`` owns, for
        elements of ``size`` bytes (groups of 16 B, 16 groups apart)."""
        cw = 16 // size
        return [cw * tx + 16 * cw * (j // cw) + j % cw for j in range(4)]


#: K2: every SM should get at least this many warps' items (K2's strips are
#: ``vec`` times K3's width; chosen by measurement: ``PERF.md``).
_K2_WARPS_PER_SM = 8


def _element_size(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


@functools.lru_cache(maxsize=256)
def k2_schedule(n: int, m: int, dtype: torch.dtype, sms: int = 132) -> K2Schedule:
    """For M ≤ 4 the route and store width, the rows of an item (the most of
    8, 4, 2, 1 that still gives every SM 8 warps' items), 4 warps a block
    and a grid of at most 16 blocks per SM, never more blocks than the items
    fill.  For M > 4 the generic route: :func:`_k2_generic_groups` picks the
    task groups and the b chunk, and the grid is the two blocks an SM holds,
    never more than the units."""
    vec = _store_width(n, dtype)
    if m > K2_MAX_M:
        row_tasks, col_tasks, b_chunk = _k2_generic_groups(n, m, dtype, sms)
        smem = _element_size(dtype) * (row_tasks + col_tasks) * b_chunk * _K2_GEN_PITCH
        sched = K2Schedule(n, m, "generic", vec, K2_GENERIC_TILE, _K2_GEN_THREADS // 32, 1, row_tasks, col_tasks,
                           b_chunk, smem)
        return dataclasses.replace(sched, grid=min(sched.n_units, 2 * sms))
    rows = _strip_rows(n, -(-n // (32 * vec)), sms, _K2_WARPS_PER_SM)
    sched = K2Schedule(n, m, "vector" if vec > 1 else "scalar", vec, rows, 4, 1)
    return dataclasses.replace(sched, grid=_strip_grid(sched.n_items, sched.warps, sms))


def _k2_generic_groups(n: int, m: int, dtype: torch.dtype, sms: int) -> tuple[int, int, int]:
    """K2's generic route: the row tasks and column tasks of a unit and the b
    values staged at once.  One b value of a task staged for a tile's 64
    inputs takes 68·w bytes, and a block stages within half an SM.  Where a
    row and a column task do not fit whole, a unit is one task pair staged
    in chunks of b.  Else, of the groups whose staging fits, the one whose
    waves of units (two blocks an SM) cost least, a unit costing its task
    pairs and one more for its Gibbs terms, staging and barriers; the fewest
    units break a tie."""
    per_b = _element_size(dtype) * _K2_GEN_PITCH
    b_chunk = min(m, _K2_GEN_HALF_SM // (2 * per_b))
    if b_chunk < m:
        return 1, 1, b_chunk
    cap = _K2_GEN_HALF_SM // (per_b * m)  # whole tasks staged at once
    tiles, slots = (-(-n // K2_GENERIC_TILE)) ** 2, 2 * sms
    sizes = sorted({-(-m // g) for g in range(1, m + 1)}, reverse=True)  # the distinct group sizes

    def cost(a: int, c: int) -> tuple[int, int]:
        units = tiles * -(-m // a) * -(-m // c)
        return -(-units // slots) * (a * c + 1), units

    row_tasks, col_tasks = min(((a, c) for a in sizes for c in sizes if a + c <= cap), key=lambda ac: cost(*ac))
    return row_tasks, col_tasks, m


# ---------------------------------------------------------------------------
# K3: tiled SVC Gram (input-major) and its backward
# ---------------------------------------------------------------------------

#: The largest M with a specialised (templated) route in K3's forward and
#: backward; above it both take their generic routes, with M at run time.
K3_MAX_M = 8

#: K3's generic routes (M > 8) cut the flattened NM × NM index into tiles of
#: this many rows (and columns), whatever M.
K3_GENERIC_TILE = 64
#: The inputs a tile's 64 rows span at M >= 9 (63 // 9 + 2): the Gibbs terms
#: a tile needs fit a 9 × 9 table.
_K3_GENERIC_SPAN = 9
#: The generic forward stages L 16 task columns at a time, [b][row] with rows
#: padded to 68; a block's shared memory: those two strips and the Gibbs
#: table in the input's type, and two int arrays of 64 (each row's and
#: column's input), whatever M.
_K3_GEN_FWD_K, _K3_GEN_FWD_PITCH = 16, 68
#: The generic backward: b values of a task, the padded row of a staged K̄
#: tile, and a block's shared memory on the H100 (227 KB), which decides
#: whether the tiles' rows of L join the staged K̄.
K3_GENERIC_BB, _K3_GEN_KP, _H100_SMEM = 3, 65, 232_448


def svc_gram_tiled_plain(x, ell, ls, jitter: float) -> torch.Tensor:
    """Plain version of kernel K3: the kernel's order of operations is K2's,
    so this is :func:`svc_gram_plain` in the input-major layout."""
    return svc_gram_plain(x, ell, ls, jitter, layout="input")


def _check_svc(name, x, ell, ls):
    tensors = {"x": x, "ell": ell, "ls": ls}
    device, dtype = _check_cuda(name, tensors, {"x": 1, "ell": 1, "ls": 3})
    n, m = ls.shape[0], ls.shape[1]
    if x.shape[0] != n or ell.shape[0] != n or ls.shape[2] != m:
        raise ValueError(
            f"{name}: want x (N,), ell (N,), ls (N, M, M); got {tuple(x.shape)}, "
            f"{tuple(ell.shape)}, {tuple(ls.shape)}"
        )
    if n > _MAX_ROWS:
        raise ValueError(f"{name}: N={n} exceeds the launch grid")
    return device, dtype, n, m


@dataclasses.dataclass(frozen=True)
class K3ForwardSchedule(_Strips):
    """How K3's forward kernel cuts its work, from (N, M, dtype) alone.

    ``route`` is ``"vector"`` or ``"scalar"`` (M ≤ 8) or ``"generic"`` (M >
    8).  For M ≤ 8 an item is ``rows`` row inputs by a strip of 32 column
    inputs; item ``i`` is row chunk ``i // n_strips`` and strip ``i %
    n_strips``.  Warp ``w`` of block ``b`` (``warps`` a block, ``grid``
    blocks) takes items ``b·warps + w``, then every ``grid·warps``-th.  Lane
    ``l`` evaluates the Gibbs term of column input ``p0 + l`` and stores
    chunks ``(l + 32k)·vec ..`` of each output row of the strip, ``vec``
    values at once, for ``k < M / vec``.  ``vec`` is 2 for an even M in
    float64, 4 or 2 for M divisible by 4 or 2 in float32, else 1: then every
    row offset ``(n·M + a)·N·M`` and strip offset ``p0·M`` is a multiple of
    ``vec``, and the output's base is 256-B aligned.

    The generic route (M > 8) cuts the flattened NM × NM output into tiles of
    ``rows`` = 64 rows and columns, one block of 256 threads (``warps`` = 8)
    a tile, ``grid`` = ``n_tiles``² blocks (block (x, y): column tile x, row
    tile y).  Thread ``(ty, tx)`` = ``(t // 16, t % 16)`` owns rows ``4ty ..
    4ty + 3`` of its tile and the 4 columns :meth:`generic_columns` gives
    (two 16-B groups in float64, one in float32), sums b = 0..M−1 in order
    from L staged 16 task columns at a time, and stores ``vec`` values at
    once: the widest store of at most 16 B whose width divides N·M, so that
    every row offset ``r·N·M`` is a multiple of it.  ``smem_bytes`` is a
    block's shared memory as the kernel sizes it: the warps' strips of L for
    M = 5..8, none for M ≤ 4, and for the generic route a size that does not
    depend on M.

    A batch of ``batch`` Grams (:func:`svc_gram_tiled_batched`): the
    member is the grid's y (M ≤ 8; ``grid`` blocks a member, each walking
    the member's items as above) or z (the generic route, ``grid`` tiles² a
    member); for M ≤ 8 ``rows`` and ``grid`` are chosen for the whole batch.
    """

    n: int
    m: int
    route: str
    vec: int
    rows: int
    warps: int
    grid: int
    smem_bytes: int
    batch: int = 1

    strip = 32

    @property
    def n_tiles(self) -> int:
        """The generic route's tiles a side: ⌈N·M / rows⌉."""
        return -(-self.n * self.m // self.rows)

    def generic_columns(self, tx: int, size: int) -> list[int]:
        """The generic route: the 4 columns of its tile that thread column
        ``tx`` owns, for elements of ``size`` bytes (groups of 16 B, 16
        groups apart)."""
        cw = 16 // size
        return [cw * tx + 16 * cw * (j // cw) + j % cw for j in range(4)]


#: K3's forward: every SM should get at least this many warps' items.
_K3_FWD_WARPS_PER_SM = 16


def k3_forward_schedule(n: int, m: int, dtype: torch.dtype, sms: int = 132, batch: int = 1) -> K3ForwardSchedule:
    """For M ≤ 8 the store route and width, the rows of an item (the most of
    8, 4, 2, 1 that still gives every SM 16 warps' items over the batch),
    4 warps a block and a grid of at most 16 blocks per SM over the batch,
    never more blocks than a member's items fill; for M > 8 the generic
    route's tiles and store width."""
    size = torch.tensor([], dtype=dtype).element_size()
    if m > K3_MAX_M:
        tiles = -(-n * m // K3_GENERIC_TILE)
        smem = size * (2 * _K3_GEN_FWD_K * _K3_GEN_FWD_PITCH + _K3_GENERIC_SPAN**2) + 4 * 2 * K3_GENERIC_TILE
        return K3ForwardSchedule(n, m, "generic", _store_width(n * m, dtype), K3_GENERIC_TILE, 8, tiles * tiles, smem,
                                 batch)
    vec = _store_width(m, dtype)
    rows = _strip_rows(n, -(-n // 32) * batch, sms, _K3_FWD_WARPS_PER_SM)
    warps = 4
    smem = 0 if m <= 4 else size * 32 * m * m * warps
    sched = K3ForwardSchedule(n, m, "vector" if vec > 1 else "scalar", vec, rows, warps, 1, smem, batch)
    return dataclasses.replace(sched, grid=_strip_grid(sched.n_items, warps, sms, batch))


def _svc_gram_tiled_forward(x, ell, ls, jitter) -> torch.Tensor:
    if x.device.type == "cpu":
        return svc_gram_tiled_plain(x, ell, ls, jitter)
    device, dtype, n, m = _check_svc("svc_gram_tiled", x, ell, ls)
    out = torch.empty((n * m, n * m), dtype=dtype, device=device)
    if n == 0 or m == 0:
        return out
    sched = k3_forward_schedule(n, m, dtype, sm_count(device))
    _launch("svc_gram_tiled", dtype, device, x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m,
            float(jitter), sched.vec, sched.rows, sched.warps, sched.grid, out.data_ptr())
    svc_gram_tiled.launches += 1
    return out


def svc_gram_tiled(x, ell, ls, jitter: float) -> torch.Tensor:
    """The GNMGP Gram ``(K_x + jitter·I)[n,p]·(L_n L_pᵀ)[a,c]`` in the
    input-major layout (row ``n·M + a``), (NM, NM).

    ``x``, ``ell``: (N,); ``ls``: (N, M, M).  Differentiable in ``x``,
    ``ell`` and ``ls`` (through :func:`svc_gram_tiled_backward`).
    """
    if _needs_grad(x, ell, ls):
        return _SvcGramTiled.apply(x, ell, ls, float(jitter))
    return _svc_gram_tiled_forward(x, ell, ls, jitter)


svc_gram_tiled.launches = 0


def svc_gram_tiled_backward_plain(x, ell, ls, jitter: float, kbar, input_grad: bool = False):
    """Plain version of K3's backward: ``(ℓ̄, L̄)`` and, with ``input_grad``,
    ``x̄``, by ``torch.autograd.grad`` through :func:`svc_gram_tiled_plain`."""
    f = lambda x_, ell_, ls_: svc_gram_tiled_plain(x_, ell_, ls_, jitter)
    if input_grad:
        x_bar, ell_bar, ls_bar = _grads(f, (x, ell, ls), (True, True, True), kbar)
        return ell_bar, ls_bar, x_bar
    return _grads(f, (x, ell, ls), (False, True, True), kbar)


@dataclasses.dataclass(frozen=True)
class K3BackwardSchedule(_TilePairs):
    """How K3's backward kernel cuts its work, from (N, M) alone.

    ``route`` is ``"tiled"`` for M ≤ 8 or ``"generic"`` above.  Both walk
    the unordered tile pairs ``(I, J)``, ``I <= J``, in the order of
    :meth:`pairs` (row-major), and compute the same mapping from a pair's
    index themselves; block ``b`` of ``grid`` takes pairs ``b, b + grid,
    ...``.  Pair ``(I, J)`` writes the rows of tile ``I`` into slot ``J`` and
    the rows of tile ``J`` into slot ``I``; every (slot, row) is written
    once, and a second launch sums each row's slots in one fixed order, so
    the result does not depend on ``grid``.

    Tiled (M ≤ 8): tiles of ``tile`` inputs, ``partial[slot][row][k]`` (``k
    < M²``: L̄'s share, ``k = M²``: ℓ̄'s), in the input's type; the second
    launch's lane ``j`` of a row's warp adds slots ``j, j + 32, ...``, then a
    shuffle tree adds the lanes.

    Generic (M > 8): tiles of ``tile`` = 64 rows of the flattened index (row
    ``n·M + a``), one block of 384 threads per SM; the tiles' rows of L join
    the staged K̄ where both stages fit (:meth:`l_staged`).  A pair's tasks
    are the rows of I walking the columns of J (the row side) and, off the
    diagonal, the rows of J walking the rows of I (the column side), each
    for ``K3_GENERIC_BB`` consecutive b (b block ``k // 64``, row ``k % 64``
    of task ``k`` of a side).  The partials are doubles,
    ``partial[slot][k][row]`` with ``k < M`` L̄'s share and ``k = M + (b
    block)`` that block's ℓ̄ share.  A second launch sums each (k, row)'s
    slots in order (L̄, and the ℓ̄ shares back into slot 0); a third sums ℓ̄
    by one warp per input, lane ``l`` adding terms ``l, l + 32, ...`` of
    ``j = a·(b blocks) + b block``, then a shuffle tree.

    A batch of ``batch`` members (:func:`svc_gram_tiled_batched_backward`):
    the tiled route's blocks walk ``batch`` × ``n_pairs`` pairs,
    member-major (pair ``q`` of the walk is pair ``q % n_pairs`` of member
    ``q // n_pairs``), each member's partials at its own offset, and its
    second launch sums ``batch`` × N rows; ``grid`` is chosen for the whole
    walk.  The generic route runs its three launches once per member with
    one member's ``grid`` and partials.
    """

    n: int
    m: int
    route: str
    tile: int
    grid: int
    batch: int = 1

    @property
    def n_tiles(self) -> int:
        rows = self.n * self.m if self.route == "generic" else self.n
        return -(-rows // self.tile)

    @property
    def n_bblocks(self) -> int:
        """The generic route's b blocks a row: ⌈M / K3_GENERIC_BB⌉."""
        return -(-self.m // K3_GENERIC_BB)

    @property
    def partial_numel(self) -> int:
        """The partials of the launch: a member's (generic: the members run
        one after another and reuse them), else ``batch`` members'."""
        if self.route == "generic":
            return self.n_tiles * (self.m + self.n_bblocks) * self.n * self.m
        return self.batch * self.n_tiles * self.n * (self.m * self.m + 1)

    @property
    def input_partial_numel(self) -> int:
        """With a gradient in x (one Gram): x̄'s partials after
        :attr:`partial_numel` (generic: a ``K3_GENERIC_BB`` block's share
        a row and slot, as ℓ̄'s)."""
        if self.route == "generic":
            return self.n_tiles * self.n_bblocks * self.n * self.m
        return self.n_tiles * self.n

    def partial_dtype(self, dtype: torch.dtype) -> torch.dtype:
        """The partials' type: the input's (tiled), float64 (generic)."""
        return torch.float64 if self.route == "generic" else dtype

    def scratch_bytes(self, dtype: torch.dtype) -> int:
        return self.partial_numel * torch.tensor([], dtype=self.partial_dtype(dtype)).element_size()

    def smem_bytes(self, dtype: torch.dtype, l_staged: bool | None = None) -> int:
        """The generic route's shared memory a block: two stages of the two
        K̄ tiles (and, staged, the tiles' 64 rows of L) in the input's type,
        then S (float32: in double; float64 overwrites K̄[I, J]) and three
        9 × 9 tables in double."""
        if l_staged is None:
            l_staged = self.l_staged(dtype)
        size = torch.tensor([], dtype=dtype).element_size()
        kb = self.tile * _K3_GEN_KP
        stage = 2 * kb + (2 * self.tile * self.m if l_staged else 0)
        return size * 2 * stage + 8 * ((0 if size == 8 else kb) + 3 * _K3_GENERIC_SPAN**2)

    def l_staged(self, dtype: torch.dtype) -> bool:
        """Whether the generic route stages L (M <= 47 in float64, 127 in float32)."""
        return self.smem_bytes(dtype, True) <= _H100_SMEM


def k3_backward_schedule(n: int, m: int, sms: int = 132, batch: int = 1) -> K3BackwardSchedule:
    """The route; the tile side (16 inputs for M ≤ 4, else 8; 64 flattened
    rows for M > 8), the persistent grid (4 blocks per SM for M ≤ 8, one for
    M > 8, never more blocks than the walk's tile pairs) and, through the
    result's properties, the pairs and the partials' size."""
    if m > K3_MAX_M:
        sched = K3BackwardSchedule(n, m, "generic", K3_GENERIC_TILE, 1, batch)
        return dataclasses.replace(sched, grid=max(1, min(sched.n_pairs, sms)))
    sched = K3BackwardSchedule(n, m, "tiled", 16 if m <= 4 else 8, 1, batch)
    return dataclasses.replace(sched, grid=max(1, min(sched.n_pairs * batch, 4 * sms)))


def svc_gram_tiled_backward(x, ell, ls, kbar, jitter: float, input_grad: bool = False):
    """``(ℓ̄, L̄)`` of K3 for the cotangent ``kbar`` (NM, NM), input-major,
    which need not be symmetric, and with ``input_grad`` ``x̄`` after them
    (from the same launches).  ``L̄`` is (N, M, M), upper triangle included.
    The jitter rides ``K̄``'s weight on the diagonal blocks."""
    if x.device.type == "cpu":
        return svc_gram_tiled_backward_plain(x, ell, ls, jitter, kbar, input_grad)
    device, dtype, n, m = _check_svc("svc_gram_tiled_backward", x, ell, ls)
    if kbar.device != device or kbar.dtype != dtype or tuple(kbar.shape) != (n * m, n * m):
        raise ValueError(f"svc_gram_tiled_backward: kbar must be ({n * m}, {n * m}) {dtype} on {device}")
    if not kbar.is_contiguous():
        raise ValueError("svc_gram_tiled_backward: kbar must be contiguous")
    ell_bar = torch.empty(n, dtype=dtype, device=device)
    ls_bar = torch.empty((n, m, m), dtype=dtype, device=device)
    x_bar = torch.empty(n, dtype=dtype, device=device) if input_grad else None
    outs = (ell_bar, ls_bar, x_bar) if input_grad else (ell_bar, ls_bar)
    if n == 0:
        return outs
    sched = k3_backward_schedule(n, m, sm_count(device))
    numel = sched.partial_numel + (sched.input_partial_numel if input_grad else 0)
    partial = torch.empty(numel, dtype=sched.partial_dtype(dtype), device=device)
    _launch("svc_gram_tiled_backward", dtype, device, x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m,
            float(jitter), kbar.data_ptr(), sched.tile, sched.grid, partial.data_ptr(),
            ls_bar.data_ptr(), ell_bar.data_ptr(), _ptr(x_bar))
    svc_gram_tiled_backward.launches += 1
    svc_gram_tiled_backward.input_grad_launches += input_grad
    return outs


svc_gram_tiled_backward.launches = svc_gram_tiled_backward.input_grad_launches = 0


class _SvcGramTiled(torch.autograd.Function):
    """K3 with its backward kernel, first order only."""

    @staticmethod
    def forward(ctx, x, ell, ls, jitter):
        ctx.save_for_backward(x, ell, ls)
        ctx.jitter = jitter
        return _svc_gram_tiled_forward(x, ell, ls, jitter)

    @staticmethod
    @first_order_only
    def backward(ctx, kbar):
        x, ell, ls = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            ell_bar, ls_bar, x_bar = svc_gram_tiled_backward(x, ell, ls, kbar.contiguous(), ctx.jitter, input_grad=True)
            return x_bar, ell_bar, ls_bar, None
        ell_bar, ls_bar = svc_gram_tiled_backward(x, ell, ls, kbar.contiguous(), ctx.jitter)
        return None, ell_bar, ls_bar, None


# ---------------------------------------------------------------------------
# K3 over a batch
# ---------------------------------------------------------------------------


def svc_gram_tiled_batched_plain(x, ell, ls, jitter: float) -> torch.Tensor:
    """Plain version of the batched K3: :func:`svc_gram_tiled_plain` of each
    member, stacked."""
    return torch.stack([svc_gram_tiled_plain(x, e, l, jitter) for e, l in zip(ell, ls)])


def _check_svc_batched(name, x, ell, ls):
    tensors = {"x": x, "ell": ell, "ls": ls}
    device, dtype = _check_cuda(name, tensors, {"x": 1, "ell": 2, "ls": 4})
    b, n, m = ls.shape[0], ls.shape[1], ls.shape[2]
    if x.shape[0] != n or tuple(ell.shape) != (b, n) or ls.shape[3] != m:
        raise ValueError(
            f"{name}: want x (N,), ell (B, N), ls (B, N, M, M); got {tuple(x.shape)}, "
            f"{tuple(ell.shape)}, {tuple(ls.shape)}"
        )
    if n > _MAX_ROWS or b > 65535:
        raise ValueError(f"{name}: N={n}, B={b} exceeds the launch grid")
    return device, dtype, b, n, m


def _svc_gram_tiled_batched_forward(x, ell, ls, jitter) -> torch.Tensor:
    if x.device.type == "cpu":
        return svc_gram_tiled_batched_plain(x, ell, ls, jitter)
    device, dtype, b, n, m = _check_svc_batched("svc_gram_tiled_batched", x, ell, ls)
    out = torch.empty((b, n * m, n * m), dtype=dtype, device=device)
    if b == 0 or n == 0 or m == 0:
        return out
    sched = k3_forward_schedule(n, m, dtype, sm_count(device), batch=b)
    _launch("svc_gram_tiled_batched", dtype, device, x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, b,
            float(jitter), sched.vec, sched.rows, sched.warps, sched.grid, out.data_ptr())
    svc_gram_tiled_batched.launches += 1
    return out


def svc_gram_tiled_batched(x, ell, ls, jitter: float) -> torch.Tensor:
    """K3 for a batch of B members sharing the inputs: ``x`` (N,), ``ell``
    (B, N), ``ls`` (B, N, M, M) → (B, NM, NM), member ``i`` equal to
    ``svc_gram_tiled(x, ell[i], ls[i], jitter)`` bit for bit, in one launch.
    Differentiable in ``ell`` and ``ls`` (through
    :func:`svc_gram_tiled_batched_backward`)."""
    if _needs_grad(x, ell, ls):
        if x.requires_grad:
            raise NotImplementedError("svc_gram_tiled_batched: no gradient with respect to x (x is data: a "
                                      "population sampler moves the latents, never the inducing inputs)")
        return _SvcGramTiledBatched.apply(x, ell, ls, float(jitter))
    return _svc_gram_tiled_batched_forward(x, ell, ls, jitter)


svc_gram_tiled_batched.launches = 0


def svc_gram_tiled_batched_backward_plain(x, ell, ls, jitter: float, kbar):
    """Plain version of the batched K3 backward: each member's
    :func:`svc_gram_tiled_backward_plain`, stacked."""
    bars = [svc_gram_tiled_backward_plain(x, e, l, jitter, k) for e, l, k in zip(ell, ls, kbar)]
    if not bars:
        return torch.zeros_like(ell), torch.zeros_like(ls)
    return torch.stack([e for e, _ in bars]), torch.stack([l for _, l in bars])


def svc_gram_tiled_batched_backward(x, ell, ls, kbar, jitter: float):
    """``(ℓ̄ (B, N), L̄ (B, N, M, M))`` of the batched K3 for the cotangent
    ``kbar`` (B, NM, NM), member ``i`` equal to
    ``svc_gram_tiled_backward(x, ell[i], ls[i], kbar[i], jitter)`` bit for
    bit; one launch of the pair walk and one of the row sums for the batch
    (M ≤ 8), the generic route's three once per member (M > 8)."""
    if x.device.type == "cpu":
        return svc_gram_tiled_batched_backward_plain(x, ell, ls, jitter, kbar)
    device, dtype, b, n, m = _check_svc_batched("svc_gram_tiled_batched_backward", x, ell, ls)
    if kbar.device != device or kbar.dtype != dtype or tuple(kbar.shape) != (b, n * m, n * m):
        raise ValueError(f"svc_gram_tiled_batched_backward: kbar must be ({b}, {n * m}, {n * m}) {dtype} on {device}")
    if not kbar.is_contiguous():
        raise ValueError("svc_gram_tiled_batched_backward: kbar must be contiguous")
    ell_bar = torch.empty((b, n), dtype=dtype, device=device)
    ls_bar = torch.empty((b, n, m, m), dtype=dtype, device=device)
    if b == 0 or n == 0:
        return ell_bar, ls_bar
    sched = k3_backward_schedule(n, m, sm_count(device), batch=b)
    partial = torch.empty(sched.partial_numel, dtype=sched.partial_dtype(dtype), device=device)
    _launch("svc_gram_tiled_batched_backward", dtype, device, x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, b,
            float(jitter), kbar.data_ptr(), sched.tile, sched.grid, partial.data_ptr(), ls_bar.data_ptr(),
            ell_bar.data_ptr())
    svc_gram_tiled_batched_backward.launches += 1
    return ell_bar, ls_bar


svc_gram_tiled_batched_backward.launches = 0


class _SvcGramTiledBatched(torch.autograd.Function):
    """The batched K3 with its batched backward kernel, first order only."""

    @staticmethod
    def forward(ctx, x, ell, ls, jitter):
        ctx.save_for_backward(x, ell, ls)
        ctx.jitter = jitter
        return _svc_gram_tiled_batched_forward(x, ell, ls, jitter)

    @staticmethod
    @first_order_only
    def backward(ctx, kbar):
        x, ell, ls = ctx.saved_tensors
        ell_bar, ls_bar = svc_gram_tiled_batched_backward(x, ell, ls, kbar.contiguous(), ctx.jitter)
        return None, ell_bar, ls_bar, None


_WRAPPERS = {
    "gibbs_gram": gibbs_gram,
    "gibbs_gram_backward": gibbs_gram_backward,
    "gibbs_gram_cross_backward": gibbs_gram_cross_backward,
    "svc_gram": svc_gram,
    "svc_gram_tiled": svc_gram_tiled,
    "svc_gram_tiled_backward": svc_gram_tiled_backward,
    "svc_gram_tiled_batched": svc_gram_tiled_batched,
    "svc_gram_tiled_batched_backward": svc_gram_tiled_batched_backward,
}


#: The backward wrappers that also count the launches asked for x̄ (in
#: ``.input_grad_launches``, a part of ``.launches``).
_INPUT_GRAD_WRAPPERS = ("gibbs_gram_backward", "gibbs_gram_cross_backward", "svc_gram_tiled_backward")


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (and the counts of launches
    asked for x̄)."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for name in _INPUT_GRAD_WRAPPERS:
        _WRAPPERS[name].input_grad_launches = 0


def launches() -> dict[str, int]:
    """Each kernel's launches since the last :func:`reset_launches`."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def input_grad_launches() -> dict[str, int]:
    """The backward kernels' launches asked for x̄ since the last
    :func:`reset_launches` (each also in :func:`launches`)."""
    return {name: _WRAPPERS[name].input_grad_launches for name in _INPUT_GRAD_WRAPPERS}
