"""The hand-written CUDA Gram kernels, their plain versions and launch counts.

Counterpart of the JAX package's ``ops/pallas_kernels.py``:

* :func:`gibbs_gram` — kernel K1, ``csrc/gibbs_gram.cu``, replaces
  ``gibbs_gram_pallas``.  The Gibbs kernel of a row strip (x1, σ1, ℓ1) and a
  column strip (x2, σ2, ℓ2); the self form adds the jitter on i == j.
* :func:`svc_gram` — kernel K2, ``csrc/svc_gram.cu``, replaces
  ``svc_gram_fused2d``.  The fused GNMGP Gram
  ``K[(n,a),(p,c)] = (K_x[n,p] + jitter·δ_np)·(L_n L_pᵀ)[a,c]`` in the
  task-major (row ``a·N + n``) or input-major (row ``n·M + a``) layout.

Each wrapper takes its plain PyTorch version for a tensor on the CPU, and
launches its kernel for a CUDA tensor, on the current stream, or raises.  It
counts its launches in a plain integer attribute (``gibbs_gram.launches``),
which a run sets to 0 with :func:`reset_launches` to show afterwards that its
path went through the kernels.  The plain versions (:func:`gibbs_gram_plain`,
:func:`svc_gram_plain`) repeat the kernels' arithmetic operation by operation
and serve the CPU, the tests, and the on-card comparison in ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

KERNEL_SOURCES = ("gibbs_gram", "svc_gram")
LAYOUTS = ("task", "input")

#: Grid rows are blockIdx.y with blocks of 8 rows; CUDA caps gridDim.y.
_MAX_ROWS = 65535 * 8

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "gibbs_gram": [_P, _P, _P, _I, _P, _P, _P, _I, _D, _P, _P],
    "svc_gram": [_P, _P, _P, _I, _I, _D, _I, _P, _P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_fns: dict = {}  # (name, dtype) -> bound ctypes function


def build() -> None:
    """Compile both kernels now (in parallel) rather than at first launch."""
    cuda_build.build(KERNEL_SOURCES)


def _kernel_fn(name: str, dtype: torch.dtype):
    key = (name, dtype)
    if key not in _fns:
        fn = getattr(cuda_build.load(name), f"{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _check_cuda(name: str, tensors: dict, ndims: dict) -> tuple[torch.device, torch.dtype]:
    first = next(iter(tensors.values()))
    device, dtype = first.device, first.dtype
    if device.type != "cuda":
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


def _raise_on(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")


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


def gibbs_gram(x1, s1, l1, x2=None, s2=None, l2=None, jitter: float = 0.0) -> torch.Tensor:
    """``K[i,j] = σ1_iσ2_j·sqrt(2ℓ1_iℓ2_j/(ℓ1_i²+ℓ2_j²))·exp(−(x1_i−x2_j)²/(ℓ1_i²+ℓ2_j²))``.

    Self form (``x2 is None``): the column strip is the row strip and
    ``jitter`` is added on the diagonal.  Cross form: ``jitter`` must be 0.
    Returns (n1, n2).
    """
    if x2 is None:
        x2, s2, l2 = x1, s1, l1
    elif jitter:
        raise ValueError("gibbs_gram: jitter belongs to the self form (x2=None) only")
    if x1.device.type == "cpu":
        return gibbs_gram_plain(x1, s1, l1, x2, s2, l2, jitter)
    tensors = {"x1": x1, "s1": s1, "l1": l1, "x2": x2, "s2": s2, "l2": l2}
    device, dtype = _check_cuda("gibbs_gram", tensors, dict.fromkeys(tensors, 1))
    n1, n2 = x1.shape[0], x2.shape[0]
    if s1.shape[0] != n1 or l1.shape[0] != n1 or s2.shape[0] != n2 or l2.shape[0] != n2:
        raise ValueError("gibbs_gram: each strip's x, sigma and ell must have one length")
    if n1 > _MAX_ROWS or n2 >= 2**31:
        raise ValueError(f"gibbs_gram: strips of {n1} x {n2} exceed the launch grid")
    out = torch.empty((n1, n2), dtype=dtype, device=device)
    if n1 == 0 or n2 == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _kernel_fn("gibbs_gram", dtype)(
            x1.data_ptr(), s1.data_ptr(), l1.data_ptr(), n1,
            x2.data_ptr(), s2.data_ptr(), l2.data_ptr(), n2,
            float(jitter), out.data_ptr(), stream,
        )
    gibbs_gram.launches += 1
    _raise_on("gibbs_gram", status)
    return out


gibbs_gram.launches = 0


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
    (n, a) at row ``a·N + n`` (``models.gnmgp.gram``); ``layout="input"`` at
    row ``n·M + a`` (``svc_gram_fused2d``'s contract).
    """
    _check_layout(layout)
    if x.device.type == "cpu":
        return svc_gram_plain(x, ell, ls, jitter, layout)
    tensors = {"x": x, "ell": ell, "ls": ls}
    device, dtype = _check_cuda("svc_gram", tensors, {"x": 1, "ell": 1, "ls": 3})
    n, m = ls.shape[0], ls.shape[1]
    if x.shape[0] != n or ell.shape[0] != n or ls.shape[2] != m:
        raise ValueError(
            f"svc_gram: want x (N,), ell (N,), ls (N, M, M); got {tuple(x.shape)}, "
            f"{tuple(ell.shape)}, {tuple(ls.shape)}"
        )
    if n > _MAX_ROWS:
        raise ValueError(f"svc_gram: N={n} exceeds the launch grid")
    out = torch.empty((n * m, n * m), dtype=dtype, device=device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _kernel_fn("svc_gram", dtype)(
            x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m,
            float(jitter), int(layout == "input"), out.data_ptr(), stream,
        )
    svc_gram.launches += 1
    _raise_on("svc_gram", status)
    return out


svc_gram.launches = 0


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    gibbs_gram.launches = 0
    svc_gram.launches = 0


def launches() -> dict[str, int]:
    """Each kernel's launches since the last :func:`reset_launches`."""
    return {"gibbs_gram": gibbs_gram.launches, "svc_gram": svc_gram.launches}
