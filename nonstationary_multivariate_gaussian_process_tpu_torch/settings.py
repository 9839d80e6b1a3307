"""Global numerics settings for the PyTorch/CUDA port.

Counterpart of ``nonstationary_multivariate_gaussian_process_tpu.settings``
(reference ``Utility/settings.py``: float64, ``jitter = 1e-6``,
``precision = 1e-6``).

* ``NMGP_X64=1`` (default) or ``NMGP_PRECISION=f64``: float64 everywhere.
* ``NMGP_X64=0`` or ``NMGP_PRECISION=f32``: float32 compute.
* ``NMGP_PRECISION=mixed``: float64 arrays and values, with the large PSD
  logdet and quadratic forms done by the f32-preconditioned corrected kernel
  (``ops/mixed.py``); gradients through it are f32-class.

The port runs eagerly, so there is no compile cache.  Every entry point takes
an explicit ``device``; with none given it runs on ``cuda`` and raises when no
CUDA device is present (it never falls back to the CPU).
"""

from __future__ import annotations

import os

import torch

# float32 matrix products and convolutions stay in full float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def precision_from_env(environ) -> str:
    """Precision mode from ``NMGP_X64`` / ``NMGP_PRECISION`` (as the JAX
    package): ``"f64"``, ``"f32"`` or ``"mixed"``."""
    x64 = environ.get("NMGP_X64", "1") not in ("0", "false", "False")
    mode = environ.get("NMGP_PRECISION", "f64" if x64 else "f32").lower()
    if mode not in ("f64", "f32", "mixed"):
        raise ValueError(f"NMGP_PRECISION must be f64|f32|mixed, got {mode}")
    return mode


def dtype_from_env(environ) -> torch.dtype:
    """Working dtype from ``NMGP_X64`` / ``NMGP_PRECISION``: float64 for
    ``f64`` and ``mixed``, float32 for ``f32``."""
    return torch.float32 if precision_from_env(environ) == "f32" else torch.float64


#: "f64" (default), "f32" or "mixed".
precision_mode = precision_from_env(os.environ)

#: True in the "mixed" mode: large float64 PSD logdet/quadratic forms route
#: through ``ops.mixed.mixed_logdet_quad``.  Callers read it at call time
#: (``settings.mixed_solves``), so it can be switched in a running process.
mixed_solves = precision_mode == "mixed"

#: Default floating dtype for all covariance/posterior computations.
dtype = dtype_from_env(os.environ)

#: Diagonal jitter added to self-covariance matrices (reference: settings.jitter).
jitter = 1e-6

#: Small positive floor for variance clipping (reference: settings.precision).
precision = 1e-6

#: When True (default), dense factorizations run the two-rung jitter ladder
#: (ops.chol.safe_cholesky).  NMGP_ROBUST_CHOL=0 takes the plain factor only.
robust_cholesky = os.environ.get("NMGP_ROBUST_CHOL", "1") not in ("0", "false")


def default_device() -> torch.device:
    """The device entry points use when the caller names none."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means :func:`default_device`.

    Raises when the default is asked for and no CUDA device is present: the
    port never moves work to the CPU unless the caller passes ``"cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return default_device()
    return torch.device(device)
