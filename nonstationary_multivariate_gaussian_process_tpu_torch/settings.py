"""Global numerics settings for the PyTorch/CUDA port.

Counterpart of ``nonstationary_multivariate_gaussian_process_tpu.settings``
(reference ``Utility/settings.py``: float64, ``jitter = 1e-6``,
``precision = 1e-6``).

* ``NMGP_X64=1`` (default) or ``NMGP_PRECISION=f64``: float64 everywhere.
* ``NMGP_X64=0`` or ``NMGP_PRECISION=f32``: float32 compute.
* ``NMGP_PRECISION=mixed`` is not ported yet and raises on import.

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


def dtype_from_env(environ) -> torch.dtype:
    """Working dtype from ``NMGP_X64`` / ``NMGP_PRECISION`` (as the JAX package)."""
    x64 = environ.get("NMGP_X64", "1") not in ("0", "false", "False")
    mode = environ.get("NMGP_PRECISION", "f64" if x64 else "f32").lower()
    if mode == "mixed":
        raise ValueError(
            "NMGP_PRECISION=mixed is not yet ported to the torch package "
            "(use f64 or f32)"
        )
    if mode not in ("f64", "f32"):
        raise ValueError(f"NMGP_PRECISION must be f64|f32|mixed, got {mode}")
    return torch.float64 if mode == "f64" else torch.float32


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
