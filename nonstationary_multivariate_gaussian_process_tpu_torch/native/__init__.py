"""Native (C++/OpenMP) host kernels, loaded with ctypes.

The port's own copy of the JAX package's ``native`` loader for the windowed
variogram (``variogram.cpp``, a copy of that package's source).  The library
is built with ``g++`` at first use into the port's ``build/`` directory
(ignored by git), named after the hash of its source, with the same flag
ladder: ``-O3 -march=native -fopenmp``, then without OpenMP, then without
``-march=native``.  :func:`available` says whether it loaded; the empirical
initializer's ``method="auto"`` takes it when it does.  Nothing here runs on
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SRC = os.path.join(_HERE, "variogram.cpp")

#: Tried in order until one compiles.
FLAG_LADDER = (
    ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
    ("-O3", "-march=native", "-shared", "-fPIC"),
    ("-O3", "-shared", "-fPIC"),
)

_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False}


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"variogram-{digest}.so")


def _compile(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for flags in FLAG_LADDER:
        try:
            subprocess.run(["g++", *flags, _SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        return True
    return False


def _bind(lib) -> None:
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.local_variogram_fit.argtypes = [dp, dp, i64, i64, i64, i64, dp, dp]
    lib.local_variogram_fit.restype = None
    lib.windowed_cov.argtypes = [dp, i64, i64, i64, dp]
    lib.windowed_cov.restype = None


def _load():
    """The bound library, built first if needed; ``None`` when it cannot be
    built or loaded (tried once per process)."""
    with _lock:
        if _state["lib"] is None and not _state["tried"]:
            _state["tried"] = True
            so = _lib_path()
            if os.path.exists(so) or _compile(so):
                try:
                    lib = ctypes.CDLL(so)
                except OSError:
                    lib = None
                if lib is not None:
                    _bind(lib)
                    _state["lib"] = lib
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native variogram library unavailable (g++ build failed)")
    return lib


def local_variogram_fit(x: np.ndarray, y: np.ndarray, window: int, n_grid: int = 60):
    """Per-point (sigma, ell) variogram estimates averaged over tasks."""
    lib = _require()
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    n, m = y.shape
    sig = np.empty(n)
    ell = np.empty(n)
    lib.local_variogram_fit(x, y, n, m, window, n_grid, sig, ell)
    return sig, ell


def windowed_cov(y: np.ndarray, window: int) -> np.ndarray:
    """Windowed second-moment matrices ``Y_segᵀ Y_seg / (len − 1)``, (N, M, M)."""
    lib = _require()
    y = np.ascontiguousarray(y, np.float64)
    n, m = y.shape
    out = np.empty((n, m, m))
    lib.windowed_cov(y, n, m, window, out)
    return out
