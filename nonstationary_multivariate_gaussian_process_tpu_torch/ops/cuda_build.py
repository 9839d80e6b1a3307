"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``.  Nothing here includes
PyTorch's headers, so a build takes seconds.  A library is named after the
hash of its source and flags and lives in the package's ``build/`` directory
(ignored by git): a changed source is rebuilt at its next use, an unchanged
one is loaded as it is.  Building happens at first use, never on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

#: No fast math: exp/sqrt/division stay IEEE-accurate.  -fmad=false keeps
#: every multiply and add rounded on its own, as the plain PyTorch versions'
#: separate elementwise operations are.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names) -> None:
    """Compile every named source that has no current library, all at once
    (one ``nvcc`` for each source, started together)."""
    todo = [(name, path) for name in names if not os.path.exists(path := _lib_path(name))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for name, path in todo:
            tmp = f"{path}.{os.getpid()}.tmp"
            src = os.path.join(CSRC_DIR, name + ".cu")
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            )
            jobs.append((name, path, tmp, proc))
        for name, path, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
                    + log.decode(errors="replace")
                )
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    finally:
        for _, _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]
