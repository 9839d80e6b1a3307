#!/usr/bin/env python3
"""Time K1's backward kernel against an earlier version of it, in turns, on one card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k1_ab.py --old-source OLD.cu [--out RECORD.json]

``OLD.cu`` is ``csrc/gibbs_gram.cu`` of commit 56c5de2, the parent of the
backward's redesign:

    git show 56c5de2:nonstationary_multivariate_gaussian_process_tpu_torch/csrc/gibbs_gram.cu > chip_checkout/old_k1.cu

Its backward entry points take ``(x, s, l, n, kbar, n_chunks, partial,
s_bar, l_bar, stream)``, with ``n_chunks`` column shares of 16-input tiles
(``min(tiles, ceil(528 / tiles))``, as that commit's wrapper computed it)
and ``n_chunks·n·2`` values of scratch; the script refuses a source whose
backward entry points do not take ``n_chunks``.  The current kernel comes
from the package.

At N=1000 and N=257, in float64 and float32, it:

* holds both kernels against autograd through the plain version (within
  1e-10 (f64) or 1e-4 (f32) of the gradient's largest |entry|) and checks
  that two launches of each are bit-equal;
* times old, new, new, old with a warm L2 (CUDA events over back-to-back
  calls) and with a cold L2 (a 128 MB buffer written before each call, each
  call timed alone), and each kernel's own device time by torch.profiler
  (the new kernel's two launches apart).

It also prints ``nvcc -Xptxas -v`` for both sources' backward kernels.
Every line goes to stdout and the whole record to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k3_ab import HBM_BYTES_PER_S, cold_ms, kernel_ms, ptxas_report, warm_ms  # noqa: E402

GRAD_TOL = {"float64": 1e-10, "float32": 1e-4}
SHAPES = (1000, 257)
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURE = [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P]


def log(msg: str) -> None:
    print(f"[k1_ab] {msg}", flush=True)


def old_n_chunks(n: int) -> int:
    """The parent wrapper's column shares of 16-input tiles."""
    tiles = -(-n // 16)
    return min(tiles, max(1, -(-528 // tiles)))


def max_err(torch, name, got, want, dn) -> float:
    err = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs().max().item()
        if not torch.isfinite(g).all() or not diff <= GRAD_TOL[dn] * w.abs().max().item():
            raise AssertionError(f"{name}: off autograd of the plain version by {diff:.3e}")
        err = max(err, diff)
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--out", help="write the whole record there as JSON")
    args = parser.parse_args()
    with open(args.old_source) as f:
        entry = re.search(r"gibbs_gram_backward_f64\(([^)]*)\)", f.read())
    if entry is None or "n_chunks" not in entry.group(1):
        print(f"k1_ab: {args.old_source} is not the backward of 56c5de2 "
              "(its backward entry points take no n_chunks)", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "rows": []}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    nvcc = cuda_build._nvcc()
    new_src = os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")
    backward = lambda entry: "bwd" in entry
    with tempfile.TemporaryDirectory() as tmp:
        gk.build()
        record["ptxas_new"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, new_src, tmp, backward)
        record["ptxas_old"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, args.old_source, tmp, backward)
        for label in ("new", "old"):
            for line in record[f"ptxas_{label}"]:
                log(f"ptxas {label}: {line}")
        old_lib = os.path.join(tmp, "old.so")
        subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", old_lib, args.old_source], check=True, timeout=600)
        lib = ctypes.CDLL(old_lib)
        old_fns = {}
        for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(lib, f"gibbs_gram_backward_{suffix}")
            fn.argtypes, fn.restype = OLD_SIGNATURE, ctypes.c_int
            old_fns[dtype] = fn

    def old_backward(x, s, l, kbar):
        n = x.shape[0]
        chunks = old_n_chunks(n)
        partial = torch.empty(chunks * n * 2, dtype=x.dtype, device=x.device)
        s_bar, l_bar = torch.empty_like(x), torch.empty_like(x)
        status = old_fns[x.dtype](x.data_ptr(), s.data_ptr(), l.data_ptr(), n, kbar.data_ptr(), chunks,
                                  partial.data_ptr(), s_bar.data_ptr(), l_bar.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old kernel: cudaError_t {status}")
        return s_bar, l_bar

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB
    jitter = 1e-6
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        for n in SHAPES:
            x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
            ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
            s = 0.5 + 1.5 * torch.rand(n, generator=gen, dtype=torch.float64)
            kbar = torch.randn(n, n, generator=gen, dtype=torch.float64)
            x, s, ell, kbar = (t.to(dev, dtype) for t in (x, s, ell, kbar))
            new = lambda: gk.gibbs_gram_backward(x, s, ell, kbar, jitter)
            old = lambda: old_backward(x, s, ell, kbar)
            want = gk.gibbs_gram_backward_plain(x, s, ell, jitter, kbar)
            errs = {}
            for label, fn in (("new", new), ("old", old)):
                first, again = fn(), fn()
                torch.cuda.synchronize()
                errs[label] = max_err(torch, f"{label} N={n} {dn}", first, want, dn)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{label} N={n} {dn}: two launches differ")
            turns = {"old": [], "new": []}
            for label in ("old", "new", "new", "old"):
                turns[label].append(warm_ms(torch, new if label == "new" else old))
            cold = {label: cold_ms(torch, fn, flush) for label, fn in (("old", old), ("new", new))}
            by_kernel = {"new": kernel_ms(torch, new), "old": kernel_ms(torch, old)}
            sched = gk.k1_backward_schedule(n, gk.sm_count(dev))
            nbytes = n * n * size + 5 * n * size
            row = {
                "n": n, "dtype": dn, "max_abs_err": errs, "bit_equal_repeat": True,
                "warm_ms": turns, "cold_ms": cold, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "schedule": {"tile": sched.tile, "grid": sched.grid, "n_pairs": sched.n_pairs,
                             "scratch_bytes": sched.partial_numel * size},
                "old_scratch_bytes": old_n_chunks(n) * n * 2 * size,
                "profile_ms_by_kernel": by_kernel,
            }
            record["rows"].append(row)
            log(f"N={n} {dn}: max abs err new {errs['new']:.3e} old {errs['old']:.3e}; repeats bit-equal; "
                f"warm ms old {turns['old'][0]:.5f}, new {turns['new'][0]:.5f}, new {turns['new'][1]:.5f}, "
                f"old {turns['old'][1]:.5f}; cold ms old {cold['old']:.5f} new {cold['new']:.5f}; "
                f"bound {row['bound_ms']:.5f} ms (bytes); schedule {row['schedule']}; "
                f"old scratch {row['old_scratch_bytes']} B")
            for label, rows in by_kernel.items():
                log(f"N={n} {dn}: {label} device ms by kernel: "
                    + ", ".join(f"{k} {v:.5f}" for k, v in rows.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
