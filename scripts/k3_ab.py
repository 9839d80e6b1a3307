#!/usr/bin/env python3
"""Time K3's forward kernel against an earlier version of it, in turns, on one card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k3_ab.py --old-source OLD.cu [--out RECORD.json]

``OLD.cu`` is the tiled version of ``csrc/svc_gram_tiled.cu``, the one of
commit b4f5812 (the parent of the forward's redesign):

    git show b4f5812:nonstationary_multivariate_gaussian_process_tpu_torch/csrc/svc_gram_tiled.cu > chip_checkout/old.cu

Its forward entry points take ``(x, ell, ls, n, m, jitter, out, stream)``;
the script refuses a source whose forward entry points take a schedule
(``rows``): the current kernel does.  The current kernel comes from the
package.

At N=1000 M=2 and N=257 M=3, in float64 and float32, it:

* holds both kernels against the plain version (rtol 1e-12 in float64,
  2e-6 with a 1e-7 floor in float32), the current one also against K2's
  input-major layout bit for bit, and checks that two launches of the
  current kernel are bit-equal;
* times old, new, new, old with a warm L2 (CUDA events over back-to-back
  launches) and with a cold L2 (a 128 MB buffer written before each launch,
  each launch timed alone), each kernel's own device time by torch.profiler,
  and the write floor: ``torch.empty((N·M)², dtype).fill_(1.0)``, the same
  bytes written by PyTorch's fill kernel, warm and cold.

It also prints ``nvcc -Xptxas -v`` for both sources' forward kernels.  Every
line goes to stdout and the whole record to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = {"float64": (1e-12, 0.0), "float32": (2e-6, 1e-7)}
SHAPES = ((1000, 2), (257, 3))
OLD_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_double] + [ctypes.c_void_p] * 2


def log(msg: str) -> None:
    print(f"[k3_ab] {msg}", flush=True)


def ptxas_report(nvcc, flags, src, out_dir, wanted=lambda entry: "bwd" not in entry) -> list[str]:
    """``-Xptxas -v`` lines (registers, shared memory, spills) of the
    kernels in ``src`` whose entry line ``wanted`` accepts (by default the
    forward kernels)."""
    proc = subprocess.run(
        [nvcc, *flags, "-Xptxas", "-v", "-o", os.path.join(out_dir, "ptxas.so"), src],
        capture_output=True, text=True, check=True, timeout=600,
    )
    keep, on = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            on = wanted(line)
        if on:
            keep.append(line.strip())
    return keep


def warm_ms(torch, fn, batches=7, reps=50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # the host enqueues while the device sleeps
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def cold_ms(torch, fn, flush, reps=30) -> float:
    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(50_000_000)  # the host enqueues every launch before the device starts
    for _ in range(reps):
        flush.fill_(1.0)  # 128 MB written: the last output no longer sits in the 50 MB L2
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_ms(torch, fn, reps=20) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    self_dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    return {e.key[:60]: self_dev(e) / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and self_dev(e) > 0}


def max_err(torch, name, got, want, dn) -> float:
    rtol, atol = KERNEL_TOL[dn]
    diff = (got - want).abs()
    if not torch.isfinite(got).all() or bool((diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{name}: off the plain version (max abs err {diff.max().item():.3e})")
    return diff.max().item()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--out", help="write the whole record there as JSON")
    args = parser.parse_args()
    with open(args.old_source) as f:
        entry = re.search(r"svc_gram_tiled_f64\(([^)]*)\)", f.read())
    if entry is None or "rows" in entry.group(1):
        print(f"k3_ab: {args.old_source} is not the tiled forward of b4f5812 "
              "(its forward entry points take a schedule)", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "rows": []}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    nvcc = cuda_build._nvcc()
    new_src = os.path.join(cuda_build.CSRC_DIR, "svc_gram_tiled.cu")
    with tempfile.TemporaryDirectory() as tmp:
        gk.build()
        record["ptxas_new"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, new_src, tmp)
        record["ptxas_old"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, args.old_source, tmp)
        for label in ("new", "old"):
            for line in record[f"ptxas_{label}"]:
                log(f"ptxas {label}: {line}")
        old_lib = os.path.join(tmp, "old.so")
        subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", old_lib, args.old_source], check=True, timeout=600)
        lib = ctypes.CDLL(old_lib)
        old_fns = {}
        for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(lib, f"svc_gram_tiled_{suffix}")
            fn.argtypes, fn.restype = OLD_SIGNATURE, ctypes.c_int
            old_fns[dtype] = fn

    def old_forward(x, ell, ls, jitter):
        n, m = ls.shape[0], ls.shape[1]
        out = torch.empty((n * m, n * m), dtype=x.dtype, device=x.device)
        status = old_fns[x.dtype](x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, float(jitter),
                                  out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old kernel: cudaError_t {status}")
        return out

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB
    jitter = 1e-6
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        for n, m in SHAPES:
            x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
            ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
            ls = torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64)) + 2.0 * torch.eye(m, dtype=torch.float64)
            x, ell, ls = (t.to(dev, dtype) for t in (x, ell, ls))
            new = lambda: gk.svc_gram_tiled(x, ell, ls, jitter)
            old = lambda: old_forward(x, ell, ls, jitter)
            fill = lambda: torch.empty((n * m) ** 2, dtype=dtype, device=dev).fill_(1.0)
            want = gk.svc_gram_tiled_plain(x, ell, ls, jitter)
            got = {"new": new(), "old": old()}
            torch.cuda.synchronize()
            errs = {label: max_err(torch, f"{label} N={n} M={m} {dn}", g, want, dn) for label, g in got.items()}
            if not torch.equal(got["new"], gk.svc_gram(x, ell, ls, jitter, "input")):
                raise AssertionError(f"new N={n} M={m} {dn}: not bit-equal to svc_gram input-major")
            if not torch.equal(new(), new()):
                raise AssertionError(f"new N={n} M={m} {dn}: two launches differ")
            turns = {"old": [], "new": []}
            for label in ("old", "new", "new", "old"):
                turns[label].append(warm_ms(torch, new if label == "new" else old))
            cold = {label: cold_ms(torch, fn, flush) for label, fn in (("old", old), ("new", new))}
            floor = {"warm": warm_ms(torch, fill), "cold": cold_ms(torch, fill, flush)}
            by_kernel = {"new": kernel_ms(torch, new), "old": kernel_ms(torch, old), "fill": kernel_ms(torch, fill)}
            sched = gk.k3_forward_schedule(n, m, dtype, gk.sm_count(dev))
            nbytes = (n * m) ** 2 * size + (2 * n + n * m * m) * size
            row = {
                "n": n, "m": m, "dtype": dn, "max_abs_err": errs, "bit_equal_to_plain":
                {label: bool(torch.equal(g, want)) for label, g in got.items()},
                "bit_equal_repeat": True, "warm_ms": turns, "cold_ms": cold, "write_floor_ms": floor,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "schedule": {
                    "route": sched.route, "vec": sched.vec, "rows": sched.rows, "warps": sched.warps,
                    "grid": sched.grid},
                "profile_ms_by_kernel": by_kernel,
            }
            record["rows"].append(row)
            log(f"N={n} M={m} {dn}: max abs err new {errs['new']:.3e} old {errs['old']:.3e}; "
                f"bit-equal to plain {row['bit_equal_to_plain']}; repeat bit-equal; "
                f"warm ms old {turns['old'][0]:.5f}, new {turns['new'][0]:.5f}, new {turns['new'][1]:.5f}, "
                f"old {turns['old'][1]:.5f}; cold ms old {cold['old']:.5f} new {cold['new']:.5f}; "
                f"write floor warm {floor['warm']:.5f} cold {floor['cold']:.5f}; "
                f"bound {row['bound_ms']:.5f} ms (bytes); schedule {row['schedule']}")
            for label, rows in by_kernel.items():
                log(f"N={n} M={m} {dn}: {label} device ms by kernel: "
                    + ", ".join(f"{k} {v:.5f}" for k, v in rows.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
