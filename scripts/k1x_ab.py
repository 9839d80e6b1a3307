#!/usr/bin/env python3
"""Time K1's cross-form backward against its earlier version, in turns, on one card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k1x_ab.py --old-source OLD.cu [--out RECORD.json]

``OLD.cu`` is ``csrc/gibbs_gram.cu`` of commit 295daf7, whose cross-form
backward takes two launches (row strips of 8, 16 or 32 rows, then the self
form's reduction of the per-block column partials):

    git show 295daf7:nonstationary_multivariate_gaussian_process_tpu_torch/csrc/gibbs_gram.cu > chip_checkout/old_k1x.cu

Its entry points take ``(x1, s1, l1, n1, x2, s2, l2, n2, kbar,
rows_per_warp, grid, partial, s1_bar, l1_bar, s2_bar, l2_bar, stream)``, with
``rows_per_warp`` the most of 4, 2 that still gives every SM a block (else
1), ``grid = ceil(n1 / (8 rows_per_warp))`` and ``grid·n2·2`` values of
scratch, as that commit's wrapper computed them; the script refuses a
source whose entry points take no ``rows_per_warp``.  The current kernel
comes from the package.

At 2000 x 64 and 2000 x 128 (the sparse path's K_xz at m_z = 64 and 128),
1000 x 256, 20,000 x 64 (the N = 20,000 rate's) and 20,000 x 256, in
float64 and float32, it:

* holds both kernels against autograd through the plain version (within
  1e-10 (f64) or 1e-4 (f32) of the gradient's largest |entry|), checks that
  launches of each are bit-equal (the current kernel's over 20 launches, in
  which blocks finish in different orders) and that the current kernel
  leaves its tickets at 0;
* times old, new, new, old with a warm L2 (CUDA events over back-to-back
  calls) and with a cold L2 (a 128 MB buffer written before each call, each
  call timed alone), and each kernel's own device time by torch.profiler
  (the current kernel must be one device kernel a call).

Then a sweep of the current kernel's schedule at each shape in both types:
strip heights of 32 to 256 rows by 1, 2, 4 and 8 column groups (as many as
the chunks allow), each checked against the plain version and timed warm.  It also prints ``nvcc
-Xptxas -v`` for both sources' cross-form kernels.  Every line goes to
stdout and the whole record to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
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
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
SHAPES = ((2000, 64), (2000, 128), (1000, 256), (20000, 64), (20000, 256))
SWEEP_ROWS = (32, 64, 96, 128, 160, 256)
SWEEP_GROUPS = (1, 2, 4, 8)
REPEATS = 20
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURE = [_P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P]


def log(msg: str) -> None:
    print(f"[k1x_ab] {msg}", flush=True)


def old_schedule(n1: int, sms: int) -> tuple[int, int]:
    """295daf7's (rows_per_warp, grid): strips of 8 warps' rows."""
    rpw = next((r for r in (4, 2) if -(-n1 // (8 * r)) >= sms), 1)
    return rpw, -(-n1 // (8 * rpw))


def grad_err(torch, label, got, want, dn) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: shape {tuple(g.shape)} or non-finite values")
        diff, scale = (g - w).abs().max().item(), w.abs().max().item()
        if not diff <= GRAD_TOL[dn] * scale:
            raise AssertionError(f"{label}: off by {diff:.3e} against a scale of {scale:.3e}")
        err = max(err, diff)
    return err


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-source", required=True)
    parser.add_argument("--out", help="write the whole record there as JSON")
    args = parser.parse_args()
    with open(args.old_source) as f:
        entry = re.search(r"int gibbs_gram_cross_backward_f64\(([^)]*)\)", f.read())
    if entry is None or "rows_per_warp" not in entry.group(1):
        print(f"k1x_ab: {args.old_source} is not K1 of 295daf7 (its cross-form backward takes no rows_per_warp)",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("k1x_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "rows": [], "sweep": []}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    nvcc = cuda_build._nvcc()
    cross = lambda entry: "cross_bwd" in entry or "bwd_reduce" in entry
    old_fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        gk.build()
        for label, src in (("new", os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")), ("old", args.old_source)):
            record[f"ptxas_{label}"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, src, tmp, cross)
            for line in record[f"ptxas_{label}"]:
                log(f"ptxas {label}: {line}")
        lib_path = os.path.join(tmp, "old_k1x.so")
        subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib_path, args.old_source], check=True, timeout=600)
        lib = ctypes.CDLL(lib_path)
        for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(lib, f"gibbs_gram_cross_backward_{suffix}")
            fn.argtypes, fn.restype = OLD_SIGNATURE, ctypes.c_int
            old_fns[dtype] = fn

    dev = torch.device("cuda")
    sms = gk.sm_count(dev)

    def old(x1, s1, l1, x2, s2, l2, kbar):
        n1, n2 = x1.shape[0], x2.shape[0]
        rpw, grid = old_schedule(n1, sms)
        outs = [torch.empty(n, dtype=x1.dtype, device=dev) for n in (n1, n1, n2, n2)]
        partial = torch.empty(grid * n2 * 2, dtype=x1.dtype, device=dev)
        status = old_fns[x1.dtype](x1.data_ptr(), s1.data_ptr(), l1.data_ptr(), n1, x2.data_ptr(), s2.data_ptr(),
                                   l2.data_ptr(), n2, kbar.data_ptr(), rpw, grid, partial.data_ptr(),
                                   *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old cross backward: cudaError_t {status}")
        return tuple(outs)

    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB

    def inputs(n, dtype):
        x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
        ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
        s = 0.5 + 1.5 * torch.rand(n, generator=gen, dtype=torch.float64)
        return [t.to(dev, dtype) for t in (x, s, ell)]

    def bit_equal(outs_a, outs_b) -> bool:
        return all(torch.equal(a, b) for a, b in zip(outs_a, outs_b))

    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        for n1, n2 in SHAPES:
            args_ = (*inputs(n1, dtype), *inputs(n2, dtype),
                     torch.randn(n1, n2, generator=gen, dtype=torch.float64).to(dev, dtype))
            label = f"{n1}x{n2} {dn}"
            new_fn = lambda: gk.gibbs_gram_cross_backward(*args_)
            old_fn = lambda: old(*args_)
            want = gk.gibbs_gram_cross_backward_plain(*args_)
            first = {"new": new_fn(), "old": old_fn()}
            torch.cuda.synchronize()
            errs = {k: grad_err(torch, f"{k} {label}", g, want, dn) for k, g in first.items()}
            repeat = {k: all(bit_equal(first[k], fn()) for _ in range(REPEATS))
                      for k, fn in (("new", new_fn), ("old", old_fn))}
            if not repeat["new"]:
                raise AssertionError(f"new {label}: launches on the same inputs differ")
            torch.cuda.synchronize()
            if gk._tickets_for(dev, 1).count_nonzero().item() != 0:
                raise AssertionError(f"new {label}: a ticket is not back at 0")
            turns = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                turns[which].append(warm_ms(torch, new_fn if which == "new" else old_fn))
            cold = {which: cold_ms(torch, fn, flush) for which, fn in (("old", old_fn), ("new", new_fn))}
            by_kernel = {"new": kernel_ms(torch, new_fn), "old": kernel_ms(torch, old_fn)}
            if len(by_kernel["new"]) != 1:
                raise AssertionError(f"new {label}: {len(by_kernel['new'])} device kernels a call, not 1")
            sched = gk.k1_cross_backward_schedule(n1, n2, sms)
            bytes_ms = (n1 * n2 + 5 * (n1 + n2)) * size / HBM_BYTES_PER_S * 1e3
            ops_ms = n1 * n2 * 32 / PEAK_FLOPS[dn] * 1e3
            row = {
                "shape": [n1, n2], "dtype": dn, "max_abs_err": errs, "repeat_bit_equal": repeat,
                "warm_ms": turns, "cold_ms": cold, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "schedule": {**dataclasses.asdict(sched), "grid": sched.grid, "n_slots": sched.n_slots},
                "scratch_bytes": {"new": sched.slots_numel * size, "old": old_schedule(n1, sms)[1] * n2 * 2 * size},
                "old_schedule": dict(zip(("rows_per_warp", "grid"), old_schedule(n1, sms))),
                "profile_ms_by_kernel": by_kernel,
            }
            record["rows"].append(row)
            log(f"{label}: max abs err new {errs['new']:.3e} old {errs['old']:.3e}; {REPEATS + 1} launches bit-equal "
                f"{repeat}; warm ms old {turns['old'][0]:.5f}, new {turns['new'][0]:.5f}, new {turns['new'][1]:.5f}, "
                f"old {turns['old'][1]:.5f}; cold ms old {cold['old']:.5f} new {cold['new']:.5f}; bound "
                f"{row['bound_ms']:.5f} ms ({row['bound_by']}); scratch bytes {row['scratch_bytes']}; schedule "
                f"{row['schedule']}; old {row['old_schedule']}")
            for which, kernels in by_kernel.items():
                log(f"{label}: {which} device ms by kernel: " + ", ".join(f"{k} {v:.5f}" for k, v in kernels.items()))
            # the sweep: the current kernel under other strip heights and column groups
            n_chunks = -(-n2 // gk.K1CrossBackwardSchedule.chunk)
            groups = sorted({gk.k1x_column_groups(n_chunks, g) for g in SWEEP_GROUPS})
            for rows, col_groups in itertools.product(SWEEP_ROWS, groups):
                s = gk.K1CrossBackwardSchedule(n1, n2, rows, col_groups)
                fn = lambda s=s: gk._k1x_launch(s, *args_)
                got = fn()
                tag = f"rows {rows} column groups {col_groups}"
                err = grad_err(torch, f"sweep {label} {tag}", got, want, dn)
                if not bit_equal(got, fn()):
                    raise AssertionError(f"sweep {label} {tag}: two launches differ")
                ms = warm_ms(torch, fn)
                record["sweep"].append({"shape": [n1, n2], "dtype": dn, "rows": rows, "col_groups": col_groups,
                                        "grid": s.grid, "n_slots": s.n_slots, "warm_ms": ms, "max_abs_err": err,
                                        "default": s == sched})
                log(f"sweep {label}: {tag} (grid {s.grid}, {s.n_slots} slots): "
                    f"{ms:.5f} ms warm{' (the schedule)' if s == sched else ''}")

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
