#!/usr/bin/env python3
"""Time K2's generic route (M > 4) against an earlier tree's, in turns, on one card, and a GNMGP prediction at M = 9 on both trees.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k2g_ab.py --old-root OLD [--out RECORD.json] [--groups N:M:DTYPE:ROWSxCOLS ...]

``OLD`` is a checkout of commit 125ef4c, whose generic route is the first
one (one thread per input pair on blocks of 32 x 8, scalar stores):

    mkdir -p chip_checkout/parent && git archive 125ef4c | tar -x -C chip_checkout/parent

The script refuses a tree whose ``csrc/svc_gram.cu`` lacks that route.  The
old entry points take ``vec = 1, rows = 8, warps = 8`` and ``grid`` =
⌈N/32⌉·⌈N/8⌉ on the generic route, as that commit's wrapper passed them.
The current kernel comes from the package.

Kernel: at (N, M) = (1000, 9), (1000, 5), (500, 16), (200, 32) and (64, 9),
in float64 and float32, it

* holds both routes against the plain version bit for bit, and checks that
  two launches of the new route are bit-equal;
* times old, new, new, old with a warm L2 (CUDA events over back-to-back
  calls) and with a cold L2 (a 128 MB buffer written before each call), and
  each route's device kernels by torch.profiler;
* where ``--groups`` names the shape (for example ``500:16:float64:8x4``),
  also times the new route with those row and column task groups in place
  of its schedule's (same b chunk and grid rule), in the turns old, new,
  groups, groups, new, old, and holds it bit for bit too;
* prints the bound, the larger of the bytes (each input read once, each
  output written once) over 3.35 TB/s and the operations (12 a Gibbs term,
  2 M an output) over the peak rate of their type (34 TFLOP/s f64, 67 f32),
  and the new route's schedule.

It also prints ``nvcc -Xptxas -v`` (registers, spills) for both sources'
generic kernels.  Then the prediction: ``chip_smoke.generic_prediction``
(``predict_map`` and a 10-draw ``predict_sample`` at N=1000, M=9, f64:
launches, wall and device ms, device ms by kernel, K2's share) of this
tree's ``chip_smoke.py`` run against the old tree's package, this tree's,
this tree's and the old tree's, each turn a process of its own that imports
only that tree's package (so each builds and uses its own kernels).  Every
line goes to stdout and the whole record to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k3_ab import HBM_BYTES_PER_S, cold_ms, kernel_ms, ptxas_report, warm_ms  # noqa: E402
from k3g_ab import PEAK_FLOPS, child, turns  # noqa: E402

SRC = os.path.join("nonstationary_multivariate_gaussian_process_tpu_torch", "csrc", "svc_gram.cu")
SHAPES = ((1000, 9), (1000, 5), (500, 16), (200, 32), (64, 9))
JITTER = 1e-6
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
OLD_SIGNATURE = [_P, _P, _P, _I, _I, _D, _I, _I, _I, _I, _P, _P]


def log(msg: str) -> None:
    print(f"[k2g_ab] {msg}", flush=True)


def kernel_ab(torch, gk, old_root: str, seed: int, record: dict, groups: dict) -> None:
    """The kernel rows of the record: both routes at SHAPES in both types,
    and the new route with ``groups[(n, m, dtype name)]`` = (row tasks,
    column tasks) where given."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build

    old_src = os.path.join(old_root, SRC)
    nvcc = cuda_build._nvcc()
    generic = lambda entry: "generic" in entry
    with tempfile.TemporaryDirectory() as tmp:
        gk.build()
        for label, src in (("new", os.path.join(ROOT, SRC)), ("old", old_src)):
            record[f"ptxas_{label}"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, src, tmp, generic)
            for line in record[f"ptxas_{label}"]:
                log(f"ptxas {label}: {line}")
        old_lib = os.path.join(tmp, "old.so")
        subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", old_lib, old_src], check=True, timeout=600)
        lib = ctypes.CDLL(old_lib)
        old_fns = {}
        for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
            fn = getattr(lib, f"svc_gram_{suffix}")
            fn.argtypes, fn.restype = OLD_SIGNATURE, ctypes.c_int
            old_fns[dtype] = fn

    def old_route(x, ell, ls):
        n, m = ls.shape[0], ls.shape[1]
        out = torch.empty((n * m, n * m), dtype=x.dtype, device=x.device)
        grid = -(-n // 32) * -(-n // 8)
        status = old_fns[x.dtype](x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, JITTER, 1, 8, 8, grid,
                                  out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old route: cudaError_t {status}")
        return out

    gen = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    sms = gk.sm_count(dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        for n, m in SHAPES:
            nm = n * m
            x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
            ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
            ls = torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64)) + 2.0 * torch.eye(m, dtype=torch.float64)
            x, ell, ls = (t.to(dev, dtype) for t in (x, ell, ls))
            tag = f"N={n} M={m} {dn}"
            sched = gk.k2_schedule(n, m, dtype, sms)
            fns = {"new": lambda: gk.svc_gram(x, ell, ls, JITTER), "old": lambda: old_route(x, ell, ls)}
            order = ("old", "new", "new", "old")
            if (n, m, dn) in groups:
                a, c = groups[n, m, dn]
                alt = dataclasses.replace(sched, row_tasks=a, col_tasks=c,
                                          smem_bytes=size * (a + c) * sched.b_chunk * 68)
                alt = dataclasses.replace(alt, grid=min(alt.n_units, 2 * sms))
                fns["groups"] = lambda alt=alt: gk._k2_launch(alt, x, ell, ls, JITTER,
                                                               torch.empty((nm, nm), dtype=dtype, device=dev))
                order = ("old", "new", "groups", "groups", "new", "old")
            want = gk.svc_gram_plain(x, ell, ls, JITTER)
            for label in fns:
                if not torch.equal(fns[label](), want):
                    raise AssertionError(f"{label} route {tag}: not bit-equal to the plain version")
            del want
            if not torch.equal(fns["new"](), fns["new"]()):
                raise AssertionError(f"new route {tag}: two launches differ")
            torch.cuda.synchronize()
            bytes_ms = (nm * nm + 2 * n + n * m * m) * size / HBM_BYTES_PER_S * 1e3
            operations_ms = (12 * n * n + 2 * m * nm * nm) / PEAK_FLOPS[dn] * 1e3
            bound = max(bytes_ms, operations_ms)
            warm = {label: [] for label in fns}
            for label in order:
                warm[label].append(warm_ms(torch, fns[label], reps=10 if label == "old" else 50))
            cold = {label: cold_ms(torch, fns[label], flush, reps=10) for label in fns}
            by_kernel = {label: kernel_ms(torch, fns[label], reps=5) for label in fns}
            new_ms = min(warm["new"])
            row = {"n": n, "m": m, "dtype": dn, "warm_ms": warm, "cold_ms": cold, "bound_ms": bound,
                   "bound_by": "bytes" if bytes_ms >= operations_ms else "operations", "bytes_ms": bytes_ms,
                   "operations_ms": operations_ms, "share_of_bound_new": bound / new_ms,
                   "profile_ms_by_kernel": by_kernel,
                   "schedule": {"vec": sched.vec, "row_tasks": sched.row_tasks, "col_tasks": sched.col_tasks,
                                "b_chunk": sched.b_chunk, "units": sched.n_units, "grid": sched.grid,
                                "smem_bytes": sched.smem_bytes}}
            if "groups" in fns:
                row["groups"] = {"row_tasks": alt.row_tasks, "col_tasks": alt.col_tasks, "units": alt.n_units,
                                 "grid": alt.grid, "smem_bytes": alt.smem_bytes}
                log(f"{tag}: groups {alt.row_tasks} x {alt.col_tasks} ({alt.n_units} units) warm ms "
                    f"{warm['groups'][0]:.5f}, {warm['groups'][1]:.5f}, cold {cold['groups']:.5f}, against the "
                    f"schedule's {sched.row_tasks} x {sched.col_tasks} ({sched.n_units} units) {new_ms:.5f}")
            record["rows"].append(row)
            log(f"{tag}: warm ms old {warm['old'][0]:.5f}, new {warm['new'][0]:.5f}, new {warm['new'][1]:.5f}, "
                f"old {warm['old'][1]:.5f}; cold ms old {cold['old']:.5f} new {cold['new']:.5f}; bound "
                f"{bound:.5f} ms ({row['bound_by']}; bytes {bytes_ms:.5f}, operations {operations_ms:.5f}), new at "
                f"{100 * bound / new_ms:.1f}% of it; both bit-equal to the plain version; new schedule "
                f"{row['schedule']}")
            for label, rows in by_kernel.items():
                log(f"{tag}: {label} device ms by kernel: " + ", ".join(f"{k} {v:.5f}" for k, v in rows.items()))
            del x, ell, ls, fns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-root", help="the earlier tree's root")
    parser.add_argument("--out", help="write the whole record there as JSON")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--groups", action="append", default=[], metavar="N:M:DTYPE:ROWSxCOLS",
                        help="also time the new route with these task groups at that shape")
    parser.add_argument("--child", help=argparse.SUPPRESS)  # one prediction turn: the tree's root
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.seed, "generic_prediction", log)
    old_src = os.path.join(args.old_root or "", SRC)
    if not args.old_root or not os.path.isfile(old_src):
        print("k2g_ab: --old-root must name a tree with " + SRC, file=sys.stderr)
        return 2
    with open(old_src) as f:
        if "M > 4, any M: one thread per input pair (n, p)" not in f.read():
            print(f"k2g_ab: {old_src} does not hold the first generic route (125ef4c's)", file=sys.stderr)
            return 2

    import torch

    if not torch.cuda.is_available():
        print("k2g_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "rows": []}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    groups = {}
    for spec in args.groups:
        n, m, dn, ac = spec.split(":")
        groups[int(n), int(m), dn] = tuple(int(v) for v in ac.split("x"))
    kernel_ab(torch, gk, args.old_root, args.seed, record, groups)
    record["prediction"] = turns(__file__, "prediction", args.old_root, args.seed)
    for t in record["prediction"]:
        for mode in ("map", "sample"):
            r = t[mode]
            log(f"prediction {t['tree']} {mode}: wall {r['wall_ms']:.3f} ms, device {r['device_ms']:.3f} ms, "
                f"K2 {r['k2_ms']:.4f} ms ({100 * r['k2_ms'] / r['device_ms']:.1f}% of the device time), "
                f"launches {r['launches']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
