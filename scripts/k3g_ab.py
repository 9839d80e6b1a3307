#!/usr/bin/env python3
"""Time K3's generic routes (M > 8) against an earlier tree's, in turns, on one card, and a GNMGP gradient at M = 9 on both trees.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/k3g_ab.py --old-root OLD [--out RECORD.json]

``OLD`` is a checkout of commit 7585f59, whose generic routes are the first
ones (the forward one block per 16 x 16 tile of input pairs, the backward
one block per row input):

    mkdir -p chip_checkout/parent && git archive 7585f59 | tar -x -C chip_checkout/parent

The script refuses a tree whose ``csrc/svc_gram_tiled.cu`` lacks that
backward (``one block per row input``).  Both sources export the same entry
points; the old generic routes take ``vec = 1, rows = 16`` (forward) and
``tile = 1, grid = N`` and no partials (backward), as that commit's wrapper
passed them.  The current kernels come from the package.

Kernels: at (N, M) = (200, 9), (1000, 9), (500, 16), (200, 32) and (64, 9),
in float64 and float32, it

* holds both forwards against the plain version bit for bit, both backwards
  against autograd through the plain version (within 1e-10 (f64) or 1e-4
  (f32) of the gradient's largest |entry|), and checks that two launches of
  each new route are bit-equal;
* times old, new, new, old with a warm L2 (CUDA events over back-to-back
  calls) and with a cold L2 (a 128 MB buffer written before each call), and
  each route's device kernels by torch.profiler;
* prints each route's bound, the larger of its bytes (each input read once,
  each output written once) over 3.35 TB/s and its operations over the peak
  rate of their type (34 TFLOP/s f64, 67 f32), and the new backward's
  scratch.

It also prints ``nvcc -Xptxas -v`` (registers, spills) for both sources'
generic kernels.  Then the gradient: ``chip_smoke.generic_gradient`` (the
GNMGP f64 gradient at N=1000, M=9: launches, gradient evaluations/s, device
ms by kernel) of this tree's ``chip_smoke.py`` run against the old tree's
package, this tree's, this tree's and the old tree's, each turn a process of its own that imports only that tree's
package (so each builds and uses its own kernels).  Every line goes to
stdout and the whole record to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k3_ab import HBM_BYTES_PER_S, cold_ms, kernel_ms, ptxas_report, warm_ms  # noqa: E402

SRC = os.path.join("nonstationary_multivariate_gaussian_process_tpu_torch", "csrc", "svc_gram_tiled.cu")
SHAPES = ((200, 9), (1000, 9), (500, 16), (200, 32), (64, 9))
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
GRAD_TOL = {"float64": 1e-10, "float32": 1e-4}
JITTER = 1e-6
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
FWD_SIGNATURE = [_P, _P, _P, _I, _I, _D, _I, _I, _I, _I, _P, _P]
BWD_SIGNATURE = [_P, _P, _P, _I, _I, _D, _P, _I, _I, _P, _P, _P, _P]


def log(msg: str) -> None:
    print(f"[k3g_ab] {msg}", flush=True)


def grad_err(torch, label, got, want, dn) -> float:
    err = 0.0
    for g, w in zip(got, want):
        diff, scale = (g - w).abs().max().item(), w.abs().max().item()
        if not torch.isfinite(g).all() or not diff <= GRAD_TOL[dn] * scale:
            raise AssertionError(f"{label}: off autograd of the plain version by {diff:.3e} (scale {scale:.3e})")
        err = max(err, diff)
    return err


def load_smoke():
    """This tree's chip_smoke.py as a module (its package imports are made
    inside its functions, from whichever tree leads sys.path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str, seed: int, smoke_fn: str = "generic_gradient", log=log) -> int:
    """One turn: ``root``'s package built, then ``chip_smoke.<smoke_fn>`` on
    it, its result printed as a ``RESULT`` line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    if not os.path.abspath(gk.__file__).startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {gk.__file__}, not {root}'s package")
    t0 = time.perf_counter()
    gk.build()
    for name in gk.KERNEL_SOURCES:
        cuda_build.load(name)
    log(f"built in {time.perf_counter() - t0:.3f} s")
    res = getattr(load_smoke(), smoke_fn)(torch, np, gk, seed)
    print("RESULT " + json.dumps(res), flush=True)
    return 0


def turns(script: str, what: str, old_root: str, seed: int) -> list:
    """Old, new, new, old: each turn ``script --child ROOT`` in a process of
    its own that imports only that tree's package; their results."""
    out = []
    for which in ("old", "new", "new", "old"):
        root = os.path.abspath(old_root) if which == "old" else ROOT
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(script), "--child", root, "--seed", str(seed)],
                             cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=1200)
        lines = run.stdout.splitlines()
        for line in lines:
            if not line.startswith("RESULT "):
                print(f"[{which}] {line}", flush=True)
        if run.returncode != 0:
            raise RuntimeError(f"the {which} {what} turn failed (rc {run.returncode})")
        res = json.loads(next(line for line in lines if line.startswith("RESULT "))[7:])
        res.update(tree=which, turn_seconds=time.perf_counter() - t0)
        out.append(res)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-root", help="the earlier tree's root")
    parser.add_argument("--out", help="write the whole record there as JSON")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--child", help=argparse.SUPPRESS)  # one gradient turn: the tree's root
    args = parser.parse_args()
    if args.child:
        return child(args.child, args.seed)
    old_src = os.path.join(args.old_root or "", SRC)
    if not args.old_root or not os.path.isfile(old_src):
        print("k3g_ab: --old-root must name a tree with " + SRC, file=sys.stderr)
        return 2
    with open(old_src) as f:
        if "M > 8, any M: one block per row input n" not in f.read():
            print(f"k3g_ab: {old_src} does not hold the first generic routes (7585f59's)", file=sys.stderr)
            return 2

    import torch

    if not torch.cuda.is_available():
        print("k3g_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "rows": []}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

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
            fwd, bwd = getattr(lib, f"svc_gram_tiled_{suffix}"), getattr(lib, f"svc_gram_tiled_backward_{suffix}")
            fwd.argtypes, fwd.restype = FWD_SIGNATURE, ctypes.c_int
            bwd.argtypes, bwd.restype = BWD_SIGNATURE, ctypes.c_int
            old_fns[dtype] = (fwd, bwd)

    def old_forward(x, ell, ls):
        n, m = ls.shape[0], ls.shape[1]
        out = torch.empty((n * m, n * m), dtype=x.dtype, device=x.device)
        tiles = -(-n // 16)
        status = old_fns[x.dtype][0](x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, JITTER, 1, 16, 8,
                                     tiles * tiles, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old forward: cudaError_t {status}")
        return out

    def old_backward(x, ell, ls, kbar):
        n, m = ls.shape[0], ls.shape[1]
        ell_bar = torch.empty(n, dtype=x.dtype, device=x.device)
        ls_bar = torch.empty((n, m, m), dtype=x.dtype, device=x.device)
        status = old_fns[x.dtype][1](x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, JITTER, kbar.data_ptr(),
                                     1, n, None, ls_bar.data_ptr(), ell_bar.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"old backward: cudaError_t {status}")
        return ell_bar, ls_bar

    gen = torch.Generator().manual_seed(args.seed)
    dev = torch.device("cuda")
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB
    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        for n, m in SHAPES:
            nm = n * m
            x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
            ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
            ls = torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64)) + 2.0 * torch.eye(m, dtype=torch.float64)
            kbar = torch.randn(nm, nm, generator=gen, dtype=torch.float64)
            x, ell, ls, kbar = (t.to(dev, dtype) for t in (x, ell, ls, kbar))
            tag = f"N={n} M={m} {dn}"
            routes = {
                "forward": {"new": lambda: gk.svc_gram_tiled(x, ell, ls, JITTER), "old": lambda: old_forward(x, ell, ls)},
                "backward": {"new": lambda: gk.svc_gram_tiled_backward(x, ell, ls, kbar, JITTER),
                             "old": lambda: old_backward(x, ell, ls, kbar)},
            }
            want = gk.svc_gram_tiled_plain(x, ell, ls, JITTER)
            for label in ("new", "old"):
                if not torch.equal(routes["forward"][label](), want):
                    raise AssertionError(f"{label} forward {tag}: not bit-equal to the plain version")
            del want
            if not torch.equal(routes["forward"]["new"](), routes["forward"]["new"]()):
                raise AssertionError(f"new forward {tag}: two launches differ")
            want = gk.svc_gram_tiled_backward_plain(x, ell, ls, JITTER, kbar)
            errs = {label: grad_err(torch, f"{label} backward {tag}", routes["backward"][label](), want, dn)
                    for label in ("new", "old")}
            del want
            if not all(torch.equal(a, b) for a, b in zip(routes["backward"]["new"](), routes["backward"]["new"]())):
                raise AssertionError(f"new backward {tag}: two launches differ")
            torch.cuda.synchronize()
            in_bytes = (2 * n + n * m * m) * size
            bounds = {
                "forward": {"bytes_ms": (nm * nm * size + in_bytes) / HBM_BYTES_PER_S * 1e3,
                            "operations_ms": (12 * n * n + 2 * m * nm * nm) / PEAK_FLOPS[dn] * 1e3},
                "backward": {"bytes_ms": (nm * nm * size + 2 * in_bytes + n * size) / HBM_BYTES_PER_S * 1e3,
                             "operations_ms": (25 * n * n + (2 * m + 1) * nm * nm) / PEAK_FLOPS[dn] * 1e3},
            }
            bsched = gk.k3_backward_schedule(n, m, gk.sm_count(dev))
            for route, fns in routes.items():
                turns = {"old": [], "new": []}
                for label in ("old", "new", "new", "old"):
                    turns[label].append(warm_ms(torch, fns[label], reps=10 if label == "old" else 50))
                cold = {label: cold_ms(torch, fns[label], flush, reps=10) for label in ("old", "new")}
                by_kernel = {label: kernel_ms(torch, fns[label], reps=5) for label in ("old", "new")}
                b = bounds[route]
                bound = max(b["bytes_ms"], b["operations_ms"])
                new_ms = min(turns["new"])
                row = {"route": route, "n": n, "m": m, "dtype": dn, "warm_ms": turns, "cold_ms": cold,
                       "bound_ms": bound, "bound_by": "bytes" if b["bytes_ms"] >= b["operations_ms"] else "operations",
                       **b, "share_of_bound_new": bound / new_ms, "profile_ms_by_kernel": by_kernel,
                       "scratch_bytes_new": bsched.scratch_bytes(dtype) if route == "backward" else 0}
                if route == "backward":
                    row["max_abs_err"] = errs
                record["rows"].append(row)
                log(f"{route} {tag}: warm ms old {turns['old'][0]:.5f}, new {turns['new'][0]:.5f}, new "
                    f"{turns['new'][1]:.5f}, old {turns['old'][1]:.5f}; cold ms old {cold['old']:.5f} new "
                    f"{cold['new']:.5f}; bound {bound:.5f} ms ({row['bound_by']}; bytes {b['bytes_ms']:.5f}, "
                    f"operations {b['operations_ms']:.5f}), new at {100 * bound / new_ms:.1f}% of it"
                    + (f"; scratch {row['scratch_bytes_new']} B; max abs err new {errs['new']:.3e} old "
                       f"{errs['old']:.3e}" if route == "backward" else "; both bit-equal to the plain version"))
                for label, rows in by_kernel.items():
                    log(f"{route} {tag}: {label} device ms by kernel: "
                        + ", ".join(f"{k} {v:.5f}" for k, v in rows.items()))
            del x, ell, ls, kbar, routes
    record["gradient"] = turns(__file__, "gradient", args.old_root, args.seed)
    for t in record["gradient"]:
        log(f"gradient {t['tree']}: {t['rate']:.3f} gradient evaluations/s, device {t['device_ms']:.3f} ms "
            f"(K3's routes {t['k3_ms']:.4f} ms), wall {t['wall_ms']:.3f} ms, value {t['value']:.10e}, "
            f"launches {t['launches']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
