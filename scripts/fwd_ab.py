#!/usr/bin/env python3
"""Time K1's forward and K2 against their earlier versions, in turns, on one card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/fwd_ab.py --old-gibbs OLD_K1.cu --old-svc OLD_K2.cu [--out RECORD.json]

``OLD_K1.cu`` and ``OLD_K2.cu`` are ``csrc/gibbs_gram.cu`` and
``csrc/svc_gram.cu`` of commit dde4b95, the parent of both redesigns:

    git show dde4b95:nonstationary_multivariate_gaussian_process_tpu_torch/csrc/gibbs_gram.cu > chip_checkout/old_k1.cu
    git show dde4b95:nonstationary_multivariate_gaussian_process_tpu_torch/csrc/svc_gram.cu > chip_checkout/old_k2.cu

Their entry points are ``gibbs_gram_f32/f64(x1, s1, l1, n1, x2, s2, l2, n2,
jitter, out, stream)`` (one thread per output) and ``svc_gram_f32/f64(x, ell,
ls, n, m, jitter, input_major, out, stream)`` (one thread per input pair);
the script refuses sources whose entry points differ.  The current kernels
come from the package.

In float64 and float32, at K1's self form N=1000 and N=257, its cross form
1000 x 256, and K2 (task-major) at N=1000 M=2 and N=257 M=3, it:

* holds both versions against the plain version (the current one bit for
  bit, its self form also exactly symmetric; the old one within rtol 1e-12
  in float64, 2e-6 with a 1e-7 floor in float32) and checks that two
  launches of the current one are bit-equal;
* times old, new, new, old with a warm L2 (CUDA events over back-to-back
  launches) and with a cold L2 (a 128 MB buffer written before each launch,
  each launch timed alone), each version's own device time by
  torch.profiler, and the write floor: ``torch.empty(outputs).fill_(1.0)``,
  the same bytes written by PyTorch's fill kernel, warm and cold.

Then a sweep of the current kernels' schedules, each warm and checked bit
for bit: K1's self form by both routes (pairs and threads) at N = 257 to
2000 in float64 and 257 to 1000 in float32, where the schedule switches
between them, and its pairs route at 2, 4 and 8 blocks per SM at N = 1000
and 2000; K2 at its two shapes over 1, 2, 4 and 8 rows an item and 4 or 8
warps a block.  It also prints ``nvcc -Xptxas -v`` for both versions'
forward kernels.  Every line goes to stdout
and the whole record to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from k3_ab import HBM_BYTES_PER_S, cold_ms, kernel_ms, max_err, ptxas_report, warm_ms  # noqa: E402

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
OLD_K1_SIGNATURE = [_P, _P, _P, _I, _P, _P, _P, _I, _D, _P, _P]
OLD_K2_SIGNATURE = [_P, _P, _P, _I, _I, _D, _I, _P, _P]
SELF_SHAPES = (1000, 257)
CROSS_SHAPES = ((1000, 256),)
K2_SHAPES = ((1000, 2), (257, 3))
JITTER = 1e-6


def log(msg: str) -> None:
    print(f"[fwd_ab] {msg}", flush=True)


def refuse(path: str, pattern: str, must: str) -> bool:
    with open(path) as f:
        entry = re.search(pattern, f.read())
    return entry is None or must not in entry.group(1)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-gibbs", required=True)
    parser.add_argument("--old-svc", required=True)
    parser.add_argument("--out", help="write the whole record there as JSON")
    args = parser.parse_args()
    if refuse(args.old_gibbs, r"int gibbs_gram_f64\(([^)]*)\)", "double jitter, void* out"):
        print(f"fwd_ab: {args.old_gibbs} is not K1 of dde4b95 (no gibbs_gram_f64(..., jitter, out, stream))",
              file=sys.stderr)
        return 2
    if refuse(args.old_svc, r"int svc_gram_f64\(([^)]*)\)", "input_major"):
        print(f"fwd_ab: {args.old_svc} is not K2 of dde4b95 (its entry points take no input_major)",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("fwd_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "rows": [], "sweep": []}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    nvcc = cuda_build._nvcc()
    forward = lambda entry: "bwd" not in entry
    old_fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        gk.build()
        for label, src in (("new_k1", os.path.join(cuda_build.CSRC_DIR, "gibbs_gram.cu")),
                           ("old_k1", args.old_gibbs),
                           ("new_k2", os.path.join(cuda_build.CSRC_DIR, "svc_gram.cu")),
                           ("old_k2", args.old_svc)):
            record[f"ptxas_{label}"] = ptxas_report(nvcc, cuda_build.NVCC_FLAGS, src, tmp, forward)
            for line in record[f"ptxas_{label}"]:
                log(f"ptxas {label}: {line}")
        for key, src, name, sig in (("k1", args.old_gibbs, "gibbs_gram", OLD_K1_SIGNATURE),
                                    ("k2", args.old_svc, "svc_gram", OLD_K2_SIGNATURE)):
            lib_path = os.path.join(tmp, f"old_{key}.so")
            subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib_path, src], check=True, timeout=600)
            lib = ctypes.CDLL(lib_path)
            for dtype, suffix in ((torch.float32, "f32"), (torch.float64, "f64")):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = sig, ctypes.c_int
                old_fns[key, dtype] = fn

    stream = lambda: torch.cuda.current_stream().cuda_stream

    def old_k1(x1, s1, l1, x2, s2, l2, jitter):
        out = torch.empty((x1.shape[0], x2.shape[0]), dtype=x1.dtype, device=x1.device)
        status = old_fns["k1", x1.dtype](x1.data_ptr(), s1.data_ptr(), l1.data_ptr(), x1.shape[0], x2.data_ptr(),
                                         s2.data_ptr(), l2.data_ptr(), x2.shape[0], float(jitter),
                                         out.data_ptr(), stream())
        if status != 0:
            raise RuntimeError(f"old K1: cudaError_t {status}")
        return out

    def old_k2(x, ell, ls, jitter):
        n, m = ls.shape[0], ls.shape[1]
        out = torch.empty((n * m, n * m), dtype=x.dtype, device=x.device)
        status = old_fns["k2", x.dtype](x.data_ptr(), ell.data_ptr(), ls.data_ptr(), n, m, float(jitter), 0,
                                        out.data_ptr(), stream())
        if status != 0:
            raise RuntimeError(f"old K2: cudaError_t {status}")
        return out

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    sms = gk.sm_count(dev)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev)  # 128 MB

    def inputs(n, dtype, m=None):
        x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
        ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
        s = 0.5 + 1.5 * torch.rand(n, generator=gen, dtype=torch.float64)
        out = [x, s, ell]
        if m is not None:
            out.append(torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64))
                       + 2.0 * torch.eye(m, dtype=torch.float64))
        return [t.to(dev, dtype) for t in out]

    def compare(label, dn, new, old, plain, numel, in_bytes, sched, symmetric=False):
        want = plain()
        got = {"new": new(), "old": old()}
        torch.cuda.synchronize()
        errs = {k: max_err(torch, f"{k} {label} {dn}", g, want, dn) for k, g in got.items()}
        if not torch.equal(got["new"], want):
            raise AssertionError(f"new {label} {dn}: not bit-equal to the plain version")
        if symmetric and not torch.equal(got["new"], got["new"].T):
            raise AssertionError(f"new {label} {dn}: not exactly symmetric")
        if not torch.equal(new(), new()):
            raise AssertionError(f"new {label} {dn}: two launches differ")
        fill = lambda: torch.empty(numel, dtype=want.dtype, device=dev).fill_(1.0)
        turns = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            turns[which].append(warm_ms(torch, new if which == "new" else old))
        cold = {which: cold_ms(torch, fn, flush) for which, fn in (("old", old), ("new", new))}
        floor = {"warm": warm_ms(torch, fill), "cold": cold_ms(torch, fill, flush)}
        by_kernel = {"new": kernel_ms(torch, new), "old": kernel_ms(torch, old), "fill": kernel_ms(torch, fill)}
        nbytes = numel * want.element_size() + in_bytes
        row = {
            "kernel": label, "dtype": dn, "max_abs_err": errs,
            "bit_equal_to_plain": {k: bool(torch.equal(g, want)) for k, g in got.items()},
            "bit_equal_repeat": True, "warm_ms": turns, "cold_ms": cold, "write_floor_ms": floor,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "schedule": dataclasses.asdict(sched),
            "profile_ms_by_kernel": by_kernel,
        }
        record["rows"].append(row)
        log(f"{label} {dn}: max abs err new {errs['new']:.3e} old {errs['old']:.3e}; bit-equal to plain "
            f"{row['bit_equal_to_plain']}; warm ms old {turns['old'][0]:.5f}, new {turns['new'][0]:.5f}, "
            f"new {turns['new'][1]:.5f}, old {turns['old'][1]:.5f}; cold ms old {cold['old']:.5f} "
            f"new {cold['new']:.5f}; write floor warm {floor['warm']:.5f} cold {floor['cold']:.5f}; "
            f"bound {row['bound_ms']:.5f} ms (bytes); schedule {row['schedule']}")
        for which, kernels in by_kernel.items():
            log(f"{label} {dn}: {which} device ms by kernel: "
                + ", ".join(f"{k} {v:.5f}" for k, v in kernels.items()))

    for dtype in (torch.float64, torch.float32):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        for n in SELF_SHAPES:
            x, s, l = inputs(n, dtype)
            compare(f"K1 self N={n}", dn, lambda: gk.gibbs_gram(x, s, l, jitter=JITTER),
                    lambda: old_k1(x, s, l, x, s, l, JITTER),
                    lambda: gk.gibbs_gram_plain(x, s, l, x, s, l, JITTER), n * n, 3 * n * size,
                    gk.k1_forward_schedule(n, n, True, dtype, sms), symmetric=True)
        for n1, n2 in CROSS_SHAPES:
            x1, s1, l1 = inputs(n1, dtype)
            x2, s2, l2 = inputs(n2, dtype)
            s1, s2 = torch.ones_like(s1), torch.ones_like(s2)  # the served path's σ≡1
            compare(f"K1 cross {n1}x{n2}", dn, lambda: gk.gibbs_gram(x1, s1, l1, x2, s2, l2),
                    lambda: old_k1(x1, s1, l1, x2, s2, l2, 0.0),
                    lambda: gk.gibbs_gram_plain(x1, s1, l1, x2, s2, l2), n1 * n2, 3 * (n1 + n2) * size,
                    gk.k1_forward_schedule(n1, n2, False, dtype, sms))
        for n, m in K2_SHAPES:
            x, _, l, ls = inputs(n, dtype, m)
            compare(f"K2 task N={n} M={m}", dn, lambda: gk.svc_gram(x, l, ls, JITTER),
                    lambda: old_k2(x, l, ls, JITTER), lambda: gk.svc_gram_plain(x, l, ls, JITTER),
                    (n * m) ** 2, (2 * n + n * m * m) * size, gk.k2_schedule(n, m, dtype, sms))

    # the sweep: the current kernels under other schedules, warm, each
    # checked bit for bit
    def sweep(label, fn, want, sched):
        if not torch.equal(fn(), want):
            raise AssertionError(f"sweep {label} {sched}: not bit-equal to the plain version")
        ms = warm_ms(torch, fn)
        record["sweep"].append({"kernel": label, "schedule": dataclasses.asdict(sched), "warm_ms": ms})
        log(f"sweep {label}: {ms:.5f} ms warm; {dataclasses.asdict(sched)}")

    for dtype, sizes in ((torch.float64, (257, 512, 640, 704, 768, 832, 1000, 2000)),
                         (torch.float32, (257, 640, 768, 1000))):
        dn = str(dtype).replace("torch.", "")
        for n in sizes:  # K1's self form: both routes across N, where the schedule switches
            x, s, l = inputs(n, dtype)
            want = gk.gibbs_gram_plain(x, s, l, x, s, l, JITTER)
            pairs = gk.k1_pairs_schedule(n, dtype, sms)
            scheds = [gk.K1ForwardSchedule(n, n, "self", "threads", 1, 32, -(-n // 32) * -(-n // 8)), pairs]
            if n >= 1000 and dtype == torch.float64:
                scheds += [dataclasses.replace(pairs, grid=min(pairs.n_pairs, k * sms)) for k in (2, 8)]
            for sched in scheds:
                sweep(f"K1 self N={n} {dn}", lambda sched=sched: gk._k1_launch(sched, x, s, l, x, s, l, JITTER),
                      want, sched)
        for n, m in K2_SHAPES:  # K2: rows an item and warps a block
            x, _, l, ls = inputs(n, dtype, m)
            want = gk.svc_gram_plain(x, l, ls, JITTER)
            base = gk.k2_schedule(n, m, dtype, sms)
            for rows in (1, 2, 4, 8):
                for warps in (4, 8):
                    sched = dataclasses.replace(base, rows=rows, warps=warps)
                    sched = dataclasses.replace(sched, grid=gk._strip_grid(sched.n_items, warps, sms))
                    out = torch.empty_like(want)
                    sweep(f"K2 task N={n} M={m} {dn}",
                          lambda sched=sched, out=out: gk._k2_launch(sched, x, l, ls, JITTER, out), want, sched)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
