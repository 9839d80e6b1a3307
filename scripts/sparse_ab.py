#!/usr/bin/env python3
"""Run the smoke's sparse phase on an earlier tree and on this one, in turns, on one card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 scripts/sparse_ab.py --old-root OLD [--m-z 64,128] [--out RECORD.json]

``OLD`` is a checkout of an earlier commit whose ``chip_smoke.py`` has
``phase_sparse(torch, np, gk, seed)``, for example

    mkdir -p chip_checkout/parent && git archive 13ab694 | tar -x -C chip_checkout/parent

For each number of inducing points in ``--m-z`` it runs ``phase_sparse`` of
the old tree, this tree, this tree and the old tree, each in a process of
its own that imports only that tree's package (so both build and use their
own kernels), with ``chip_smoke.SPARSE_M_Z`` set.  The phase holds each
tree to its own checks (exact launches, card against CPU) and prints its
end-to-end numbers: FITC and VFE gradient evaluations/s and a profile of
one gradient, the ``run_subject(do_hmc=True, do_loo=True)`` stages and
chain, NUTS, warm HTTP latencies, mixed against f64, the CLI and the
N = 20,000 rate.  Every line of each turn goes to stdout with the turn's
tag, and the whole record to ``--out`` as JSON.  A turn that fails stops
the script with its exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root: str, m_z: int, seed: int) -> int:
    """One turn: ``root``'s kernels built and its sparse phase run."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != os.path.abspath(root):
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}'s chip_smoke.py")
    t0 = time.perf_counter()
    gk.build()
    for name in gk.KERNEL_SOURCES:
        cuda_build.load(name)
    print(f"[sparse_ab] built in {time.perf_counter() - t0:.3f} s", flush=True)
    chip_smoke.SPARSE_M_Z = m_z
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)  # the phase's store and CLI output go there
    t0 = time.perf_counter()
    chip_smoke.phase_sparse(torch, np, gk, seed)
    print(f"[sparse_ab] phase_sparse took {time.perf_counter() - t0:.3f} s", flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--old-root", help="the earlier tree's root")
    parser.add_argument("--m-z", default="64", help="comma-separated numbers of inducing points (default 64)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", help="write the whole record there as JSON")
    parser.add_argument("--child", help=argparse.SUPPRESS)  # one turn: the tree's root
    args = parser.parse_args()
    m_zs = [int(m) for m in args.m_z.split(",")]
    if args.child:
        return child(args.child, m_zs[0], args.seed)
    if not args.old_root or not os.path.isfile(os.path.join(args.old_root, "chip_smoke.py")):
        print("sparse_ab: --old-root must name a tree with a chip_smoke.py", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("sparse_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[sparse_ab] card: {smi}", flush=True)
    record = {"card": smi, "turns": []}
    roots = {"old": os.path.abspath(args.old_root), "new": ROOT}
    for m_z in m_zs:
        for which in ("old", "new", "new", "old"):
            tag = f"{which} m_z={m_z}"
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", roots[which], "--m-z",
                                  str(m_z), "--seed", str(args.seed)], cwd=roots[which], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True, timeout=1800)
            lines = run.stdout.splitlines()
            for line in lines:
                print(f"[{tag}] {line}", flush=True)
            record["turns"].append({"tree": which, "m_z": m_z, "rc": run.returncode,
                                    "seconds": time.perf_counter() - t0, "lines": lines})
            if run.returncode != 0:
                print(f"sparse_ab: the {tag} turn failed (rc {run.returncode})", file=sys.stderr)
                return run.returncode
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"[sparse_ab] wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
