"""Single-subject synthetic pipeline driver.

Counterpart of the JAX package's ``examples/run_sim_pipeline.py`` for the
dense models and the sparse tiers (``--model
lmc|snmgp|gnmgp|gnmgp_hetero|gnmgp_sparse|gnmgp_hetero_sparse|snmgp_sparse|lmc_sparse``,
the sparse ones with ``--n-inducing`` and ``--sparse-approx fitc|vfe``):
generate (or load) one synthetic subject (``sim_mnts``, or
``sim_mnts_hetero`` for ``gnmgp_hetero`` and ``gnmgp_hetero_sparse``), run
empirical init → MAP (→ HMC) → grid/test prediction → scores, and write
figures, artifacts and a JSON summary on stdout.

    python -m nonstationary_multivariate_gaussian_process_tpu_torch.examples.run_sim_pipeline \\
        --model gnmgp --n 200 --n-opt 1000 --out res/sim_nonseparable

It runs on ``cuda``.  The arguments are the JAX CLI's, and ``--sampler``
takes ``hmc``, ``nuts``, ``drhmc``, ``chees`` and ``smc`` (with ``--smc-ref
prior``); the samplers this package does not have yet (``rmhmc`` and
``pathfinder``) and SMC's pathfinder reference exit with an error that says
so.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import settings, viz, workflows
from ..data import io as data_io
from ..data import sim
from ..utils.artifacts import ArtifactStore


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gnmgp",
                    choices=["lmc", "snmgp", "gnmgp", "gnmgp_hetero",
                             "gnmgp_sparse", "gnmgp_hetero_sparse",
                             "snmgp_sparse", "lmc_sparse"])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--n-inducing", type=int, default=64,
                    help="sparse models: inducing-input count")
    ap.add_argument("--sparse-approx", default="fitc", choices=["fitc", "vfe"])
    ap.add_argument("--n-opt", type=int, default=1000)
    ap.add_argument("--map-method", default="lbfgs", choices=["lbfgs", "adam"],
                    help="MAP engine (lbfgs default; adam = the reference contract)")
    ap.add_argument("--n-hmc", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", default="hmc",
                    choices=["hmc", "nuts", "drhmc", "rmhmc", "chees", "smc",
                             "pathfinder"])
    ap.add_argument("--smc-ref", default="prior", choices=["prior", "pathfinder"],
                    help="SMC reference distribution (sampler=smc)")
    ap.add_argument("--whiten", default="off", choices=["off", "prior", "pncp"],
                    help="sampling reparameterization")
    ap.add_argument("--hmc-step-size", type=float, default=1e-4)
    ap.add_argument("--test-size", type=float, default=0.25)
    ap.add_argument("--data", default=None, help="optional sim_MNTS pickle to load")
    ap.add_argument("--out", default="res/sim")
    return ap


def main(argv=None, device=None) -> dict:
    """Run the pipeline on ``device`` (default ``cuda``, raising when there is
    none); print and return the JSON summary."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.sampler in workflows.UNPORTED_SAMPLERS:
        ap.error(f"--sampler {args.sampler} {workflows.UNPORTED_SAMPLERS[args.sampler]}")
    if args.smc_ref == "pathfinder":
        ap.error("--smc-ref pathfinder is not yet ported to the torch package (it needs the pathfinder sampler)")
    device = settings.resolve_device(device)

    os.makedirs(args.out, exist_ok=True)
    if args.data:
        loaded = data_io.load_sim_pickle(args.data)
        x, y = loaded["x"], loaded["y"]
    else:
        gen = sim.sim_mnts_hetero if args.model in ("gnmgp_hetero", "gnmgp_hetero_sparse") else sim.sim_mnts
        d = gen(torch.Generator().manual_seed(args.seed), n=args.n, device=device)
        x, y = d.x.cpu().numpy(), d.y.cpu().numpy()

    hyper = ({"alpha_tilde_l": 10.0, "beta_tilde_l": 1.0, "alpha_L": 10.0, "beta_L": 1.0}
             if args.model in ("gnmgp", "gnmgp_sparse") else {})
    cfg = workflows.PipelineConfig(
        model=args.model, n_opt=args.n_opt, do_hmc=args.n_hmc > 0,
        map_method=args.map_method,
        n_hmc=max(args.n_hmc, 1), test_size=args.test_size, hyper=hyper,
        seed=args.seed, sampler=args.sampler, smc_ref=args.smc_ref,
        whiten=False if args.whiten == "off" else args.whiten,
        hmc_step_size=args.hmc_step_size, n_inducing=args.n_inducing, sparse_approx=args.sparse_approx,
    )
    store = ArtifactStore(args.out)
    res = workflows.run_subject(x, y, cfg, store=store, dataset="sim", subject=args.seed, device=device)

    viz.plot_posterior(
        os.path.join(args.out, "posterior.png"), res["grid"],
        res["pred_grid"].percentiles.cpu().numpy(), x=x[: res["n"]], y=y[: res["n"]],
    )
    if "target_hist" in res:
        viz.plot_target_trace(os.path.join(args.out, "target_trace.png"), res["target_hist"])
    summary = {
        k: float(v) for k, v in res.items()
        if isinstance(v, (int, float)) and np.isfinite(v)
    }
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
