"""The single-subject pipeline: empirical init → multi-start MAP → HMC →
analysis → grid/test prediction → scoring.

Counterpart of ``PipelineConfig`` and ``run_subject`` of the JAX package's
``workflows.py`` for fully observed data: the dense models ``lmc``,
``snmgp``, ``gnmgp`` and ``gnmgp_hetero``, and the sparse (inducing-point)
tiers ``gnmgp_sparse``, ``gnmgp_hetero_sparse``, ``snmgp_sparse`` and
``lmc_sparse`` (FITC or VFE at ``n_inducing`` inputs; their whiteners and
LOO at the inducing inputs, the sparse GNMGP's latent analysis there too),
with the reference-contract HMC
sampler (``sampler="hmc"``, any ``hmc_mass``), adaptive NUTS
(``sampler="nuts"``), delayed-rejection HMC (``sampler="drhmc"``),
many-chain ChEES-HMC (``sampler="chees"``) or adaptive tempered SMC
(``sampler="smc"``, its evidence estimate in ``result["sampling"]``; the
dense GNMGP's population is one batched evaluation,
``gnmgp.make_objective_batched``, every other objective's one evaluation a
particle), any of them in the natural space or whitened (``whiten=True``/``"prior"``, or ``"pncp"`` retuned from a
pilot chain), and, with ``do_loo``, WAIC and PSIS-LOO from the chain.  The
stages, their order, the result dict and the artifacts written (``data``,
``map``, ``map_ckpt``, ``hmc``, ``sampling`` for ChEES and SMC, ``pred_grid``,
``scores``, ``loo``) are the JAX package's, so a store written here serves
from either package's engine.

``run_subject_hadamard`` is the JAX function's counterpart for subjects in
the Hadamard layout (one observation per (input, task) pair, so a channel
may be missing at any time): MAP on the model's Hadamard objective, grid
prediction, the chain (either sampler, any ``whiten``), LOO, and held-out
test scoring by the MAP and by the chain, for ``lmc``, ``snmgp`` and
``gnmgp`` and the sparse ``gnmgp_sparse``, ``snmgp_sparse`` and
``lmc_sparse`` (FITC or VFE at the inducing inputs chosen among the
subject's times; their whiteners and LOO at those inputs).  With
``refine_z > 0`` both pipelines move a sparse model's inducing inputs after
MAP (``gnmgp_sparse.refine_inducing``) and condition every later stage on
the refined set.

Not ported yet, and refused with ``ValueError``: the samplers
``"rmhmc"`` (it needs second- and third-order derivatives of the Gram
kernels K1 and K3) and ``"pathfinder"``, and SMC's pathfinder reference
(``smc_ref="pathfinder"``).  The
heteroscedastic GNMGPs, dense or sparse, have no Hadamard objective in the
JAX package either, and ``run_subject_hadamard`` refuses them.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Any

import numpy as np
import torch

from . import evaluate, settings
from .data import preprocess
from .inference import chees
from .inference import diagnostics
from .inference import drhmc
from .inference import empirical
from .inference import hmc
from .inference import init as init_mod
from .inference import map as map_mod
from .inference import nuts
from .inference import smc as smc_mod
from .inference import whiten as whiten_mod
from .models import gnmgp, gnmgp_hetero, gnmgp_sparse, lmc, lmc_sparse, snmgp, snmgp_sparse
from .models.base import FullData, as_hadamard_data
from .postprocess import analysis
from .predict import gnmgp as pred_gnmgp
from .predict import gnmgp_hetero as pred_gnmgp_hetero
from .predict import gnmgp_sparse as pred_gnmgp_sparse
from .predict import hadamard as pred_h
from .predict import lmc as pred_lmc
from .predict import lmc_sparse as pred_lmc_sparse
from .predict import snmgp as pred_snmgp
from .predict import snmgp_sparse as pred_snmgp_sparse
from .utils.artifacts import ArtifactStore

_MODELS = {"lmc": lmc, "snmgp": snmgp, "gnmgp": gnmgp, "gnmgp_hetero": gnmgp_hetero, "gnmgp_sparse": gnmgp_sparse,
           "gnmgp_hetero_sparse": gnmgp_sparse, "snmgp_sparse": snmgp_sparse, "lmc_sparse": lmc_sparse}
_PREDICT = {"lmc": pred_lmc, "snmgp": pred_snmgp, "gnmgp": pred_gnmgp, "gnmgp_hetero": pred_gnmgp_hetero,
            "gnmgp_sparse": pred_gnmgp_sparse, "gnmgp_hetero_sparse": pred_gnmgp_sparse,
            "snmgp_sparse": pred_snmgp_sparse, "lmc_sparse": pred_lmc_sparse}
MODELS = tuple(_MODELS)
#: The sparse (inducing-point) models.
SPARSE_MODELS = ("gnmgp_sparse", "gnmgp_hetero_sparse", "snmgp_sparse", "lmc_sparse")
SPARSE_APPROXES = ("fitc", "vfe")
#: The models with a Hadamard-layout objective.
HADAMARD_MODELS = ("lmc", "snmgp", "gnmgp", "gnmgp_sparse", "snmgp_sparse", "lmc_sparse")
HMC_MASSES = ("none", "pilot", "window")
SAMPLERS = ("hmc", "nuts", "drhmc", "chees", "smc")
#: The JAX package's samplers that the port refuses, and why.
UNPORTED_SAMPLERS = {
    "rmhmc": "needs second- and third-order derivatives of K1 and K3 (not yet ported)",
    "pathfinder": "is not yet ported to the torch package",
}
#: SMC's references: the port runs "prior"; JAX's "pathfinder" waits for the
#: pathfinder sampler.
SMC_REFS = ("prior", "pathfinder")
#: The stream of ChEES's multichain starts (``_pilot_generator``'s tag).
CHEES_START_TAG = 13


@dataclasses.dataclass
class PipelineConfig:
    """Stage gates and budgets (the reference's ``do_*`` flag blocks and
    ``hyper_pars`` dicts, e.g. ``Nonseparable_model.py:253-275``); the fields
    of the JAX package's config that this path reads."""

    model: str = "gnmgp"
    hyper: dict = dataclasses.field(default_factory=dict)
    n_inducing: int = 64  # sparse models: the inducing-input count m_z
    #                       (latents at m_z quantile-chosen inputs, kriged to
    #                       the data; the likelihood is O(N M (m_z M)^2))
    sparse_approx: str = "fitc"  # sparse models: "fitc" (diagonal-corrected)
    #                              or "vfe" (Titsias' bound)
    refine_z: int = 0  # any sparse model, either layout: alternating
    #                    inducing-input refinement rounds after MAP (Z
    #                    descends the traced objective, the latents refit at
    #                    the moved Z; gnmgp_sparse.refine_inducing); later
    #                    stages condition on the refined ops
    refine_z_iters: int = 40  # Adam steps on Z per refinement round
    do_empirical: bool = True
    do_map: bool = True
    do_map_analysis: bool = True
    do_hmc: bool = False
    do_pred_grid: bool = True
    do_pred_test: bool = True
    do_evaluation: bool = True
    do_loo: bool = False  # with do_hmc: WAIC and PSIS-LOO from the chain
    loo_draws: int = 200  # chain draws used for LOO (evenly thinned)
    n_opt: int = 1000
    lr: float = 2e-1
    map_method: str = "lbfgs"  # "lbfgs" (optax's, with the zoom linesearch) | "adam"
    err_opt: float | None = None
    n_hmc: int = 100
    sampler: str = "hmc"  # "hmc" (the reference contract, inference/hmc.py)
    #                        | "nuts" (adaptive trajectories and windowed
    #                        warmup, inference/nuts.py) | "drhmc" (delayed
    #                        rejection, inference/drhmc.py) | "chees"
    #                        (lockstep chains with cross-chain adaptive
    #                        trajectory lengths, inference/chees.py) | "smc"
    #                        (adaptive tempered SMC from the prior to the
    #                        posterior, inference/smc.py; its evidence
    #                        estimate in result["sampling"]["log_evidence"])
    smc_particles: int = 0  # smc population size (0 = max(256, n_hmc))
    smc_mutations: int = 5  # smc batched-HMC decorrelation sweeps per stage
    smc_leapfrog: int = 10  # smc leapfrog steps per mutation sweep
    smc_cess: float = 0.5  # smc conditional-ESS target for the beta schedule
    smc_dr: float = 0.0  # smc >0: delayed-rejection sweeps at eps/this
    smc_polish: int = 0  # smc extra mutation-only stages at beta=1
    smc_resample_ess: float = 1.0  # smc <1: resample only when the carried-
    #                                weight ESS fraction drops below this
    smc_resample: str = "systematic"  # systematic | stratified | residual | multinomial
    smc_ref: str = "prior"  # SMC reference: "prior" (N(0, I) in the whitened
    #                         space); "pathfinder" is not yet ported
    smc_waste_free: int = 0  # >=2: waste-free SMC with chains of this length
    smc_metric: str = "full"  # mutation metric: "full" population covariance or "diag"
    dr_stages: int = 3  # drhmc proposal stages (1 = plain HMC)
    dr_reduction: float = 4.0  # drhmc per-stage step-size reduction
    hmc_step_size: float = 1e-4
    hmc_leapfrog: int = 20
    hmc_adapt: bool = False  # dual-averaging step-size adaptation
    hmc_warmup: int = 0  # for "nuts": 0 means max(100, n_hmc)
    hmc_mass: str = "none"  # "none" | "pilot" (mass matrix from a pilot run,
    #                          the reference's preconditioning recipe)
    #                          | "window" (Stan-style windowed warmup)
    whiten: bool | str = False  # False | True/"prior": sample the prior-
    #                       whitened latent-GP blocks (inference/whiten.py)
    #                       | "pncp": partially non-centered, every
    #                       eigendirection retuned to its posterior scale by
    #                       a pilot chain.  The same posterior either way;
    #                       samples come back in the natural space.
    pncp_pilot: int = 200  # pilot-chain draws for whiten="pncp"
    pncp_interp: float = 1.0  # 0 keeps prior whitening, 1 is fully
    #                           posterior-scaled (whiten.retune's interp)
    n_chains: int = 2  # chees: chains (at least 2; chain 0 starts at the MAP)
    n_grid: int = 201
    window_size: int = 30
    test_size: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"unknown model {self.model!r} (the torch package runs {MODELS})")
        if self.sparse_approx not in SPARSE_APPROXES:
            raise ValueError(f"sparse_approx must be one of {SPARSE_APPROXES}, got {self.sparse_approx!r}")
        if self.sampler in UNPORTED_SAMPLERS:
            raise ValueError(f"sampler {self.sampler!r} {UNPORTED_SAMPLERS[self.sampler]} (the torch package "
                             f"runs {SAMPLERS})")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler {self.sampler!r} is not yet ported to the torch package (it runs {SAMPLERS})")
        if self.smc_ref not in SMC_REFS:
            raise ValueError(f"unknown smc_ref {self.smc_ref!r} (want 'prior' or 'pathfinder')")
        if self.smc_ref == "pathfinder":
            raise ValueError("smc_ref='pathfinder' (the multipathfinder reference) is not yet ported to the torch "
                             "package: it needs the pathfinder sampler")
        if self.hmc_mass not in HMC_MASSES:
            raise ValueError(f"hmc_mass must be one of {HMC_MASSES}, got {self.hmc_mass!r}")
        if self.map_method not in map_mod.METHODS:
            raise ValueError(f"map_method must be one of {map_mod.METHODS}, got {self.map_method!r}")


def _validate_subject(x, y):
    """Named validation errors for degenerate inputs."""
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D (N,), got shape {x.shape}")
    if y.ndim != 2:
        raise ValueError(f"Y must be 2-D (N, M), got shape {y.shape}")
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"x and Y disagree on N: {x.shape[0]} vs {y.shape[0]}")
    if x.shape[0] < 4:
        raise ValueError(f"need at least 4 observations, got {x.shape[0]}")
    if y.shape[1] < 1:
        raise ValueError("Y must have at least one task column")
    if not np.all(np.isfinite(x)) or not np.all(np.isfinite(y)):
        raise ValueError("x/Y contain non-finite values")


def _validate_hadamard(x, indx, y, m):
    """Named validation errors for a degenerate Hadamard-layout subject."""
    if x.ndim != 1 or indx.ndim != 1 or y.ndim != 1:
        raise ValueError(f"Hadamard layout needs 1-D x/indx/y, got {x.shape}/{indx.shape}/{y.shape}")
    if not (x.shape[0] == indx.shape[0] == y.shape[0]):
        raise ValueError(f"x/indx/y lengths differ: {x.shape[0]}/{indx.shape[0]}/{y.shape[0]}")
    if x.shape[0] < 4:
        raise ValueError(f"need at least 4 observations, got {x.shape[0]}")
    if indx.min() < 0 or indx.max() >= m:
        raise ValueError(f"task indices must lie in [0, {m}), got [{indx.min()}, {indx.max()}]")
    if not np.all(np.isfinite(x)) or not np.all(np.isfinite(y)):
        raise ValueError("x/y contain non-finite values")


def n_params(model: str, n: int, m: int) -> int:
    """Length of ``model``'s packed vector for N inputs (m_z inducing inputs
    for a sparse model) and M tasks (LMC's, sparse or not, does not depend on
    N)."""
    if model in ("lmc", "lmc_sparse"):
        return lmc.n_params(m)
    if model == "gnmgp_hetero_sparse":
        return gnmgp_sparse.n_params_hetero(n, m)
    return _MODELS[model].n_params(n, m)


def _build_inits(cfg: PipelineConfig, emp, data: FullData, z=None) -> dict:
    """The model's MAP starts, in JAX's order (JAX ``workflows._build_inits``):
    LMC from the empirical estimates; SNMGP from a short LMC Adam fit
    (stationary, combined) and the empirical estimates; GNMGP from a short
    SNMGP Adam fit (separable) and the empirical estimates, and the
    heteroscedastic GNMGP from those two with the noise broadcast; the
    sparse GNMGP and SNMGP from their empirical estimates subsampled onto the
    inducing inputs ``z`` (no separable warm start: that costs the dense work
    this tier avoids), the sparse hetero GNMGP from the sparse GNMGP's with
    the noise broadcast over m_z·M, the sparse LMC as the LMC (its layout is
    N-free)."""
    n, m = data.y.shape
    dev, dt = data.x.device, data.x.dtype
    if cfg.model in ("gnmgp_sparse", "gnmgp_hetero_sparse"):
        dense = init_mod.gnmgp_from_empirical(emp, n, m, device=dev, dtype=dt)
        v = gnmgp_sparse.init_from_empirical(dense, n, z.shape[0], m, data.x, z)
        if cfg.model == "gnmgp_hetero_sparse":
            # the homoscedastic noise broadcast over the (Z × task) process
            v = torch.cat([v[:-1], v[-1].expand(z.shape[0] * m)])
        return {"empirical": v}
    if cfg.model == "snmgp_sparse":
        dense = init_mod.snmgp_from_empirical(emp, n, m, dev, dt)
        return {"empirical": snmgp_sparse.init_from_empirical(dense, n, z.shape[0], m, data.x, z)}
    if cfg.model in ("lmc", "lmc_sparse"):
        return {"empirical": init_mod.lmc_from_empirical(emp, n, m, dev, dt)}
    if cfg.model == "snmgp":
        lmc_res = map_mod.fit_map(
            lmc.make_objective(data), init_mod.lmc_from_empirical(emp, n, m, dev, dt),
            n_iters=min(cfg.n_opt, 500), lr=0.1,
        )
        return {
            "stationary": init_mod.snmgp_from_stationary(lmc_res.vec, n, dev, dt),
            "empirical": init_mod.snmgp_from_empirical(emp, n, m, dev, dt),
            "combined": init_mod.snmgp_combined(lmc_res.vec, emp, n, m, dev, dt),
        }
    sn_nlp = snmgp.make_objective(data)
    sn_res = map_mod.fit_map(
        sn_nlp, init_mod.snmgp_from_empirical(emp, n, m, dev, dt), n_iters=min(cfg.n_opt, 500), lr=0.2
    )
    inits = {
        "separable": init_mod.gnmgp_from_separable(sn_res.vec, n, m, dev, dt),
        "empirical": init_mod.gnmgp_from_empirical(emp, n, m, device=dev, dtype=dt),
    }
    if cfg.model == "gnmgp_hetero":
        # the homoscedastic noise broadcast over the (input × task) process
        # (Nonseparable_model_mpiKAISER_extended.py:317-328)
        inits = {name: gnmgp_hetero.init_from_gnmgp(v, n, m) for name, v in inits.items()}
    return inits


def _refit_iters(cfg: PipelineConfig) -> int:
    """The latents' refit at each refined Z: half the MAP's budget, within
    [100, 400], as the JAX workflow takes it."""
    return min(max(100, cfg.n_opt // 2), 400)


def _predict_map(cfg: PipelineConfig, map_vec, data: FullData, xs, device, dtype, sp_ops=None):
    """The model's plug-in prediction at ``xs`` (LMC's takes no ``hyper``, a
    sparse model's takes its ``sp_ops`` and approximation, the sparse hetero
    tier's is ``predict_map_hetero``)."""
    if cfg.model in SPARSE_MODELS:
        pred = _PREDICT[cfg.model]
        fn = pred.predict_map_hetero if cfg.model == "gnmgp_hetero_sparse" else pred.predict_map
        return fn(map_vec, data, sp_ops, xs, hyper=cfg.hyper, approx=cfg.sparse_approx, device=device, dtype=dtype)
    if cfg.model == "lmc":
        return pred_lmc.predict_map(map_vec, data, xs, device=device, dtype=dtype)
    return _PREDICT[cfg.model].predict_map(map_vec, data, xs, device=device, dtype=dtype, hyper=cfg.hyper)


def _pilot_generator(seed: int, tag: int, device) -> torch.Generator:
    """The generator of a pilot chain: where JAX derives the pilot's key as
    ``fold_in(key, tag)``, a stream of its own seeded from
    ``SeedSequence([seed, tag])``, fixed by the config's seed."""
    state = np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state))


def _run_chain(nlp, map_vec: torch.Tensor, cfg: PipelineConfig, generator: torch.Generator, whitener=None,
               nlp_batched=None):
    """Posterior sampling stage (JAX ``_run_chain``): the reference-contract
    HMC, adaptive NUTS, delayed-rejection HMC, ChEES or SMC.  Returns
    ``(samples on the chain's device, mean acceptance)``: (n_hmc, P), or
    ChEES's chain-major (K·n_hmc, P).  The acceptance is HMC's mean over
    every draw, warmup included, NUTS's mean leaf acceptance statistic over
    the kept draws, DRHMC's share of kept draws accepted at any stage,
    ChEES's mean accept probability over the kept draws of every chain,
    SMC's last stage's mean accept probability.
    ``cfg.hmc_mass`` picks HMC's preconditioning: "pilot" is the reference's
    pilot-covariance recipe, "window" Stan-style windowed warmup.  With a
    ``whitener`` the chain runs in the whitened space and its samples are
    mapped back.  ``nlp_batched``, (B, P) → (B,), evaluates SMC's population
    at once (:func:`_run_chain_smc`)."""
    if whitener is not None:
        samples, accept = _run_chain(
            whitener.wrap(nlp), whitener.to_white(map_vec), dataclasses.replace(cfg, whiten=False), generator,
            nlp_batched=None if nlp_batched is None else whitener.wrap(nlp_batched),
        )
        return whitener.from_white_batch(samples), accept
    if cfg.sampler == "nuts":
        n_warm = cfg.hmc_warmup if cfg.hmc_warmup > 0 else max(100, cfg.n_hmc)
        chain = nuts.nuts_sample(nlp, map_vec, cfg.n_hmc, generator, step_size=cfg.hmc_step_size, n_warmup=n_warm)
        return chain.samples, float(torch.mean(chain.accept_stat[n_warm:]))
    if cfg.sampler == "drhmc":
        n_warm = cfg.hmc_warmup if cfg.hmc_warmup > 0 else max(100, cfg.n_hmc)
        chain = drhmc.drhmc_sample(
            nlp, map_vec, cfg.n_hmc, generator, step_size=cfg.hmc_step_size, n_leapfrog=cfg.hmc_leapfrog,
            n_warmup=n_warm, n_stages=cfg.dr_stages, reduction=cfg.dr_reduction,
        )
        return chain.samples, float(torch.mean((chain.accept_stage[n_warm:] > 0).double()))
    if cfg.sampler == "chees":
        samples, accept, _ = _run_chain_chees(nlp, map_vec, cfg, generator)
        return samples, accept
    if cfg.sampler == "smc":
        samples, accept, _ = _run_chain_smc(nlp, map_vec, cfg, generator, nlp_batched=nlp_batched)
        return samples, accept
    mass = None
    if cfg.hmc_mass == "pilot":
        # mass matrix from a short pilot chain's sample covariance
        # (Nonseparable_model_mpiKAISER_extended.py:542-570 recipe), drawn
        # from the stream JAX derives as fold_in(key, 7)
        pilot = hmc.hmc_sample(
            nlp, map_vec, max(20, cfg.n_hmc // 10), _pilot_generator(cfg.seed, 7, map_vec.device),
            step_size=cfg.hmc_step_size, n_leapfrog=cfg.hmc_leapfrog,
        )
        mass = hmc.estimate_mass_matrix(pilot.samples)
    chain = hmc.hmc_sample(
        nlp, map_vec, cfg.n_hmc, generator, step_size=cfg.hmc_step_size,
        n_leapfrog=cfg.hmc_leapfrog, adapt_step_size=cfg.hmc_adapt,
        n_warmup=cfg.hmc_warmup, mass_matrix=mass,
        adapt_mass=(cfg.hmc_mass == "window"),
    )
    return chain.samples, float(torch.mean(chain.accept_prob))


def _run_chain_chees(nlp, map_vec: torch.Tensor, cfg: PipelineConfig, generator: torch.Generator, whitener=None):
    """ChEES sampling stage (JAX ``_run_chain_chees``): ``max(2,
    cfg.n_chains)`` lockstep chains from ``init.multichain_starts`` (chain 0
    at the MAP, the others jittered and descended).  Returns ``(samples, accept, sampling)``: the pooled
    chain-major (K·n_hmc, P) draws in the natural space on the chain's
    device, the mean accept probability over the kept draws, and the
    sampler's record: the pooled min-ESS over every 7th coordinate
    (``diagnostics.ess_multichain``) and the max split-R̂, both on
    natural-space draws, the acceptance, the tuned step size and trajectory
    length and the mean leapfrog count.

    Where JAX splits the stage's key into a start and a run key, the starts
    draw from a stream of their own, ``_pilot_generator(cfg.seed,
    CHEES_START_TAG)`` (tag 13), and the chains from ``generator``."""
    pot = nlp if whitener is None else whitener.wrap(nlp)
    q0 = map_vec if whitener is None else whitener.to_white(map_vec)
    n_warm = cfg.hmc_warmup if cfg.hmc_warmup > 0 else max(100, cfg.n_hmc)
    starts = init_mod.multichain_starts(pot, q0, max(2, cfg.n_chains),
                                        _pilot_generator(cfg.seed, CHEES_START_TAG, q0.device))
    r = chees.chees_sample(pot, starts, cfg.n_hmc, generator, step_size=cfg.hmc_step_size, n_warmup=n_warm)
    k, s, p = r.samples.shape
    flat = r.samples.reshape(k * s, p)
    if whitener is not None:
        flat = whitener.from_white_batch(flat)
    nat = flat.cpu().numpy().reshape(k, s, p)
    accept = float(torch.mean(r.accept_prob[n_warm:]))
    sampling = {
        "sampler": "chees",
        "chains": int(k),
        # the sampler bench's column subsample convention
        "min_ess": float(min(diagnostics.ess_multichain(nat[:, :, j]) for j in range(0, p, 7))),
        "max_rhat": float(np.max(diagnostics.rhat(nat))),
        "accept": accept,
        "step_size": float(r.step_size),
        "trajectory_length": float(r.trajectory_length),
        "mean_leapfrog": float(torch.mean(r.n_leapfrog.double())),
    }
    return flat, accept, sampling


def _run_chain_smc(nlp, map_vec: torch.Tensor, cfg: PipelineConfig, generator: torch.Generator, whitener=None,
                   nlp_batched=None):
    """Adaptive tempered SMC sampling stage (JAX ``_run_chain_smc``, with
    ``smc_ref="prior"``): a population of ``max(cfg.smc_particles or 256,
    cfg.n_hmc)`` follows the prior-to-posterior path (``inference/smc.py``)
    with the config's ``smc_*`` settings, drawn from ``generator``.

    Returns ``(samples, accept, sampling)``: the first ``cfg.n_hmc``
    natural-space particles (exchangeable, so a valid draw matrix) on the
    population's device, the last stage's mean accept probability, and the
    sampler's record (JAX's keys): the population, stages, final beta, the
    log evidence (``logz``, plus ``Whitener.logdet()`` when whitened), the
    final accept rate and step size.

    With ``nlp_batched`` ((B, P) → (B,), the dense GNMGP's
    ``make_objective_batched``) the population is one evaluation
    (``potential_batched=True``), wrapped by the whitener when there is one;
    under ``NMGP_PRECISION=mixed``, and for every other objective, each
    particle is its own evaluation of ``nlp``."""
    pot = nlp if whitener is None else whitener.wrap(nlp)
    batched = nlp_batched is not None and not settings.mixed_solves
    if batched:
        pot = nlp_batched if whitener is None else whitener.wrap(nlp_batched)
    # never return fewer draws than asked: the population at least n_hmc
    n_particles = max(cfg.smc_particles or 256, cfg.n_hmc)
    r = smc_mod.smc_sample(
        pot, int(map_vec.shape[0]), generator, n_particles,
        n_mutations=cfg.smc_mutations, n_leapfrog=cfg.smc_leapfrog,
        target_cess=cfg.smc_cess, dr_reduction=cfg.smc_dr,
        metric=cfg.smc_metric, n_polish=cfg.smc_polish,
        waste_free=cfg.smc_waste_free, resample_ess=cfg.smc_resample_ess,
        resample=cfg.smc_resample, potential_batched=batched,
        dtype=map_vec.dtype, device=map_vec.device,
    )
    parts = r.particles if whitener is None else whitener.from_white_batch(r.particles)
    ns = int(r.n_stages)
    logz = float(r.logz)
    # n_stages counts tempering and polish stages; the histories hold max_stages
    last = min(max(ns - 1, 0), int(r.accept.shape[0]) - 1)
    sampling = {
        "sampler": "smc",
        "n_particles": int(n_particles),
        "n_stages": ns,
        "beta_final": float(r.beta_final),
        "log_evidence": logz if whitener is None else logz + float(whitener.logdet()),
        "final_accept": float(r.accept[last]),
        "step_size": float(r.step_sizes[last]),
    }
    return parts[: cfg.n_hmc], sampling["final_accept"], sampling


def _make_sampling_whitener(nlp, map_vec: torch.Tensor, cfg: PipelineConfig, x: torch.Tensor, n: int, m: int,
                            hadamard: bool = False, nlp_batched=None):
    """The sampling stage's whitener for ``cfg.whiten`` (JAX
    ``_make_sampling_whitener``), or None; ``hadamard`` takes the Hadamard
    objective's prior defaults (``whiten.make_whitener``).  The sparse
    layout is the dense layout with (x, N) → (Z, m_z): the caller passes
    ``x=Z``, ``n=m_z`` and the dense model's whitener applies.

    ``True``/``"prior"``: prior-factor whitening.  ``"pncp"``: partially
    non-centered, a prior-whitened eigen-mode pilot chain of
    ``cfg.pncp_pilot`` draws estimates every eigendirection's posterior
    scale and ``whiten.retune`` rebuilds the map around it; the pilot draws
    from the stream JAX derives as ``fold_in(key, 11)`` (an SMC pilot's
    population evaluates through ``nlp_batched`` where given).
    """
    if not cfg.whiten:
        return None
    model_name = {"gnmgp_sparse": "gnmgp", "gnmgp_hetero_sparse": "gnmgp_hetero", "snmgp_sparse": "snmgp",
                  "lmc_sparse": "lmc"}.get(cfg.model, cfg.model)
    if cfg.whiten == "pncp":
        w = whiten_mod.make_whitener(model_name, x, n, m, cfg.hyper, hadamard=hadamard, mode="eig")
        pilot, _ = _run_chain(nlp, map_vec, dataclasses.replace(cfg, n_hmc=cfg.pncp_pilot, whiten=False),
                              _pilot_generator(cfg.seed, 11, map_vec.device), whitener=w, nlp_batched=nlp_batched)
        return whiten_mod.retune(w, pilot, interp=cfg.pncp_interp)
    if cfg.whiten in (True, "prior"):
        return whiten_mod.make_whitener(model_name, x, n, m, cfg.hyper, hadamard=hadamard)
    raise ValueError(f"unknown whiten setting {cfg.whiten!r} (want False, True, 'prior' or 'pncp')")


def run_subject(
    x,
    y,
    cfg: PipelineConfig | None = None,
    store: ArtifactStore | None = None,
    subject: Any = 0,
    dataset: str = "data",
    device=None,
    dtype=None,
) -> dict:
    """Single-subject pipeline on ``device`` (default ``cuda``, raising when
    there is none) in ``dtype`` (default ``settings.dtype``).  A sparse model
    adds ``n_inducing`` and ``sparse_approx`` to the result and its inducing
    inputs ``z`` and ``approx`` to the ``map`` artifact.

    Returns the JAX package's result dict (tensors where it has arrays);
    stages are also written to ``store`` when one is given, and a stored MAP
    of the right length is resumed.  The HMC stage draws from
    ``torch.Generator(device).manual_seed(cfg.seed)``.
    """
    cfg = cfg or PipelineConfig()
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    x = np.array(x, dtype=float)  # a writable copy: tensors are made from it
    y = np.array(y, dtype=float)
    _validate_subject(x, y)
    if cfg.test_size > 0:
        x, x_test, y, y_test = preprocess.data_split(x, y, test_size=cfg.test_size)
    else:
        x_test = y_test = None
    n, m = y.shape
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    xd, yd = as_t(x), as_t(y)
    data = FullData(xd, yd)
    result: dict = {"model": cfg.model, "n": n, "m": m, "timings": {}}

    def _key(stage):
        return ArtifactStore.key(cfg.model, dataset, subject, stage)

    if store is not None and not store.exists(_key("data")):
        # conditioning data rides the store so a serving engine can stand up
        # from the artifact root alone (serving/engine.py)
        store.save(_key("data"), x=x, y=y)

    t0 = time.time()
    emp = empirical.local_estimation(x, y, window_size=min(cfg.window_size, max(2, n // 3)))
    result["timings"]["empirical"] = time.time() - t0
    result["empirical"] = emp

    model = _MODELS[cfg.model]
    sparse = cfg.model in SPARSE_MODELS
    hsparse = cfg.model == "gnmgp_hetero_sparse"
    # the sparse tiers share the (nlp, ops) make_objective contract
    make_sparse = gnmgp_sparse.make_objective_hetero if hsparse else model.make_objective
    sp_ops = sp_z = m_z = None
    if sparse:
        nlp, sp_ops = make_sparse(data, n_inducing=cfg.n_inducing, approx=cfg.sparse_approx, hyper=cfg.hyper)
        sp_z = sp_ops.base.z if hsparse else sp_ops.z
        m_z = int(sp_z.shape[0])
        result["n_inducing"] = m_z
        result["sparse_approx"] = cfg.sparse_approx
    else:
        nlp = model.make_objective(data, hyper=cfg.hyper)
    map_vec = None
    if cfg.do_map:
        stored = None
        if store is not None and store.exists(_key("map")):
            map_art = store.load(_key("map"))
            stored = map_art["vec"]
            expected = (n_params(cfg.model, m_z if sparse else n, m),)
            if stored.shape != expected:
                # a stale artifact from other data or another split: refit
                warnings.warn(
                    f"ignoring stored MAP for {_key('map')}: length {stored.shape} != "
                    f"expected {expected} for N={n}, M={m} — refitting", stacklevel=2)
                stored = None
        if stored is not None:
            result["map_vec"] = map_vec = as_t(stored)
            z_art = map_art.get("z") if sparse else None
            if z_art is not None and not np.array_equal(np.asarray(z_art, np.float64),
                                                         sp_z.cpu().numpy().astype(np.float64)):
                # a MAP stored with another inducing set (a refined one) is
                # read at its own inputs, never reinterpreted at the default Z
                sp_z = as_t(z_art)
                nlp, sp_ops = make_sparse(data, z=sp_z, approx=cfg.sparse_approx, hyper=cfg.hyper)
        else:
            t0 = time.time()
            inits = _build_inits(cfg, emp, data, z=sp_z)
            ckpt = None
            if store is not None:
                ckpt = lambda v, i: store.save(_key("map_ckpt"), vec=v.cpu().numpy(), iteration=i)
            name, res, _ = map_mod.multi_start_map(
                nlp, inits, n_iters=cfg.n_opt, lr=cfg.lr, err_opt=cfg.err_opt,
                checkpoint_fn=ckpt, method=cfg.map_method,
            )
            result["timings"]["map"] = time.time() - t0
            result["map_vec"] = map_vec = res.vec
            result["map_init"] = name
            result["target_hist"] = res.target_hist.cpu().numpy()
            if cfg.refine_z > 0 and sparse:
                # inducing-input refinement: Z descends the objective and the
                # latents refit at the moved Z; sampling, DIC, LOO and
                # prediction condition on the refined ops
                t0 = time.time()
                sp_z, map_vec, _, _ = gnmgp_sparse.refine_inducing(
                    data, sp_z, map_vec, n_rounds=cfg.refine_z, z_iters=cfg.refine_z_iters,
                    vec_iters=_refit_iters(cfg), lr_vec=cfg.lr, hyper=cfg.hyper, approx=cfg.sparse_approx,
                    method=cfg.map_method, model=cfg.model)
                nlp, sp_ops = make_sparse(data, z=sp_z, approx=cfg.sparse_approx, hyper=cfg.hyper)
                result["map_vec"] = map_vec
                result["refined_z"] = sp_z.cpu().numpy()
                result["timings"]["refine_z"] = time.time() - t0
            if store is not None:
                # a sparse MAP keeps its inducing inputs and approximation beside it
                extra = {"z": sp_z.cpu().numpy(), "approx": np.asarray(cfg.sparse_approx)} if sparse else {}
                store.save(_key("map"), vec=map_vec.cpu().numpy(), target_hist=result["target_hist"], **extra)

    if cfg.do_hmc and map_vec is not None:
        t0 = time.time()
        # SMC's population of the dense GNMGP is one batched evaluation
        nlp_b = gnmgp.make_objective_batched(data, hyper=cfg.hyper) if (
            cfg.sampler == "smc" and cfg.model == "gnmgp") else None
        # the sparse layout is the dense one at the inducing inputs
        whitener = _make_sampling_whitener(nlp, map_vec, cfg, sp_z if sparse else xd, m_z if sparse else n, m,
                                           nlp_batched=nlp_b)
        generator = torch.Generator(device).manual_seed(cfg.seed)
        if cfg.sampler == "chees":
            samples, accept, result["sampling"] = _run_chain_chees(nlp, map_vec, cfg, generator, whitener=whitener)
        elif cfg.sampler == "smc":
            samples, accept, result["sampling"] = _run_chain_smc(nlp, map_vec, cfg, generator, whitener=whitener,
                                                                 nlp_batched=nlp_b)
        else:
            samples, accept = _run_chain(nlp, map_vec, cfg, generator, whitener=whitener)
        result["timings"]["hmc"] = time.time() - t0
        result["hmc_samples"] = samples
        result["hmc_accept"] = accept
        if store is not None:
            store.save(_key("hmc"), samples=samples.cpu().numpy())
            if "sampling" in result:
                # the sampler's own record, for the serving info endpoint
                store.save(_key("sampling"), **{k: v for k, v in result["sampling"].items() if np.isscalar(v)})

    if cfg.do_map_analysis and map_vec is not None and cfg.model in ("gnmgp", "gnmgp_sparse"):
        # the sparse layout is the dense one at the inducing inputs, so the
        # same unpack applies with N → m_z; "inputs" says where the processes live
        n_lat = m_z if sparse else n
        tilde_l, b_proc, cor_proc, std_proc = analysis.gnmgp_map_latents(map_vec.cpu().numpy(), n_lat, m)
        result["map_latents"] = {"tilde_l": tilde_l, "B": b_proc, "R": cor_proc,
                                 "stds": std_proc, "inputs": sp_z.cpu().numpy() if sparse else x}
        if "hmc_samples" in result:
            result["latent_summary"] = analysis.gnmgp_latent_summary(
                result["hmc_samples"].cpu().numpy(), n_lat, m
            )

    grid = torch.linspace(float(x.min()), float(x.max()), cfg.n_grid, dtype=dtype, device=device)
    if cfg.do_pred_grid and map_vec is not None:
        t0 = time.time()
        gp = _predict_map(cfg, map_vec, data, grid, device, dtype, sp_ops)
        result["timings"]["pred_grid"] = time.time() - t0
        result["pred_grid"] = gp
        result["grid"] = grid.cpu().numpy()
        if store is not None:
            store.save(_key("pred_grid"), percentiles=gp.percentiles.cpu().numpy(), grid=result["grid"])

    if cfg.do_pred_test and map_vec is not None and x_test is not None:
        tp = _predict_map(cfg, map_vec, data, as_t(x_test), device, dtype, sp_ops)
        result["pred_test"] = tp
        if cfg.do_evaluation:
            mean, std = tp.mean.cpu().numpy(), tp.std.cpu().numpy()
            result["test_rmse"] = evaluate.rmse(mean, y_test)
            result["test_lpd"] = evaluate.lpd(mean, std, y_test)
            result["test_pmse"] = evaluate.pmse(mean, y_test)
            if store is not None:
                store.save(_key("scores"), rmse=result["test_rmse"], lpd=result["test_lpd"])

    if cfg.do_evaluation and map_vec is not None:
        def dev(v):
            with torch.no_grad():
                if hsparse:
                    return -2.0 * gnmgp_sparse.log_lik_hetero(gnmgp_sparse.unpack_hetero(v, m_z, m), data, sp_ops,
                                                              approx=cfg.sparse_approx, hyper=cfg.hyper)
                if sparse:
                    # unpack is (vec, m) for the N-free LMC layout, (vec, m_z, m) for the others
                    p = model.unpack(v, m) if cfg.model == "lmc_sparse" else model.unpack(v, m_z, m)
                    return -2.0 * model.log_lik(p, data, sp_ops, approx=cfg.sparse_approx, hyper=cfg.hyper)
                return model.deviance(v, yd, xd)

        result["deviance"] = float(dev(map_vec))
        result["aic"] = evaluate.get_aic(map_vec, dev)
        result["bic"] = evaluate.get_bic(map_vec, dev, n_obs=n)
        if "hmc_samples" in result:
            result["dic"] = evaluate.get_dic(result["hmc_samples"], dev)
        if cfg.do_loo and "hmc_samples" in result:
            # fully Bayesian criteria from the chain: the pointwise terms are
            # the exact LOO conditionals of the joint MVN likelihood (no refits)
            hist = result["hmc_samples"]
            if hist.shape[0] > cfg.loo_draws:
                idx = np.linspace(0, hist.shape[0] - 1, cfg.loo_draws).astype(int)
                hist = hist[torch.as_tensor(idx, device=hist.device)]
            if sparse:
                cond_ll = evaluate.chain_conditional_loglik_sparse(hist, data, sp_ops, approx=cfg.sparse_approx,
                                                                   hyper=cfg.hyper, hetero=hsparse, model=cfg.model,
                                                                   device=device, dtype=dtype)
            else:
                cond_ll = evaluate.chain_conditional_loglik(cfg.model, hist, xd, yd, device=device, dtype=dtype)
            loo = evaluate.psis_loo(cond_ll)
            wa = evaluate.waic(cond_ll)
            result["loo"] = {
                "elpd_loo": loo["elpd_loo"], "p_loo": loo["p_loo"],
                "looic": loo["looic"], "n_bad_k": loo["n_bad_k"],
                "k_hat_max": float(np.max(loo["k_hat"])),
                "elpd_waic": wa["elpd_waic"], "p_waic": wa["p_waic"],
                "waic": wa["waic"],
            }
            if store is not None:
                store.save(_key("loo"), **result["loo"])
            # the pointwise elpd vector, kept out of the scalar artifact
            result["loo"]["pointwise"] = loo["pointwise"]
    return result


def _hadamard_start(seed: int, dim: int, device, dtype) -> torch.Tensor:
    """The MAP start of :func:`run_subject_hadamard`, ``v0 = 0.1·N(0, I)``
    with ``v0[-1] = −2`` (log noise variance), drawn from a CPU
    ``torch.Generator`` seeded by ``seed``, so that every device starts from
    the same point."""
    v0 = 0.1 * torch.randn(dim, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    v0[-1] = -2.0
    return v0.to(device=device, dtype=dtype)


def _hadamard_predictors(cfg: PipelineConfig, sp_ops=None):
    """The model's ``predict_map``, ``predict_test`` (mean and std) and
    ``predict_test_sample`` from ``predict.hadamard``, with ``cfg.hyper``
    bound where the JAX workflow passes it (not to LMC's); for a sparse
    model its ``*_hadamard`` predictors with its ``sp_ops``, ``cfg.hyper``
    and the approximation bound."""
    if cfg.model in SPARSE_MODELS:
        pred = _PREDICT[cfg.model]
        kw = {"hyper": cfg.hyper, "approx": cfg.sparse_approx}

        def predict_test(vec, data, x_test, indx_test, m, **dev):
            mean, var = pred.predict_test_hadamard(vec, data, sp_ops, m, x_test, indx_test, **kw, **dev)
            return mean, torch.sqrt(var)

        return [lambda vec, data, grid, m, **dev: pred.predict_map_hadamard(vec, data, sp_ops, m, grid, **kw, **dev),
                predict_test,
                lambda gen, hist, data, x_test, indx_test, m, **dev: pred.predict_test_hadamard_sample(
                    gen, hist, data, sp_ops, m, x_test, indx_test, **kw, **dev)]
    name = {"lmc": "lmc", "snmgp": "snmgp", "gnmgp": "svc"}[cfg.model]
    fns = [getattr(pred_h, f"{name}_{kind}") for kind in ("predict_map", "predict_test", "predict_test_sample")]
    if cfg.model == "lmc":
        return fns
    return [functools.partial(f, hyper=cfg.hyper) for f in fns]


def run_subject_hadamard(x, indx, y, m: int, cfg: PipelineConfig | None = None, device=None, dtype=None) -> dict:
    """Single-subject pipeline for Hadamard-layout data (one observation per
    (input, task) pair): the reference's ``*_non``/mimic data path
    (``utils.data_split_non``, ``logpos.nlogpos_obj_hadamard*``), on
    ``device`` (default ``cuda``, raising when there is none) in ``dtype``
    (default ``settings.dtype``).

    The training half is sorted by ``x`` with ``np.argsort``, as in JAX, so
    tied times keep one order.  MAP runs on the model's Hadamard objective
    from :func:`_hadamard_start` (a sparse model's at the m_z inducing
    inputs its objective chooses among the training times, fewer than
    ``n_inducing`` where times tie); then grid prediction, with ``do_hmc`` the
    chain (drawn from the stream JAX derives as ``fold_in(key, 3)``, seeded
    from ``SeedSequence([seed, 3])``) and with ``do_loo`` WAIC and PSIS-LOO
    from it, and with ``test_size`` > 0 the held-out scores by the MAP and,
    given a chain, by its draws (stream 9).  Returns the JAX function's
    result dict (tensors where it has arrays) and the stage ``timings``.
    """
    cfg = cfg or PipelineConfig()
    if cfg.model == "gnmgp_hetero_sparse":
        raise ValueError("gnmgp_hetero_sparse has no Hadamard objective — use model='gnmgp_sparse' (or the "
                         "full-layout hetero pipeline)")
    if cfg.model not in HADAMARD_MODELS:
        raise ValueError(
            f"model {cfg.model!r} has no Hadamard-layout objective in the torch package "
            f"(run_subject_hadamard runs {HADAMARD_MODELS})"
        )
    device = settings.resolve_device(device)
    dtype = dtype or settings.dtype
    x = np.asarray(x, float)
    indx = np.asarray(indx, int)
    y = np.asarray(y, float)
    _validate_hadamard(x, indx, y, m)
    if cfg.test_size > 0:
        x, x_te, indx, indx_te, y, y_te = preprocess.data_split_non(x, indx, y, test_size=cfg.test_size)
    else:
        x_te = indx_te = y_te = None
    order = np.argsort(x)
    x, indx, y = x[order], indx[order], y[order]
    n = x.shape[0]
    data = as_hadamard_data(x, indx, y, device, dtype)
    out: dict = {"n": n, "m": m, "timings": {}}

    t0 = time.time()
    sparse = cfg.model in SPARSE_MODELS
    sp_ops = None
    if sparse:
        nlp, sp_ops = _MODELS[cfg.model].make_objective_hadamard(data, m, n_inducing=cfg.n_inducing,
                                                                 approx=cfg.sparse_approx, hyper=cfg.hyper)
        n_lat, x_lat = sp_ops.z.shape[0], sp_ops.z  # the latent processes live at Z
    else:
        nlp = _MODELS[cfg.model].make_objective_hadamard(data, m, hyper=cfg.hyper)
        n_lat, x_lat = n, data.x
    predict_map, predict_test, predict_test_sample = _hadamard_predictors(cfg, sp_ops)
    res = map_mod.fit_map(nlp, _hadamard_start(cfg.seed, n_params(cfg.model, n_lat, m), device, dtype),
                          n_iters=cfg.n_opt, lr=cfg.lr, err_opt=cfg.err_opt, method=cfg.map_method)
    out["timings"]["map"] = time.time() - t0
    out["map_vec"] = res.vec
    out["target_hist"] = res.target_hist.cpu().numpy()
    if cfg.refine_z > 0 and sparse:
        # inducing-input refinement through the traced Hadamard objective;
        # every later stage conditions on the refined ops
        t0 = time.time()
        z_r, vec_r, sp_ops, _ = gnmgp_sparse.refine_inducing(
            data, sp_ops.z, res.vec, n_rounds=cfg.refine_z, z_iters=cfg.refine_z_iters, vec_iters=_refit_iters(cfg),
            lr_vec=cfg.lr, hyper=cfg.hyper, approx=cfg.sparse_approx, method=cfg.map_method, m=m, model=cfg.model)
        nlp, _ = _MODELS[cfg.model].make_objective_hadamard(data, m, z=z_r, approx=cfg.sparse_approx, hyper=cfg.hyper)
        res = res._replace(vec=vec_r)
        out["map_vec"] = vec_r
        out["refined_z"] = z_r.cpu().numpy()
        out["timings"]["refine_z"] = time.time() - t0
        n_lat, x_lat = sp_ops.z.shape[0], sp_ops.z
        predict_map, predict_test, predict_test_sample = _hadamard_predictors(cfg, sp_ops)

    if cfg.do_pred_grid:
        t0 = time.time()
        grid = torch.linspace(float(x.min()), float(x.max()), cfg.n_grid, dtype=dtype, device=device)
        out["pred_grid"] = predict_map(res.vec, data, grid, m, device=device, dtype=dtype)
        out["grid"] = grid.cpu().numpy()
        out["timings"]["pred_grid"] = time.time() - t0

    if cfg.do_hmc:
        t0 = time.time()
        whitener = _make_sampling_whitener(nlp, res.vec, cfg, x_lat, n_lat, m, hadamard=True)
        samples, accept = _run_chain(nlp, res.vec, cfg, _pilot_generator(cfg.seed, 3, device), whitener=whitener)
        out["timings"]["hmc"] = time.time() - t0
        out["hmc_samples"] = samples
        out["hmc_accept"] = accept
        if cfg.do_loo:
            t0 = time.time()
            hist = samples
            if hist.shape[0] > cfg.loo_draws:
                idx = np.linspace(0, hist.shape[0] - 1, cfg.loo_draws).astype(int)
                hist = hist[torch.as_tensor(idx, device=hist.device)]
            if sparse:
                cond_ll = evaluate.chain_conditional_loglik_sparse_hadamard(
                    hist, data, sp_ops, m, approx=cfg.sparse_approx, hyper=cfg.hyper, model=cfg.model,
                    device=device, dtype=dtype)
            else:
                cond_ll = evaluate.chain_conditional_loglik_hadamard(
                    cfg.model, hist, data.x, data.indx, data.y, m, device=device, dtype=dtype
                )
            loo = evaluate.psis_loo(cond_ll)
            wa = evaluate.waic(cond_ll)
            out["loo"] = {
                "elpd_loo": loo["elpd_loo"], "p_loo": loo["p_loo"],
                "looic": loo["looic"], "n_bad_k": loo["n_bad_k"],
                "k_hat_max": float(np.max(loo["k_hat"])),
                "elpd_waic": wa["elpd_waic"], "p_waic": wa["p_waic"],
                "waic": wa["waic"],
            }
            out["timings"]["loo"] = time.time() - t0

    if x_te is not None and cfg.do_pred_test:
        t0 = time.time()
        xt = torch.as_tensor(x_te, dtype=dtype, device=device)
        it = torch.as_tensor(indx_te, dtype=torch.long, device=device)
        mean, std = predict_test(res.vec, data, xt, it, m, device=device, dtype=dtype)
        out["test_rmse"] = evaluate.rmse(mean.cpu().numpy(), y_te)
        out["test_lpd"] = evaluate.lpd(mean.cpu().numpy(), std.cpu().numpy(), y_te)
        out["timings"]["pred_test"] = time.time() - t0
        if "hmc_samples" in out:
            # sample-based indexed scoring over the chain, the KAISER path
            # (reference test_predsample_hadamard, prediction.py:678-708)
            t0 = time.time()
            d = predict_test_sample(_pilot_generator(cfg.seed, 9, device), out["hmc_samples"], data, xt, it, m,
                                    device=device, dtype=dtype).cpu().numpy()  # (G_test, S)
            out["test_sample_rmse"] = evaluate.rmse(d.mean(axis=1), y_te)
            out["test_sample_lpd"] = evaluate.lpd(d.mean(axis=1), np.maximum(d.std(axis=1), 1e-8), y_te)
            out["timings"]["pred_test_sample"] = time.time() - t0
    return out
