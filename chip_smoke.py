#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, HMC, chain-consumer, other-model, whitened-NUTS, Hadamard-layout, mixed-precision, other-sampler, sparse-tier, sparse Hadamard and tempered-SMC paths on one NVIDIA card.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--phases kernels,sparse]

``--phases`` runs the named phases (comma-separated, of 2-17 below) and
those whose results they take (drift takes serving's; chain and precision
hmc's; nuts models'; samplers hmc's and models'), in the order below; the
default is every phase.  The summary then lists what those phases measured.

Phases, each printing its lines:

1. build     — compile the CUDA kernels from ``csrc/`` with nvcc (sm_90a),
               one nvcc per source, all started together.
2. kernels   — each kernel against its plain PyTorch version on the card, in
               float32 and float64, with its warm time, the plain version's
               time and its bound (bytes over 3.35 TB/s, operations over the
               peak rate of their type).  The forward kernels (K1's self and
               cross forms, K2 task-major, K3) must equal their plain
               versions bit for bit, and K1's self form must be exactly
               symmetric; K3 must equal K2's task-major output permuted to
               input-major.  A backward kernel's plain version is autograd
               through its forward's.  Each kernel of the training and
               serving paths must give bit-equal results on a repeat and is
               also timed with a cold L2; a forward beside a write floor
               (fill_ of the same bytes) with its route, a backward with its
               scratch bytes.  Each is also checked, untimed, at the other
               shapes its routes take: K1's self form at N = 1..1100 (single
               input, odd N, whole and ragged last tiles), its cross form at
               37 x 45; K2 at M = 1..4 with even and odd N and its generic
               route at M = 5, 9, 17, 33 and 130 (odd N, ragged tiles, task
               groups past the first staging chunk); K3's forward at every other M (1..8,
               an odd N·M, N = 1) and its generic route up to M = 130; K3's
               backward at M = 1, 4..8 and large M; K1's backward at
               N = 1..1100.  The generic routes of K3 are timed at
               K3_GENERIC_TIMED (N=200..1000, M = 9, 16, 32) in both types
               with their bounds by bytes and by operations, and one call
               of each profiled at N=1000, M=9 (the forward one device
               kernel, the backward three); K2's generic route is timed at
               N=1000, M = 5 and 9 in both types and one call of it profiled
               at M = 9 (one device kernel).  K1's cross form is also timed at the
               sparse path's 2000 x 64, and one call of its cross-form
               backward is profiled: it must be one device kernel.
3. serving   — (slice 1's path) a ``sim_mnts`` subject at N=1000, M=2
               (float64) written to an artifact store, served over HTTP by
               the port's ``serve``; its /predict answers are checked and
               held against ``predict_map`` on the CPU, and the served
               kernels' launch counts must have risen during the requests.
               A profile of a warm 201-point ``engine.predict`` follows.
4. drift     — where the card's 201-point answer departs from the CPU's: each
               stage (kriging, Gram factor, moments) on both, and the card's
               moments fed the CPU's kriged latents, which must match the
               CPU's at rtol 1e-6 with no absolute floor.
5. objective — the GNMGP and SNMGP MAP objectives at N=1000, M=2, and the
               GNMGP objective at N=200, M=9 (K3's generic routes): value and
               gradient on the card against the CPU at rtol 1e-6, gradient
               evaluations per second (GNMGP f64 and f32, SNMGP f64), the
               kernels launched per gradient, and a profile of one GNMGP
               gradient; then the GNMGP f64 gradient at N=1000, M=9: its
               launches (one of each K3 wrapper), gradient evaluations per
               second and a profile with the share of K3's routes; then the
               GNMGP f64 prediction at N=1000, M=9 (K2's generic route):
               ``predict_map`` on a 201-point grid and ``predict_sample``
               over 10 draws, each with its launches (K2 exactly once a map
               call and once a draw), wall and device ms, device ms by kernel
               and K2's share; and at N=200, M=9 the card against the CPU
               with the same draws and noise: both predictions at rtol 1e-6
               with a floor of 1e-6 of the scale, each draw's
               ``observation_cov`` and the LOO conditionals at rtol 1e-6.
6. training  — (slice 2's path) ``workflows.run_subject`` on the card for a
               ``sim_mnts`` subject at N=1000, M=2, f64 into an artifact
               store, with every kernel's launch count read around it; the
               port's server then answers a 201-point request from that
               store, held against ``predict_map`` on the CPU.  A smaller
               ``run_subject`` (N=200) on the card and on the CPU must agree
               on the final objective and the MAP vector at rtol 1e-6.
7. hmc       — (slice 3's path) ``workflows.run_subject`` with ``do_hmc=True``
               on the card, no device named, at N=1000, M=2, f64 with the
               default HMC config (100 draws of 20 leapfrog steps) into an
               artifact store: stage times, draws and gradients per second
               inside the chain, acceptance, DIC, the chain summaries; K3
               and its backward must launch exactly once per gradient of the
               chain, 1 + draws × leapfrog steps.  Then ``hmc_sample`` at
               N=200 on the card and on the CPU with the same injected noise
               for the plain, dual-averaging and windowed drivers: the same
               accept decisions, and draws and step sizes at rtol 1e-6.
8. chain     — (the chain's consumers' path, no device named) the
               LOO stage on the hmc phase's chain (``chain_conditional_loglik``,
               ``psis_loo``, ``waic``): its wall time with the card's and the
               host's parts, the criteria, and K2 launched exactly once per
               draw; ``mode="sample"`` over HTTP from the hmc phase's store at
               7, 201 and 1000 points over 100 draws, with warm latencies and
               K1 and K2 launched exactly once per draw per request, and a
               profile of one request; the LOO conditionals, ``predict_sample``
               and the three returns of ``predict_map_sampling`` card against
               CPU at N=200 with the same draws and noise; then
               ``run_subject(do_hmc=True, do_loo=True)`` at N=200 and the
               port's CLI into ``chiprun_out/cli``.
9. models    — (the other model families: LMC, SNMGP and the
               heteroscedastic GNMGP, no device named) for each model at
               N=1000, M=2, f64: the objective's value and gradient on the
               card against the CPU at rtol 1e-6, its gradient evaluations
               per second and a profile of one gradient;
               ``run_subject(do_hmc=True, do_loo=True)`` into a store with
               a chain of MODEL_CHAIN_DRAWS draws, its stage times, acceptance, DIC and LOO,
               and each kernel's launches counted exactly in the chain (per
               gradient), the DIC and the LOO stage (per draw);
               ``mode="map"`` and ``mode="sample"`` over HTTP from that store
               at 201 points, with warm latencies, exact launches per request,
               the map answer held against ``predict_map`` on the CPU and the
               card's ``predict_sample`` against the CPU's given the same
               draws and noise, and a profile of one sample request; then ``run_subject`` at N=200 on the card and
               on the CPU; and the CLI with ``--model gnmgp_hetero`` at N=200
               into ``chiprun_out/cli_hetero``.
10. nuts     — (whitened NUTS, no device named) (a) at N=200, M=2, f64 a
               prior-whitened and a retuned eig-mode (pncp-shaped) GNMGP
               chain of 6 draws at max_depth 5 on the card and on the CPU
               with the same injected noise: equal tree depths, leaf counts
               and divergence flags, draws at rtol 1e-6; then the CLI with
               ``--sampler nuts --whiten prior`` at N=48, max_depth 5, into
               ``chiprun_out/cli_nuts``.  (b) at N=1000, M=2, f64 from a MAP
               at ``n_opt=30``: GNMGP through ``run_subject(sampler="nuts",
               whiten="prior", do_loo=True)`` with 10 warmup and 10 kept
               draws (max_depth 6), and LMC, SNMGP and the hetero GNMGP
               through ``nuts_sample`` on their prior-whitened potentials
               with 10 + 10 draws at max_depth 6 (the hetero model also
               with 50 warmup draws, cut from run_subject's default 100), all at the
               default step (1e-4) and target: draws/s, gradients/s, tree depths,
               divergences, acceptance, the adapted step and the distinct
               kept draws; K3 and its backward (GNMGP, hetero) or K1 and its
               backward (LMC, SNMGP) must launch exactly 1 + Σ n_leapfrog
               times in each chain.
11. hadamard — (the Hadamard layout, no device named) the ``sim_mnts``
               subject at N=1000, M=2 with each (time, channel) cell
               dropped with probability 0.25 (about 1,500 observations,
               both channels at about 560 times): K1's self form and
               backward on its tied training inputs (N_obs ≈ 1,125) and its
               cross form against the grid and the test points, each equal
               to its plain version; each Hadamard objective's launches per
               gradient and gradient evaluations per second, and a profile
               of one GNMGP gradient; for LMC, SNMGP and GNMGP
               ``run_subject_hadamard(do_hmc=True, do_loo=True,
               n_opt=30)`` with MODEL_CHAIN_DRAWS draws, and GNMGP once more with
               ``sampler="nuts", whiten="prior"`` and 10 + 10 draws: stage
               times, gradients/s, acceptance, LOO, the test scores by the
               MAP and by the chain, and K1's launches counted exactly in
               each stage (K2 and K3 never launch); then the card against
               the CPU at about 200 observations: each objective's value
               and gradient and ``run_subject_hadamard``'s MAP vector at
               rtol 1e-6, the grid, test and sample predictions at rtol
               1e-6 with a floor of 1e-6 of the scale, the LOO conditionals
               at rtol 1e-8.
12. precision — (``NMGP_PRECISION=mixed``, switched in the process through
               ``settings.mixed_solves``) for GNMGP, LMC, SNMGP, the hetero
               GNMGP at N=1000, M=2 and the Hadamard GNMGP (about 1,130
               observations): launches per gradient, the mixed value
               against f64 at rtol 1e-8 and the gradient within 5e-3 of its
               scale, the refinement's sweeps, gradient evaluations per
               second under mixed against f64 in turns, and GNMGP's rate by
               the spacing of the refinement's host exit check; a profile
               of one mixed GNMGP gradient and K3's backward under the mixed
               cotangent against autograd of its plain version;
               ``run_subject(do_hmc=True, do_loo=True, n_opt=30)`` for
               GNMGP under mixed (stages, chain rate, acceptance, elpd_loo,
               K3's launches exactly 1 + draws × leapfrog in the chain);
               the card against the CPU at N=200 under mixed for each
               model; the CLI in a subprocess with NMGP_PRECISION=mixed
               into ``chiprun_out/cli_mixed``; A/B tables of the blocked
               Cholesky and triangular solve against cuSOLVER and cuBLAS at
               n = 512, 1000, 2000 and of the loop-free small factor and
               solve at n = 32..512, device and wall ms.
13. samplers — (DRHMC, ChEES and replica exchange, no device named) at
               N=1000, M=2, f64 from a MAP at ``n_opt=30``, 10 warmup + 10
               kept draws: ``run_subject(sampler="drhmc", do_loo=True)`` for
               GNMGP and LMC, ``run_subject(sampler="chees", whiten=True,
               do_loo=True)`` for GNMGP and ``run_subject_hadamard(sampler=
               "chees", do_loo=True)`` for the Hadamard phase's GNMGP
               subject: stage times, gradients/s against the objective's
               rate and fixed HMC's chain, DRHMC's accepting-stage
               histogram, stage-1 rate and step, ChEES's T, leapfrog counts,
               min-ESS and max R-hat, and the sampling stage's launches
               checked exactly against its gradients (DRHMC 1 + Σ(2^t −
               1)(L + 1); ChEES the K − 1 start descents, the start
               sanitizer and K a leapfrog step); ``tempered_hmc_sample`` on
               the whitened GNMGP potential with 4 replicas of 10 steps
               (swap and replica acceptance, launches); each sampler on the
               card against the CPU at N=200 with the same injected noise
               (equal accepting stages and leapfrog counts, draws at rtol
               1e-8, the whitened tempering chain's at 1e-6); the CLI with ``--sampler chees`` at N=48 into
               ``chiprun_out/cli_chees``.
14. sparse   — (the sparse GNMGP tier, no device named) at N=2000, m_z=64
               inducing inputs, M=2, f64: FITC and VFE gradient evaluations
               per second, launches per gradient (K1's cross form and its
               backward, K3 and its backward, once each) and a profile of one
               gradient; ``run_subject(model="gnmgp_sparse", do_hmc=True,
               do_loo=True, n_opt=30)`` with the default chain into a store,
               its stages, acceptance, elpd_loo and the launches of its
               chain, DIC and LOO stages counted exactly; prior-whitened NUTS
               from that MAP (10 + 10 draws, max_depth 6); ``mode="map"`` and
               ``mode="sample"`` over HTTP at 201 points (warm latencies,
               exact launches, the map answer against the CPU); one gradient
               under NMGP_PRECISION=mixed against f64; the card against the
               CPU at N=200, m_z=16 (objectives, gradients, run_subject's MAP
               at rtol 1e-6); the CLI with ``--model gnmgp_sparse`` at N=200
               into ``chiprun_out/cli_sparse``; one gradient rate at
               N=20,000, m_z=64.  The kernels phase also holds K1's
               cross-form backward against autograd of its plain version at
               2000 × 64, 2000 × 128, 1000 × 256 and 20,000 × 64 (timed)
               and at the other strip heights, column groups and ragged
               edges (untimed), and logs its walk (grid, rows a block,
               column groups, slots, tickets).
15. sparse_models — (the sparse SNMGP, LMC and heteroscedastic GNMGP tiers,
               no device named) for each at N=2000, m_z=64, M=2, f64: FITC
               and VFE gradient evaluations per second, exact launches per
               gradient (the separable tiers: K1's self form for K_zz and
               cross form for K_xz, and both backward kernels, σ and ℓ on
               both sides; the hetero tier the sparse GNMGP's) and a profile
               of one gradient; K1's self form, cross form and their
               backward kernels at the SNMGP path's own inputs against their
               plain versions; ``run_subject(do_hmc=True, do_loo=True,
               n_opt=30)`` into a store (each with 25 draws) with the
               launches of its chain,
               DIC and LOO stages counted exactly; warm ``POST /predict`` at
               201 points, mode="map" for each and mode="sample" for the
               separable tiers (exact launches), the hetero tier's sample
               request refused with a 400 as JAX's engine refuses it; the
               card against the CPU at N=200, m_z=16 (values and gradients
               under both approximations, run_subject's MAP at rtol 1e-6,
               predictions at rtol 1e-6 with a floor of 1e-6 of the scale,
               the LOO conditionals at 1e-8); one SNMGP gradient under
               NMGP_PRECISION=mixed against f64; the CLI with ``--model
               snmgp_sparse`` at N=200 into ``chiprun_out/cli_snmgp_sparse``.
16. sparse_hadamard — (the sparse models in the Hadamard layout, no device
               named) the hadamard phase's subject at N=2000 times (about
               3,000 observations, 2,240 training, tied times), m_z=64, f64,
               for ``gnmgp_sparse``, ``snmgp_sparse`` and ``lmc_sparse``:
               FITC and VFE gradients with their exact launches, gradient
               evaluations per second and a profile; K1's cross form (bit
               for bit) and its backward kernel at the path's tied inputs
               against their plain versions;
               ``run_subject_hadamard(do_hmc=True, do_loo=True, n_opt=30)``
               (the GNMGP tier with the default chain, the others with 25
               draws) with every stage's launches counted exactly; one GNMGP
               gradient under NMGP_PRECISION=mixed against f64; the card
               against the CPU at 200 times, m_z=16 (values, gradients,
               MAPs, predictions, LOO conditionals, chain-sample draws).
17. smc      — (tempered SMC, no device named) (a) K3 and its backward over a
               batch at (B, N, M) = (256, 200, 2) and (16, 1000, 2) and the
               generic route at (8, 200, 9), float64 and float32: equal to
               B single launches bit for bit and within KERNEL_TOL /
               GRAD_TOL of the per-member plain versions, timed beside the
               loop of B single launches and the plain versions, with their
               bound; one call of each profiled first, at (256, 200, 2) f64
               (one device kernel forward, two backward).  (b) The batched
               GNMGP objective at B=256, N=200, M=2 against the per-vector
               one on the card, member by member, values and gradients
               within 1e-10, a member on the jitter rung and one failing
               (NaN alone) among them; one population gradient launches each
               batched kernel once and peaks at most ``gnmgp.BATCH_COPIES``
               Grams a member above its inputs; its profile; the chunked
               route (8 members at N=1000, 3 a chunk) against the whole
               batch within 1e-10, with two forward launches and one
               backward a chunk.  (c) The slice's path:
               ``run_subject(sampler="smc", whiten="prior", do_hmc=True,
               do_loo=True, n_opt=30)`` at N=200 with the default smc_*
               fields (256 particles, 5 × 10 sweeps, metric "full"): β = 1, a
               finite evidence, one batched K3 forward a population value or
               gradient and one backward a gradient, no single-member K3 in
               the sampler; stages, particle gradients/s, accept, step; one
               stage profiled.  (d) The row route: SNMGP's ``smc_sample``
               (16 particles, 2 stages) with K1's launches counted against
               rows × evaluations, and ``run_subject_hadamard(sampler=
               "smc")`` on a subject of 60 times (16 particles, 2 × 5
               sweeps).
18. summary  — one JSON line listing every kernel, the card's name and power
               limit, and the final JSON line.

Any failed check raises and exits non-zero.  With no CUDA device, or without
the rest of the repository beside it, the script exits non-zero and prints
no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core
#: FLOP/s by dtype (float32 67 TFLOP/s, float64 34 TFLOP/s).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

#: Same formula in the same order on both sides, so only ulp differences of
#: exp/sqrt remain: (rtol, atol) by dtype.
KERNEL_TOL = {"float64": (1e-12, 0.0), "float32": (2e-6, 1e-7)}

#: The device every phase runs on.
DEVICE = "cuda"

SERVED_N, SERVED_M = 1000, 2
REQUEST_SIZES = (7, 201, 1000)
TIMED_REQUESTS = 5

#: The kernels of each path (slice 1: serving; slice 2: training).
SERVED_KERNELS = ("gibbs_gram", "svc_gram")
TRAINING_KERNELS = ("gibbs_gram", "gibbs_gram_backward", "svc_gram", "svc_gram_tiled",
                    "svc_gram_tiled_backward")

#: Backward kernels against autograd through the plain versions: the sums
#: run in another order, so the tolerance is relative to the gradient's
#: largest |entry|, by dtype; where that entry is subnormal, GRAD_TINY units
#: of the type's smallest normal instead (a relative bound there falls under
#: one subnormal step, so rounding alone could break it).
GRAD_TOL = {"float64": 1e-10, "float32": 1e-4}
GRAD_TINY = 4

#: K3's backward is timed at N=1000 M=2 and N=257 M=3; these (N, M) cover
#: the other M it is compiled for, each checked once.
K3_BWD_OTHER_SHAPES = ((100, 1), (100, 4), (100, 5), (64, 5), (77, 6), (61, 7), (50, 8))

#: K3's forward is timed at N=1000 M=2 and N=257 M=3; these (N, M) cover the
#: other M of its vector and scalar routes, an odd N·M and N = 1, each
#: checked once.
K3_FWD_OTHER_SHAPES = ((100, 1), (100, 4), (64, 5), (77, 6), (61, 7), (50, 8), (37, 3),
                       (1, 1), (1, 2), (1, 5))

#: K3's generic routes (M > 8), checked once each: the forward where its
#: first design staged L and overflowed a block's shared memory (f64 from
#: M = 30, f32 from M = 43), the backward beyond the templated M = 8; and the
#: (N, M) of their timed rows and of the objective phase's M > 8 check.
K3_FWD_GENERIC_SHAPES = {"float64": ((40, 9), (24, 29), (24, 30), (8, 64), (4, 130)),
                         "float32": ((40, 9), (24, 42), (24, 43), (4, 130))}
K3_BWD_GENERIC_SHAPES = ((40, 9), (33, 12), (20, 16), (12, 30), (4, 130))
#: K3's generic routes are timed, in both types, at the objective phase's
#: N=200, M=9 check, the M=9 gradient's N=1000, M = 16 at N=500 (where the
#: forward's arithmetic meets its bytes), M = 32 at N=200 (where it sets the
#: bound) and N=64, M=9 (the sparse tier's K_mm at m_z = 64);
#: K3_GENERIC_PROFILED is profiled for its device kernels a call.
GENERIC_N, GENERIC_M = 200, 9
K3_GENERIC_TIMED = ((GENERIC_N, GENERIC_M), (1000, 9), (500, 16), (200, 32), (64, 9))
K3_GENERIC_PROFILED = (1000, 9)
#: K2's generic route (M > 4, the prediction path's task-major Gram at M > 4)
#: is timed at these (N, M), in float64 (from the generic routes' generator,
#: as since it was first timed) and float32 (from K2's own), and profiled at
#: K2_GENERIC_PROFILED for its device kernels a call; K2_GENERIC_SHAPES are
#: checked once each, untimed, in both types from K2's own generator: odd N
#: (scalar stores), ragged tiles, one tile walked by many units, small task
#: groups (M = 33), M = 130, and b staged in chunks (M = 120 in float64; M =
#: 430, past where two whole tasks fit a block in either type).
K2_GENERIC_TIMED = ((1000, 5), (1000, 9))
K2_GENERIC_PROFILED = (1000, 9)
K2_GENERIC_SHAPES = ((37, 9), (130, 9), (66, 17), (37, 33), (1, 130), (4, 130), (37, 120), (3, 430))
#: The GNMGP prediction at M > 4 (K2's generic route): predict_map on a
#: PREDICT_GRID-point grid and predict_sample over PREDICT_DRAWS draws (the
#: MAP vector and small perturbations of it) at N=PREDICT_N, M=PREDICT_M, f64;
#: the card against the CPU at N=PREDICT_CHECK_N with the same draws and
#: noise.
PREDICT_N, PREDICT_M, PREDICT_GRID, PREDICT_DRAWS, PREDICT_CHECK_N = 1000, 9, 201, 10, 200
#: The GNMGP f64 gradient at M > 8 (K3's generic routes) that the objective
#: phase rates and profiles.
GRADIENT_N, GRADIENT_M = 1000, 9

#: K1's forward, self form, is timed at N=1000 (pairs route) and N=257
#: (threads route); these N cover the threads route up to N = 735 and the
#: pairs route above it (odd N: scalar stores; N % 4 = 2: float32's two-value
#: stores; whole and ragged last tiles), each checked once.  Up to N = 735
#: the pairs route is also checked by a launch with its schedule, so that
#: its single-input and small ragged tiles run too.  The cross form is also
#: checked at a ragged 37 x 45.
K1_FWD_OTHER_SIZES = (1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 600, 737, 738, 1024, 1100)
K1_CROSS_OTHER_SHAPES = ((37, 45), (1, 1))

#: K2 is timed at N=1000 M=2 and N=257 M=3; these (N, M) cover M = 1..4 on
#: the vector route (float64: even N; float32: N divisible by 4 or 2) and the
#: scalar route (odd N), N = 1, and the generic route (M > 4), each checked
#: once.
K2_OTHER_SHAPES = ((64, 1), (37, 1), (38, 2), (37, 2), (36, 3), (37, 3), (40, 4), (37, 4), (1, 2),
                   (40, 5), (24, 9), (12, 17))

#: K1's backward is timed at N=1000 and N=257; these N cover a single input,
#: whole and ragged last tiles of 16 and 32 inputs, and more partial slots
#: than a warp has lanes (N = 1100: 35), each checked once.
K1_BWD_OTHER_SIZES = (1, 16, 17, 31, 32, 33, 600, 1024, 1100)

#: K1's cross-form backward (the sparse tier's K_xz) is timed at the sparse
#: path's N × m_z = 2000 × 64 and 2000 × 128, at 1000 × 256 and at the
#: N = 20,000 rate's 20,000 × 64; these (N1, N2) cover a single input,
#: ragged strips and column chunks, column groups (3 at 500 × 130, 4 of 3
#: chunks at 1000 × 600, 11 at 200 × 700), strips of several 4-row groups a
#: warp, and the tallest strip with more blocks than SMs (70,000 × 3), each
#: checked once.  K1's cross forward is also timed at the sparse path's
#: 2000 × 64 (σ ≡ 1 on both sides, as K_xz is built).
K1_CROSS_BWD_TIMED = ((2000, 64), (2000, 128), (1000, 256), (20000, 64))
K1_CROSS_BWD_OTHER_SHAPES = ((1, 1), (37, 45), (600, 33), (500, 130), (1000, 600), (200, 700), (3000, 20),
                             (9000, 40), (70000, 3))
K1_CROSS_SPARSE = (2000, 64)

#: The training path: the objective phase's shape, the run_subject subject
#: and budget, and the card-vs-CPU run.
TRAIN_N, TRAIN_N_OPT = 1000, 30
CHECK_N, CHECK_N_OPT = 200, 20

#: The HMC path: the K3 kernels run once per gradient of the chain; the
#: card-vs-CPU chains at N=HMC_CHECK_N take this many kept draws, leapfrog
#: steps and warmup draws (the adaptive drivers).
HMC_KERNELS = ("svc_gram_tiled", "svc_gram_tiled_backward")
HMC_CHECK_N, HMC_CHECK_DRAWS, HMC_CHECK_LEAPFROG, HMC_CHECK_WARMUP = 200, 6, 5, 6
OBJECTIVE_RTOL = 1e-6
RATE_BATCHES, RATE_EVALS = 5, 5

#: The served answer against the CPU plain path: rtol, and an absolute floor
#: as a fraction of the largest |value| for entries near 0.
SERVED_RTOL, SERVED_ATOL_OF_SCALE = 1e-6, 1e-6

#: The chain's consumers: mode="sample" requests take the chain's last
#: CHAIN_N_SAMPLE draws; the card-vs-CPU checks run at N=CHAIN_CHECK_N with
#: CHAIN_CHECK_DRAWS draws, the LOO conditionals at rtol CHAIN_LOO_RTOL (with
#: a floor of that fraction of the scale) and the kriged latents with an
#: absolute floor KRIGE_ATOL (the kriging solve's condition, as in the CPU
#: tests); the CLI samples CHAIN_CLI_HMC draws.
CHAIN_N_SAMPLE = 100
CHAIN_CHECK_N, CHAIN_CHECK_DRAWS, CHAIN_CLI_HMC = 200, 8, 20
CHAIN_LOO_RTOL, KRIGE_ATOL = 1e-8, 5e-7

#: The other dense model families: the kernels each launches per gradient of
#: its objective, per DIC draw, per LOO draw, per mode="map" request and per
#: draw of a mode="sample" request (K1's self and cross forms both count as
#: gibbs_gram); every other kernel must launch 0 times there.  The card's
#: predict_sample is held against the CPU's over MODELS_CHECK_DRAWS draws;
#: the CLI samples CHAIN_CLI_HMC draws.  The run_subject(do_hmc=True) chains
#: of this phase and of the hadamard phase take MODEL_CHAIN_DRAWS draws of 20
#: leapfrog steps (501 gradients), cut from the default 100 to keep the smoke
#: well inside its time limit on a slow host; the hmc phase and the sparse
#: phases' GNMGP tiers keep the default chain.
MODEL_FAMILIES = ("lmc", "snmgp", "gnmgp_hetero")
MODEL_CHAIN_DRAWS = 25
MODEL_LAUNCHES = {
    "lmc": {"gradient": {"gibbs_gram": 1, "gibbs_gram_backward": 1}, "dic": {"gibbs_gram": 1},
            "loo": {"gibbs_gram": 1}, "map_request": {}, "sample_draw": {}},
    "snmgp": {"gradient": {"gibbs_gram": 1, "gibbs_gram_backward": 1}, "dic": {"gibbs_gram": 1},
              "loo": {"gibbs_gram": 1}, "map_request": {"gibbs_gram": 2}, "sample_draw": {"gibbs_gram": 2}},
    "gnmgp_hetero": {"gradient": {"svc_gram_tiled": 1, "svc_gram_tiled_backward": 1},
                     "dic": {"svc_gram_tiled": 1}, "loo": {"svc_gram": 1},
                     "map_request": {"svc_gram": 1, "gibbs_gram": 1},
                     "sample_draw": {"svc_gram": 1, "gibbs_gram": 1}},
}
MODELS_CHECK_DRAWS = 4

#: Whitened NUTS: the card-vs-CPU chains at N=NUTS_CHECK_N (warmup and kept
#: draws, max_depth); the CLI at N=NUTS_CLI_N with NUTS_CLI_HMC draws (and
#: the CLI's max(100, n_hmc) warmup draws, which at the default max_depth 8
#: ran most of their trees to 255 leaves and took 115-170 s: the CLI has no
#: depth flag, so its sampler's max_depth is cut to NUTS_CLI_DEPTH); at N=TRAIN_N each model's chain takes
#: NUTS_WARMUP + NUTS_DRAWS draws at max_depth NUTS_MODEL_DEPTH (GNMGP
#: through run_subject too: at the default 8 its trees ran to 255 leaves and
#: the chain took 32-64 s), and the hetero model once more with NUTS_HETERO_WARMUP warmup draws
#: (cut from run_subject's default 100 when the sparse phase joined the
#: smoke: at 100 its chain took 27.7-37.7 s).  Each leaf is one gradient, so each chain
#: launches the kernels of its model's gradient 1 + Σ n_leapfrog times.
NUTS_CHECK_N, NUTS_CHECK_WARMUP, NUTS_CHECK_DRAWS, NUTS_CHECK_DEPTH = 200, 3, 3, 5
NUTS_CLI_N, NUTS_CLI_HMC, NUTS_CLI_DEPTH = 48, 4, 5
NUTS_WARMUP, NUTS_DRAWS, NUTS_MODEL_DEPTH, NUTS_HETERO_WARMUP = 10, 10, 6, 50
NUTS_KERNELS = {"gnmgp": HMC_KERNELS, "gnmgp_hetero": HMC_KERNELS,
                "lmc": ("gibbs_gram", "gibbs_gram_backward"), "snmgp": ("gibbs_gram", "gibbs_gram_backward")}


#: The Hadamard layout: the headline ``sim_mnts`` subject at N=TRAIN_N, M=2
#: with each (time, channel) cell dropped with probability HADAMARD_DROP
#: (``np.random.default_rng(seed)``), so about 1,500 observations at about
#: 1,000 times, both channels at about 560 of them; ``run_subject_hadamard``
#: holds out HADAMARD_TEST_SIZE of them.  K1's launches (self and cross form
#: both count as gibbs_gram) per gradient, per LOO draw, per MAP prediction
#: (one self form and one cross form) and per draw of the chain-sample
#: prediction; every other kernel must launch 0 times on this path.  The
#: card-vs-CPU checks run on HADAMARD_CHECK_TIMES times (about 200
#: observations) with HADAMARD_CHECK_DRAWS draws.
HADAMARD_MODELS = ("lmc", "snmgp", "gnmgp")
HADAMARD_DROP, HADAMARD_TEST_SIZE = 0.25, 0.25
HADAMARD_CHECK_TIMES, HADAMARD_CHECK_DRAWS = 134, 4
_K1_HADAMARD = {"gradient": {"gibbs_gram": 1, "gibbs_gram_backward": 1}, "loo": {"gibbs_gram": 1},
                "prediction": {"gibbs_gram": 2}, "sample_draw": {"gibbs_gram": 2}}
HADAMARD_LAUNCHES = {"lmc": dict.fromkeys(_K1_HADAMARD, {}), "snmgp": _K1_HADAMARD, "gnmgp": _K1_HADAMARD}

#: The precision tier (NMGP_PRECISION=mixed, switched in the process through
#: ``settings.mixed_solves``): each model's objective at N=TRAIN_N under
#: mixed against f64, its value within MIXED_VALUE_RTOL and its gradient
#: within MIXED_GRAD_TOL of the f64 gradient's largest |entry| (float32-class
#: by design); the refinement's host exit check every k sweeps for k in
#: PRECISION_CHECK_EVERY (IR_MAX_SWEEPS: never); the card against the CPU at
#: N=PRECISION_CHECK_N (the Hadamard subject at PRECISION_CHECK_TIMES times,
#: about 225 training observations, past the mixed gate); the blocked routes
#: against cuSOLVER and cuBLAS at BLOCKED_AB_N and the loop-free small
#: factors at UNROLLED_AB_N, their solves against UNROLLED_AB_COLS columns
#: (the sparse tier's K_mn at N=1000, M=2).
MIXED_VALUE_RTOL, MIXED_GRAD_TOL = 1e-8, 5e-3
#: The blocked routes do the default routes' float64 arithmetic in another
#: order: values, gradients and predictions against them at this rtol (with
#: a floor of it times the largest |entry|).
BLOCKED_RTOL = 1e-8
PRECISION_CHECK_EVERY = (1, 4, 20)
PRECISION_CHECK_N, PRECISION_CHECK_TIMES = 200, 200
BLOCKED_AB_N = (512, 1000, 2000)
UNROLLED_AB_N = (32, 64, 128, 256, 512)
UNROLLED_AB_COLS = 2000


#: The samplers (DRHMC, ChEES, replica exchange): at N=TRAIN_N each chain
#: takes SAMPLER_WARMUP warmup and SAMPLER_DRAWS kept draws (cut from
#: run_subject's max(100, n_hmc) + 100), tempering SAMPLER_REPLICAS replicas
#: of SAMPLER_TEMPER_LEAPFROG steps (cut from 20); the card against the CPU
#: at N=SAMPLER_CHECK_N with injected noise, draws at SAMPLER_CHECK_RTOL
#: (the whitened tempering chain at OBJECTIVE_RTOL);
#: the CLI with --sampler chees at N=SAMPLER_CLI_N (its run_subject's 100
#: warmup draws: the CLI has no warmup flag).
SAMPLER_WARMUP, SAMPLER_DRAWS, SAMPLER_REPLICAS, SAMPLER_TEMPER_LEAPFROG = 10, 10, 4, 10
SAMPLER_CHECK_N, SAMPLER_CHECK_RTOL, SAMPLER_CLI_N, SAMPLER_CLI_HMC = 200, 1e-8, 48, 4
#: The card-vs-CPU chains: DRHMC's first step (its draws then accept at
#: every stage: 1, 3, 2, 1, 1, 1 on the CPU), and ChEES's initial trajectory
#: time in steps, not a multiple of a Halton point's inverse, so that the
#: first draws' ceil(tau / eps) is not a tie that the last bit could flip.
DRHMC_CHECK_STEP, CHEES_CHECK_T = 1e-3, 17.3
K1_KERNELS = ("gibbs_gram", "gibbs_gram_backward")

#: The sparse tier (``gnmgp_sparse``): the path at N=SPARSE_N, m_z=SPARSE_M_Z
#: inducing inputs, M=2, f64 (the JAX tier's own headline shape and its
#: default n_inducing); the card against the CPU at N=SPARSE_CHECK_N,
#: m_z=SPARSE_CHECK_M_Z; one gradient rate at N=SPARSE_BIG_N, where the dense
#: path's (2N)² Gram would take 12.8 GB.  One sparse gradient launches each
#: kernel of SPARSE_GRADIENT once (K1's cross form builds K_xz, K3 K_mm); a
#: value (a DIC or LOO draw) each of SPARSE_VALUE once; a mode="map" request
#: (and each draw of a mode="sample" one) also K1's cross form for K_gz.
SPARSE_N, SPARSE_M_Z, SPARSE_CHECK_N, SPARSE_CHECK_M_Z, SPARSE_BIG_N = 2000, 64, 200, 16, 20000
SPARSE_GRADIENT = {"gibbs_gram": 1, "gibbs_gram_cross_backward": 1, "svc_gram_tiled": 1, "svc_gram_tiled_backward": 1}
SPARSE_VALUE = {"gibbs_gram": 1, "svc_gram_tiled": 1}
SPARSE_REQUEST = {"gibbs_gram": 2, "svc_gram_tiled": 1}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(torch, fn, batches: int = 5, reps: int = 20) -> float:
    """Median over ``batches`` of the mean device time of ``reps`` back-to-back
    calls, by CUDA events.  A sleep kernel queued first keeps the device busy
    while the host enqueues, so host overhead does not count as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def time_cold_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of one call to ``fn`` with a cold L2: a 128 MB
    buffer (over twice the H100's 50 MB L2) is written before each call,
    and each call is timed alone by CUDA events.  A sleep kernel queued
    first keeps the host's enqueueing out of the times."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    events = []
    torch.cuda._sleep(50_000_000)
    for _ in range(reps):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def check_close(torch, name, got, want, dtype_name) -> float:
    """Elementwise |got - want| <= atol + rtol |want|; returns the max abs error."""
    rtol, atol = KERNEL_TOL[dtype_name]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bad.any():
        rel = (diff / want.abs()).max().item()
        raise AssertionError(f"{name}: {int(bad.sum())} entries off (max rel err {rel:.3e})")
    return diff.max().item()


def check_grad(torch, name, got, want, dtype_name) -> float:
    """Backward outputs against autograd of the plain version: every entry
    within GRAD_TOL of the output's largest |entry| or, where that entry is
    subnormal, within GRAD_TINY units of the type's smallest normal; returns
    the max abs error."""
    err = 0.0
    tiny = torch.finfo(getattr(torch, dtype_name)).tiny
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite kernel output")
        diff = (g - w).abs().max().item()
        scale = w.abs().max().item()
        bound = GRAD_TOL[dtype_name] * scale if scale >= tiny else GRAD_TINY * tiny
        if not diff <= bound:
            raise AssertionError(f"{name}: off by {diff:.3e} against a scale of {scale:.3e}")
        err = max(err, diff)
    return err


def kernel_inputs(torch, gen, n, dtype, device):
    """Inputs shaped like the served path's: sorted x on (0, 1), lengthscales
    exp(3(x−1)³ − 3 + noise), scales around 1."""
    x = torch.sort(torch.rand(n, generator=gen, dtype=torch.float64)).values
    ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(n, generator=gen, dtype=torch.float64))
    sigma = 0.5 + 1.5 * torch.rand(n, generator=gen, dtype=torch.float64)
    return [t.to(device=device, dtype=dtype) for t in (x, sigma, ell)]


def phase_kernels(torch, gk, settings, cross_columns, seed):
    """Each kernel against its plain version; returns the main-path timings.

    K1's cross form runs at 1000 x ``cross_columns``: every grid bucket the
    served path pads a request to."""
    gen = torch.Generator().manual_seed(seed)
    # the generic routes' timed rows (but K3's at GENERIC_N, GENERIC_M in
    # float64, timed before the others joined) draw from a generator of their
    # own, so that every other check keeps its inputs
    gen_g = torch.Generator().manual_seed(seed + 17)
    gen_k2 = torch.Generator().manual_seed(seed + 18)  # K2's generic rows added since
    dev = torch.device(DEVICE)
    sms = gk.sm_count(dev)
    main, generic = {}, {}  # generic: the generic routes' timed rows (K3 M > 8, K2 M > 4)
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).replace("torch.", "")
        size = torch.tensor([], dtype=dtype).element_size()
        cases = []
        # forward kernels checked bit for bit and timed cold beside a write
        # floor: label -> (outputs, schedule, description of the walk)
        fwd = {}
        # K1 self form at N=1000 and a ragged N=257; cross form at each bucket
        for n in (1000, 257):
            x, s, l = kernel_inputs(torch, gen, n, dtype, dev)
            label = f"gibbs_gram self N={n}"
            sched = gk.k1_forward_schedule(n, n, True, dtype, sms)
            fwd[label] = (n * n, sched, k1_walk(sched))
            cases.append((
                label, "gibbs_gram",
                lambda x=x, s=s, l=l: gk.gibbs_gram(x, s, l, jitter=settings.jitter),
                lambda x=x, s=s, l=l: gk.gibbs_gram_plain(x, s, l, x, s, l, settings.jitter),
                3 * n * size + n * n * size, 15 * n * n,
            ))
        # the served path's σ ≡ 1 at each bucket, and the sparse path's K_xz
        for n1, n2 in [(SERVED_N, g) for g in cross_columns] + [K1_CROSS_SPARSE]:
            x1, s1, l1 = kernel_inputs(torch, gen, n1, dtype, dev)
            x2, s2, l2 = kernel_inputs(torch, gen, n2, dtype, dev)
            s1, s2 = torch.ones_like(s1), torch.ones_like(s2)
            label = f"gibbs_gram cross {n1}x{n2}"
            sched = gk.k1_forward_schedule(n1, n2, False, dtype, sms)
            fwd[label] = (n1 * n2, sched, k1_walk(sched))
            cases.append((
                label, "gibbs_gram",
                lambda a=(x1, s1, l1, x2, s2, l2): gk.gibbs_gram(*a),
                lambda a=(x1, s1, l1, x2, s2, l2): gk.gibbs_gram_plain(*a),
                3 * (n1 + n2) * size + n1 * n2 * size, 15 * n1 * n2,
            ))
        # K2 (task-major; the input-major layout is K3's) at the served shape
        # and a ragged N=257, M=3
        for n, m in ((1000, 2), (257, 3)) + K2_GENERIC_TIMED:
            g = gen if m <= 4 else gen_g if dn == "float64" else gen_k2
            x, _, l = kernel_inputs(torch, g, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=g, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            label = f"svc_gram task N={n} M={m}"
            sched = gk.k2_schedule(n, m, dtype, sms)
            fwd[label] = ((n * m) ** 2, sched, k2_walk(sched))
            cases.append((
                label, "svc_gram",
                lambda x=x, l=l, ls=ls: gk.svc_gram(x, l, ls, settings.jitter),
                lambda x=x, l=l, ls=ls: gk.svc_gram_plain(x, l, ls, settings.jitter),
                (2 * n + n * m * m) * size + (n * m) ** 2 * size, n * n * (12 + 2 * m**3),
            ))
        # K3 and the two backward kernels (the training path) at the served
        # shape and a ragged N=257, M=3, then K3's generic routes
        grads, k3_shapes, k1_sizes = [], {}, {}
        for n, m in ((1000, 2), (257, 3)) + K3_GENERIC_TIMED:
            shared = m <= gk.K3_MAX_M or (dn == "float64" and (n, m) == (GENERIC_N, GENERIC_M))
            g = gen if shared else gen_g
            x, s, l = kernel_inputs(torch, g, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=g, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            kbar = torch.randn(n * m, n * m, generator=g, dtype=torch.float64).to(dev, dtype)
            kbar1 = torch.randn(n, n, generator=g, dtype=torch.float64).to(dev, dtype)
            k3_equals_k2(torch, gk, settings, f"svc_gram_tiled N={n} M={m} {dn}", x, l, ls)
            sched = gk.k3_forward_schedule(n, m, dtype, sms)
            walk = (f"tiles of {sched.rows} x {sched.rows} outputs, {sched.warps} warps a block, grid {sched.grid}"
                    if sched.route == "generic" else strip_walk(sched))
            fwd[f"svc_gram_tiled N={n} M={m}"] = ((n * m) ** 2, sched, walk)
            out_bytes = (n * m) ** 2 * size
            cases.append((
                f"svc_gram_tiled N={n} M={m}", "svc_gram_tiled",
                lambda x=x, l=l, ls=ls: gk.svc_gram_tiled(x, l, ls, settings.jitter),
                lambda x=x, l=l, ls=ls: gk.svc_gram_tiled_plain(x, l, ls, settings.jitter),
                (2 * n + n * m * m) * size + out_bytes, n * n * 12 + (n * m) ** 2 * 2 * m,
            ))
            k3_shapes[f"svc_gram_tiled_backward N={n} M={m}"] = (n, m)
            grads.append((
                f"svc_gram_tiled_backward N={n} M={m}", "svc_gram_tiled_backward",
                lambda x=x, l=l, ls=ls, kb=kbar: gk.svc_gram_tiled_backward(x, l, ls, kb, settings.jitter),
                lambda x=x, l=l, ls=ls, kb=kbar: gk.svc_gram_tiled_backward_plain(x, l, ls, settings.jitter, kb),
                out_bytes + (2 * n + n * m * m) * size + (n + n * m * m) * size,
                # the generic route: S once, then M fma a side for each element of S
                n * n * 25 + (n * m) ** 2 * ((2 * m + 1) if m > gk.K3_MAX_M else (4 * m + 3)),
            ))
            if m > gk.K3_MAX_M:
                continue  # K1's backward is timed at the training path's shapes alone
            k1_sizes[f"gibbs_gram_backward N={n}"] = n
            grads.append((
                f"gibbs_gram_backward N={n}", "gibbs_gram_backward",
                lambda x=x, s=s, l=l, kb=kbar1: gk.gibbs_gram_backward(x, s, l, kb, settings.jitter),
                lambda x=x, s=s, l=l, kb=kbar1: gk.gibbs_gram_backward_plain(x, s, l, settings.jitter, kb),
                n * n * size + 5 * n * size, n * n * 30,
            ))
        # K1's cross-form backward (the sparse tier's K_xz, both sides' σ̄ and ℓ̄)
        k1x_shapes = {}
        for n1, n2 in K1_CROSS_BWD_TIMED:
            x1, s1, l1 = kernel_inputs(torch, gen, n1, dtype, dev)
            x2, s2, l2 = kernel_inputs(torch, gen, n2, dtype, dev)
            kbar = torch.randn(n1, n2, generator=gen, dtype=torch.float64).to(dev, dtype)
            label = f"gibbs_gram_cross_backward {n1}x{n2}"
            k1x_shapes[label] = (n1, n2)
            args = (x1, s1, l1, x2, s2, l2, kbar)
            grads.append((
                label, "gibbs_gram_cross_backward",
                lambda args=args: gk.gibbs_gram_cross_backward(*args),
                lambda args=args: gk.gibbs_gram_cross_backward_plain(*args),
                # K̄ and the six input vectors read once, the four gradients written once
                n1 * n2 * size + 5 * (n1 + n2) * size, n1 * n2 * 32,
            ))
        # the generic routes' plain versions build (N, M, N, M) tensors M times over:
        # timed over fewer calls
        slow_plain = {f"svc_gram_tiled{b} N={n} M={m}" for n, m in K3_GENERIC_TIMED for b in ("", "_backward")}
        slow_plain |= {f"svc_gram task N={n} M={m}" for n, m in K2_GENERIC_TIMED}
        main_labels = (f"gibbs_gram cross {SERVED_N}x256", "svc_gram task N=1000 M=2",
                       "svc_gram_tiled N=1000 M=2", "svc_gram_tiled_backward N=1000 M=2",
                       "gibbs_gram_backward N=1000", "gibbs_gram_cross_backward 2000x64")
        rows = {}
        for label, kname, kern, plain, nbytes, ops in cases + grads:
            if kname.endswith("_backward"):
                err = check_grad(torch, f"{label} {dn}", kern(), plain(), dn)
            else:
                err = check_close(torch, f"{label} {dn}", kern(), plain(), dn)
            torch.cuda.synchronize()
            ms = time_ms(torch, kern)
            plain_ms = time_ms(torch, plain, 3, 3) if label in slow_plain else time_ms(torch, plain)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_FLOPS[dn] * 1e3
            row = {
                "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            }
            row["share_of_bound"] = row["bound_ms"] / ms
            log("kernels", f"{label} {dn}: ok, max_abs_err={err:.3e} ms={ms:.5f} "
                f"plain_ms={plain_ms:.5f} bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; bytes "
                f"{bytes_ms:.5f}, operations {ops_ms:.5f}), {100 * row['share_of_bound']:.1f}% of it")
            if label in k3_shapes or label in k1_sizes or label in k1x_shapes:
                # a backward: bit-equal on a repeat, a cold-L2 time (K̄'s 32
                # MB at N=1000, M=2, f64 fits in the 50 MB L2), its scratch
                first, again = kern(), kern()
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{label} {dn}: two launches on the same inputs differ")
                if label in k3_shapes:
                    sched = gk.k3_backward_schedule(*k3_shapes[label], gk.sm_count(dev))
                    walk = (f"{sched.route} route, {sched.n_pairs} tile pairs of {sched.tile} "
                            + ("flattened rows" if sched.route == "generic" else "inputs") + f", grid {sched.grid}")
                elif label in k1x_shapes:
                    sched = gk.k1_cross_backward_schedule(*k1x_shapes[label], gk.sm_count(dev))
                    walk = k1x_walk(sched)
                else:
                    sched = gk.k1_backward_schedule(k1_sizes[label], gk.sm_count(dev))
                    walk = f"{sched.n_pairs} tile pairs of {sched.tile} inputs, grid {sched.grid}"
                route = "strips" if label in k1x_shapes else getattr(sched, "route", "tiled")
                scratch = (sched.scratch_bytes(dtype) if label in k3_shapes
                           else (sched.slots_numel if label in k1x_shapes else sched.partial_numel) * size)
                row.update(cold_ms=time_cold_ms(torch, kern), scratch_bytes=scratch,
                           kernel_route=route, repeat_bit_equal=True)
                log("kernels", f"{label} {dn}: two launches bit-equal; cold-L2 ms={row['cold_ms']:.5f} "
                    f"(warm {ms:.5f}); scratch {row['scratch_bytes']} B; {walk}")
            if label in fwd:
                # a forward: bit-equal to its plain version and on a repeat
                # (K1's self form also exactly symmetric), a cold-L2 time, the
                # write floor (fill_ of the same bytes) warm and cold, its route
                numel, sched, walk = fwd[label]
                out = kern()
                if not torch.equal(out, plain()):
                    raise AssertionError(f"{label} {dn}: not bit-equal to the plain version")
                if label.startswith("gibbs_gram self") and not torch.equal(out, out.T):
                    raise AssertionError(f"{label} {dn}: not exactly symmetric")
                if not torch.equal(out, kern()):
                    raise AssertionError(f"{label} {dn}: two launches on the same inputs differ")
                fill = lambda numel=numel: torch.empty(numel, dtype=dtype, device=dev).fill_(1.0)
                row.update(cold_ms=time_cold_ms(torch, kern), write_floor_ms=time_ms(torch, fill),
                           write_floor_cold_ms=time_cold_ms(torch, fill), kernel_route=sched.route,
                           vec=sched.vec, bit_equal_to_plain=True, repeat_bit_equal=True)
                log("kernels", f"{label} {dn}: bit-equal to the plain version"
                    + (", exactly symmetric" if label.startswith("gibbs_gram self") else "")
                    + f" and on a repeat; cold-L2 ms={row['cold_ms']:.5f} (warm {ms:.5f}); write floor "
                    f"(fill_ of the same bytes) warm {row['write_floor_ms']:.5f} cold "
                    f"{row['write_floor_cold_ms']:.5f}; {sched.route} route, {sched.vec} values a store, {walk}")
            rows[label] = row
            if dn == "float64" and label in main_labels:
                main[kname] = row
            if label in slow_plain:
                generic[f"{label} {dn}"] = row
        if dn == "float64":
            # K1's self form (the training path's) beside the served cross form,
            # and its cross-form backward at the second timed shape
            main["gibbs_gram"]["self_form_n1000"] = rows["gibbs_gram self N=1000"]
            for n1, n2 in K1_CROSS_BWD_TIMED[1:]:
                main["gibbs_gram_cross_backward"][f"at_{n1}x{n2}"] = rows[f"gibbs_gram_cross_backward {n1}x{n2}"]
            for name in ("svc_gram", "svc_gram_tiled", "svc_gram_tiled_backward"):
                main[name]["generic_route"] = {}
            main["gibbs_gram"]["cross_{}x{}".format(*K1_CROSS_SPARSE)] = rows["gibbs_gram cross {}x{}".format(
                *K1_CROSS_SPARSE)]
            # one call of the cross-form backward is one device kernel
            n1, n2 = K1_CROSS_BWD_TIMED[0]
            x1, s1, l1 = kernel_inputs(torch, gen, n1, dtype, dev)
            x2, s2, l2 = kernel_inputs(torch, gen, n2, dtype, dev)
            kbar = torch.randn(n1, n2, generator=gen, dtype=torch.float64).to(dev, dtype)
            one_call_kernels(torch, f"gibbs_gram_cross_backward {n1}x{n2} {dn}",
                             lambda: gk.gibbs_gram_cross_backward(x1, s1, l1, x2, s2, l2, kbar), 1)
            # one call of each K3 wrapper on its generic route: the forward one
            # device kernel, the backward three (the pairs, the slots' sums, ℓ̄)
            n, m = K3_GENERIC_PROFILED
            x, _, l = kernel_inputs(torch, gen_g, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=gen_g, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            kbar = torch.randn(n * m, n * m, generator=gen_g, dtype=torch.float64).to(dev, dtype)
            for name, fn, want in (
                    ("svc_gram_tiled", lambda: gk.svc_gram_tiled(x, l, ls, settings.jitter), 1),
                    ("svc_gram_tiled_backward", lambda: gk.svc_gram_tiled_backward(x, l, ls, kbar, settings.jitter),
                     3)):
                main[name][f"generic_kernels_per_call_n{n}_m{m}"] = one_call_kernels(
                    torch, f"{name} N={n} M={m} {dn} (generic route)", fn, want)
            del x, l, ls, kbar
            # one call of K2's generic route is one device kernel (profiled after
            # the others, so that their profiles keep their place)
            n, m = K2_GENERIC_PROFILED
            x, _, l = kernel_inputs(torch, gen_k2, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=gen_k2, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            main["svc_gram"][f"generic_kernels_per_call_n{n}_m{m}"] = one_call_kernels(
                torch, f"svc_gram task N={n} M={m} {dn} (generic route)",
                lambda: gk.svc_gram(x, l, ls, settings.jitter), 1)
            del x, l, ls
        # K2's generic route at the other shapes, untimed, from its own generator:
        # bit-equal to the plain version and on a repeat, K3 to it permuted
        for n, m in K2_GENERIC_SHAPES:
            x, _, l = kernel_inputs(torch, gen_k2, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=gen_k2, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            sched = gk.k2_schedule(n, m, dtype, sms)
            check_forward(torch, f"svc_gram task N={n} M={m} {dn} ({k2_walk(sched)})",
                          lambda: gk.svc_gram(x, l, ls, settings.jitter), gk.svc_gram_plain(x, l, ls, settings.jitter),
                          dn, sched)
            k3_equals_k2(torch, gk, settings, f"svc_gram_tiled N={n} M={m} {dn}", x, l, ls)
        # K1's forward at other N, untimed: bit-equal to the plain version and
        # on a repeat, the self form exactly symmetric
        for n in K1_FWD_OTHER_SIZES:
            x, s, l = kernel_inputs(torch, gen, n, dtype, dev)
            want = gk.gibbs_gram_plain(x, s, l, x, s, l, settings.jitter)
            sched = gk.k1_forward_schedule(n, n, True, dtype, sms)
            check_forward(torch, f"gibbs_gram self N={n} {dn}", lambda: gk.gibbs_gram(x, s, l, jitter=settings.jitter),
                          want, dn, sched, symmetric=True)
            if sched.route != "pairs":
                pairs = gk.k1_pairs_schedule(n, dtype, sms)
                check_forward(torch, f"gibbs_gram self N={n} {dn}, pairs route by its schedule",
                              lambda: gk._k1_launch(pairs, x, s, l, x, s, l, settings.jitter), want, dn, pairs,
                              symmetric=True)
        for n1, n2 in K1_CROSS_OTHER_SHAPES:
            x1, s1, l1 = kernel_inputs(torch, gen, n1, dtype, dev)
            x2, s2, l2 = kernel_inputs(torch, gen, n2, dtype, dev)
            check_forward(torch, f"gibbs_gram cross {n1}x{n2} {dn}", lambda: gk.gibbs_gram(x1, s1, l1, x2, s2, l2),
                          gk.gibbs_gram_plain(x1, s1, l1, x2, s2, l2), dn,
                          gk.k1_forward_schedule(n1, n2, False, dtype, sms))
        # K2 at the other M and N, untimed: both store routes and the generic
        # route, each bit-equal to the plain version and K3 to it permuted
        for n, m in K2_OTHER_SHAPES:
            x, _, l = kernel_inputs(torch, gen, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            label = f"svc_gram task N={n} M={m} {dn}"
            check_forward(torch, label, lambda: gk.svc_gram(x, l, ls, settings.jitter),
                          gk.svc_gram_plain(x, l, ls, settings.jitter), dn, gk.k2_schedule(n, m, dtype, sms))
            k3_equals_k2(torch, gk, settings, f"svc_gram_tiled N={n} M={m} {dn}", x, l, ls)
        # K3's backward at the other M it takes, untimed: tile 16 at M=1 and
        # M=4, tile 8 at M=5..8, with ragged and whole last tiles; the
        # generic route above M = 8
        for n, m in K3_BWD_OTHER_SHAPES + K3_BWD_GENERIC_SHAPES:
            x, _, l = kernel_inputs(torch, gen, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            kbar = torch.randn(n * m, n * m, generator=gen, dtype=torch.float64).to(dev, dtype)
            label = f"svc_gram_tiled_backward N={n} M={m} {dn}"
            kern = lambda: gk.svc_gram_tiled_backward(x, l, ls, kbar, settings.jitter)
            err = check_grad(torch, label, kern(),
                             gk.svc_gram_tiled_backward_plain(x, l, ls, settings.jitter, kbar), dn)
            if not all(torch.equal(a, b) for a, b in zip(kern(), kern())):
                raise AssertionError(f"{label}: two launches on the same inputs differ")
            sched = gk.k3_backward_schedule(n, m)
            log("kernels", f"{label} ({sched.route} route, tile {sched.tile}): ok, "
                f"max_abs_err={err:.3e}, two launches bit-equal (untimed)")
        # K3's forward at the other M and edge shapes, untimed: each route;
        # the generic route bit for bit against the plain version too
        for n, m in K3_FWD_OTHER_SHAPES + K3_FWD_GENERIC_SHAPES[dn]:
            x, _, l = kernel_inputs(torch, gen, n, dtype, dev)
            ls = torch.tril(torch.randn(n, m, m, generator=gen, dtype=torch.float64))
            ls = (ls + 2.0 * torch.eye(m, dtype=torch.float64)).to(device=dev, dtype=dtype)
            label = f"svc_gram_tiled N={n} M={m} {dn}"
            got = gk.svc_gram_tiled(x, l, ls, settings.jitter)
            want = gk.svc_gram_tiled_plain(x, l, ls, settings.jitter)
            err = check_close(torch, label, got, want, dn)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: not bit-equal to the plain version")
            k3_equals_k2(torch, gk, settings, label, x, l, ls)
            if not torch.equal(got, gk.svc_gram_tiled(x, l, ls, settings.jitter)):
                raise AssertionError(f"{label}: two launches on the same inputs differ")
            sched = gk.k3_forward_schedule(n, m, dtype, gk.sm_count(dev))
            log("kernels", f"{label} ({sched.route} route, {sched.vec} values a store, "
                f"{sched.smem_bytes} B of shared memory a block): ok, max_abs_err={err:.3e}, "
                "two launches bit-equal (untimed)")
        # K1's backward at other N, untimed: each tile size, whole and ragged
        for n in K1_BWD_OTHER_SIZES:
            x, s, l = kernel_inputs(torch, gen, n, dtype, dev)
            kbar = torch.randn(n, n, generator=gen, dtype=torch.float64).to(dev, dtype)
            label = f"gibbs_gram_backward N={n} {dn}"
            kern = lambda: gk.gibbs_gram_backward(x, s, l, kbar, settings.jitter)
            got, want = kern(), gk.gibbs_gram_backward_plain(x, s, l, settings.jitter, kbar)
            if n == 1:
                # one input: ℓ̄ is 0 in exact arithmetic (f = 0 on the
                # diagonal) and autograd of the plain version returns its
                # rounding there, so the kernel's must be exactly 0
                err = check_grad(torch, label, got[:1], want[:1], dn)
                if got[1].item() != 0.0:
                    raise AssertionError(f"{label}: ℓ̄ of one input is {got[1].item():.3e}, not 0")
            else:
                err = check_grad(torch, label, got, want, dn)
            if not all(torch.equal(a, b) for a, b in zip(kern(), kern())):
                raise AssertionError(f"{label}: two launches on the same inputs differ")
            sched = gk.k1_backward_schedule(n, gk.sm_count(dev))
            log("kernels", f"{label} (tile {sched.tile}, {sched.n_tiles} slots): ok, max_abs_err={err:.3e}, "
                "two launches bit-equal (untimed)")
        # K1's cross-form backward at other shapes, untimed: each strip height, ragged edges
        for n1, n2 in K1_CROSS_BWD_OTHER_SHAPES:
            args = (*kernel_inputs(torch, gen, n1, dtype, dev), *kernel_inputs(torch, gen, n2, dtype, dev),
                    torch.randn(n1, n2, generator=gen, dtype=torch.float64).to(dev, dtype))
            label = f"gibbs_gram_cross_backward {n1}x{n2} {dn}"
            kern = lambda: gk.gibbs_gram_cross_backward(*args)
            err = check_grad(torch, label, kern(), gk.gibbs_gram_cross_backward_plain(*args), dn)
            if not all(torch.equal(a, b) for a, b in zip(kern(), kern())):
                raise AssertionError(f"{label}: two launches on the same inputs differ")
            sched = gk.k1_cross_backward_schedule(n1, n2, gk.sm_count(dev))
            log("kernels", f"{label} ({k1x_walk(sched)}): ok, max_abs_err={err:.3e}, two launches bit-equal "
                "(untimed)")
    for label, row in generic.items():  # the generic routes' rows, both types, by kernel
        name = label.split()[0] if not label.startswith("svc_gram task") else "svc_gram"
        main[name]["generic_route"][label.split(" ", 1)[1]] = row
    return main


def k3_equals_k2(torch, gk, settings, label, x, l, ls) -> None:
    """K3's forward must equal K2's task-major output permuted to input-major
    bit for bit: two kernels held against each other."""
    n, m = ls.shape[0], ls.shape[1]
    task = gk.svc_gram(x, l, ls, settings.jitter).reshape(m, n, m, n)
    if not torch.equal(gk.svc_gram_tiled(x, l, ls, settings.jitter), task.permute(1, 0, 3, 2).reshape(n * m, n * m)):
        raise AssertionError(f"{label}: not bit-equal to svc_gram task-major, permuted")
    log("kernels", f"{label} vs svc_gram task-major permuted: equal bit for bit")


def k1_walk(sched) -> str:
    """K1's forward route's shape, for the log."""
    if sched.route == "pairs":
        return f"{sched.n_pairs} tile pairs of {sched.tile} inputs, grid {sched.grid}"
    return f"one thread per output, {sched.grid} blocks of 32 x 8"


def k1x_walk(sched) -> str:
    """K1's cross-form backward's walk, for the log."""
    return (f"grid {sched.grid}, {sched.rows} rows a block, {sched.col_groups} column group(s) of "
            f"{sched.chunks_per_group} chunk(s), {sched.n_slots} column slots, {sched.n_tickets} ticket(s)")


def k2_walk(sched) -> str:
    """K2's walk, for the log: the strips, or the generic route's units."""
    if sched.route != "generic":
        return strip_walk(sched)
    return (f"{sched.n_units} units of a 64 x 64 tile by {sched.row_tasks} x {sched.col_tasks} tasks, "
            f"b in chunks of {sched.b_chunk}, {sched.smem_bytes} B of staged L a block, grid {sched.grid}")


def strip_walk(sched) -> str:
    """A strip walk's shape, for the log."""
    return (f"items of {sched.rows} x {sched.strip} inputs, {sched.n_items} items, "
            f"{sched.warps} warps a block, grid {sched.grid}")


def check_forward(torch, label, kern, want, dn, sched, symmetric=False) -> None:
    """An untimed forward check: bit-equal to the plain version's ``want``
    and on a repeat (and, for K1's self form, exactly symmetric)."""
    got = kern()
    err = check_close(torch, label, got, want, dn)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: not bit-equal to the plain version")
    if symmetric and not torch.equal(got, got.T):
        raise AssertionError(f"{label}: not exactly symmetric")
    if not torch.equal(got, kern()):
        raise AssertionError(f"{label}: two launches on the same inputs differ")
    log("kernels", f"{label} ({sched.route} route, {sched.vec} values a store): ok, bit-equal to the plain "
        f"version{', exactly symmetric' if symmetric else ''}, max_abs_err={err:.3e}, two launches bit-equal "
        "(untimed)")


def write_subject(torch, sim, transforms, store_cls, root, seed):
    """A sim_mnts subject at the served size, its true latents packed as the MAP."""
    gen = torch.Generator().manual_seed(seed)
    d = sim.sim_mnts(gen, n=SERVED_N, m=SERVED_M, device=DEVICE, dtype=torch.float64)
    t = transforms.tri_size(SERVED_M)
    ul = transforms.lvec_to_ulvec(d.l_vecs.reshape(SERVED_N, t), SERVED_M).reshape(-1)
    log_s2 = torch.log(torch.tensor([d.sigma2_err], dtype=torch.float64, device=DEVICE))
    vec = torch.cat([torch.log(d.l), ul, log_s2])
    if not torch.isfinite(vec).all() or not torch.isfinite(d.y).all():
        raise AssertionError("sim subject has non-finite values")
    store = store_cls(root)
    store.save(store_cls.key("gnmgp", "sim", 0, "data"), x=d.x.cpu().numpy(), y=d.y.cpu().numpy())
    store.save(store_cls.key("gnmgp", "sim", 0, "map"), vec=vec.cpu().numpy())
    return d, vec


def check_answer(np, out, g):
    arr = {k: np.asarray(out[k], dtype=float) for k in ("mean", "std", "lower", "upper")}
    for k, v in arr.items():
        if v.shape != (g, SERVED_M) or not np.isfinite(v).all():
            raise AssertionError(f"/predict {g} points: {k} has shape {v.shape} or non-finite values")
    if not (arr["std"] > 0).all():
        raise AssertionError(f"/predict {g} points: std not positive")
    if not ((arr["lower"] <= arr["mean"]) & (arr["mean"] <= arr["upper"])).all():
        raise AssertionError(f"/predict {g} points: lower <= mean <= upper fails")
    return arr


#: Profiles of a call taken before device_profile gives up on recording a
#: device kernel, and the cycles of the spin kernel that opens each profile
#: (late in the whole smoke the profiler recorded no device kernel for a
#: short call it recorded alone, unless a kernel of PyTorch's ran first in
#: the profile: PERF.md §7).
PROFILE_TRIES, PROFILE_SPIN_CYCLES = 3, 2_000_000


def device_profile(torch, fn, reps: int = 3, top_n: int | None = 12, per_call: bool = True):
    """``fn`` warm, timed on the host clock (ending in a synchronize), then
    under torch.profiler: ``(wall ms, device ms, kernel kinds, the top_n
    kernel rows (every row where None))`` per call; a row's launches are per
    call (floored), or the records in all ``reps`` calls where not
    ``per_call``.  Each profile opens with a spin kernel, queued ahead of
    the calls and left out of the rows; one that records no device kernel
    is taken again, up to PROFILE_TRIES profiles, then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    self_dev = lambda e: getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # device-side rows only: an aten op row repeats the time of the kernels it launched
        rows = sorted(
            (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and self_dev(e) > 0
             and "spin_kernel" not in e.key),
            key=self_dev, reverse=True,
        )
        if rows:
            break
        log("profile", f"profile {attempt + 1} of {PROFILE_TRIES} recorded no device kernel")
    else:
        raise AssertionError(f"the profiler recorded no device kernel in {PROFILE_TRIES} profiles of {reps} calls")
    device_ms = sum(self_dev(e) for e in rows) / 1e3 / reps
    top = [(self_dev(e) / 1e3 / reps, e.count // reps if per_call else e.count, e.key[:90]) for e in rows[:top_n]]
    return wall_ms, device_ms, len(rows), top


def one_call_kernels(torch, label: str, fn, want: int, reps: int = 10):
    """One call of ``fn`` launches ``want`` device kernels, each once: of
    ``reps`` profiled calls, ``want`` kernel kinds, each with ``reps``
    records or ``reps`` − 1 (the profiler has been seen to drop the record
    of a short kernel: PERF.md §7).  Logs them, returns the kinds."""
    _, device_ms, kinds, top = device_profile(torch, fn, reps, top_n=None, per_call=False)
    log("kernels", f"{label} profiled: {kinds} device kernel(s) a call, {device_ms:.5f} ms; records in {reps} "
        "calls: " + ", ".join(f"{key} x{count}" for _, count, key in top))
    if kinds != want or any(not reps - 1 <= count <= reps for _, count, _ in top):
        raise AssertionError(f"{label}: {kinds} device kernel kind(s), {[c for _, c, _ in top]} records in "
                             f"{reps} calls, not {want} kernel(s) once a call")
    return kinds


def profile_request(torch, engine, xs, http_ms: float, reps: int = 3) -> None:
    """Where a warm request's time goes: engine.predict (no HTTP) on the host
    clock and under torch.profiler for device time by kernel."""
    wall_ms, device_ms, kinds, top = device_profile(torch, lambda: engine.predict("0", xs), reps)
    log("profile", f"engine.predict {len(xs)} points: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms "
        f"per request (busy share {device_ms / wall_ms:.3f}), {kinds} kernel kinds; "
        f"HTTP request {http_ms:.3f} ms, so HTTP and JSON take {http_ms - wall_ms:.3f} ms")
    for ms, count, key in top:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")


def phase_serving(torch, np, gk, seed):
    from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import serve
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="smoke_store_") as root:
        d, vec = write_subject(torch, sim, transforms, ArtifactStore, root, seed)
        t0 = time.perf_counter()
        httpd = serve(root, port=0)  # warms the 64- and 256-point buckets
        log("serving", f"server up on port {httpd.server_port}, warm in {time.perf_counter() - t0:.3f} s")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_port}"

        def get(path):
            return json.load(urllib.request.urlopen(base + path, timeout=300))

        def post(xs):
            body = json.dumps({"subject": "0", "x": list(map(float, xs))}).encode()
            req = urllib.request.Request(base + "/predict", data=body, method="POST")
            return json.load(urllib.request.urlopen(req, timeout=300))

        lo, hi = float(d.x.min()), float(d.x.max())
        grids = {g: np.linspace(lo, hi, g) for g in REQUEST_SIZES}
        latency, answers = {}, {}
        try:
            gk.reset_launches()  # the main path starts here
            health = get("/health")
            if health.get("status") != "ok" or health.get("subjects") != 1:
                raise AssertionError(f"/health: {health}")
            info = get("/subjects/0")
            if info.get("n") != SERVED_N or info.get("m") != SERVED_M:
                raise AssertionError(f"/subjects/0: {info}")
            n_requests = 0
            for g, xs in grids.items():
                answers[g] = check_answer(np, post(xs), g)  # first request at this bucket
                times = []
                for _ in range(TIMED_REQUESTS):
                    t0 = time.perf_counter()
                    check_answer(np, post(xs), g)
                    times.append((time.perf_counter() - t0) * 1e3)
                n_requests += 1 + TIMED_REQUESTS
                latency[g] = statistics.median(times)
                log("serving", f"POST /predict {g} points: ok, warm latency median {latency[g]:.3f} ms "
                    f"(min {min(times):.3f}, max {max(times):.3f}, {TIMED_REQUESTS} requests)")
            launches = gk.launches()  # the main path ends here
            profile_request(torch, httpd.engine, grids[201], latency[201])
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("server thread did not stop")

    log("serving", f"{n_requests} requests launched {launches}")
    for name in SERVED_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the served path")

    # every answer against predict_map on the CPU (the plain path)
    for g, xs in grids.items():
        ref = pred.predict_map(vec.cpu(), FullData(d.x.cpu(), d.y.cpu()), xs, device="cpu", dtype=torch.float64)
        ref = {
            "mean": ref.mean.numpy(), "std": ref.std.numpy(),
            "lower": ref.percentiles[:, 0].numpy(), "upper": ref.percentiles[:, 2].numpy(),
        }
        for k, want in ref.items():
            # the floor covers entries near 0: the kriging solve's condition
            # (~1e10) moves the kriged L-processes by ~1e-7 of their scale
            # between two f64 solvers, and the drift phase checks that the
            # rest of the path meets rtol alone
            got = answers[g][k]
            err = np.abs(got - want)
            if not (err <= SERVED_RTOL * np.abs(want) + SERVED_ATOL_OF_SCALE * np.abs(want).max()).all():
                raise AssertionError(f"{g}-point {k} differs from the CPU plain path: max abs err {err.max():.3e}")
            log("serving", f"{g}-point {k} vs CPU plain path: ok, max abs err {err.max():.3e}, "
                f"max rel err {(err / np.abs(want)).max():.3e}, max |CPU| {np.abs(want).max():.3e}")
    return launches, n_requests, latency, (vec, d, grids[201])


def stage_values(torch, vec, d, grid, device, latents=None) -> dict:
    """The served path's stages in float64 on ``device``: the kriged latents,
    the Gram's Cholesky factor, the predictive mean and variance.  Given
    ``latents`` (kriged log-lengthscale and L-processes), they replace the
    kriging."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp as model
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred

    to = lambda t: torch.as_tensor(t, dtype=torch.float64, device=device)
    data = FullData(to(d.x), to(d.y))
    n, m = data.y.shape
    p = model.unpack(to(vec), n, m)
    g = to(grid)
    if latents is None:
        cond_l, cond_ul = pred._latent_conds(p, data, g, model.DEFAULT_HYPERS, n, m)
        latents = (cond_l.mean, cond_ul.mean)
    l_mean, ul_mean = (to(t) for t in latents)
    ls_star = transforms.vec_to_tril(transforms.ulvec_to_lvec(ul_mean.T, m), m)
    factors = pred._factorize(p, data)
    mu, s2 = pred._moments(data, g, torch.exp(l_mean), ls_star, factors)
    return {
        "kriged log-lengthscale": l_mean, "kriged L-processes": ul_mean,
        "Gram factor": factors[3], "mean": mu, "variance": s2,
    }


def phase_drift(torch, vec, d, grid) -> None:
    """Each stage's card-vs-CPU difference, as a fraction of the stage's
    largest |value| on the CPU, for the card's own path and for the card's
    factorization and moments fed the CPU's kriged latents."""
    cpu = stage_values(torch, vec, d, grid, "cpu")
    card = stage_values(torch, vec, d, grid, DEVICE)
    fed = stage_values(
        torch, vec, d, grid, DEVICE, (cpu["kriged log-lengthscale"], cpu["kriged L-processes"])
    )
    for name, want in cpu.items():
        scale = want.abs().max().item()
        rel = lambda got: (got.cpu() - want).abs().max().item() / scale
        log("drift", f"{len(grid)}-point {name}: card vs CPU {rel(card[name]):.3e} of max |CPU| "
            f"{scale:.3e}; fed the CPU's kriged latents {rel(fed[name]):.3e}")
    # past the kriging, the card's path meets rtol alone, with no floor
    for name in ("mean", "variance"):
        want = cpu[name]
        rel = ((fed[name].cpu() - want).abs() / want.abs()).max().item()
        if not rel <= SERVED_RTOL:
            raise AssertionError(f"fed the CPU's kriged latents, the card's {name} is off by {rel:.3e} relative")
        log("drift", f"{len(grid)}-point {name}, fed the CPU's kriged latents: ok, max rel err {rel:.3e}")


def training_subject(torch, seed: int, n: int):
    """A ``sim_mnts`` subject (x, y as numpy) and its truth packed as a GNMGP
    and an SNMGP parameter vector, on the CPU in float64."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms

    d = sim.sim_mnts(torch.Generator().manual_seed(seed), n=n, m=2, device="cpu", dtype=torch.float64)
    t = transforms.tri_size(2)
    ul = transforms.lvec_to_ulvec(d.l_vecs.reshape(n, t), 2)
    log_s2 = torch.log(torch.tensor([d.sigma2_err], dtype=torch.float64))
    gvec = torch.cat([torch.log(d.l), ul.reshape(-1), log_s2])
    svec = torch.cat([torch.log(d.l), torch.zeros(n, dtype=torch.float64), ul.mean(dim=0), log_s2])
    return d.x.numpy(), d.y.numpy(), gvec, svec


def gnmgp_subject(torch, seed: int, n: int, m: int, device: str = "cpu"):
    """A GNMGP subject at any M (``sim_mnts`` draws M = 2 only) in float64:
    the sim's lengthscale process, smooth random L-process vectors, y drawn
    from the GNMGP likelihood they define, its Gram and factor on ``device``
    (random numbers from a CPU generator).  Returns x, y (numpy) and the
    packed parameter vector (on the CPU)."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import settings
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms

    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    x = torch.sort(torch.rand(n, generator=gen, dtype=f64)).values
    tilde_l = 3.0 * (x - 1.0) ** 3 - 3.0
    t = transforms.tri_size(m)
    a, b = (0.3 * torch.randn(t, generator=gen, dtype=f64) for _ in range(2))
    ul = a[None, :] + b[None, :] * x[:, None]  # (N, T), smooth in x
    sigma2 = 1e-2
    ls = gnmgp.chol_process(ul.reshape(-1).to(device), n, m)
    cov = gk.svc_gram_tiled_plain(x.to(device), torch.exp(tilde_l).to(device), ls, settings.jitter)
    cov = cov + sigma2 * torch.eye(n * m, dtype=f64, device=device)
    y = torch.linalg.cholesky(cov) @ torch.randn(n * m, generator=gen, dtype=f64).to(device)
    vec = torch.cat([tilde_l, ul.reshape(-1), torch.log(torch.tensor([sigma2], dtype=f64))])
    return x.numpy(), y.reshape(n, m).cpu().numpy(), vec


def held(np, got, want, rtol) -> tuple[float, float]:
    """Max relative error and max error as a fraction of the largest |want|;
    raises unless every entry is within rtol·|want| + rtol·max|want|."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    err = np.abs(got - want)
    scale = np.abs(want).max()
    if not (err <= rtol * np.abs(want) + rtol * scale).all():
        raise AssertionError(f"off by {err.max():.3e} against a scale of {scale:.3e}")
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.nanmax(err / np.abs(want))
    return float(rel), float(err.max() / scale)


def generic_gradient(torch, np, gk, seed: int, n: int = GRADIENT_N, m: int = GRADIENT_M) -> dict:
    """The GNMGP f64 gradient at M > 8 (K3's generic routes) on the card:
    the kernels one gradient launches, gradient evaluations per second
    (median of RATE_BATCHES batches of RATE_EVALS) and a profile of one
    gradient with the device time by kernel and the share of K3's routes.
    It calls only what every tree of the port since dde4b95 (K3 at any M)
    has, so that ``scripts/k3g_ab.py`` runs it against an earlier tree's
    package too."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    label = f"gnmgp f64 N={n} M={m}"
    t0 = time.perf_counter()
    x, y, vec = gnmgp_subject(torch, seed, n, m, device=DEVICE)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=DEVICE)
    f = gnmgp.make_objective(FullData(as_t(x), as_t(y)))
    v = vec.to(DEVICE)
    gk.reset_launches()
    val, grad = value_and_grad(f, v)
    torch.cuda.synchronize()
    counts = {k: c for k, c in gk.launches().items() if c}
    if counts != {"svc_gram_tiled": 1, "svc_gram_tiled_backward": 1}:
        raise AssertionError(f"{label}: one gradient launched {counts}")
    if not (torch.isfinite(val) and torch.isfinite(grad).all()):
        raise AssertionError(f"{label}: non-finite value or gradient")
    per_s = []
    for _ in range(RATE_BATCHES):
        t1 = time.perf_counter()
        for _ in range(RATE_EVALS):
            value_and_grad(f, v)
        torch.cuda.synchronize()
        per_s.append(RATE_EVALS / (time.perf_counter() - t1))
    wall_ms, device_ms, kinds, rows = device_profile(torch, lambda: value_and_grad(f, v), top_n=None)
    k3_ms = sum(ms for ms, _, key in rows if "svc_gram_tiled" in key)
    out = {"rate": statistics.median(per_s), "rates": per_s, "wall_ms": wall_ms, "device_ms": device_ms,
           "k3_ms": k3_ms, "kinds": kinds, "launches": counts, "value": val.item(),
           "by_kernel": [(ms, count, key) for ms, count, key in rows], "seconds": time.perf_counter() - t0}
    log("objective", f"{label}: one gradient launched {counts}; {out['rate']:.3f} gradient evaluations/s (median "
        f"of {RATE_BATCHES} batches of {RATE_EVALS}; min {min(per_s):.3f}, max {max(per_s):.3f}); value "
        f"{out['value']:.10e}")
    log("profile", f"one {label} gradient: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms (busy share "
        f"{device_ms / wall_ms:.3f}), {kinds} kernel kinds; K3's routes {k3_ms:.4f} ms "
        f"({100 * k3_ms / device_ms:.1f}% of the device time)")
    for ms, count, key in rows[:12]:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    return out


def prediction_draws(torch, vec, s: int, g: int, m: int, seed: int):
    """A chain of ``s`` draws (``vec`` and s − 1 perturbations of it by 0.01
    standard normals) and the normals ``predict_sample`` takes for them on a
    ``g``-point grid, from a CPU generator of their own."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms

    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    hist = vec[None, :] + 0.01 * torch.randn(s, vec.shape[0], generator=gen, dtype=f64)
    hist[0] = vec
    t = transforms.tri_size(m)
    noise = tuple(torch.randn((s,) + shape, generator=gen, dtype=f64) for shape in ((g,), (t, g), (g, m)))
    return hist, noise


def generic_prediction(torch, np, gk, seed: int, n: int = PREDICT_N, m: int = PREDICT_M) -> dict:
    """The GNMGP f64 prediction at M > 4 (K2's generic route) on the card:
    ``predict_map`` on a PREDICT_GRID-point grid and ``predict_sample`` over
    PREDICT_DRAWS draws with injected noise; for each the kernels one call
    launches (K2 exactly once a map call and once a draw), its wall and
    device ms and the device ms by kernel with K2's share.  It calls only
    what the tree of 125ef4c has, so that ``scripts/k2g_ab.py`` runs it
    against that tree's package too."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred

    label = f"gnmgp f64 N={n} M={m}"
    t0 = time.perf_counter()
    x, y, vec = gnmgp_subject(torch, seed, n, m, device=DEVICE)
    data = FullData(x, y)
    grid = np.linspace(float(x.min()), float(x.max()), PREDICT_GRID)
    hist, noise = prediction_draws(torch, vec, PREDICT_DRAWS, PREDICT_GRID, m, seed + 1)
    calls = {"map": (lambda: pred.predict_map(vec, data, grid, device=DEVICE), 1),
             "sample": (lambda: pred.predict_sample(None, hist, data, grid, device=DEVICE, noise=noise),
                        PREDICT_DRAWS)}
    out = {}
    for mode, (fn, draws) in calls.items():
        gk.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        counts = {k: c for k, c in gk.launches().items() if c}
        if counts != {"svc_gram": draws, "gibbs_gram": draws}:
            raise AssertionError(f"{label} predict_{mode}: launched {counts}, expected K1 and K2 {draws} each")
        values = got.mean if mode == "map" else got
        if not torch.isfinite(values).all():
            raise AssertionError(f"{label} predict_{mode}: non-finite values")
        wall_ms, device_ms, kinds, rows = device_profile(torch, fn, reps=3 if mode == "map" else 1, top_n=None)
        k2_ms = sum(ms for ms, _, key in rows if "svc_gram_" in key and "tiled" not in key)
        out[mode] = {"wall_ms": wall_ms, "device_ms": device_ms, "k2_ms": k2_ms, "kinds": kinds,
                     "launches": counts, "draws": draws, "by_kernel": rows}
        log("objective", f"{label} predict_{mode} on a {PREDICT_GRID}-point grid ({draws} draw(s)): launched "
            f"{counts}; wall {wall_ms:.3f} ms, device {device_ms:.3f} ms a call ({device_ms / draws:.3f} ms a draw; "
            f"busy share {device_ms / wall_ms:.3f}); K2 {k2_ms:.4f} ms ({100 * k2_ms / device_ms:.1f}% of the "
            f"device time), {kinds} kernel kinds")
        for ms, count, key in rows[:8]:
            log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    out["seconds"] = time.perf_counter() - t0
    return out


def generic_prediction_check(torch, np, seed: int, n: int = PREDICT_CHECK_N, m: int = PREDICT_M) -> None:
    """The GNMGP prediction path at M > 4 on the card against the CPU, with
    the same draws and noise: ``predict_map`` and ``predict_sample`` at rtol
    SERVED_RTOL with a floor of SERVED_ATOL_OF_SCALE of the scale, and each
    draw's ``observation_cov`` and the LOO conditionals at rtol
    OBJECTIVE_RTOL (with the same floor)."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred

    x, y, vec = gnmgp_subject(torch, seed, n, m)
    data = FullData(x, y)
    grid = np.linspace(float(x.min()), float(x.max()), PREDICT_GRID)
    hist, noise = prediction_draws(torch, vec, PREDICT_DRAWS, PREDICT_GRID, m, seed + 1)
    outs = {}
    for dev in (DEVICE, "cpu"):
        xd = torch.as_tensor(x, dtype=torch.float64, device=dev)
        map_ = pred.predict_map(vec, data, grid, device=dev)
        outs[dev] = {
            "predict_map mean": map_.mean, "predict_map std": map_.std, "predict_map percentiles": map_.percentiles,
            "predict_sample": pred.predict_sample(None, hist, data, grid, device=dev, noise=noise),
            "observation_cov": torch.stack([evaluate.observation_cov("gnmgp", v.to(dev), xd, n, m) for v in hist]),
            "LOO conditionals": evaluate.chain_conditional_loglik("gnmgp", hist, x, y, device=dev),
        }
    for name, got in outs[DEVICE].items():
        rtol = SERVED_RTOL if name.startswith("predict") else OBJECTIVE_RTOL
        got, want = (np.asarray(v.cpu() if torch.is_tensor(v) else v) for v in (got, outs["cpu"][name]))
        if not np.isfinite(got).all():
            raise AssertionError(f"N={n} M={m} {name}: non-finite values on the card")
        rel, frac = held(np, got, want, rtol)
        log("objective", f"gnmgp f64 N={n} M={m} {name}, card vs CPU, {PREDICT_DRAWS} draws, the same noise: ok at "
            f"rtol {rtol} with a floor of {rtol} of the scale; max rel err {rel:.3e}, max err {frac:.3e} of the scale")


def phase_objective(torch, np, gk, seed) -> dict:
    """The MAP objectives at N=TRAIN_N, M=2, and the GNMGP objective at
    N=GENERIC_N, M=GENERIC_M: card against CPU, gradient evaluations per
    second, launches per gradient, and a profile of one GNMGP gradient."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp, snmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    x, y, gvec, svec = training_subject(torch, seed + 1, TRAIN_N)
    xg, yg, gvec_g = gnmgp_subject(torch, seed + 3, GENERIC_N, GENERIC_M)
    checks = {f"gnmgp N={TRAIN_N} M=2": (gnmgp, gvec, x, y), f"snmgp N={TRAIN_N} M=2": (snmgp, svec, x, y),
              f"gnmgp N={GENERIC_N} M={GENERIC_M}": (gnmgp, gvec_g, xg, yg)}

    def objective(mod, device, dtype, x=x, y=y):
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return mod.make_objective(FullData(as_t(x), as_t(y)))

    expected = {gnmgp: {"svc_gram_tiled": 1, "svc_gram_tiled_backward": 1},
                snmgp: {"gibbs_gram": 1, "gibbs_gram_backward": 1}}
    for name, (mod, vec, xs, ys) in checks.items():
        f_card = objective(mod, DEVICE, torch.float64, xs, ys)
        gk.reset_launches()
        v_card, g_card = value_and_grad(f_card, vec.to(DEVICE))
        torch.cuda.synchronize()
        counts = gk.launches()
        want = {k: expected[mod].get(k, 0) for k in counts}
        if counts != want:
            raise AssertionError(f"{name} gradient launched {counts}, expected {want}")
        v_cpu, g_cpu = value_and_grad(objective(mod, "cpu", torch.float64, xs, ys), vec)
        if not (torch.isfinite(v_cpu) and torch.isfinite(g_cpu).all()):
            raise AssertionError(f"{name}: non-finite objective or gradient on the CPU")
        rel_v, _ = held(np, [v_card.item()], [v_cpu.item()], OBJECTIVE_RTOL)
        rel_g, frac_g = held(np, g_card.cpu().numpy(), g_cpu.numpy(), OBJECTIVE_RTOL)
        log("objective", f"{name} f64, card vs CPU: value {v_card.item():.10e} vs "
            f"{v_cpu.item():.10e} (rel {rel_v:.3e}); gradient max rel err {rel_g:.3e}, max err "
            f"{frac_g:.3e} of max |grad| {g_cpu.abs().max().item():.3e}: ok at rtol {OBJECTIVE_RTOL}")
        log("objective", f"{name} one gradient launched {counts}")

    rates = {}
    for label, mod, vec, dtype in (("gnmgp f64", gnmgp, gvec, torch.float64),
                                   ("gnmgp f32", gnmgp, gvec, torch.float32),
                                   ("snmgp f64", snmgp, svec, torch.float64)):
        f = objective(mod, DEVICE, dtype)
        v = vec.to(DEVICE, dtype)
        for _ in range(2):
            val, _ = value_and_grad(f, v)
        torch.cuda.synchronize()
        per_s = []
        for _ in range(RATE_BATCHES):
            t0 = time.perf_counter()
            for _ in range(RATE_EVALS):
                val, grad = value_and_grad(f, v)
            torch.cuda.synchronize()
            per_s.append(RATE_EVALS / (time.perf_counter() - t0))
        rates[label] = statistics.median(per_s)
        finite = bool(torch.isfinite(val)) and bool(torch.isfinite(grad).all())
        log("objective", f"{label} N={TRAIN_N} M=2: {rates[label]:.3f} gradient evaluations/s (median of "
            f"{RATE_BATCHES} batches of {RATE_EVALS}; min {min(per_s):.3f}, max {max(per_s):.3f}); "
            f"value {val.item():.6e}, finite value and gradient: {finite}")

    f = objective(gnmgp, DEVICE, torch.float64)
    v = gvec.to(DEVICE)
    wall_ms, device_ms, kinds, top = device_profile(torch, lambda: value_and_grad(f, v))
    log("profile", f"one gnmgp gradient N={TRAIN_N} M=2 f64: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms "
        f"(busy share {device_ms / wall_ms:.3f}), {kinds} kernel kinds")
    for ms, count, key in top:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    # K3's generic routes in a gradient at the headline N
    res = generic_gradient(torch, np, gk, seed + 5)
    rates[f"gnmgp f64 N={GRADIENT_N} M={GRADIENT_M}"] = res["rate"]
    # K2's generic route in a prediction at the headline N, then card vs CPU
    prediction = generic_prediction(torch, np, gk, seed + 8)
    generic_prediction_check(torch, np, seed + 10)
    return {"rates": rates, "prediction": prediction}


def phase_training(torch, np, gk, seed):
    """Slice 2's path: run_subject on the card into a store, then the port's
    server answers from that store; every kernel's launches are read around
    the two.  Then run_subject at N=CHECK_N on the card and on the CPU."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import serve
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    x, y, _, _ = training_subject(torch, seed + 1, TRAIN_N)
    cfg = workflows.PipelineConfig(n_opt=TRAIN_N_OPT)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="smoke_train_") as root:
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        res = workflows.run_subject(x, y, cfg, store=ArtifactStore(root), dataset="sim",
                                    device=DEVICE, dtype=torch.float64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = res["target_hist"]
        log("training", f"run_subject gnmgp N={TRAIN_N} M=2 f64 n_opt={TRAIN_N_OPT} on the card: "
            f"{wall:.3f} s; stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()))
        log("training", f"best start {res['map_init']!r}; log-posterior by iteration: "
            + ", ".join(f"{i}: {hist[i]:.6e}" for i in sorted({0, 1, 2, 5, 10, 20, len(hist) - 1})
                        if i < len(hist)))
        log("training", f"deviance {res['deviance']:.6e}, AIC {res['aic']:.6e}, BIC {res['bic']:.6e}")
        vec = res["map_vec"]
        pct = res["pred_grid"].percentiles
        if not (torch.isfinite(vec).all() and torch.isfinite(pct).all() and np.isfinite(hist[-1])):
            raise AssertionError("run_subject gave non-finite MAP, history or grid prediction")
        if tuple(pct.shape) != (cfg.n_grid, 3, 2):
            raise AssertionError(f"pred_grid percentiles have shape {tuple(pct.shape)}")

        httpd = serve(root, port=0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        xs = np.linspace(float(x.min()), float(x.max()), 201)
        try:
            body = json.dumps({"subject": "0", "x": list(map(float, xs))}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/predict", data=body,
                                         method="POST")
            answer = check_answer(np, json.load(urllib.request.urlopen(req, timeout=300)), 201)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("server thread did not stop")
        launches = gk.launches()  # the main path ends here
    log("training", f"run_subject and one served request launched {launches}")
    for name in TRAINING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    ref = pred.predict_map(vec.cpu(), FullData(torch.as_tensor(x), torch.as_tensor(y)), xs,
                           device="cpu", dtype=torch.float64)
    for k, want in (("mean", ref.mean), ("std", ref.std)):
        rel, frac = held(np, answer[k], want.numpy(), SERVED_RTOL)
        log("training", f"served 201-point {k} from the trained store vs CPU predict_map: ok, "
            f"max rel err {rel:.3e}, max err {frac:.3e} of max |CPU|")

    x2, y2, _, _ = training_subject(torch, seed + 2, CHECK_N)
    cfg2 = workflows.PipelineConfig(n_opt=CHECK_N_OPT)
    runs = {}
    for device in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        runs[device] = workflows.run_subject(x2, y2, cfg2, device=device, dtype=torch.float64)
        log("training", f"run_subject N={CHECK_N} n_opt={CHECK_N_OPT} on {device}: "
            f"{time.perf_counter() - t0:.3f} s, best start {runs[device]['map_init']!r}")
    f = gnmgp.make_objective(FullData(torch.as_tensor(x2), torch.as_tensor(y2)))
    with torch.no_grad():
        final = {d: f(r["map_vec"].cpu()).item() for d, r in runs.items()}
    rel_f, _ = held(np, [final[DEVICE]], [final["cpu"]], OBJECTIVE_RTOL)
    rel_v, frac_v = held(np, runs[DEVICE]["map_vec"].cpu().numpy(), runs["cpu"]["map_vec"].numpy(),
                         OBJECTIVE_RTOL)
    log("training", f"N={CHECK_N} card vs CPU: final objective {final[DEVICE]:.10e} vs {final['cpu']:.10e} "
        f"(rel {rel_f:.3e}); map_vec max rel err {rel_v:.3e}, max err {frac_v:.3e} of its scale: "
        f"ok at rtol {OBJECTIVE_RTOL}")
    return launches


def phase_hmc(torch, np, gk, seed, root):
    """Slice 3's path: run_subject(do_hmc=True) on the card, with no device
    named, into the store at ``root``; every kernel's launches read around it
    and the K3 kernels' also around the sampling stage.  Then hmc_sample's
    three drivers on the card against the CPU with the same injected noise.
    Returns the sampling stage's launches, the run's result and its (x, y)."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import hmc
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    x, y, _, _ = training_subject(torch, seed + 1, TRAIN_N)
    cfg = workflows.PipelineConfig(n_opt=TRAIN_N_OPT, do_hmc=True)
    n_draws = cfg.n_hmc + cfg.hmc_warmup
    n_grads = 1 + n_draws * cfg.hmc_leapfrog
    stage: dict = {}
    run_chain = workflows._run_chain

    def counted_chain(*args, **kwargs):
        # reads the launch counts around the sampling stage; the stage runs as is
        before = gk.launches()
        out = run_chain(*args, **kwargs)
        after = gk.launches()
        stage.update({k: after[k] - before[k] for k in after})
        return out

    store = ArtifactStore(root)
    workflows._run_chain = counted_chain
    try:
        torch.cuda.reset_peak_memory_stats()
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        res = workflows.run_subject(x, y, cfg, store=store, dataset="sim")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gk.launches()  # the main path ends here
    finally:
        workflows._run_chain = run_chain
    key = ArtifactStore.key("gnmgp", "sim", 0, "hmc")
    stored = store.load(key)["samples"] if store.exists(key) else None
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    t_hmc = res["timings"]["hmc"]
    samples = res["hmc_samples"]
    log("hmc", f"run_subject gnmgp N={TRAIN_N} M=2 f64 n_opt={TRAIN_N_OPT} do_hmc=True on "
        f"{samples.device} (no device named): {wall:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()))
    log("hmc", f"chain: {cfg.n_hmc} draws + {cfg.hmc_warmup} warmup, {cfg.hmc_leapfrog} leapfrog steps, "
        f"step size {cfg.hmc_step_size}: {n_draws / t_hmc:.3f} draws/s, {n_grads / t_hmc:.3f} gradients/s "
        f"({n_grads} gradients in {t_hmc:.3f} s); mean acceptance {res['hmc_accept']:.6f}; "
        f"peak device memory {peak_gib:.3f} GiB")
    summ = res["latent_summary"]
    log("hmc", f"DIC {res['dic']:.6e} (deviance at the MAP {res['deviance']:.6e}); latent_summary "
        + ", ".join(f"{f} {tuple(v.shape)}" for f, v in zip(summ._fields, summ)))
    log("hmc", f"sampling stage launched {stage}; the whole run launched {launches}")
    p = gnmgp.n_params(TRAIN_N, 2)
    if samples.device.type != torch.device(DEVICE).type or tuple(samples.shape) != (cfg.n_hmc, p):
        raise AssertionError(f"hmc_samples on {samples.device} with shape {tuple(samples.shape)}")
    if not (torch.isfinite(samples).all() and np.isfinite(res["dic"]) and 0.0 < res["hmc_accept"] <= 1.0):
        raise AssertionError("non-finite draws or DIC, or no draw accepted")
    want_shapes = {"tilde_l_q": (3, TRAIN_N), "std_q": (3, TRAIN_N, 2), "cor_q": (3, TRAIN_N, 2, 2),
                   "b_mean": (TRAIN_N, 2, 2)}
    for f, v in zip(summ._fields, summ):
        if v.shape != want_shapes[f] or not np.isfinite(v).all():
            raise AssertionError(f"latent_summary {f} has shape {v.shape} or non-finite entries")
    if stored is None or not np.array_equal(stored, samples.cpu().numpy()):
        raise AssertionError("the hmc artifact is missing or differs from the chain")
    for name in HMC_KERNELS:
        if stage[name] != n_grads:
            raise AssertionError(f"{name} launched {stage[name]} times in the sampling stage, "
                                 f"expected one per gradient: {n_grads}")
    for name in TRAINING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the HMC path")

    # where a draw's time goes: one draw of the default chain at the MAP
    nlp = gnmgp.make_objective(FullData(*(torch.as_tensor(a, dtype=torch.float64, device=DEVICE)
                                          for a in (x, y))))
    gen = torch.Generator(DEVICE).manual_seed(seed)
    draw = lambda: hmc.hmc_sample(nlp, res["map_vec"], 1, gen, step_size=cfg.hmc_step_size,
                                  n_leapfrog=cfg.hmc_leapfrog)
    wall_ms, device_ms, kinds, top = device_profile(torch, draw)
    per = 1 + cfg.hmc_leapfrog
    log("profile", f"one HMC draw N={TRAIN_N} M=2 f64 ({per} gradients): wall {wall_ms:.3f} ms, device "
        f"{device_ms:.3f} ms (busy share {device_ms / wall_ms:.3f}); per gradient wall {wall_ms / per:.3f} ms, "
        f"device {device_ms / per:.3f} ms; {kinds} kernel kinds")
    for ms, count, key in top:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")

    # the card against the CPU, draw by draw, with the same injected noise
    xc, yc, vec, _ = training_subject(torch, seed + 4, HMC_CHECK_N)
    as_t = lambda a, dev: torch.as_tensor(a, dtype=torch.float64, device=dev)
    objectives = {dev: gnmgp.make_objective(FullData(as_t(xc, dev), as_t(yc, dev))) for dev in (DEVICE, "cpu")}
    drivers = {"plain": {}, "dual averaging": dict(adapt_step_size=True, n_warmup=HMC_CHECK_WARMUP),
               "windowed": dict(adapt_mass=True, n_warmup=HMC_CHECK_WARMUP)}
    for name, kw in drivers.items():
        n_total = HMC_CHECK_DRAWS + kw.get("n_warmup", 0)
        gen = torch.Generator().manual_seed(seed + 5)
        noise = (torch.randn(n_total, vec.shape[0], generator=gen, dtype=torch.float64),
                 torch.rand(n_total, generator=gen, dtype=torch.float64))
        chains = {}
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            chains[dev] = hmc.hmc_sample(objectives[dev], vec.to(dev), HMC_CHECK_DRAWS, noise=noise,
                                         step_size=cfg.hmc_step_size, n_leapfrog=HMC_CHECK_LEAPFROG, **kw)
            log("hmc", f"N={HMC_CHECK_N} {name} chain on {dev}: {time.perf_counter() - t0:.3f} s")
        card, cpu = chains[DEVICE], chains["cpu"]
        if not torch.equal(card.accepted.cpu(), cpu.accepted):
            raise AssertionError(f"{name}: accept decisions differ, card {card.accepted.tolist()} "
                                 f"vs CPU {cpu.accepted.tolist()}")
        if not cpu.accepted.any():
            raise AssertionError(f"{name}: no draw accepted, so the check compares nothing")
        rel_s, frac_s = held(np, card.samples.cpu().numpy(), cpu.samples.numpy(), OBJECTIVE_RTOL)
        rel_e, _ = held(np, [card.step_size.item()], [cpu.step_size.item()], OBJECTIVE_RTOL)
        log("hmc", f"N={HMC_CHECK_N} {name}, card vs CPU: accept decisions equal "
            f"({int(cpu.accepted.sum())} of {n_total} accepted); draws max rel err {rel_s:.3e}, max err "
            f"{frac_s:.3e} of their scale; step size {card.step_size.item():.6e} (rel {rel_e:.3e}): "
            f"ok at rtol {OBJECTIVE_RTOL}")
    return stage, res, (x, y)


def check_sample_answer(np, out, g):
    """A mode="sample" answer: shapes, finite values, std > 0, lower <= upper."""
    arr = {k: np.asarray(out[k], dtype=float) for k in ("mean", "std", "lower", "upper")}
    for k, v in arr.items():
        if v.shape != (g, SERVED_M) or not np.isfinite(v).all():
            raise AssertionError(f"sample /predict {g} points: {k} has shape {v.shape} or non-finite values")
    if not ((arr["std"] > 0).all() and (arr["lower"] <= arr["upper"]).all()):
        raise AssertionError(f"sample /predict {g} points: std not positive or lower > upper")
    return arr


def phase_chain(torch, np, gk, seed, root, res, data) -> dict:
    """The chain's consumers' path, on the card with no device
    named: (a) the LOO stage on the hmc phase's chain; (b) mode="sample"
    requests over HTTP from the hmc phase's store; (c) the LOO conditionals
    and the sampling predictions card against CPU at N=CHAIN_CHECK_N with
    the same draws and noise; (d) run_subject(do_loo=True) and the CLI.
    Returns K1's and K2's launches in the LOO stage and per sample request."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, viz, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData, task_major
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import serve
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    counted = {"gibbs_gram": "K1", "svc_gram": "K2"}
    x, y = data
    samples = res["hmc_samples"]
    s = samples.shape[0]

    # (a) the LOO stage at the headline shape
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()  # the LOO stage starts here
    t0 = time.perf_counter()
    cond_ll = evaluate.chain_conditional_loglik("gnmgp", samples, x, y)
    t1 = time.perf_counter()
    loo = evaluate.psis_loo(cond_ll)
    wa = evaluate.waic(cond_ll)
    t2 = time.perf_counter()
    loo_launches = gk.launches()  # the LOO stage ends here
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("chain", f"LOO stage N={len(x)} M=2 f64 over {s} draws: {t2 - t0:.3f} s (conditionals on the card "
        f"{t1 - t0:.3f} s, {(t1 - t0) / s * 1e3:.3f} ms a draw; psis_loo + waic on the host {t2 - t1:.3f} s); "
        f"peak device memory {peak_gib:.3f} GiB")
    log("chain", f"elpd_loo {loo['elpd_loo']:.6f}, p_loo {loo['p_loo']:.6f}, looic {loo['looic']:.6f}, "
        f"n_bad_k {loo['n_bad_k']} of {cond_ll.shape[1]}, k_hat_max {np.max(loo['k_hat']):.6f}, k_hat median "
        f"{np.median(loo['k_hat']):.6f}; elpd_waic {wa['elpd_waic']:.6f}, p_waic {wa['p_waic']:.6f}; the chain "
        f"holds {len(torch.unique(samples, dim=0))} distinct draws of {s} (a rejected draw repeats the last)")
    log("chain", f"LOO stage launched {loo_launches}")
    if cond_ll.shape != (s, 2 * len(x)) or not np.isfinite(cond_ll).all():
        raise AssertionError(f"LOO conditionals have shape {cond_ll.shape} or non-finite entries")
    if not all(np.isfinite(v) for v in (loo["elpd_loo"], loo["p_loo"], wa["elpd_waic"], wa["p_waic"])):
        raise AssertionError("non-finite elpd_loo, p_loo, elpd_waic or p_waic")
    if loo_launches["svc_gram"] != s:
        raise AssertionError(f"K2 launched {loo_launches['svc_gram']} times in the LOO stage, "
                             f"expected one per draw: {s}")
    xd, yd = (torch.as_tensor(a, dtype=torch.float64, device=DEVICE) for a in (x, y))
    one_draw = lambda: evaluate.pointwise_conditional_loglik(
        evaluate.observation_cov("gnmgp", samples[0], xd, len(x), 2), task_major(yd))
    wall_ms, device_ms, kinds, top = device_profile(torch, one_draw)
    log("profile", f"one LOO draw N={len(x)} M=2 f64: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms "
        f"(busy share {device_ms / wall_ms:.3f}); {kinds} kernel kinds")
    for ms, count, key in top:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")

    # (b) mode="sample" over HTTP from the hmc phase's store
    httpd = serve(root, port=0)  # warms mode="map" at the 64- and 256-point buckets
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}/predict"

    def post(xs):
        body = json.dumps({"subject": "0", "x": list(map(float, xs)), "mode": "sample",
                           "n_sample": CHAIN_N_SAMPLE}).encode()
        req = urllib.request.Request(url, data=body, method="POST")
        return json.load(urllib.request.urlopen(req, timeout=300))

    lo, hi = float(x.min()), float(x.max())
    grids = {g: np.linspace(lo, hi, g) for g in REQUEST_SIZES}
    per_request, latency = {}, {}
    torch.cuda.reset_peak_memory_stats()
    try:
        for g, xs in grids.items():
            check_sample_answer(np, post(xs), g)  # first request at this bucket
            times = []
            for _ in range(TIMED_REQUESTS):
                gk.reset_launches()  # a request starts here
                t0 = time.perf_counter()
                check_sample_answer(np, post(xs), g)
                times.append((time.perf_counter() - t0) * 1e3)
                rose = {name: gk.launches()[name] for name in counted}  # a request ends here
                if any(v != s for v in rose.values()):
                    raise AssertionError(f"a {g}-point sample request launched {rose}, expected {s} each")
                per_request[g] = rose
            latency[g] = statistics.median(times)
            log("chain", f"POST /predict mode=sample n_sample={CHAIN_N_SAMPLE} {g} points: ok, warm latency "
                f"median {latency[g]:.3f} ms (min {min(times):.3f}, max {max(times):.3f}, "
                f"{TIMED_REQUESTS} requests); launches per request {per_request[g]}")
        log("chain", f"peak device memory over the sample requests {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        xs = grids[201]
        wall_ms, device_ms, kinds, top = device_profile(
            torch, lambda: httpd.engine.predict("0", xs, mode="sample", n_sample=CHAIN_N_SAMPLE), reps=2)
        log("profile", f"engine.predict mode=sample 201 points, {s} draws: wall {wall_ms:.3f} ms, device "
            f"{device_ms:.3f} ms per request (busy share {device_ms / wall_ms:.3f}), {kinds} kernel kinds; "
            f"HTTP request {latency[201]:.3f} ms")
        for ms, count, key in top:
            log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")

    # (c) card against CPU at N=CHAIN_CHECK_N, the same draws and noise
    xc, yc, vec, _ = training_subject(torch, seed + 6, CHAIN_CHECK_N)
    gen = torch.Generator().manual_seed(seed + 7)
    f64 = torch.float64
    hist = vec[None, :] + 0.01 * torch.randn(CHAIN_CHECK_DRAWS, vec.shape[0], generator=gen, dtype=f64)
    grid = np.linspace(float(xc.min()), float(xc.max()), 201)
    t = 3
    normals = lambda *shape: torch.randn((CHAIN_CHECK_DRAWS,) + shape, generator=gen, dtype=f64)
    z_y = (normals(201), normals(t, 201), normals(201, 2))
    z_l, z_ul = normals(201), normals(t, 201)
    outs = {}
    for dev in (DEVICE, "cpu"):
        data = FullData(xc, yc)
        outs[dev] = {
            "LOO conditionals": evaluate.chain_conditional_loglik("gnmgp", hist, xc, yc, device=dev),
            "predict_sample": pred.predict_sample(None, hist, data, grid, device=dev, noise=z_y),
            "predict_map_sampling ℓ̃": pred.predict_map_sampling(None, CHAIN_CHECK_DRAWS, vec, data, grid,
                                                                pred_smoothness=True, device=dev, noise=z_l),
            "predict_map_sampling L_f": pred.predict_map_sampling(None, CHAIN_CHECK_DRAWS, vec, data, grid,
                                                                  pred_cov=True, device=dev, noise=z_ul),
            "predict_map_sampling y": pred.predict_map_sampling(None, CHAIN_CHECK_DRAWS, vec, data, grid,
                                                                device=dev, noise=z_y),
        }
    for name, got in outs[DEVICE].items():
        want = outs["cpu"][name]
        # the LOO conditionals as in the CPU tests; the kriged latents with the
        # kriging solve's absolute floor; y draws as the served answers
        rtol, atol, of_scale = {"LOO conditionals": (CHAIN_LOO_RTOL, 0.0, CHAIN_LOO_RTOL),
                                "predict_map_sampling ℓ̃": (SERVED_RTOL, KRIGE_ATOL, 0.0),
                                "predict_map_sampling L_f": (SERVED_RTOL, KRIGE_ATOL, 0.0)}.get(
            name, (SERVED_RTOL, 0.0, SERVED_ATOL_OF_SCALE))
        errs = []
        for g_, w_ in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
            g_, w_ = (np.asarray(v.cpu() if torch.is_tensor(v) else v) for v in (g_, w_))
            err = np.abs(g_ - w_)
            if not (np.isfinite(g_).all() and (err <= rtol * np.abs(w_) + atol + of_scale * np.abs(w_).max()).all()):
                raise AssertionError(f"N={CHAIN_CHECK_N} {name}: card vs CPU off by {err.max():.3e}")
            errs.append(err.max() / np.abs(w_).max())
        log("chain", f"N={CHAIN_CHECK_N} {name}, card vs CPU, {CHAIN_CHECK_DRAWS} draws, the same noise: ok at "
            f"rtol {rtol}, atol {atol}, floor {of_scale} of the scale; max abs err {max(errs):.3e} of the scale")

    # (d) the pipeline wiring: run_subject(do_loo=True) and the CLI, on the card
    out_dir = os.path.join(ROOT, "chiprun_out")
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="smoke_loo_") as loo_root:
        cfg = workflows.PipelineConfig(n_opt=CHECK_N_OPT, do_hmc=True, do_loo=True, n_hmc=CHAIN_CHECK_DRAWS)
        t0 = time.perf_counter()
        run = workflows.run_subject(xc, yc, cfg, store=ArtifactStore(loo_root), dataset="sim")
        wall = time.perf_counter() - t0
        key = ArtifactStore.key("gnmgp", "sim", 0, "loo")
        stored = ArtifactStore(loo_root).load(key) if ArtifactStore(loo_root).exists(key) else None
    scalars = {k: v for k, v in run["loo"].items() if k != "pointwise"}
    log("chain", f"run_subject N={CHAIN_CHECK_N} do_hmc do_loo n_hmc={CHAIN_CHECK_DRAWS} on "
        f"{run['hmc_samples'].device}: {wall:.3f} s; loo " + ", ".join(f"{k} {v:.6g}" for k, v in scalars.items()))
    if len(scalars) != 8 or not all(np.isfinite(v) for v in scalars.values()):
        raise AssertionError(f"run_subject's loo keys are missing or non-finite: {scalars}")
    if stored is None or {k: float(v) for k, v in stored.items()} != {k: float(v) for k, v in scalars.items()}:
        raise AssertionError("the loo artifact is missing or differs from result['loo']")
    cli_out = os.path.join(out_dir, "cli")
    t0 = time.perf_counter()
    summary = run_sim_pipeline.main(["--n", str(CHAIN_CHECK_N), "--n-opt", str(CHECK_N_OPT),
                                     "--n-hmc", str(CHAIN_CLI_HMC), "--out", cli_out])
    log("chain", f"CLI --n {CHAIN_CHECK_N} --n-opt {CHECK_N_OPT} --n-hmc {CHAIN_CLI_HMC} on the card: "
        f"{time.perf_counter() - t0:.3f} s, figures by {'matplotlib' if viz.plt else 'the raster writer'}; "
        f"summary {summary}")
    for name in ("posterior.png", "target_trace.png", "manifest.json"):
        if not os.path.getsize(os.path.join(cli_out, name)) > 0:
            raise AssertionError(f"the CLI did not write {name}")
    if not {"deviance", "aic", "bic", "dic", "hmc_accept"} <= set(summary):
        raise AssertionError(f"the CLI's summary lacks finite scores: {summary}")
    return {name: {"launches_loo": loo_launches[name], "launches_sample_request": per_request[201][name]}
            for name in counted}


def model_subject(torch, model: str, seed: int, n: int):
    """A subject for ``model`` at N=n, M=2, on the CPU in float64: x, y
    (numpy) and the truth packed as the model's parameter vector.
    ``sim_mnts`` for LMC (the truth's mean log-lengthscale and task factor,
    unit scale) and SNMGP, ``sim_mnts_hetero`` for the heteroscedastic GNMGP
    (its noise varies across inputs and tasks)."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.data import sim
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import transforms

    if model == "gnmgp_hetero":
        d = sim.sim_mnts_hetero(torch.Generator().manual_seed(seed), n=n, device="cpu", dtype=torch.float64)
        ul = transforms.lvec_to_ulvec(d.l_vecs.reshape(n, 3), 2).reshape(-1)
        return d.x.numpy(), d.y.numpy(), torch.cat([torch.log(d.l), ul, d.tilde_sigma2_err])
    x, y, _, svec = training_subject(torch, seed, n)
    if model == "snmgp":
        return x, y, svec
    return x, y, torch.cat([svec[:n].mean().reshape(1), torch.zeros(1, dtype=torch.float64), svec[2 * n:]])


def sample_noise(torch, model: str, gen, s: int, g: int):
    """The standard normals of ``predict_sample``'s ``noise=`` for ``model``
    over s draws at g points (M=2, T=3)."""
    f64 = torch.float64
    z = lambda *shape: torch.randn((s,) + shape, generator=gen, dtype=f64)
    return {"lmc": lambda: z(g, 2), "snmgp": lambda: (z(g), z(g), z(g, 2)),
            "gnmgp_hetero": lambda: (z(g), z(3, g), z(2, g), z(g, 2))}[model]()


def phase_models(torch, np, gk, seed) -> dict:
    """The other model families' paths: for each of LMC, SNMGP and the heteroscedastic GNMGP
    at N=TRAIN_N, M=2, f64, with no device named: the objective card vs CPU
    and its gradient rate; run_subject(do_hmc=True, do_loo=True) into a store
    with the launches of its chain, DIC and LOO stages counted exactly;
    mode="map" and mode="sample" over HTTP from that store; run_subject at
    N=CHECK_N card vs CPU.  Then the CLI with --model gnmgp_hetero.  Returns
    each kernel's launches by model and stage, and each model's subject (x,
    y), its MAP vector on the CPU, its chain's mean acceptance and gradients
    per second."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import serve
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    f64 = torch.float64
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    counts: dict = {}
    subjects: dict = {}
    for i, model in enumerate(MODEL_FAMILIES):
        t_model = time.perf_counter()
        mod, pred = workflows._MODELS[model], workflows._PREDICT[model]
        want = MODEL_LAUNCHES[model]
        expect = lambda per, times: {k: per.get(k, 0) * times for k in gk.launches()}
        x, y, vec = model_subject(torch, model, seed + 20 + i, TRAIN_N)
        as_t = lambda a, dev: torch.as_tensor(a, dtype=f64, device=dev)

        # (a) the objective, card against CPU, and its gradient rate
        objs = {dev: mod.make_objective(FullData(as_t(x, dev), as_t(y, dev))) for dev in (DEVICE, "cpu")}
        gk.reset_launches()
        v_card, g_card = value_and_grad(objs[DEVICE], vec.to(DEVICE))
        torch.cuda.synchronize()
        if gk.launches() != expect(want["gradient"], 1):
            raise AssertionError(f"{model}: one gradient launched {gk.launches()}, expected {want['gradient']}")
        v_cpu, g_cpu = value_and_grad(objs["cpu"], vec)
        if not (torch.isfinite(v_cpu) and torch.isfinite(g_cpu).all()):
            raise AssertionError(f"{model}: non-finite objective or gradient on the CPU")
        rel_v, _ = held(np, [v_card.item()], [v_cpu.item()], OBJECTIVE_RTOL)
        rel_g, frac_g = held(np, g_card.cpu().numpy(), g_cpu.numpy(), OBJECTIVE_RTOL)
        per_s = []
        v = vec.to(DEVICE)
        for _ in range(RATE_BATCHES):
            t0 = time.perf_counter()
            for _ in range(RATE_EVALS):
                value_and_grad(objs[DEVICE], v)
            torch.cuda.synchronize()
            per_s.append(RATE_EVALS / (time.perf_counter() - t0))
        log("models", f"{model} N={TRAIN_N} M=2 f64 (P={vec.shape[0]}) objective card vs CPU: value "
            f"{v_card.item():.10e} (rel {rel_v:.3e}); gradient max rel err {rel_g:.3e}, max err {frac_g:.3e} of "
            f"max |grad| {g_cpu.abs().max().item():.3e}: ok at rtol {OBJECTIVE_RTOL}; one gradient launched "
            f"{want['gradient']}; {statistics.median(per_s):.3f} gradient evaluations/s (median of {RATE_BATCHES} "
            f"batches of {RATE_EVALS}; min {min(per_s):.3f}, max {max(per_s):.3f})")
        wall_ms, device_ms, kinds, top = device_profile(torch, lambda: value_and_grad(objs[DEVICE], v))
        log("profile", f"one {model} gradient N={TRAIN_N} M=2 f64: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms "
            f"(busy share {device_ms / wall_ms:.3f}), {kinds} kernel kinds")
        for ms, count, key in top:
            log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")

        # (b) run_subject(do_hmc=True, do_loo=True), no device named, into a store
        cfg = workflows.PipelineConfig(model=model, n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True,
                                       n_hmc=MODEL_CHAIN_DRAWS)
        n_grads = 1 + (cfg.n_hmc + cfg.hmc_warmup) * cfg.hmc_leapfrog
        stages: dict = {}

        def counted(name, fn):
            def wrapped(*args, **kwargs):
                before = gk.launches()
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                torch.cuda.synchronize()
                stages[name] = ({k: v - before[k] for k, v in gk.launches().items()}, time.perf_counter() - t0)
                return res
            return wrapped

        originals = (workflows._run_chain, evaluate.get_dic, evaluate.chain_conditional_loglik)
        workflows._run_chain = counted("chain", originals[0])
        evaluate.get_dic = counted("dic", originals[1])
        evaluate.chain_conditional_loglik = counted("loo", originals[2])
        with tempfile.TemporaryDirectory(dir=out_dir, prefix=f"smoke_{model}_") as root:
            try:
                torch.cuda.reset_peak_memory_stats()
                gk.reset_launches()  # the main path starts here
                t0 = time.perf_counter()
                res = workflows.run_subject(x, y, cfg, store=ArtifactStore(root), dataset="sim")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                run_launches = gk.launches()  # the main path ends here
            finally:
                workflows._run_chain, evaluate.get_dic, evaluate.chain_conditional_loglik = originals
            samples = res["hmc_samples"]
            s = samples.shape[0]
            t_hmc = res["timings"]["hmc"]
            loo = {k: v for k, v in res["loo"].items() if k != "pointwise"}
            log("models", f"{model} run_subject N={TRAIN_N} M=2 f64 n_opt={TRAIN_N_OPT} do_hmc do_loo on "
                f"{samples.device} (no device named): {wall:.3f} s; stages (s): "
                + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items())
                + f", DIC {stages['dic'][1]:.3f}, LOO {stages['loo'][1]:.3f}; best start {res['map_init']!r}; "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            log("models", f"{model} chain: {cfg.n_hmc} draws x {cfg.hmc_leapfrog} leapfrog steps at "
                f"{cfg.hmc_step_size}: {cfg.n_hmc / t_hmc:.3f} draws/s, {n_grads / t_hmc:.3f} gradients/s; "
                f"mean acceptance {res['hmc_accept']:.6f}; DIC {res['dic']:.6e} (deviance at the MAP "
                f"{res['deviance']:.6e}); loo " + ", ".join(f"{k} {v:.6g}" for k, v in loo.items()))
            log("models", f"{model} launches: chain {stages['chain'][0]}, DIC {stages['dic'][0]}, LOO "
                f"{stages['loo'][0]}; the whole run {run_launches}")
            if tuple(samples.shape) != (cfg.n_hmc, vec.shape[0]) or samples.device.type != torch.device(DEVICE).type:
                raise AssertionError(f"{model}: hmc_samples on {samples.device} with shape {tuple(samples.shape)}")
            finite = [res["dic"], res["deviance"], *loo.values()]
            if not (torch.isfinite(samples).all() and np.isfinite(finite).all() and 0.0 < res["hmc_accept"] <= 1.0):
                raise AssertionError(f"{model}: non-finite draws, DIC or LOO, or no draw accepted")
            for stage, per, times in (("chain", "gradient", n_grads), ("dic", "dic", s + 1), ("loo", "loo", s)):
                if stages[stage][0] != expect(want[per], times):
                    raise AssertionError(f"{model}: the {stage} stage launched {stages[stage][0]}, "
                                         f"expected {expect(want[per], times)}")
            if tuple(res["pred_grid"].percentiles.shape) != (cfg.n_grid, 3, 2):
                raise AssertionError(f"{model}: pred_grid has shape {tuple(res['pred_grid'].percentiles.shape)}")

            # (c) mode="map" and mode="sample" over HTTP from that store
            httpd = serve(root, port=0, model=model)  # warms mode="map" at the 64- and 256-point buckets
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            xs = np.linspace(float(x.min()), float(x.max()), 201)

            def post(mode):
                body = json.dumps({"subject": "0", "x": list(map(float, xs)), "mode": mode,
                                   "n_sample": CHAIN_N_SAMPLE}).encode()
                req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/predict", data=body,
                                             method="POST")
                return json.load(urllib.request.urlopen(req, timeout=300))

            latency, answers, per_request = {}, {}, {}
            try:
                for mode, check, per, times in (("map", check_answer, "map_request", 1),
                                                ("sample", check_sample_answer, "sample_draw", s)):
                    answers[mode] = check(np, post(mode), 201)  # first request at this bucket
                    times_ms = []
                    for _ in range(TIMED_REQUESTS):
                        gk.reset_launches()  # a request starts here
                        t0 = time.perf_counter()
                        check(np, post(mode), 201)
                        times_ms.append((time.perf_counter() - t0) * 1e3)
                        per_request[mode] = gk.launches()  # a request ends here
                        if per_request[mode] != expect(want[per], times):
                            raise AssertionError(f"{model}: a {mode} request launched {per_request[mode]}, "
                                                 f"expected {expect(want[per], times)}")
                    latency[mode] = statistics.median(times_ms)
                    log("models", f"{model} POST /predict mode={mode} 201 points: ok, warm latency median "
                        f"{latency[mode]:.3f} ms (min {min(times_ms):.3f}, max {max(times_ms):.3f}, "
                        f"{TIMED_REQUESTS} requests); launches per request {want[per]} x {times}")
                wall_ms, device_ms, kinds, top = device_profile(
                    torch, lambda: httpd.engine.predict("0", xs, mode="sample", n_sample=CHAIN_N_SAMPLE), reps=2)
                log("profile", f"{model} engine.predict mode=sample 201 points, {s} draws: wall {wall_ms:.3f} ms, "
                    f"device {device_ms:.3f} ms per request (busy share {device_ms / wall_ms:.3f}), {kinds} kernel "
                    f"kinds")
                for ms, count, key in top:
                    log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=30)
            if thread.is_alive():
                raise AssertionError("server thread did not stop")
        map_vec = res["map_vec"].cpu()
        subjects[model] = (x, y, map_vec, res["hmc_accept"], n_grads / res["timings"]["hmc"])
        ref = pred.predict_map(map_vec, FullData(x, y), xs, device="cpu", dtype=f64)
        for k, w in (("mean", ref.mean), ("std", ref.std), ("lower", ref.percentiles[:, 0]),
                     ("upper", ref.percentiles[:, 2])):
            rel, frac = held(np, answers["map"][k], w.numpy(), SERVED_RTOL)
            log("models", f"{model} served 201-point map {k} vs CPU predict_map: ok, max rel err {rel:.3e}, "
                f"max err {frac:.3e} of max |CPU|")
        gen = torch.Generator().manual_seed(seed + 30 + i)
        noise = sample_noise(torch, model, gen, MODELS_CHECK_DRAWS, 201)
        hist = samples[-MODELS_CHECK_DRAWS:]
        draws = {dev: pred.predict_sample(None, hist.to(dev), FullData(x, y), xs, device=dev, dtype=f64,
                                          noise=noise).cpu().numpy() for dev in (DEVICE, "cpu")}
        rel, frac = held(np, draws[DEVICE], draws["cpu"], SERVED_RTOL)
        log("models", f"{model} predict_sample N={TRAIN_N} 201 points, {MODELS_CHECK_DRAWS} draws, the same "
            f"noise: card vs CPU ok, max rel err {rel:.3e}, max err {frac:.3e} of the scale")

        # (d) run_subject at N=CHECK_N on the card and on the CPU
        x2, y2, _ = model_subject(torch, model, seed + 40 + i, CHECK_N)
        cfg2 = workflows.PipelineConfig(model=model, n_opt=CHECK_N_OPT)
        runs = {}
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            runs[dev] = workflows.run_subject(x2, y2, cfg2, device=dev, dtype=f64)
            log("models", f"{model} run_subject N={CHECK_N} n_opt={CHECK_N_OPT} on {dev}: "
                f"{time.perf_counter() - t0:.3f} s, best start {runs[dev]['map_init']!r}")
        f = mod.make_objective(FullData(as_t(x2, "cpu"), as_t(y2, "cpu")))
        with torch.no_grad():
            final = {dev: f(r["map_vec"].cpu()).item() for dev, r in runs.items()}
        rel_f, _ = held(np, [final[DEVICE]], [final["cpu"]], OBJECTIVE_RTOL)
        rel_m, frac_m = held(np, runs[DEVICE]["map_vec"].cpu().numpy(), runs["cpu"]["map_vec"].numpy(),
                             OBJECTIVE_RTOL)
        log("models", f"{model} N={CHECK_N} card vs CPU: final objective {final[DEVICE]:.10e} vs "
            f"{final['cpu']:.10e} (rel {rel_f:.3e}); map_vec max rel err {rel_m:.3e}, max err {frac_m:.3e} of its "
            f"scale: ok at rtol {OBJECTIVE_RTOL}; the model's phase took {time.perf_counter() - t_model:.3f} s")
        counts[model] = {name: {"chain": stages["chain"][0][name], "dic": stages["dic"][0][name],
                                "loo": stages["loo"][0][name], "map_request": per_request["map"][name],
                                "sample_request": per_request["sample"][name]} for name in gk.launches()}

    cli_out = os.path.join(out_dir, "cli_hetero")
    t0 = time.perf_counter()
    summary = run_sim_pipeline.main(["--model", "gnmgp_hetero", "--n", str(CHECK_N), "--n-opt", str(CHECK_N_OPT),
                                     "--n-hmc", str(CHAIN_CLI_HMC), "--out", cli_out])
    log("models", f"CLI --model gnmgp_hetero --n {CHECK_N} --n-opt {CHECK_N_OPT} --n-hmc {CHAIN_CLI_HMC} on "
        f"the card: {time.perf_counter() - t0:.3f} s; summary {summary}")
    for name in ("posterior.png", "target_trace.png", "manifest.json"):
        if not os.path.getsize(os.path.join(cli_out, name)) > 0:
            raise AssertionError(f"the CLI did not write {name}")
    if not {"deviance", "aic", "bic", "dic", "hmc_accept"} <= set(summary):
        raise AssertionError(f"the CLI's summary lacks finite scores: {summary}")
    return counts, subjects


def nuts_stats(torch, res, n_warmup: int, max_depth: int) -> str:
    """A NUTS chain's tree depths, divergences, acceptance after warmup,
    adapted step and distinct kept draws, as one log fragment."""
    depth = res.tree_depth.cpu()
    kept = torch.unique(res.samples, dim=0).shape[0]
    return (f"tree depth mean {depth.double().mean().item():.3f}, max {int(depth.max())}, "
            f"{int((depth == max_depth).sum())} of {depth.numel()} draws at max_depth {max_depth}; "
            f"{int(res.diverging.sum())} divergent; mean accept_stat after warmup "
            f"{res.accept_stat[n_warmup:].mean().item():.6f}; adapted step {res.step_size.item():.6e}; "
            f"{kept} distinct of {res.samples.shape[0]} kept draws")


def check_nuts_launches(model, launched: dict, res) -> dict:
    """The kernels of ``model``'s gradient launched exactly 1 + Σ n_leapfrog
    times in its NUTS chain, and no other kernel; returns the launches."""
    n_grads = 1 + int(res.n_leapfrog.sum())
    want = {k: n_grads if k in NUTS_KERNELS[model] else 0 for k in launched}
    if launched != want:
        raise AssertionError(f"{model}: the NUTS chain launched {launched}, expected {want} (1 + Σ n_leapfrog)")
    return launched


def phase_nuts(torch, np, gk, seed, subjects) -> dict:
    """The whitened NUTS path: (a) the card against the CPU at
    N=NUTS_CHECK_N with the same injected noise, and the CLI at
    N=NUTS_CLI_N; (b) each model's chain at N=TRAIN_N from a MAP at
    ``n_opt=TRAIN_N_OPT`` (GNMGP through run_subject, the others, from the
    models phase's MAPs in ``subjects``, through nuts_sample) with the launch
    counts checked exactly.  Returns each kernel's launches by model."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import nuts, whiten
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    f64 = torch.float64
    step = workflows.PipelineConfig().hmc_step_size
    out_dir = os.path.join(ROOT, "chiprun_out")

    # (a) the card against the CPU: a prior-whitened chain and one on an
    # eig-mode map retuned (whiten.retune) from seeded draws around the truth
    x, y, vec, _ = training_subject(torch, seed + 50, NUTS_CHECK_N)
    p = vec.shape[0]
    gen = torch.Generator().manual_seed(seed + 51)
    pilot = vec + 0.01 * torch.randn(20, p, generator=gen, dtype=f64)
    n_total = NUTS_CHECK_WARMUP + NUTS_CHECK_DRAWS
    noise = (torch.randn(n_total, p, generator=gen, dtype=f64),
             torch.rand(n_total, NUTS_CHECK_DEPTH, generator=gen, dtype=f64) < 0.5,
             torch.rand(n_total, NUTS_CHECK_DEPTH, 2 ** (NUTS_CHECK_DEPTH - 1), generator=gen, dtype=f64),
             torch.rand(n_total, NUTS_CHECK_DEPTH, generator=gen, dtype=f64))
    for name in ("prior", "pncp"):
        chains = {}
        for dev in (DEVICE, "cpu"):
            xd = torch.as_tensor(x, dtype=f64, device=dev)
            nlp = gnmgp.make_objective(FullData(xd, torch.as_tensor(y, dtype=f64, device=dev)))
            if name == "prior":
                w = whiten.make_whitener("gnmgp", xd, NUTS_CHECK_N, 2)
            else:
                w = whiten.retune(whiten.make_whitener("gnmgp", xd, NUTS_CHECK_N, 2, mode="eig"), pilot.to(dev))
            t0 = time.perf_counter()
            chains[dev] = nuts.nuts_sample(w.wrap(nlp), w.to_white(vec.to(dev)), NUTS_CHECK_DRAWS, noise=noise,
                                           step_size=step, n_warmup=NUTS_CHECK_WARMUP, max_depth=NUTS_CHECK_DEPTH)
            log("nuts", f"N={NUTS_CHECK_N} {name}-whitened chain on {dev}: {time.perf_counter() - t0:.3f} s, "
                f"leaves {chains[dev].n_leapfrog.tolist()}")
        card, cpu = chains[DEVICE], chains["cpu"]
        for f in ("tree_depth", "n_leapfrog", "diverging"):
            if not torch.equal(getattr(card, f).cpu(), getattr(cpu, f)):
                raise AssertionError(f"{name}: {f} differs, card {getattr(card, f).tolist()} vs CPU "
                                     f"{getattr(cpu, f).tolist()}")
        rel_s, frac_s = held(np, card.samples.cpu().numpy(), cpu.samples.numpy(), OBJECTIVE_RTOL)
        rel_e, _ = held(np, [card.step_size.item()], [cpu.step_size.item()], OBJECTIVE_RTOL)
        log("nuts", f"N={NUTS_CHECK_N} {name}-whitened, card vs CPU: tree depths, leaf counts and divergence "
            f"flags equal ({int(cpu.n_leapfrog.sum())} leaves in {n_total} draws); draws max rel err {rel_s:.3e}, "
            f"max err {frac_s:.3e} of their scale; step size rel {rel_e:.3e}: ok at rtol {OBJECTIVE_RTOL}")

    cli_out = os.path.join(out_dir, "cli_nuts")
    nuts_sample = nuts.nuts_sample
    nuts.nuts_sample = lambda *args, **kwargs: nuts_sample(*args, **kwargs, max_depth=NUTS_CLI_DEPTH)
    t0 = time.perf_counter()
    try:
        summary = run_sim_pipeline.main(["--sampler", "nuts", "--whiten", "prior", "--n", str(NUTS_CLI_N), "--n-opt",
                                         str(CHECK_N_OPT), "--n-hmc", str(NUTS_CLI_HMC), "--out", cli_out])
    finally:
        nuts.nuts_sample = nuts_sample
    log("nuts", f"CLI --sampler nuts --whiten prior --n {NUTS_CLI_N} --n-opt {CHECK_N_OPT} --n-hmc {NUTS_CLI_HMC} "
        f"(warmup max(100, n_hmc), max_depth {NUTS_CLI_DEPTH}) on the card: {time.perf_counter() - t0:.3f} s; "
        f"summary {summary}")
    for name in ("posterior.png", "target_trace.png", "manifest.json"):
        if not os.path.getsize(os.path.join(cli_out, name)) > 0:
            raise AssertionError(f"the CLI did not write {name}")
    if not {"deviance", "dic", "hmc_accept"} <= set(summary):
        raise AssertionError(f"the CLI's summary lacks finite scores: {summary}")

    # (b) each model at N=TRAIN_N from a MAP at n_opt=TRAIN_N_OPT
    counts: dict = {}
    x, y, _, _ = training_subject(torch, seed + 1, TRAIN_N)
    cfg = workflows.PipelineConfig(n_opt=TRAIN_N_OPT, do_hmc=True, sampler="nuts", whiten="prior",
                                   n_hmc=NUTS_DRAWS, hmc_warmup=NUTS_WARMUP, do_loo=True)
    chain: dict = {}
    run_chain, nuts_sample = workflows._run_chain, nuts.nuts_sample

    def counted_chain(*args, **kwargs):
        # the launches around the sampling stage (the whitened call recurses:
        # the outer call, which ends last, covers the inner one)
        before = gk.launches()
        out = run_chain(*args, **kwargs)
        chain["launches"] = {k: v - before[k] for k, v in gk.launches().items()}
        return out

    def kept_result(*args, **kwargs):
        chain["res"] = nuts_sample(*args, **kwargs, max_depth=NUTS_MODEL_DEPTH)
        return chain["res"]

    workflows._run_chain, nuts.nuts_sample = counted_chain, kept_result
    try:
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        res = workflows.run_subject(x, y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = gk.launches()  # the main path ends here
    finally:
        workflows._run_chain, nuts.nuts_sample = run_chain, nuts_sample
    nres, t_chain = chain["res"], res["timings"]["hmc"]
    n_draws, n_grads = NUTS_WARMUP + NUTS_DRAWS, 1 + int(nres.n_leapfrog.sum())
    loo = {k: v for k, v in res["loo"].items() if k != "pointwise"}
    log("nuts", f"gnmgp run_subject N={TRAIN_N} M=2 f64 n_opt={TRAIN_N_OPT} sampler=nuts whiten=prior do_loo on "
        f"{res['hmc_samples'].device} (no device named): {wall:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()))
    log("nuts", f"gnmgp chain: {NUTS_WARMUP} warmup + {NUTS_DRAWS} draws at step {step} (max_depth "
        f"{NUTS_MODEL_DEPTH}): {n_draws / t_chain:.3f} draws/s, {n_grads / t_chain:.3f} gradients/s ({n_grads} "
        f"gradients in {t_chain:.3f} s); " + nuts_stats(torch, nres, NUTS_WARMUP, NUTS_MODEL_DEPTH) + f"; hmc_accept {res['hmc_accept']:.6f}; "
        f"DIC {res['dic']:.6e}; loo " + ", ".join(f"{k} {v:.6g}" for k, v in loo.items()))
    launched = check_nuts_launches("gnmgp", chain["launches"], nres)
    log("nuts", f"gnmgp launches: chain {launched} = 1 + Σ n_leapfrog; the whole run {run_launches}")
    samples = res["hmc_samples"]
    if (tuple(samples.shape) != (NUTS_DRAWS, gnmgp.n_params(TRAIN_N, 2))
            or samples.device.type != torch.device(DEVICE).type or not torch.isfinite(samples).all()):
        raise AssertionError(f"gnmgp: hmc_samples on {samples.device} with shape {tuple(samples.shape)}")
    # k̂ may be inf over NUTS_DRAWS draws (PSIS's tail fit has too few); the criteria may not
    if not np.isfinite([res["dic"], loo["elpd_loo"], loo["looic"], loo["elpd_waic"], loo["waic"]]).all():
        raise AssertionError("gnmgp: non-finite DIC or LOO after the NUTS chain")
    counts["gnmgp"] = launched

    # the other models from the models phase's MAPs; the hetero model also at
    # run_subject's default warmup, max(100, n_hmc)
    runs = [(model, NUTS_WARMUP) for model in MODEL_FAMILIES] + [("gnmgp_hetero", NUTS_HETERO_WARMUP)]
    for i, (model, n_warmup) in enumerate(runs):
        mx, my, map_vec, hmc_accept, _ = subjects[model]
        xd = torch.as_tensor(mx, dtype=f64, device=DEVICE)
        nlp = workflows._MODELS[model].make_objective(FullData(xd, torch.as_tensor(my, dtype=f64, device=DEVICE)))
        w = whiten.make_whitener(model, xd, TRAIN_N, 2)
        gen = torch.Generator(DEVICE).manual_seed(seed + 60 + i)
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        nres = nuts.nuts_sample(w.wrap(nlp), w.to_white(map_vec.to(DEVICE)), NUTS_DRAWS, gen, step_size=step,
                                n_warmup=n_warmup, max_depth=NUTS_MODEL_DEPTH)
        samples = w.from_white_batch(nres.samples)
        torch.cuda.synchronize()
        t_chain = time.perf_counter() - t0
        key = model if n_warmup == NUTS_WARMUP else f"{model}_warmup{n_warmup}"
        counts[key] = check_nuts_launches(model, gk.launches(), nres)  # the main path ends here
        n_grads = 1 + int(nres.n_leapfrog.sum())
        if not torch.isfinite(samples).all():
            raise AssertionError(f"{model}: non-finite NUTS draws")
        log("nuts", f"{model} N={TRAIN_N} M=2 f64 prior-whitened NUTS ({len(w.blocks)} whitened blocks) from the "
            f"n_opt={TRAIN_N_OPT} MAP, {n_warmup} warmup + {NUTS_DRAWS} draws at step {step}: {t_chain:.3f} s, "
            f"{(n_warmup + NUTS_DRAWS) / t_chain:.3f} draws/s, {n_grads / t_chain:.3f} gradients/s; "
            + nuts_stats(torch, nres, n_warmup, NUTS_MODEL_DEPTH)
            + f"; launches {counts[key]} = 1 + Σ n_leapfrog")
        if model == "gnmgp_hetero":
            log("nuts", f"gnmgp_hetero, {n_warmup} warmup draws: NUTS mean accept_stat after warmup "
                f"{nres.accept_stat[n_warmup:].mean().item():.6f} against fixed HMC's acceptance "
                f"{hmc_accept:.6f} at the same step (the models phase's chain from the same MAP)")
    return counts


def hadamard_subject(torch, np, seed: int, n: int):
    """The ``sim_mnts`` subject at N=n, M=2 in the Hadamard layout, each
    (time, channel) cell kept with probability 1 − HADAMARD_DROP: x, indx, y
    (numpy, time-major, so times observed in both channels repeat), and the
    truth as each model's packed vector at the observations of
    ``run_subject_hadamard``'s training half, sorted as it sorts them (the
    Hadamard objectives take raw L-vectors).  Also the training and test
    halves."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.data import preprocess, sim

    f64 = torch.float64
    d = sim.sim_mnts(torch.Generator().manual_seed(seed), n=n, m=2, device="cpu", dtype=f64)
    keep = np.random.default_rng(seed).random((n, 2)) >= HADAMARD_DROP
    ti, indx = np.nonzero(keep)
    x, y = d.x.numpy()[ti], d.y.numpy()[ti, indx]
    ids = np.arange(x.shape[0])
    x_tr, x_te, i_tr, i_te, id_tr, id_te = preprocess.data_split_non(x, indx, ids, test_size=HADAMARD_TEST_SIZE)
    id_tr = id_tr[np.argsort(x_tr)]
    t_tr = torch.as_tensor(ti[id_tr])
    log_l, l_vecs = torch.log(d.l), d.l_vecs.reshape(n, 3)
    log_s2 = torch.log(torch.tensor([d.sigma2_err], dtype=f64))
    vecs = {"gnmgp": torch.cat([log_l[t_tr], l_vecs[t_tr].reshape(-1), log_s2]),
            "snmgp": torch.cat([log_l[t_tr], torch.zeros(len(id_tr), dtype=f64), l_vecs.mean(dim=0), log_s2]),
            "lmc": torch.cat([log_l.mean().reshape(1), torch.zeros(1, dtype=f64), l_vecs.mean(dim=0), log_s2])}
    train = (x[id_tr], indx[id_tr], y[id_tr])
    test = (x[id_te], indx[id_te], y[id_te])
    return (x, indx, y), vecs, train, test


def check_k1_hadamard(torch, np, gk, settings, x, ell, grids) -> None:
    """K1 on the Hadamard path's shapes, against its plain version on the
    card: the self form and its backward on tied inputs at N_obs (not a
    multiple of a tile), the cross form against each of ``grids``.  These
    launches come before the path's counts are reset."""
    gen = torch.Generator().manual_seed(5)
    as_d = lambda a: torch.as_tensor(a, dtype=torch.float64).to(DEVICE)
    x, ell = as_d(x), as_d(ell)
    n = x.shape[0]
    sigma = as_d(0.5 + torch.rand(n, generator=gen, dtype=torch.float64))
    k = gk.gibbs_gram(x, sigma, ell, jitter=settings.jitter)
    plain = gk.gibbs_gram_plain(x, sigma, ell, x, sigma, ell, settings.jitter)
    sched = gk.k1_forward_schedule(n, n, True, torch.float64, gk.sm_count(x.device))
    if not (torch.equal(k, plain) and torch.equal(k, k.T)):
        raise AssertionError(f"K1 self form at N={n} with tied x: differs from its plain version or is not "
                             f"symmetric (max err {(k - plain).abs().max().item():.3e})")
    kbar = as_d(torch.randn(n, n, generator=gen, dtype=torch.float64))
    bwd = gk.gibbs_gram_backward(x, sigma, ell, kbar, settings.jitter)
    err = check_grad(torch, f"K1 backward N={n}", bwd, gk.gibbs_gram_backward_plain(x, sigma, ell, settings.jitter,
                                                                                  kbar), "float64")
    ms = time_ms(torch, lambda: gk.gibbs_gram(x, sigma, ell, jitter=settings.jitter))
    plain_ms = time_ms(torch, lambda: gk.gibbs_gram_plain(x, sigma, ell, x, sigma, ell, settings.jitter))
    bwd_ms = time_ms(torch, lambda: gk.gibbs_gram_backward(x, sigma, ell, kbar, settings.jitter))
    ties = n - torch.unique(x).shape[0]
    log("hadamard", f"K1 self form N={n} ({ties} tied inputs, {sched.route} route): equal to its plain version, "
        f"exactly symmetric; {ms:.5f} ms (plain {plain_ms:.5f} ms); backward max err {err:.3e} against autograd "
        f"of the plain version, {bwd_ms:.5f} ms")
    for g in grids:
        g = as_d(g)
        s2, l2 = (as_d(0.5 + torch.rand(g.shape[0], generator=gen, dtype=torch.float64)) for _ in range(2))
        kc = gk.gibbs_gram(x, sigma, ell, g, s2, l2)
        if not torch.equal(kc, gk.gibbs_gram_plain(x, sigma, ell, g, s2, l2)):
            raise AssertionError(f"K1 cross form {n} x {g.shape[0]} differs from its plain version")
        log("hadamard", f"K1 cross form {n} x {g.shape[0]}: equal to its plain version")


def phase_hadamard(torch, np, gk, seed) -> dict:
    """The Hadamard layout's path: (a) K1 on the path's shapes against its
    plain version; (b) each Hadamard objective at N_obs ≈ 1,125 (launches
    per gradient, gradient evaluations per second); (c) for each model
    ``run_subject_hadamard(do_hmc=True, do_loo=True)`` with no device named,
    each stage's launches counted exactly, and GNMGP once more with
    whitened NUTS; (d) the card against the CPU at about 200 observations.
    Returns each kernel's launches by model and stage."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, settings, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import map as map_mod
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import nuts
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import as_hadamard_data
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import hadamard as pred_h

    f64 = torch.float64
    (x, indx, y), vecs, (x_tr, i_tr, y_tr), (x_te, i_te, _) = hadamard_subject(torch, np, seed + 70, TRAIN_N)
    both = len(x) - len(np.unique(x))
    log("hadamard", f"sim_mnts N={TRAIN_N} M=2, each cell dropped with probability {HADAMARD_DROP}: {len(x)} "
        f"observations at {len(np.unique(x))} times, both channels at {both}; {len(x_tr)} train "
        f"({len(x_tr) - len(np.unique(x_tr))} tied), {len(x_te)} test")
    grid = np.linspace(float(x_tr.min()), float(x_tr.max()), workflows.PipelineConfig().n_grid)
    check_k1_hadamard(torch, np, gk, settings, x_tr, torch.exp(vecs["gnmgp"][: len(x_tr)]), (grid, x_te))

    # (b) each objective at the training half: launches per gradient, rate
    expect = lambda model, per, times: {k: HADAMARD_LAUNCHES[model][per].get(k, 0) * times for k in gk.launches()}
    data = as_hadamard_data(x_tr, i_tr, y_tr, device=DEVICE, dtype=f64)
    rates = {}
    for model in HADAMARD_MODELS:
        f = workflows._MODELS[model].make_objective_hadamard(data, 2)
        v = vecs[model].to(DEVICE)
        gk.reset_launches()
        val, grad = map_mod.value_and_grad(f, v)
        torch.cuda.synchronize()
        if gk.launches() != expect(model, "gradient", 1):
            raise AssertionError(f"{model}: one Hadamard gradient launched {gk.launches()}")
        if not (torch.isfinite(val) and torch.isfinite(grad).all()):
            raise AssertionError(f"{model}: non-finite Hadamard objective or gradient")
        per_s = []
        for _ in range(RATE_BATCHES):
            t0 = time.perf_counter()
            for _ in range(RATE_EVALS):
                map_mod.value_and_grad(f, v)
            torch.cuda.synchronize()
            per_s.append(RATE_EVALS / (time.perf_counter() - t0))
        rates[model] = statistics.median(per_s)
        log("hadamard", f"{model} Hadamard objective N_obs={len(x_tr)} f64 (P={v.shape[0]}): {rates[model]:.3f} "
            f"gradient evaluations/s (median of {RATE_BATCHES} batches of {RATE_EVALS}; min {min(per_s):.3f}, "
            f"max {max(per_s):.3f}); one gradient launched {HADAMARD_LAUNCHES[model]['gradient']}")
    f = workflows._MODELS["gnmgp"].make_objective_hadamard(data, 2)
    v = vecs["gnmgp"].to(DEVICE)
    wall_ms, device_ms, kinds, top = device_profile(torch, lambda: map_mod.value_and_grad(f, v))
    log("profile", f"one gnmgp Hadamard gradient N_obs={len(x_tr)} f64: wall {wall_ms:.3f} ms, device "
        f"{device_ms:.3f} ms (busy share {device_ms / wall_ms:.3f}), {kinds} kernel kinds")
    for ms, count, key in top:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")

    # (c) run_subject_hadamard on the card, no device named, stage by stage
    counts: dict = {}
    stages: dict = {}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            before = gk.launches()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = {k: v - before[k] for k, v in gk.launches().items()}
            return res
        return wrapped

    predictors, nuts_sample = workflows._hadamard_predictors, nuts.nuts_sample
    originals = (map_mod.fit_map, workflows._run_chain, evaluate.chain_conditional_loglik_hadamard, predictors)
    chain: dict = {}

    def kept_result(*args, **kwargs):
        chain["res"] = nuts_sample(*args, **kwargs)
        return chain["res"]

    map_mod.fit_map = counted("map", originals[0])
    workflows._run_chain = counted("chain", originals[1])
    evaluate.chain_conditional_loglik_hadamard = counted("loo", originals[2])
    workflows._hadamard_predictors = lambda *a: [counted(k, p) for k, p in
                                                zip(("pred_grid", "pred_test", "pred_test_sample"), predictors(*a))]
    nuts.nuts_sample = kept_result
    runs = [(model, {"n_hmc": MODEL_CHAIN_DRAWS}) for model in HADAMARD_MODELS]
    runs.append(("gnmgp", dict(sampler="nuts", whiten="prior", n_hmc=NUTS_DRAWS, hmc_warmup=NUTS_WARMUP)))
    try:
        for model, extra in runs:
            cfg = workflows.PipelineConfig(model=model, n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True,
                                           test_size=HADAMARD_TEST_SIZE, **extra)
            with_nuts = extra.get("sampler") == "nuts"
            label = f"{model}_nuts" if with_nuts else model
            stages.clear()
            chain.clear()
            torch.cuda.reset_peak_memory_stats()
            gk.reset_launches()  # the main path starts here
            t0 = time.perf_counter()
            res = workflows.run_subject_hadamard(x, indx, y, 2, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = gk.launches()  # the main path ends here
            s = res["hmc_samples"].shape[0]
            n_grads = (1 + int(chain["res"].n_leapfrog.sum()) if with_nuts
                       else 1 + (cfg.n_hmc + cfg.hmc_warmup) * cfg.hmc_leapfrog)
            t_chain = res["timings"]["hmc"]
            loo = res["loo"]
            log("hadamard", f"{label} run_subject_hadamard N_obs={len(x)} (train {res['n']}) M=2 f64 n_opt="
                f"{TRAIN_N_OPT} do_hmc do_loo on {res['hmc_samples'].device} (no device named): {wall:.3f} s; stages "
                f"(s): " + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items())
                + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            sampler = (f"NUTS, whiten=prior, {cfg.hmc_warmup} warmup + {cfg.n_hmc} draws (max_depth 8): "
                       + nuts_stats(torch, chain["res"], cfg.hmc_warmup, 8) if with_nuts else
                       f"{cfg.n_hmc} draws x {cfg.hmc_leapfrog} leapfrog steps at {cfg.hmc_step_size}")
            log("hadamard", f"{label} chain: {sampler}; {(cfg.n_hmc + cfg.hmc_warmup) / t_chain:.3f} draws/s, "
                f"{n_grads / t_chain:.3f} gradients/s ({n_grads} gradients in {t_chain:.3f} s); mean acceptance "
                f"{res['hmc_accept']:.6f}; loo " + ", ".join(f"{k} {v:.6g}" for k, v in loo.items())
                + "; " + ", ".join(f"{k} {res[k]:.6f}" for k in ("test_rmse", "test_lpd", "test_sample_rmse",
                                                                "test_sample_lpd")))
            nonzero = lambda c: {k: v for k, v in c.items() if v}
            log("hadamard", f"{label} launches by stage: " + "; ".join(
                f"{k} {nonzero(v)}" for k, v in stages.items()) + f"; the whole run {nonzero(run_launches)}")
            want = {"chain": expect(model, "gradient", n_grads), "loo": expect(model, "loo", min(s, cfg.loo_draws)),
                    "pred_grid": expect(model, "prediction", 1), "pred_test": expect(model, "prediction", 1),
                    "pred_test_sample": expect(model, "sample_draw", s)}
            for stage, w in want.items():
                if stages[stage] != w:
                    raise AssertionError(f"{label}: the {stage} stage launched {stages[stage]}, expected {w}")
            m_l = stages["map"]
            grads_map = m_l["gibbs_gram_backward"]
            if model != "lmc" and (grads_map < 1 or m_l["gibbs_gram"] != grads_map + 1):
                raise AssertionError(f"{label}: the MAP stage launched {m_l}: want K1's self form once per "
                                     f"gradient and once for the final value")
            if any(v for k, v in run_launches.items() if not k.startswith("gibbs_gram")) or (
                    model == "lmc" and any(run_launches.values())):
                raise AssertionError(f"{label}: a kernel off the Hadamard path launched: {run_launches}")
            samples = res["hmc_samples"]
            finite = [loo["elpd_loo"], loo["looic"], loo["elpd_waic"], res["test_rmse"], res["test_lpd"],
                      res["test_sample_rmse"], res["test_sample_lpd"]]
            if not (torch.isfinite(samples).all() and np.isfinite(finite).all()
                    and samples.device.type == torch.device(DEVICE).type):
                raise AssertionError(f"{label}: non-finite draws, LOO or scores, or draws off the card")
            if tuple(res["pred_grid"].percentiles.shape) != (cfg.n_grid, 3, 2):
                raise AssertionError(f"{label}: pred_grid has shape {tuple(res['pred_grid'].percentiles.shape)}")
            counts[label] = {name: {stage: v[name] for stage, v in stages.items()} for name in gk.launches()}
    finally:
        map_mod.fit_map, workflows._run_chain, evaluate.chain_conditional_loglik_hadamard = originals[:3]
        workflows._hadamard_predictors, nuts.nuts_sample = predictors, nuts_sample

    # (d) the card against the CPU at about 200 observations
    (xc, ic, yc), cvecs, (xc_tr, ic_tr, yc_tr), (xc_te, ic_te, _) = hadamard_subject(
        torch, np, seed + 71, HADAMARD_CHECK_TIMES)
    gen = torch.Generator().manual_seed(seed + 72)
    datas = {dev: as_hadamard_data(xc_tr, ic_tr, yc_tr, device=dev, dtype=f64) for dev in (DEVICE, "cpu")}
    for model in HADAMARD_MODELS:
        name = {"lmc": "lmc", "snmgp": "snmgp", "gnmgp": "svc"}[model]
        vg = {}
        for dev in (DEVICE, "cpu"):
            f = workflows._MODELS[model].make_objective_hadamard(datas[dev], 2)
            vg[dev] = map_mod.value_and_grad(f, cvecs[model].to(dev))
        rel_v, _ = held(np, [vg[DEVICE][0].item()], [vg["cpu"][0].item()], OBJECTIVE_RTOL)
        rel_g, frac_g = held(np, vg[DEVICE][1].cpu().numpy(), vg["cpu"][1].numpy(), OBJECTIVE_RTOL)
        cfg = workflows.PipelineConfig(model=model, n_opt=CHECK_N_OPT, test_size=HADAMARD_TEST_SIZE)
        out = {dev: workflows.run_subject_hadamard(xc, ic, yc, 2, cfg, device=dev, dtype=f64) for dev in (DEVICE, "cpu")}
        rel_m, frac_m = held(np, out[DEVICE]["map_vec"].cpu().numpy(), out["cpu"]["map_vec"].numpy(), OBJECTIVE_RTOL)
        worst = []
        for k in ("percentiles", "mean", "std"):
            worst.append(held(np, getattr(out[DEVICE]["pred_grid"], k).cpu().numpy(),
                              getattr(out["cpu"]["pred_grid"], k).numpy(), SERVED_RTOL))
        for k in ("test_rmse", "test_lpd"):
            worst.append(held(np, [out[DEVICE][k]], [out["cpu"][k]], OBJECTIVE_RTOL))
        vec = out["cpu"]["map_vec"]
        hist = vec + 0.01 * torch.randn(HADAMARD_CHECK_DRAWS, vec.shape[0], generator=gen, dtype=f64)
        noise = sample_noise(torch, "lmc" if model == "lmc" else "snmgp", gen, HADAMARD_CHECK_DRAWS, len(xc_te))
        if model == "gnmgp":  # the L-entry processes' normals are (S, T, G)
            noise = (noise[0], torch.randn(HADAMARD_CHECK_DRAWS, 3, len(xc_te), generator=gen, dtype=f64), noise[2])
        preds = {}
        for dev in (DEVICE, "cpu"):
            mean, std = getattr(pred_h, f"{name}_predict_test")(vec, datas[dev], xc_te, ic_te, 2, device=dev)
            draws = getattr(pred_h, f"{name}_predict_test_sample")(None, hist, datas[dev], xc_te, ic_te, 2,
                                                                  device=dev, noise=noise)
            cond = evaluate.chain_conditional_loglik_hadamard(model, hist, xc_tr, ic_tr, yc_tr, 2, device=dev)
            preds[dev] = [t.cpu().numpy() for t in (mean, std, draws)] + [cond]
        for got, want in zip(preds[DEVICE][:3], preds["cpu"][:3]):
            worst.append(held(np, got, want, SERVED_RTOL))
        rel_c, frac_c = held(np, preds[DEVICE][3], preds["cpu"][3], CHAIN_LOO_RTOL)
        rel_p = max(r for r, _ in worst)
        frac_p = max(fr for _, fr in worst)
        log("hadamard", f"{model} N_obs={len(xc)} (train {len(xc_tr)}) card vs CPU: objective value rel {rel_v:.3e}, "
            f"gradient max rel err {rel_g:.3e} (max err {frac_g:.3e} of its scale); run_subject_hadamard n_opt="
            f"{CHECK_N_OPT} map_vec max rel err {rel_m:.3e} (max err {frac_m:.3e} of its scale): ok at rtol "
            f"{OBJECTIVE_RTOL}; grid and test predictions, test scores and {HADAMARD_CHECK_DRAWS}-draw sample "
            f"predictions with the same noise max rel err {rel_p:.3e}, max err {frac_p:.3e} of their scale: ok at "
            f"rtol {SERVED_RTOL}; LOO conditionals max rel err {rel_c:.3e}: ok at rtol {CHAIN_LOO_RTOL}")
    log("summary", "Hadamard gradient evaluations/s at N_obs=" + str(len(x_tr)) + ": "
        + ", ".join(f"{k}: {v:.3f}" for k, v in rates.items()))
    return counts


def wall_ms(torch, fn, reps: int = 5) -> float:
    """Median host-clock ms of one call to ``fn`` ending in a synchronize,
    after one warm call: what a caller waits, launches included."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def event_ms(torch, fn, reps: int = 3) -> float:
    """Device ms of one call to ``fn``: CUDA events around ``reps`` calls
    behind a sleep kernel, for routes too slow on the host for ``time_ms``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gradient_rate(torch, value_and_grad, f, v) -> list:
    """Gradient evaluations per second of ``f`` at ``v``: RATE_BATCHES
    batches of RATE_EVALS, each ending in a synchronize."""
    per_s = []
    for _ in range(RATE_BATCHES):
        t0 = time.perf_counter()
        for _ in range(RATE_EVALS):
            value_and_grad(f, v)
        torch.cuda.synchronize()
        per_s.append(RATE_EVALS / (time.perf_counter() - t0))
    return per_s


def precision_objectives(torch, np, seed: int, n: int, hadamard_times: int, device):
    """Each model's objective for the precision phase on ``device``: the
    GNMGP (``training_subject``), LMC, SNMGP and hetero GNMGP subjects
    (``model_subject``) at N=n, and the Hadamard GNMGP objective on the
    training half of ``hadamard_subject`` at ``hadamard_times`` times.
    Returns {model: (objective, vec on device)}; the subjects are those of
    the objective, models and hadamard phases at N=TRAIN_N."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import as_hadamard_data
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    f64 = torch.float64
    as_t = lambda a: torch.as_tensor(a, dtype=f64, device=device)
    big = n == TRAIN_N
    x, y, gvec, _ = training_subject(torch, seed + (1 if big else 2), n)
    out = {"gnmgp": (workflows._MODELS["gnmgp"].make_objective(FullData(as_t(x), as_t(y))), gvec.to(device))}
    for i, model in enumerate(MODEL_FAMILIES):
        x, y, vec = model_subject(torch, model, seed + (20 if big else 40) + i, n)
        out[model] = (workflows._MODELS[model].make_objective(FullData(as_t(x), as_t(y))), vec.to(device))
    _, vecs, (x_tr, i_tr, y_tr), _ = hadamard_subject(torch, np, seed + (70 if big else 71), hadamard_times)
    data = as_hadamard_data(x_tr, i_tr, y_tr, device=device, dtype=f64)
    out["gnmgp_hadamard"] = (workflows._MODELS["gnmgp"].make_objective_hadamard(data, 2), vecs["gnmgp"].to(device))
    return out


def phase_precision(torch, np, gk, seed, hmc_res) -> dict:
    """The precision tier (``NMGP_PRECISION=mixed``, switched in this process
    through ``settings.mixed_solves``): (a) each model's objective at
    N=TRAIN_N under mixed against f64 in turns — launches per gradient,
    values, gradients, gradient evaluations per second, the refinement's
    sweeps — and the spacing of the refinement's exit check; (b) a profile
    of one mixed GNMGP gradient and K3's backward under the mixed cotangent
    against autograd of its plain version; (c) ``run_subject(do_hmc=True,
    do_loo=True)`` for GNMGP under mixed; (d) the card against the CPU at
    N=PRECISION_CHECK_N under mixed; (e) the CLI under
    ``NMGP_PRECISION=mixed`` in a subprocess; (f) the GNMGP gradient,
    ``predict_map`` and ``run_subject`` with ``NMGP_BLOCKED_CHOL`` on
    against the default routes; (g) the blocked and loop-free routes
    against cuSOLVER and cuBLAS.  Returns each kernel's launches under
    mixed."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import settings, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import blocked, chol, mixed
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp as pred

    f64 = torch.float64
    grad_kernels = {"gnmgp": dict.fromkeys(HMC_KERNELS, 1), "gnmgp_hadamard": HADAMARD_LAUNCHES["gnmgp"]["gradient"],
                    **{m: MODEL_LAUNCHES[m]["gradient"] for m in MODEL_FAMILIES}}
    launches: dict = {name: {} for name in TRAINING_KERNELS}

    def frac_err(got, want) -> float:
        return (got - want).abs().max().item() / want.abs().max().item()

    # (a) each objective under mixed against f64 at N=TRAIN_N
    objectives = precision_objectives(torch, np, seed, TRAIN_N, TRAIN_N, DEVICE)
    refine = mixed._refine
    sweeps: list = []

    def counted_refine(*args):
        # records each refinement's sweeps per batch member; the values are untouched
        z, s = refine(*args)
        sweeps.append(s.tolist())
        return z, s

    rates: dict = {}
    for model, (f, v) in objectives.items():
        sweeps.clear()
        res = {}
        for on in (False, True):
            settings.mixed_solves = on
            mixed._refine = counted_refine
            try:
                gk.reset_launches()
                res[on] = value_and_grad(f, v)
                torch.cuda.synchronize()
                counts = gk.launches()
            finally:
                mixed._refine = refine
            want = {k: grad_kernels[model].get(k, 0) for k in counts}
            if counts != want:
                raise AssertionError(f"{model}: one {'mixed' if on else 'f64'} gradient launched {counts}, "
                                     f"expected {want}")
            if not (torch.isfinite(res[on][0]) and torch.isfinite(res[on][1]).all()):
                raise AssertionError(f"{model}: non-finite objective or gradient")
        for name in TRAINING_KERNELS:
            launches[name][f"mixed gradient {model}"] = counts[name]
        if not sweeps:
            raise AssertionError(f"{model}: the mixed objective did not take the mixed route")
        rel_v, _ = held(np, [res[True][0].item()], [res[False][0].item()], MIXED_VALUE_RTOL)
        g_err = frac_err(res[True][1], res[False][1])
        if not g_err <= MIXED_GRAD_TOL:
            raise AssertionError(f"{model}: mixed gradient off by {g_err:.3e} of the f64 gradient's scale")
        per_s = {False: [], True: []}
        for on in (False, True, True, False):  # in turns
            settings.mixed_solves = on
            per_s[on] += gradient_rate(torch, value_and_grad, f, v)
        settings.mixed_solves = False
        rates[model] = {mode: statistics.median(per_s[on]) for mode, on in (("f64", False), ("mixed", True))}
        log("precision", f"{model} N={TRAIN_N} M=2 (P={v.shape[0]}): mixed vs f64 value {res[True][0].item():.12e} vs "
            f"{res[False][0].item():.12e} (rel {rel_v:.3e}), gradient off by {g_err:.3e} of its scale; "
            f"refinement sweeps {sweeps[0]}; gradient evaluations/s mixed {rates[model]['mixed']:.3f} "
            f"(min {min(per_s[True]):.3f}, max {max(per_s[True]):.3f}) vs f64 {rates[model]['f64']:.3f} "
            f"(min {min(per_s[False]):.3f}, max {max(per_s[False]):.3f}), ratio "
            f"{rates[model]['mixed'] / rates[model]['f64']:.3f}; one gradient launched {grad_kernels[model]}")

    # the spacing of the refinement's host exit check, in turns
    f, v = objectives["gnmgp"]
    settings.mixed_solves = True
    per_check = {k: [] for k in PRECISION_CHECK_EVERY}
    default_check = mixed.IR_CHECK_EVERY
    try:
        for k in PRECISION_CHECK_EVERY + PRECISION_CHECK_EVERY[::-1]:
            mixed.IR_CHECK_EVERY = k
            per_check[k] += gradient_rate(torch, value_and_grad, f, v)
    finally:
        mixed.IR_CHECK_EVERY = default_check
    check_rates = {k: statistics.median(r) for k, r in per_check.items()}
    log("precision", "gnmgp mixed gradient evaluations/s by the refinement's exit-check spacing (sweeps between "
        "host reads): " + ", ".join(f"{k}: {r:.3f} (min {min(per_check[k]):.3f}, max {max(per_check[k]):.3f})"
                                    for k, r in check_rates.items())
        + f"; fastest {max(check_rates, key=check_rates.get)}, the code's {default_check}")

    # (b) one mixed GNMGP gradient by device op, and K3's backward under the mixed cotangent
    wall, device_ms, kinds, top = device_profile(torch, lambda: value_and_grad(f, v))
    log("profile", f"one gnmgp gradient N={TRAIN_N} M=2 mixed: wall {wall:.3f} ms, device {device_ms:.3f} ms "
        f"(busy share {device_ms / wall:.3f}), {kinds} kernel kinds")
    for ms, count, key in top:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    p = gnmgp.unpack(v, TRAIN_N, 2)
    x, y, _, _ = training_subject(torch, seed + 1, TRAIN_N)
    xd, yd = (torch.as_tensor(a, dtype=f64, device=DEVICE) for a in (x, y))
    ell0, ls0 = torch.exp(p.tilde_l), gnmgp.chol_process(p.ul_vecs, TRAIN_N, 2)

    def mixed_grad(gram):
        ell, ls = ell0.clone().requires_grad_(True), ls0.clone().requires_grad_(True)
        cov = gram(xd, ell, ls.contiguous(), settings.jitter)
        cov = torch.diagonal_scatter(cov, torch.diagonal(cov) + torch.exp(p.tilde_sigma2_err))
        ld, q = mixed.mixed_logdet_quad(cov, yd.reshape(-1))
        return torch.autograd.grad(-0.5 * (ld + q), (ell, ls))

    err = check_grad(torch, "K3 backward under mixed", mixed_grad(gk.svc_gram_tiled),
                     mixed_grad(gk.svc_gram_tiled_plain), "float64")
    settings.mixed_solves = False
    log("precision", f"K3's backward under the mixed cotangent (ld̄·sym(G) − q̄·zzᵀ) vs autograd of its plain "
        f"version, N={TRAIN_N} M=2: max abs err {err:.3e}, ok within {GRAD_TOL['float64']} of the scale")

    # (c) run_subject(do_hmc=True, do_loo=True) for GNMGP under mixed
    cfg = workflows.PipelineConfig(n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True)
    n_grads = 1 + cfg.n_hmc * cfg.hmc_leapfrog
    stage: dict = {}
    run_chain = workflows._run_chain

    def counted_chain(*args, **kwargs):
        before = gk.launches()
        out = run_chain(*args, **kwargs)
        torch.cuda.synchronize()
        stage.update({k: v_ - before[k] for k, v_ in gk.launches().items()})
        return out

    settings.mixed_solves = True
    workflows._run_chain = counted_chain
    try:
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        res = workflows.run_subject(x, y, cfg, dataset="sim")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        run_launches = gk.launches()  # the main path ends here
    finally:
        workflows._run_chain = run_chain
        settings.mixed_solves = False
    want = {k: (n_grads if k in HMC_KERNELS else 0) for k in stage}
    if stage != want:
        raise AssertionError(f"the mixed chain launched {stage}, expected {want}")
    for name in TRAINING_KERNELS:
        launches[name]["mixed run_subject"] = run_launches[name]
        launches[name]["mixed chain"] = stage[name]
    loo = res["loo"]
    if not (torch.isfinite(res["hmc_samples"]).all() and np.isfinite(loo["elpd_loo"]) and np.isfinite(res["dic"])):
        raise AssertionError("the mixed run_subject gave non-finite draws, DIC or elpd_loo")
    map_f64, map_mixed = hmc_res["target_hist"][-1], res["target_hist"][-1]
    log("precision", f"run_subject gnmgp N={TRAIN_N} M=2 mixed n_opt={TRAIN_N_OPT} do_hmc=True do_loo=True: "
        f"{wall_s:.3f} s; stages (s): " + ", ".join(f"{k} {v_:.3f}" for k, v_ in res["timings"].items()))
    log("precision", f"mixed chain: {n_grads} gradients in {res['timings']['hmc']:.3f} s "
        f"({n_grads / res['timings']['hmc']:.3f} gradients/s), acceptance {res['hmc_accept']:.6f}, DIC "
        f"{res['dic']:.6e}, elpd_loo {loo['elpd_loo']:.6f} (p_loo {loo['p_loo']:.4f}, n_bad_k {loo['n_bad_k']}); "
        f"launches in the chain {stage}, in the run {run_launches}; final MAP objective mixed {map_mixed:.10e} "
        f"vs the hmc phase's f64 {map_f64:.10e} (rel {abs(map_mixed / map_f64 - 1):.3e})")

    # (d) the card against the CPU under mixed
    settings.mixed_solves = True
    try:
        checks = {dev: precision_objectives(torch, np, seed, PRECISION_CHECK_N, PRECISION_CHECK_TIMES, dev)
                  for dev in (DEVICE, "cpu")}
        for model, (f_card, v_card) in checks[DEVICE].items():
            f_cpu, v_cpu = checks["cpu"][model]
            sweeps.clear()
            mixed._refine = counted_refine
            try:
                val_c, g_c = value_and_grad(f_card, v_card)
            finally:
                mixed._refine = refine
            if not sweeps:
                raise AssertionError(f"{model} at N={PRECISION_CHECK_N}: the mixed route was not taken")
            val_h, g_h = value_and_grad(f_cpu, v_cpu)
            rel_v, _ = held(np, [val_c.item()], [val_h.item()], MIXED_VALUE_RTOL)
            g_err = frac_err(g_c.cpu(), g_h)
            if not g_err <= MIXED_GRAD_TOL:
                raise AssertionError(f"{model}: card gradient off by {g_err:.3e} of the CPU gradient's scale")
            log("precision", f"{model} N={PRECISION_CHECK_N} (P={v_cpu.shape[0]}) mixed, card vs CPU: value "
                f"{val_c.item():.12e} vs {val_h.item():.12e} (rel {rel_v:.3e}), gradient off by {g_err:.3e} of "
                f"its scale: ok at rtol {MIXED_VALUE_RTOL} and {MIXED_GRAD_TOL}")
    finally:
        settings.mixed_solves = False

    # (e) the CLI with NMGP_PRECISION=mixed in its environment
    cli_out = os.path.join(ROOT, "chiprun_out", "cli_mixed")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nonstationary_multivariate_gaussian_process_tpu_torch.examples.run_sim_pipeline",
         "--n", str(CHAIN_CHECK_N), "--n-opt", str(CHECK_N_OPT), "--n-hmc", str(CHAIN_CLI_HMC), "--out", cli_out],
        cwd=ROOT, env={**os.environ, "NMGP_PRECISION": "mixed"}, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"the mixed CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    summary = json.loads("\n".join(lines[next(i for i, s in enumerate(lines) if s.startswith("{")):]))
    if not all(np.isfinite(summary[k]) for k in ("deviance", "aic", "bic", "dic", "hmc_accept")):
        raise AssertionError(f"the mixed CLI's summary lacks finite scores: {summary}")
    for name in ("posterior.png", "target_trace.png", "manifest.json"):
        if not os.path.getsize(os.path.join(cli_out, name)) > 0:
            raise AssertionError(f"the mixed CLI did not write {name}")
    log("precision", f"CLI NMGP_PRECISION=mixed --n {CHAIN_CHECK_N} --n-opt {CHECK_N_OPT} --n-hmc {CHAIN_CLI_HMC} "
        f"in a subprocess: {time.perf_counter() - t0:.3f} s; summary {summary}")

    # (f) the GNMGP paths with NMGP_BLOCKED_CHOL on (MN = 2000 >= BLOCKED_MIN_N) against the default routes
    grid = np.linspace(float(x.min()), float(x.max()), cfg.n_grid)
    cfg_map = workflows.PipelineConfig(n_opt=TRAIN_N_OPT)
    routes = {}
    for on in (False, True):
        chol._BLOCKED_ENABLED = on
        try:
            val, grad = value_and_grad(f, v)
            per_s = gradient_rate(torch, value_and_grad, f, v)
            mean = pred.predict_map(v, FullData(xd, yd), grid).mean
            run = workflows.run_subject(x, y, cfg_map, dataset="sim")
            torch.cuda.synchronize()
        finally:
            chol._BLOCKED_ENABLED = False
        routes[on] = (val, grad, statistics.median(per_s), mean, run)
    (val0, grad0, rate0, mean0, run0), (val1, grad1, rate1, mean1, run1) = routes[False], routes[True]
    rel_v, _ = held(np, [val1.item()], [val0.item()], BLOCKED_RTOL)
    rel_g, frac_g = held(np, grad1.cpu().numpy(), grad0.cpu().numpy(), BLOCKED_RTOL)
    rel_p, frac_p = held(np, mean1.cpu().numpy(), mean0.cpu().numpy(), SERVED_RTOL)
    rel_m, frac_m = held(np, run1["map_vec"].cpu().numpy(), run0["map_vec"].cpu().numpy(), OBJECTIVE_RTOL)
    log("precision", f"NMGP_BLOCKED_CHOL=1 gnmgp N={TRAIN_N} M=2 f64 against the default routes: value rel "
        f"{rel_v:.3e}, gradient max err {frac_g:.3e} of its scale, {rate1:.3f} vs {rate0:.3f} gradient "
        f"evaluations/s; predict_map mean at {len(grid)} points max err {frac_p:.3e} of its scale; run_subject "
        f"n_opt={TRAIN_N_OPT} {sum(run1['timings'].values()):.3f} vs {sum(run0['timings'].values()):.3f} s, "
        f"map_vec max rel err {rel_m:.3e}: ok at rtol {BLOCKED_RTOL} ({SERVED_RTOL} with its floor for the "
        f"prediction, whose kriging is conditioned ~1e10; {OBJECTIVE_RTOL} for the MAP)")

    # (g) the blocked and loop-free routes against cuSOLVER and cuBLAS (f64)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 90)

    def spd(n):
        a = torch.randn(n, n, generator=gen, dtype=f64, device=DEVICE)
        return a @ a.T / n + 2.0 * torch.eye(n, dtype=f64, device=DEVICE)

    def row(label, n, pairs):
        cells = []
        for name, fn in pairs:
            cells.append(f"{name} {event_ms(torch, fn):.4f} ms device, {wall_ms(torch, fn):.4f} ms wall")
        log("precision", f"A/B {label} n={n}: " + "; ".join(cells))

    for n in BLOCKED_AB_N:
        a = spd(n)
        l = torch.linalg.cholesky(a)
        b_vec = torch.randn(n, generator=gen, dtype=f64, device=DEVICE)
        b_mat = torch.randn(n, n, generator=gen, dtype=f64, device=DEVICE)
        err = frac_err(blocked.blocked_cholesky(a), l)
        err = max(err, frac_err(blocked.blocked_trsm(l, b_mat), torch.linalg.solve_triangular(l, b_mat, upper=False)))
        if not err <= 1e-10:
            raise AssertionError(f"blocked routes at n={n} off by {err:.3e} of the scale")
        row("cholesky", n, (("blocked_cholesky", lambda: blocked.blocked_cholesky(a)),
                            ("cuSOLVER cholesky_ex", lambda: torch.linalg.cholesky_ex(a))))
        for label, b in (("(n,)", b_vec), ("(n, n)", b_mat)):
            row(f"triangular solve {label}", n, (
                ("blocked_trsm", lambda: blocked.blocked_trsm(l, b)),
                ("cuBLAS trsm", lambda: torch.linalg.solve_triangular(l, b if b.dim() == 2 else b[:, None],
                                                                      upper=False))))
    for n in UNROLLED_AB_N:
        a = spd(n)
        l = torch.linalg.cholesky(a)
        b = torch.randn(n, UNROLLED_AB_COLS, generator=gen, dtype=f64, device=DEVICE)
        err = max(frac_err(chol.safe_cholesky_unrolled(a), l),
                  frac_err(blocked.unrolled_tri_inv(l) @ b, torch.linalg.solve_triangular(l, b, upper=False)))
        if not err <= 1e-10:
            raise AssertionError(f"loop-free routes at n={n} off by {err:.3e} of the scale")
        row("small factor", n, (("safe_cholesky_unrolled", lambda: chol.safe_cholesky_unrolled(a)),
                                ("cuSOLVER safe_cholesky", lambda: chol.safe_cholesky(a, force_robust=True))))
        row(f"small solve (n, {UNROLLED_AB_COLS})", n, (
            ("unrolled_tri_inv @ b", lambda: blocked.unrolled_tri_inv(l) @ b),
            ("cuBLAS trsm", lambda: chol.tri_solve(l, b))))
    log("precision", "NMGP_UNROLLED_CHOL=auto on cuda: "
        + ("the loop-free kernels" if chol.use_unrolled(spd(32)) else "cuSOLVER and cuBLAS"))
    return launches


def drhmc_gradients(res, n_leapfrog: int, n_stages: int) -> int:
    """The gradients a DRHMC chain took: a draw that tried t stages (all of
    them when none accepted) ran 2**t − 1 trajectories of n_leapfrog + 1
    gradients."""
    tried = [s if s > 0 else n_stages for s in res.accept_stage.tolist()]
    return sum(2 ** t - 1 for t in tried) * (n_leapfrog + 1)


def drhmc_stats(torch, res, n_warmup: int, n_stages: int) -> str:
    """A DRHMC chain's accepting-stage histogram (warmup and kept draws),
    stage-1 acceptance after warmup and final step, as one log fragment."""
    stages = res.accept_stage.cpu()
    hist = lambda s: ", ".join(f"{k}: {int((s == k).sum())}" for k in range(n_stages + 1))
    kept = stages[n_warmup:]
    return (f"accepting stage (0 = none) in warmup {{{hist(stages[:n_warmup])}}}, after {{{hist(kept)}}}; "
            f"stage-1 accepted {(kept == 1).double().mean().item():.3f} of kept draws, mean stage-1 accept prob "
            f"{res.accept_prob1[n_warmup:].mean().item():.6f}; final step {res.step_size.item():.6e}")


def multichain_launches(k: int, n_descent: int, n_leapfrog_sum: int) -> tuple[int, int]:
    """The forward and backward launches of a model's Gram kernel in
    ``_run_chain_chees``: the K − 1 descents of ``n_descent`` gradients and a
    value each, the start sanitizer's K values and K gradients, then K
    gradients per leapfrog step."""
    bwd = (k - 1) * n_descent + k + k * n_leapfrog_sum
    return bwd + (k - 1) + k, bwd


def check_stage_launches(label, launched: dict, kernels, fwd: int, bwd: int) -> dict:
    """The stage launched the model's forward ``fwd`` and backward ``bwd``
    times and no other kernel; returns the launches."""
    want = {k: 0 for k in launched}
    want[kernels[0]], want[kernels[1]] = fwd, bwd
    if launched != want:
        raise AssertionError(f"{label}: the sampling stage launched {launched}, expected {want}")
    return launched


def phase_samplers(torch, np, gk, seed, hmc_res, subjects) -> dict:
    """DRHMC, ChEES and replica exchange: (a) ``run_subject(sampler="drhmc",
    do_loo=True)`` for GNMGP and LMC at N=TRAIN_N, (b) ``run_subject(
    sampler="chees", whiten=True, do_loo=True)`` for GNMGP and (c)
    ``run_subject_hadamard(sampler="chees")`` on the Hadamard phase's
    subject, each from a MAP at ``n_opt=TRAIN_N_OPT`` with SAMPLER_WARMUP +
    SAMPLER_DRAWS draws, with the sampling stage's launches checked exactly
    against its gradients; (d) ``tempered_hmc_sample`` on the whitened GNMGP
    potential; (e) each sampler on the card against the CPU at
    N=SAMPLER_CHECK_N with the same injected noise; (f) the CLI with
    ``--sampler chees``.  Returns each run's stage launches."""
    import inspect

    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import chees, drhmc, tempering, whiten
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import init as init_mod
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import as_hadamard_data, gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    f64 = torch.float64
    as_t = lambda a, dev=DEVICE: torch.as_tensor(a, dtype=f64, device=dev)
    n_descent = inspect.signature(init_mod.multichain_starts).parameters["descent_iters"].default
    default = workflows.PipelineConfig()
    fixed_grads = 1 + (default.n_hmc + default.hmc_warmup) * default.hmc_leapfrog
    fixed_rate = {"gnmgp": fixed_grads / hmc_res["timings"]["hmc"], "lmc": subjects["lmc"][4]}
    n_total = SAMPLER_WARMUP + SAMPLER_DRAWS
    counts: dict = {}
    kept: dict = {}
    originals = (workflows._run_chain, workflows._run_chain_chees, drhmc.drhmc_sample, chees.chees_sample,
                 init_mod.multichain_starts)

    def counted(fn):
        # the launches around the sampling stage (an outer call, which ends
        # last, covers the calls it makes)
        def wrapped(*args, **kwargs):
            before = gk.launches()
            out = fn(*args, **kwargs)
            kept["stage"] = {k: v - before[k] for k, v in gk.launches().items()}
            return out
        return wrapped

    def keep(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            kept[name] = fn(*args, **kwargs)
            torch.cuda.synchronize()
            kept[f"{name}_s"] = time.perf_counter() - t0
            return kept[name]
        return wrapped

    def run(label, fn):
        kept.clear()
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        whole = gk.launches()  # the main path ends here
        log("samplers", f"{label}: {wall:.3f} s; stages (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()) + f"; the whole run launched {whole}")
        samples = res["hmc_samples"]
        if samples.device.type != torch.device(DEVICE).type or not torch.isfinite(samples).all():
            raise AssertionError(f"{label}: hmc_samples on {samples.device} or non-finite")
        if not np.isfinite(res["loo"]["elpd_loo"]):
            raise AssertionError(f"{label}: non-finite elpd_loo")
        return res

    workflows._run_chain = counted(originals[0])
    workflows._run_chain_chees = counted(originals[1])
    drhmc.drhmc_sample = keep("drhmc", originals[2])
    chees.chees_sample = keep("chees", originals[3])
    init_mod.multichain_starts = keep("starts", originals[4])
    try:
        # (a) DRHMC through run_subject, GNMGP (the hmc phase's subject) and LMC (the models phase's)
        x, y, _, _ = training_subject(torch, seed + 1, TRAIN_N)
        for model, (mx, my) in (("gnmgp", (x, y)), ("lmc", subjects["lmc"][:2])):
            cfg = workflows.PipelineConfig(model=model, n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True, sampler="drhmc",
                                           n_hmc=SAMPLER_DRAWS, hmc_warmup=SAMPLER_WARMUP)
            res = run(f"{model} run_subject N={TRAIN_N} M=2 f64 n_opt={TRAIN_N_OPT} sampler=drhmc do_loo",
                      lambda: workflows.run_subject(mx, my, cfg))
            dres, t_chain = kept["drhmc"], res["timings"]["hmc"]
            n_grads = drhmc_gradients(dres, cfg.hmc_leapfrog, cfg.dr_stages)
            nlp = workflows._MODELS[model].make_objective(FullData(as_t(mx), as_t(my)))
            rate = statistics.median(gradient_rate(torch, value_and_grad, nlp, res["map_vec"]))
            counts[f"drhmc_{model}"] = check_stage_launches(f"{model} drhmc", kept["stage"], NUTS_KERNELS[model],
                                                            1 + n_grads, n_grads)
            log("samplers", f"{model} drhmc chain: {SAMPLER_WARMUP} warmup + {SAMPLER_DRAWS} draws, "
                f"{cfg.dr_stages} stages, reduction {cfg.dr_reduction}, {cfg.hmc_leapfrog} leapfrog steps from "
                f"{cfg.hmc_step_size}: {t_chain:.3f} s, {n_total / t_chain:.3f} draws/s, {n_grads / t_chain:.3f} "
                f"gradients/s ({n_grads} gradients) against the objective's {rate:.3f}/s here and fixed HMC's "
                f"{fixed_rate[model]:.3f}/s in its chain; " + drhmc_stats(torch, dres, SAMPLER_WARMUP, cfg.dr_stages)
                + f"; hmc_accept {res['hmc_accept']:.6f}; DIC {res['dic']:.6e}; elpd_loo "
                f"{res['loo']['elpd_loo']:.6g}; launches {counts[f'drhmc_{model}']} = 1 + gradients")
            if model == "gnmgp":
                gnmgp_map = res["map_vec"]

        # (b) ChEES through run_subject, GNMGP whitened
        cfg = workflows.PipelineConfig(n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True, sampler="chees", whiten=True,
                                       n_hmc=SAMPLER_DRAWS, hmc_warmup=SAMPLER_WARMUP)
        res = run(f"gnmgp run_subject N={TRAIN_N} M=2 f64 n_opt={TRAIN_N_OPT} sampler=chees whiten=True do_loo",
                  lambda: workflows.run_subject(x, y, cfg))
        cres, rec, t_chain = kept["chees"], res["sampling"], res["timings"]["hmc"]
        k, sum_n = cres.samples.shape[0], int(cres.n_leapfrog.sum())
        fwd, bwd = multichain_launches(k, n_descent, sum_n)
        counts["chees_gnmgp"] = check_stage_launches("gnmgp chees", kept["stage"], HMC_KERNELS, fwd, bwd)
        t_run = kept["chees_s"]
        step_ms = t_run / sum_n * 1e3
        log("samplers", f"gnmgp chees (whitened): starts (K − 1 = {k - 1} descents of {n_descent} gradients) "
            f"{kept['starts_s']:.3f} s; {k} chains x ({SAMPLER_WARMUP} warmup + {SAMPLER_DRAWS} draws) "
            f"{t_run:.3f} s, {k * sum_n / t_run:.3f} gradients/s ({k * sum_n + k} gradients); a leapfrog step of "
            f"the {k} chains {step_ms:.3f} ms against fixed HMC's {1e3 / fixed_rate['gnmgp']:.3f} ms (ratio "
            f"{step_ms * fixed_rate['gnmgp'] / 1e3:.3f}); mean leapfrog {rec['mean_leapfrog']:.3f}, T "
            f"{rec['trajectory_length']:.6e}, step {rec['step_size']:.6e}, leapfrog counts "
            f"{cres.n_leapfrog.tolist()}; accept {rec['accept']:.6f}, min-ESS {rec['min_ess']:.3f}, max R-hat "
            f"{rec['max_rhat']:.4g}; elpd_loo {res['loo']['elpd_loo']:.6g}; launches {counts['chees_gnmgp']}")
        if tuple(res["hmc_samples"].shape) != (k * SAMPLER_DRAWS, gnmgp.n_params(TRAIN_N, 2)):
            raise AssertionError(f"chees: hmc_samples shape {tuple(res['hmc_samples'].shape)}")

        # (c) ChEES through run_subject_hadamard, GNMGP on the hadamard phase's subject
        (hx, hi, hy), _, _, _ = hadamard_subject(torch, np, seed + 70, TRAIN_N)
        cfg = workflows.PipelineConfig(model="gnmgp", n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True, sampler="chees",
                                       n_hmc=SAMPLER_DRAWS, hmc_warmup=SAMPLER_WARMUP, test_size=HADAMARD_TEST_SIZE)
        workflows._run_chain_chees = originals[1]  # the stage is _run_chain, which calls it
        res = run(f"gnmgp run_subject_hadamard N_obs={hx.shape[0]} sampler=chees do_loo",
                  lambda: workflows.run_subject_hadamard(hx, hi, hy, 2, cfg))
        cres = kept["chees"]
        k, sum_n = cres.samples.shape[0], int(cres.n_leapfrog.sum())
        fwd, bwd = multichain_launches(k, n_descent, sum_n)
        counts["chees_hadamard"] = check_stage_launches("hadamard chees", kept["stage"], K1_KERNELS, fwd, bwd)
        log("samplers", f"hadamard gnmgp chees: {k} chains, {res['timings']['hmc']:.3f} s (starts "
            f"{kept['starts_s']:.3f} s), {k * sum_n / kept['chees_s']:.3f} gradients/s in the chains; mean "
            f"leapfrog {cres.n_leapfrog.double().mean().item():.3f}, T {cres.trajectory_length.item():.6e}, step "
            f"{cres.step_size.item():.6e}, accept {res['hmc_accept']:.6f}; test_sample_lpd "
            f"{res['test_sample_lpd']:.6g}; launches {counts['chees_hadamard']}")
    finally:
        (workflows._run_chain, workflows._run_chain_chees, drhmc.drhmc_sample, chees.chees_sample,
         init_mod.multichain_starts) = originals

    # (d) replica exchange on the whitened GNMGP potential from the drhmc run's MAP
    xd = as_t(x)
    nlp = gnmgp.make_objective(FullData(xd, as_t(y)))
    w = whiten.make_whitener("gnmgp", xd, TRAIN_N, 2)
    gen = torch.Generator(DEVICE).manual_seed(seed + 81)
    gk.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    tres = tempering.tempered_hmc_sample(w.wrap(nlp), w.to_white(gnmgp_map), SAMPLER_DRAWS, gen,
                                         n_replicas=SAMPLER_REPLICAS, n_leapfrog=SAMPLER_TEMPER_LEAPFROG,
                                         n_warmup=SAMPLER_WARMUP)
    torch.cuda.synchronize()
    t_temper = time.perf_counter() - t0
    n_grads = n_total * SAMPLER_REPLICAS * (SAMPLER_TEMPER_LEAPFROG + 1)
    counts["tempering"] = check_stage_launches("tempering", gk.launches(), HMC_KERNELS,
                                               n_grads + n_total * SAMPLER_REPLICAS, n_grads)  # the main path ends here
    if not torch.isfinite(tres.samples).all():
        raise AssertionError("tempering: non-finite draws")
    log("samplers", f"tempered_hmc_sample gnmgp N={TRAIN_N} whitened, {SAMPLER_REPLICAS} replicas (betas "
        f"{[round(b, 4) for b in tres.betas.tolist()]}), {SAMPLER_WARMUP} warmup + {SAMPLER_DRAWS} draws of "
        f"{SAMPLER_TEMPER_LEAPFROG} leapfrog steps: {t_temper:.3f} s, {n_grads / t_temper:.3f} gradients/s "
        f"({n_grads} gradients, {n_total * SAMPLER_REPLICAS} swap values); swap acceptance "
        f"{[round(a, 4) for a in tres.swap_accept.tolist()]}, replica acceptance "
        f"{[round(a, 4) for a in tres.accept_stat.tolist()]}, steps "
        f"{[f'{e:.3e}' for e in tres.step_sizes.tolist()]}; launches {counts['tempering']}")

    # (e) the card against the CPU at N=SAMPLER_CHECK_N with the same injected noise
    xc, yc, vec, _ = training_subject(torch, seed + 82, SAMPLER_CHECK_N)
    p = vec.shape[0]
    gen = torch.Generator().manual_seed(seed + 83)
    objectives = {dev: gnmgp.make_objective(FullData(as_t(xc, dev), as_t(yc, dev))) for dev in (DEVICE, "cpu")}
    whiteners = {dev: whiten.make_whitener("gnmgp", as_t(xc, dev), SAMPLER_CHECK_N, 2) for dev in (DEVICE, "cpu")}

    def both(label, fn):
        out = {}
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            out[dev] = fn(dev)
            log("samplers", f"N={SAMPLER_CHECK_N} {label} on {dev}: {time.perf_counter() - t0:.3f} s")
        return out[DEVICE], out["cpu"]

    def close(label, pairs, rtol=SAMPLER_CHECK_RTOL):
        errs = []
        for name, g, w_ in pairs:
            rel, frac = held(np, g, w_, rtol)
            errs.append(f"{name} max rel err {rel:.3e} ({frac:.3e} of the scale)")
        log("samplers", f"N={SAMPLER_CHECK_N} {label}, card vs CPU: " + "; ".join(errs) + f": ok at rtol {rtol}")

    dr_kw = dict(step_size=DRHMC_CHECK_STEP, n_leapfrog=5, n_stages=3, n_warmup=3)
    noise = (torch.randn(6, p, generator=gen, dtype=f64), torch.rand(6, 3, generator=gen, dtype=f64))
    card, cpu = both("drhmc", lambda dev: drhmc.drhmc_sample(objectives[dev], vec.to(dev), 3, noise=noise, **dr_kw))
    if not torch.equal(card.accept_stage.cpu(), cpu.accept_stage):
        raise AssertionError(f"drhmc: accepting stages differ, card {card.accept_stage.tolist()} vs CPU "
                             f"{cpu.accept_stage.tolist()}")
    close(f"drhmc (accepting stages {cpu.accept_stage.tolist()}, equal)",
          [("draws", card.samples.cpu().numpy(), cpu.samples.numpy()),
           ("stage-1 accept prob", card.accept_prob1.cpu().numpy(), cpu.accept_prob1.numpy()),
           ("step", [card.step_size.item()], [cpu.step_size.item()])])

    starts = vec[None] + 1e-3 * torch.randn(2, p, generator=gen, dtype=f64)
    ch_kw = dict(step_size=1e-4, trajectory_length=CHEES_CHECK_T * 1e-4, n_warmup=3, max_leapfrog=8)
    noise = (None, torch.randn(6, 2, p, generator=gen, dtype=f64), torch.rand(6, 2, generator=gen, dtype=f64))
    card, cpu = both("chees", lambda dev: chees.chees_sample(objectives[dev], starts.to(dev), 3, noise=noise, **ch_kw))
    same = (card.n_leapfrog.cpu() == cpu.n_leapfrog).tolist()
    upto = same.index(False) if False in same else len(same)
    kept_upto = max(0, upto - ch_kw["n_warmup"])
    if kept_upto == 0:
        raise AssertionError(f"chees: leapfrog counts differ from draw {upto} on, card {card.n_leapfrog.tolist()} "
                             f"vs CPU {cpu.n_leapfrog.tolist()}: nothing to compare")
    close(f"chees (leapfrog counts {cpu.n_leapfrog.tolist()}, equal through draw {upto - 1} of {len(same)}; "
          f"the {kept_upto} kept draws before any difference compared)",
          [("draws", card.samples[:, :kept_upto].cpu().numpy(), cpu.samples[:, :kept_upto].numpy()),
           ("accept prob", card.accept_prob[:upto].cpu().numpy(), cpu.accept_prob[:upto].numpy())])

    tp_kw = dict(n_replicas=3, beta_min=0.3, step_size=1e-3, n_leapfrog=3, n_warmup=2)
    noise = (torch.randn(4, 3, p, generator=gen, dtype=f64), torch.rand(4, 3, generator=gen, dtype=f64),
             torch.rand(4, 2, generator=gen, dtype=f64))
    card, cpu = both("tempering", lambda dev: tempering.tempered_hmc_sample(
        whiteners[dev].wrap(objectives[dev]), whiteners[dev].to_white(vec.to(dev)), 2, noise=noise, **tp_kw))
    # the whitening map's prior factor takes card and CPU ~1e-7 apart (the
    # nuts phase's whitened chains are held at OBJECTIVE_RTOL too)
    close("tempering (whitened)", [("draws", card.samples.cpu().numpy(), cpu.samples.numpy()),
                                   ("swap acceptance", card.swap_accept.cpu().numpy(), cpu.swap_accept.numpy()),
                                   ("steps", card.step_sizes.cpu().numpy(), cpu.step_sizes.numpy())], OBJECTIVE_RTOL)

    # (f) the CLI with --sampler chees
    cli_out = os.path.join(ROOT, "chiprun_out", "cli_chees")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nonstationary_multivariate_gaussian_process_tpu_torch.examples.run_sim_pipeline",
         "--sampler", "chees", "--n", str(SAMPLER_CLI_N), "--n-opt", str(CHECK_N_OPT), "--n-hmc",
         str(SAMPLER_CLI_HMC), "--out", cli_out],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"the chees CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    summary = json.loads("\n".join(lines[next(i for i, s in enumerate(lines) if s.startswith("{")):]))
    if not all(np.isfinite(summary[k]) for k in ("deviance", "dic", "hmc_accept")):
        raise AssertionError(f"the chees CLI's summary lacks finite scores: {summary}")
    with open(os.path.join(cli_out, "manifest.json")) as f:
        if not any(key.endswith("__sampling") for key in json.load(f)):
            raise AssertionError("the chees CLI wrote no sampling artifact")
    log("samplers", f"CLI --sampler chees --n {SAMPLER_CLI_N} --n-opt {CHECK_N_OPT} --n-hmc {SAMPLER_CLI_HMC} "
        f"(warmup max(100, n_hmc), 2 chains) on the card: {time.perf_counter() - t0:.3f} s; summary {summary}")
    return counts


def sparse_subject(torch, np, seed: int, n: int):
    """x, y (numpy) for the sparse tier: a ``sim_mnts`` draw (the GNMGP prior)
    and its truth subsampled to Z later, up to N = SPARSE_N; above it, where
    the prior's dense factor is the very cost this tier avoids, two smooth
    tasks with noise and no truth vector."""
    if n <= SPARSE_N:
        x, y, gvec, _ = training_subject(torch, seed, n)
        return x, y, gvec
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=n))
    y = np.stack([np.sin(8 * x), np.cos(5 * x) * (1 + x)], axis=1) + 0.1 * rng.normal(size=(n, 2))
    return x, y, None


def sparse_start(torch, gnmgp_sparse, gvec, n, z, x, m_z):
    """A sparse vector on the card: the dense truth subsampled to Z (as
    ``init_from_empirical`` subsamples the empirical init), or, with no
    truth, short smooth latents and noise variance e^-4."""
    if gvec is not None:
        return gnmgp_sparse.init_from_empirical(gvec.to(DEVICE), n, m_z, 2, x, z)
    return torch.cat([torch.full((m_z,), -2.5), torch.zeros(m_z * 3), torch.tensor([-4.0])]).to(
        device=DEVICE, dtype=torch.float64)


def phase_sparse(torch, np, gk, seed) -> dict:
    """The sparse GNMGP tier at N=SPARSE_N, m_z=SPARSE_M_Z, M=2, f64, no
    device named: (a) FITC and VFE gradient evaluations per second, launches
    per gradient and a profile of one gradient; (b) ``run_subject(
    model="gnmgp_sparse", do_hmc=True, do_loo=True)`` with the default chain
    into a store, with the launches of its chain, DIC and LOO stages counted
    exactly; (c) whitened NUTS from that MAP; (d) ``mode="map"`` and
    ``mode="sample"`` over HTTP from that store at 201 points; (e) one
    gradient under ``NMGP_PRECISION=mixed`` against float64; (f) the card
    against the CPU at N=SPARSE_CHECK_N; (g) the CLI with ``--model
    gnmgp_sparse``; (h) the gradient rate at N=SPARSE_BIG_N.  Returns each
    kernel's launches by stage."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, settings, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import nuts
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed
    from nonstationary_multivariate_gaussian_process_tpu_torch.predict import gnmgp_sparse as pred
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import serve
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    f64 = torch.float64
    as_t = lambda a, dev=DEVICE: torch.as_tensor(a, dtype=f64, device=dev)
    expect = lambda per, times: {k: per.get(k, 0) * times for k in gk.launches()}
    counts: dict = {}
    out_dir = os.path.join(ROOT, "chiprun_out")
    x, y, gvec = sparse_subject(torch, np, seed + 95, SPARSE_N)
    data = FullData(as_t(x), as_t(y))

    # (a) FITC and VFE: launches per gradient, gradient evaluations/s, a profile
    objectives = {}
    for approx in ("fitc", "vfe"):
        nlp, ops = gnmgp_sparse.make_objective(data, n_inducing=SPARSE_M_Z, approx=approx)
        v = sparse_start(torch, gnmgp_sparse, gvec, SPARSE_N, ops.z, data.x, SPARSE_M_Z)
        objectives[approx] = (nlp, ops, v)
        gk.reset_launches()
        val, grad = value_and_grad(nlp, v)
        torch.cuda.synchronize()
        counts[f"gradient_{approx}"] = gk.launches()
        if counts[f"gradient_{approx}"] != expect(SPARSE_GRADIENT, 1):
            raise AssertionError(f"sparse {approx}: one gradient launched {gk.launches()}, expected {SPARSE_GRADIENT}")
        if not (torch.isfinite(val) and torch.isfinite(grad).all()):
            raise AssertionError(f"sparse {approx}: non-finite objective or gradient")
        per_s = gradient_rate(torch, value_and_grad, nlp, v)
        wall, device_ms, kinds, top = device_profile(torch, lambda: value_and_grad(nlp, v))
        log("sparse", f"gnmgp_sparse {approx} N={SPARSE_N} m_z={SPARSE_M_Z} M=2 f64 (P={v.shape[0]}): objective "
            f"{val.item():.10e}; {statistics.median(per_s):.3f} gradient evaluations/s (median of {RATE_BATCHES} "
            f"batches of {RATE_EVALS}; min {min(per_s):.3f}, max {max(per_s):.3f}); one gradient launched "
            f"{SPARSE_GRADIENT}")
        log("profile", f"one gnmgp_sparse {approx} gradient N={SPARSE_N} m_z={SPARSE_M_Z}: wall {wall:.3f} ms, device "
            f"{device_ms:.3f} ms (busy share {device_ms / wall:.3f}), {kinds} kernel kinds")
        for ms, count, key in top:
            log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")

    # (b) run_subject(model="gnmgp_sparse", do_hmc=True, do_loo=True) with the default chain
    cfg = workflows.PipelineConfig(model="gnmgp_sparse", n_inducing=SPARSE_M_Z, n_opt=TRAIN_N_OPT, do_hmc=True,
                                   do_loo=True)
    n_grads = 1 + (cfg.n_hmc + cfg.hmc_warmup) * cfg.hmc_leapfrog
    stages: dict = {}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            before = gk.launches()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = ({k: v_ - before[k] for k, v_ in gk.launches().items()}, time.perf_counter() - t0)
            return res
        return wrapped

    originals = (workflows._run_chain, evaluate.get_dic, evaluate.chain_conditional_loglik_sparse)
    workflows._run_chain = counted("chain", originals[0])
    evaluate.get_dic = counted("dic", originals[1])
    evaluate.chain_conditional_loglik_sparse = counted("loo", originals[2])
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="smoke_sparse_") as root:
        try:
            torch.cuda.reset_peak_memory_stats()
            gk.reset_launches()  # the main path starts here
            t0 = time.perf_counter()
            res = workflows.run_subject(x, y, cfg, store=ArtifactStore(root), dataset="sim")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts["run_subject"] = gk.launches()  # the main path ends here
        finally:
            workflows._run_chain, evaluate.get_dic, evaluate.chain_conditional_loglik_sparse = originals
        samples, t_hmc = res["hmc_samples"], res["timings"]["hmc"]
        s = samples.shape[0]
        loo = {k: v_ for k, v_ in res["loo"].items() if k != "pointwise"}
        log("sparse", f"run_subject gnmgp_sparse N={SPARSE_N} m_z={res['n_inducing']} M=2 f64 n_opt={TRAIN_N_OPT} "
            f"do_hmc do_loo on {samples.device} (no device named): {wall:.3f} s; stages (s): "
            + ", ".join(f"{k} {v_:.3f}" for k, v_ in res["timings"].items())
            + f", DIC {stages['dic'][1]:.3f}, LOO {stages['loo'][1]:.3f}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        log("sparse", f"sparse chain: {cfg.n_hmc} draws x {cfg.hmc_leapfrog} leapfrog steps at {cfg.hmc_step_size}: "
            f"{cfg.n_hmc / t_hmc:.3f} draws/s, {n_grads / t_hmc:.3f} gradients/s ({n_grads} gradients); mean "
            f"acceptance {res['hmc_accept']:.6f}; DIC {res['dic']:.6e} (deviance at the MAP {res['deviance']:.6e}); "
            "loo " + ", ".join(f"{k} {v_:.6g}" for k, v_ in loo.items()))
        for stage, per, times in (("chain", SPARSE_GRADIENT, n_grads), ("dic", SPARSE_VALUE, s + 1),
                                  ("loo", SPARSE_VALUE, s)):
            counts[stage] = stages[stage][0]
            if counts[stage] != expect(per, times):
                raise AssertionError(f"sparse: the {stage} stage launched {counts[stage]}, expected "
                                     f"{expect(per, times)}")
        log("sparse", f"sparse launches: chain {counts['chain']} = {n_grads} gradients x {SPARSE_GRADIENT}; DIC "
            f"{counts['dic']}; LOO {counts['loo']}; the whole run {counts['run_subject']}")
        if (tuple(samples.shape) != (cfg.n_hmc, gnmgp_sparse.n_params(SPARSE_M_Z, 2))
                or samples.device.type != torch.device(DEVICE).type or not torch.isfinite(samples).all()):
            raise AssertionError(f"sparse: hmc_samples on {samples.device} with shape {tuple(samples.shape)}")
        if not (np.isfinite([res["dic"], loo["elpd_loo"], loo["looic"]]).all() and 0.0 < res["hmc_accept"] <= 1.0):
            raise AssertionError("sparse: non-finite DIC or LOO, or no draw accepted")
        map_vec = res["map_vec"]

        # (c) whitened NUTS from that MAP (the sparse layout's whitener is the dense one at Z)
        nlp, ops = gnmgp_sparse.make_objective(data, n_inducing=SPARSE_M_Z)
        ncfg = workflows.PipelineConfig(model="gnmgp_sparse", sampler="nuts", whiten="prior")
        w = workflows._make_sampling_whitener(nlp, map_vec, ncfg, ops.z, SPARSE_M_Z, 2)
        gen = torch.Generator(DEVICE).manual_seed(seed + 96)
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        nres = nuts.nuts_sample(w.wrap(nlp), w.to_white(map_vec), NUTS_DRAWS, gen, step_size=ncfg.hmc_step_size,
                                n_warmup=NUTS_WARMUP, max_depth=NUTS_MODEL_DEPTH)
        torch.cuda.synchronize()
        t_chain = time.perf_counter() - t0
        counts["nuts"] = gk.launches()  # the main path ends here
        nuts_grads = 1 + int(nres.n_leapfrog.sum())
        if counts["nuts"] != expect(SPARSE_GRADIENT, nuts_grads):
            raise AssertionError(f"sparse nuts: launched {counts['nuts']}, expected 1 + Σ n_leapfrog = {nuts_grads}")
        if not torch.isfinite(w.from_white_batch(nres.samples)).all():
            raise AssertionError("sparse nuts: non-finite draws")
        log("sparse", f"gnmgp_sparse prior-whitened NUTS ({len(w.blocks)} whitened blocks at Z) from the "
            f"n_opt={TRAIN_N_OPT} MAP, {NUTS_WARMUP} warmup + {NUTS_DRAWS} draws at step {ncfg.hmc_step_size}: "
            f"{t_chain:.3f} s, {(NUTS_WARMUP + NUTS_DRAWS) / t_chain:.3f} draws/s, {nuts_grads / t_chain:.3f} "
            f"gradients/s; " + nuts_stats(torch, nres, NUTS_WARMUP, NUTS_MODEL_DEPTH)
            + f"; launches {counts['nuts']} = 1 + Σ n_leapfrog")

        # (d) mode="map" and mode="sample" over HTTP from that store
        httpd = serve(root, port=0, model="gnmgp_sparse")  # warms mode="map" at the 64- and 256-point buckets
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        xs = np.linspace(float(x.min()), float(x.max()), 201)

        def post(mode):
            body = json.dumps({"subject": "0", "x": list(map(float, xs)), "mode": mode,
                               "n_sample": CHAIN_N_SAMPLE}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/predict", data=body, method="POST")
            return json.load(urllib.request.urlopen(req, timeout=300))

        answers = {}
        try:
            for mode, check, times in (("map", check_answer, 1), ("sample", check_sample_answer, s)):
                answers[mode] = check(np, post(mode), 201)  # first request at this bucket
                times_ms = []
                for _ in range(TIMED_REQUESTS):
                    gk.reset_launches()  # a request starts here
                    t0 = time.perf_counter()
                    check(np, post(mode), 201)
                    times_ms.append((time.perf_counter() - t0) * 1e3)
                    counts[f"{mode}_request"] = gk.launches()  # a request ends here
                    if counts[f"{mode}_request"] != expect(SPARSE_REQUEST, times):
                        raise AssertionError(f"sparse: a {mode} request launched {counts[f'{mode}_request']}, "
                                             f"expected {expect(SPARSE_REQUEST, times)}")
                log("sparse", f"gnmgp_sparse POST /predict mode={mode} 201 points: ok, warm latency median "
                    f"{statistics.median(times_ms):.3f} ms (min {min(times_ms):.3f}, max {max(times_ms):.3f}, "
                    f"{TIMED_REQUESTS} requests); launches per request {SPARSE_REQUEST} x {times}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("server thread did not stop")
        stored = ArtifactStore(root).load(ArtifactStore.key("gnmgp_sparse", "sim", 0, "map"))
        cpu_ops = gnmgp_sparse.make_ops(as_t(x, "cpu"), as_t(stored["z"], "cpu"))
        ref = pred.predict_map(map_vec.cpu(), FullData(x, y), cpu_ops, xs, device="cpu")
        for k, w_ in (("mean", ref.mean), ("std", ref.std), ("upper", ref.percentiles[:, 2])):
            rel, frac = held(np, answers["map"][k], w_.numpy(), SERVED_RTOL)
            log("sparse", f"served 201-point map {k} vs CPU predict_map: ok, max rel err {rel:.3e}, max err "
                f"{frac:.3e} of max |CPU|")

    # (e) one FITC gradient under NMGP_PRECISION=mixed against float64
    nlp, _, v = objectives["fitc"]
    calls = []
    real = mixed.mixed_logdet_quad
    mixed.mixed_logdet_quad = lambda *a: calls.append(1) or real(*a)
    settings.mixed_solves = True
    try:
        val_m, grad_m = value_and_grad(nlp, v)
    finally:
        settings.mixed_solves = False
        mixed.mixed_logdet_quad = real
    val_f, grad_f = value_and_grad(nlp, v)
    if not calls:
        raise AssertionError("sparse: the mixed objective did not take the mixed route")
    rel_v, _ = held(np, [val_m.item()], [val_f.item()], MIXED_VALUE_RTOL)
    g_err = (grad_m - grad_f).abs().max().item() / grad_f.abs().max().item()
    if not g_err <= MIXED_GRAD_TOL:
        raise AssertionError(f"sparse: the mixed gradient is off by {g_err:.3e} of the f64 gradient's scale")
    log("sparse", f"gnmgp_sparse fitc N={SPARSE_N} NMGP_PRECISION=mixed vs f64: value {val_m.item():.12e} vs "
        f"{val_f.item():.12e} (rel {rel_v:.3e}), gradient off by {g_err:.3e} of its scale: ok at "
        f"{MIXED_VALUE_RTOL} and {MIXED_GRAD_TOL}")

    # (f) the card against the CPU at N=SPARSE_CHECK_N, m_z=SPARSE_CHECK_M_Z
    xc, yc, gc = sparse_subject(torch, np, seed + 97, SPARSE_CHECK_N)
    for approx in ("fitc", "vfe"):
        vals = {}
        for dev in (DEVICE, "cpu"):
            nlp_c, ops_c = gnmgp_sparse.make_objective(FullData(as_t(xc, dev), as_t(yc, dev)),
                                                       n_inducing=SPARSE_CHECK_M_Z, approx=approx)
            v_c = gnmgp_sparse.init_from_empirical(gc.to(dev), SPARSE_CHECK_N, SPARSE_CHECK_M_Z, 2, xc, ops_c.z)
            vals[dev] = [t.cpu() for t in value_and_grad(nlp_c, v_c)]
        rel_v, _ = held(np, [vals[DEVICE][0].item()], [vals["cpu"][0].item()], OBJECTIVE_RTOL)
        rel_g, frac_g = held(np, vals[DEVICE][1].numpy(), vals["cpu"][1].numpy(), OBJECTIVE_RTOL)
        log("sparse", f"gnmgp_sparse {approx} N={SPARSE_CHECK_N} m_z={SPARSE_CHECK_M_Z} card vs CPU: value rel "
            f"{rel_v:.3e}, gradient max rel err {rel_g:.3e}, max err {frac_g:.3e} of its scale: ok at rtol "
            f"{OBJECTIVE_RTOL}")
    cfg_c = workflows.PipelineConfig(model="gnmgp_sparse", n_inducing=SPARSE_CHECK_M_Z, n_opt=CHECK_N_OPT)
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        runs[dev] = workflows.run_subject(xc, yc, cfg_c, device=dev, dtype=f64)
        log("sparse", f"run_subject gnmgp_sparse N={SPARSE_CHECK_N} m_z={SPARSE_CHECK_M_Z} n_opt={CHECK_N_OPT} on "
            f"{dev}: {time.perf_counter() - t0:.3f} s")
    nlp_c, _ = gnmgp_sparse.make_objective(FullData(as_t(xc, "cpu"), as_t(yc, "cpu")), n_inducing=SPARSE_CHECK_M_Z)
    with torch.no_grad():
        final = {dev: nlp_c(r["map_vec"].cpu()).item() for dev, r in runs.items()}
    rel_f, _ = held(np, [final[DEVICE]], [final["cpu"]], OBJECTIVE_RTOL)
    rel_m, frac_m = held(np, runs[DEVICE]["map_vec"].cpu().numpy(), runs["cpu"]["map_vec"].numpy(), OBJECTIVE_RTOL)
    rel_p, frac_p = held(np, runs[DEVICE]["pred_grid"].mean.cpu().numpy(), runs["cpu"]["pred_grid"].mean.numpy(),
                         SERVED_RTOL)
    log("sparse", f"run_subject N={SPARSE_CHECK_N} card vs CPU: final objective {final[DEVICE]:.10e} vs "
        f"{final['cpu']:.10e} (rel {rel_f:.3e}); map_vec max rel err {rel_m:.3e}, max err {frac_m:.3e} of its scale; "
        f"pred_grid mean max err {frac_p:.3e} of its scale: ok at rtol {OBJECTIVE_RTOL}")

    # (g) the CLI with --model gnmgp_sparse
    cli_out = os.path.join(out_dir, "cli_sparse")
    t0 = time.perf_counter()
    summary = run_sim_pipeline.main(["--model", "gnmgp_sparse", "--n", str(CHAIN_CHECK_N), "--n-opt", str(CHECK_N_OPT),
                                     "--n-hmc", str(CHAIN_CLI_HMC), "--out", cli_out])
    for name in ("posterior.png", "target_trace.png", "manifest.json"):
        if not os.path.getsize(os.path.join(cli_out, name)) > 0:
            raise AssertionError(f"the sparse CLI did not write {name}")
    if not all(np.isfinite(summary.get(k, np.nan)) for k in ("deviance", "aic", "bic", "dic", "hmc_accept")):
        raise AssertionError(f"the sparse CLI's summary lacks finite scores: {summary}")
    log("sparse", f"CLI --model gnmgp_sparse --n {CHAIN_CHECK_N} --n-opt {CHECK_N_OPT} --n-hmc {CHAIN_CLI_HMC} on the "
        f"card: {time.perf_counter() - t0:.3f} s; summary {summary}")

    # (h) the gradient rate at N=SPARSE_BIG_N, the objective alone
    xb, yb, _ = sparse_subject(torch, np, seed + 98, SPARSE_BIG_N)
    t0 = time.perf_counter()
    nlp_b, ops_b = gnmgp_sparse.make_objective(FullData(as_t(xb), as_t(yb)), n_inducing=SPARSE_M_Z)
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t0
    v_b = sparse_start(torch, gnmgp_sparse, None, SPARSE_BIG_N, ops_b.z, None, SPARSE_M_Z)
    gk.reset_launches()
    val_b, grad_b = value_and_grad(nlp_b, v_b)
    torch.cuda.synchronize()
    counts["gradient_big"] = gk.launches()
    if counts["gradient_big"] != expect(SPARSE_GRADIENT, 1) or not torch.isfinite(grad_b).all():
        raise AssertionError(f"sparse N={SPARSE_BIG_N}: one gradient launched {counts['gradient_big']} or is "
                             "not finite")
    per_s = gradient_rate(torch, value_and_grad, nlp_b, v_b)
    wall, device_ms, _, _ = device_profile(torch, lambda: value_and_grad(nlp_b, v_b))
    log("sparse", f"gnmgp_sparse fitc N={SPARSE_BIG_N} m_z={SPARSE_M_Z} M=2 f64: SparseOps {t_ops:.3f} s; "
        f"{statistics.median(per_s):.3f} gradient evaluations/s (min {min(per_s):.3f}, max {max(per_s):.3f}); one "
        f"gradient wall {wall:.3f} ms, device {device_ms:.3f} ms (busy share {device_ms / wall:.3f}); peak device "
        f"memory of the phase {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts



#: The other sparse tiers (``snmgp_sparse``, ``lmc_sparse``,
#: ``gnmgp_hetero_sparse``) at the sparse phase's N=SPARSE_N, m_z=SPARSE_M_Z,
#: M=2, f64.  The kernels each launches per gradient, per value (a DIC or LOO
#: draw) and per mode="map" request (and per draw of a mode="sample" one):
#: the separable tiers K1's self form for K_zz and its cross form for K_xz
#: (K_gz too in a request), with the self-form and cross-form backward
#: kernels (σ and ℓ on both sides); the hetero tier the sparse GNMGP's.  Every
#: other kernel must launch 0 times.  Each run_subject takes that many draws
#: of 20 leapfrog steps (the SNMGP's cut from the default 100 with the other
#: phases' chains, MODEL_CHAIN_DRAWS).
SPARSE_TIERS = ("snmgp_sparse", "lmc_sparse", "gnmgp_hetero_sparse")
_K1_SEPARABLE = {"gradient": {"gibbs_gram": 2, "gibbs_gram_backward": 1, "gibbs_gram_cross_backward": 1},
                 "value": {"gibbs_gram": 2}, "request": {"gibbs_gram": 3}}
SPARSE_TIER_LAUNCHES = {"snmgp_sparse": _K1_SEPARABLE, "lmc_sparse": _K1_SEPARABLE,
                        "gnmgp_hetero_sparse": {"gradient": SPARSE_GRADIENT, "value": SPARSE_VALUE,
                                                "request": SPARSE_REQUEST}}
SPARSE_TIER_DRAWS = {"snmgp_sparse": 25, "lmc_sparse": 25, "gnmgp_hetero_sparse": 25}
#: The dense model whose subject (and truth) each tier takes.
SPARSE_TIER_BASE = {"snmgp_sparse": "snmgp", "lmc_sparse": "lmc", "gnmgp_hetero_sparse": "gnmgp_hetero"}
SPARSE_TIER_CHECK_DRAWS = 4


def sparse_tier_start(torch, np, model: str, vec, n: int, x, z):
    """A tier's vector at Z from the dense truth ``vec`` (N layout): each
    inducing input takes the latents of its nearest data input, as
    ``init_from_empirical`` does; the LMC vector is N-free."""
    if model == "lmc_sparse":
        return vec
    nearest = torch.as_tensor(np.argmin(np.abs(np.asarray(x)[None, :] - z.cpu().numpy()[:, None]), axis=1))
    if model == "snmgp_sparse":
        return torch.cat([vec[:n][nearest], vec[n:2 * n][nearest], vec[2 * n:]])
    t = 3
    return torch.cat([vec[:n][nearest], vec[n:n + n * t].reshape(n, t)[nearest].reshape(-1),
                      vec[n + n * t:].reshape(2, n)[:, nearest].reshape(-1)])


def ops_to(ops, device):
    """A tier's ops (named tuples of tensors, nested for the hetero tier) on
    ``device``."""
    return type(ops)(*(o.to(device) if hasattr(o, "to") else ops_to(o, device) for o in ops))


def check_k1_sparse_path(torch, np, gk, settings, v, ops, data) -> None:
    """K1 at the separable path's own inputs (the kriged σ- and ℓ-processes at
    N=SPARSE_N and at Z): the self form and its backward kernel at m_z, the
    cross form and its backward kernel with σ̄ and ℓ̄ on both sides, each
    against its plain version, with their warm times."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import snmgp_sparse

    with torch.no_grad():
        p = snmgp_sparse.unpack(v, ops.z.shape[0], 2)
        tl_x, ts_x = snmgp_sparse.latents_at_data(p, ops)
        sx, lx, sz, lz = torch.exp(ts_x), torch.exp(tl_x), torch.exp(p.tilde_sigma_z), torch.exp(p.tilde_l_z)
    x, z = data.x, ops.z
    gen = torch.Generator().manual_seed(7)
    kbar_zz = torch.randn(z.shape[0], z.shape[0], generator=gen, dtype=torch.float64).to(DEVICE)
    kbar_xz = torch.randn(x.shape[0], z.shape[0], generator=gen, dtype=torch.float64).to(DEVICE)
    jit = settings.jitter
    n, m_z = x.shape[0], z.shape[0]
    checks = (
        ("K1 self form", m_z, lambda: gk.gibbs_gram(z, sz, lz, jitter=jit),
         lambda: gk.gibbs_gram_plain(z, sz, lz, z, sz, lz, jit), check_close),
        ("K1 cross form", n, lambda: gk.gibbs_gram(x, sx, lx, z, sz, lz),
         lambda: gk.gibbs_gram_plain(x, sx, lx, z, sz, lz), check_close),
        ("K1 self-form backward", m_z, lambda: gk.gibbs_gram_backward(z, sz, lz, kbar_zz, jit),
         lambda: gk.gibbs_gram_backward_plain(z, sz, lz, jit, kbar_zz), check_grad),
        ("K1 cross-form backward (σ̄, ℓ̄ both sides)", n,
         lambda: gk.gibbs_gram_cross_backward(x, sx, lx, z, sz, lz, kbar_xz),
         lambda: gk.gibbs_gram_cross_backward_plain(x, sx, lx, z, sz, lz, kbar_xz), check_grad),
    )
    for label, rows, kern, plain, check in checks:
        err = check(torch, label, kern(), plain(), "float64")
        log("sparse_models", f"{label} at the snmgp_sparse path's inputs ({rows} x {m_z}, f64): max abs err "
            f"{err:.3e} against its plain version; warm {time_ms(torch, kern):.5f} ms, plain "
            f"{time_ms(torch, plain):.5f} ms")


def phase_sparse_models(torch, np, gk, seed) -> dict:
    """The sparse SNMGP, LMC and hetero GNMGP tiers at N=SPARSE_N,
    m_z=SPARSE_M_Z, M=2, f64, no device named, each: (a) FITC and VFE
    gradients with their exact launches, gradient evaluations/s and a
    profile of one gradient (and, for the SNMGP, K1's self-form and
    cross-form kernels and backward kernels at its inputs against their
    plain versions); (b) ``run_subject(do_hmc=True, do_loo=True,
    n_opt=TRAIN_N_OPT)`` into a store, with the launches of its chain, DIC
    and LOO stages counted exactly; (c) warm ``POST /predict`` at 201 points,
    mode="map" for each and mode="sample" for the separable tiers, the hetero
    tier's sample request refused; (d) the card against the CPU at
    N=SPARSE_CHECK_N, m_z=SPARSE_CHECK_M_Z: values and gradients under both
    approximations, a short run_subject's MAP, the predictions and the LOO
    conditionals.  Then (e) one SNMGP gradient under NMGP_PRECISION=mixed
    against float64 and (f) the CLI with ``--model snmgp_sparse``.  Returns
    each kernel's launches by label."""
    import urllib.error

    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, settings, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.examples import run_sim_pipeline
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import serve
    from nonstationary_multivariate_gaussian_process_tpu_torch.utils.artifacts import ArtifactStore

    f64 = torch.float64
    as_t = lambda a, dev=DEVICE: torch.as_tensor(a, dtype=f64, device=dev)
    expect = lambda per, times: {k: per.get(k, 0) * times for k in gk.launches()}
    counts: dict = {}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    def objective(model, data, **kw):
        hetero = model == "gnmgp_hetero_sparse"
        return (gnmgp_sparse.make_objective_hetero if hetero else workflows._MODELS[model].make_objective)(data, **kw)

    def z_of(ops):
        return ops.base.z if hasattr(ops, "base") else ops.z

    for i, model in enumerate(SPARSE_TIERS):
        t_model = time.perf_counter()
        want = SPARSE_TIER_LAUNCHES[model]
        x, y, dense = model_subject(torch, SPARSE_TIER_BASE[model], seed + 100 + i, SPARSE_N)
        data = FullData(as_t(x), as_t(y))

        # (a) FITC and VFE: launches per gradient, gradient evaluations/s, a profile
        objectives = {}
        for approx in ("fitc", "vfe"):
            nlp, ops = objective(model, data, n_inducing=SPARSE_M_Z, approx=approx)
            v = sparse_tier_start(torch, np, model, dense, SPARSE_N, x, z_of(ops)).to(DEVICE)
            objectives[approx] = (nlp, ops, v)
            gk.reset_launches()
            val, grad = value_and_grad(nlp, v)
            torch.cuda.synchronize()
            counts[f"{model}_gradient_{approx}"] = gk.launches()
            if gk.launches() != expect(want["gradient"], 1):
                raise AssertionError(f"{model} {approx}: one gradient launched {gk.launches()}, expected "
                                     f"{want['gradient']}")
            if not (torch.isfinite(val) and torch.isfinite(grad).all()):
                raise AssertionError(f"{model} {approx}: non-finite objective or gradient")
            per_s = gradient_rate(torch, value_and_grad, nlp, v)
            wall, device_ms, kinds, top = device_profile(torch, lambda: value_and_grad(nlp, v))
            log("sparse_models", f"{model} {approx} N={SPARSE_N} m_z={SPARSE_M_Z} M=2 f64 (P={v.shape[0]}): "
                f"objective {val.item():.10e}; {statistics.median(per_s):.3f} gradient evaluations/s (median of "
                f"{RATE_BATCHES} batches of {RATE_EVALS}; min {min(per_s):.3f}, max {max(per_s):.3f}); one gradient "
                f"launched {want['gradient']}")
            log("profile", f"one {model} {approx} gradient N={SPARSE_N} m_z={SPARSE_M_Z}: wall {wall:.3f} ms, "
                f"device {device_ms:.3f} ms (busy share {device_ms / wall:.3f}), {kinds} kernel kinds")
            for ms, count, key in top:
                log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
        if model == "snmgp_sparse":
            _, ops, v = objectives["fitc"]
            check_k1_sparse_path(torch, np, gk, settings, v, ops, data)

        # (b) run_subject(do_hmc=True, do_loo=True) into a store, its stages' launches counted exactly
        draws = SPARSE_TIER_DRAWS[model]
        cfg = workflows.PipelineConfig(model=model, n_inducing=SPARSE_M_Z, n_opt=TRAIN_N_OPT, do_hmc=True,
                                       do_loo=True, **({} if draws is None else {"n_hmc": draws}))
        n_grads = 1 + (cfg.n_hmc + cfg.hmc_warmup) * cfg.hmc_leapfrog
        stages: dict = {}

        def counted(name, fn):
            def wrapped(*args, **kwargs):
                before = gk.launches()
                t0 = time.perf_counter()
                res = fn(*args, **kwargs)
                torch.cuda.synchronize()
                stages[name] = ({k: v_ - before[k] for k, v_ in gk.launches().items()}, time.perf_counter() - t0)
                return res
            return wrapped

        originals = (workflows._run_chain, evaluate.get_dic, evaluate.chain_conditional_loglik_sparse)
        workflows._run_chain = counted("chain", originals[0])
        evaluate.get_dic = counted("dic", originals[1])
        evaluate.chain_conditional_loglik_sparse = counted("loo", originals[2])
        with tempfile.TemporaryDirectory(dir=out_dir, prefix=f"smoke_{model}_") as root:
            try:
                torch.cuda.reset_peak_memory_stats()
                gk.reset_launches()  # the main path starts here
                t0 = time.perf_counter()
                res = workflows.run_subject(x, y, cfg, store=ArtifactStore(root), dataset="sim")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts[f"{model}_run_subject"] = gk.launches()  # the main path ends here
            finally:
                workflows._run_chain, evaluate.get_dic, evaluate.chain_conditional_loglik_sparse = originals
            samples, t_hmc = res["hmc_samples"], res["timings"]["hmc"]
            s = samples.shape[0]
            loo = {k: v_ for k, v_ in res["loo"].items() if k != "pointwise"}
            log("sparse_models", f"run_subject {model} N={SPARSE_N} m_z={res['n_inducing']} M=2 f64 "
                f"n_opt={TRAIN_N_OPT} do_hmc do_loo on {samples.device} (no device named): {wall:.3f} s; stages "
                "(s): " + ", ".join(f"{k} {v_:.3f}" for k, v_ in res["timings"].items())
                + f", DIC {stages['dic'][1]:.3f}, LOO {stages['loo'][1]:.3f}; peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            log("sparse_models", f"{model} chain: {cfg.n_hmc} draws x {cfg.hmc_leapfrog} leapfrog steps at "
                f"{cfg.hmc_step_size}: {cfg.n_hmc / t_hmc:.3f} draws/s, {n_grads / t_hmc:.3f} gradients/s "
                f"({n_grads} gradients); mean acceptance {res['hmc_accept']:.6f}; DIC {res['dic']:.6e} (deviance at "
                f"the MAP {res['deviance']:.6e}); loo " + ", ".join(f"{k} {v_:.6g}" for k, v_ in loo.items()))
            for stage, per, times in (("chain", "gradient", n_grads), ("dic", "value", s + 1), ("loo", "value", s)):
                counts[f"{model}_{stage}"] = stages[stage][0]
                if stages[stage][0] != expect(want[per], times):
                    raise AssertionError(f"{model}: the {stage} stage launched {stages[stage][0]}, expected "
                                         f"{expect(want[per], times)}")
            log("sparse_models", f"{model} launches: chain {stages['chain'][0]} = {n_grads} gradients x "
                f"{want['gradient']}; DIC {stages['dic'][0]}; LOO {stages['loo'][0]}; the whole run "
                f"{counts[f'{model}_run_subject']}")
            if (tuple(samples.shape) != (cfg.n_hmc, workflows.n_params(model, SPARSE_M_Z, 2))
                    or samples.device.type != torch.device(DEVICE).type or not torch.isfinite(samples).all()):
                raise AssertionError(f"{model}: hmc_samples on {samples.device} with shape {tuple(samples.shape)}")
            if not (np.isfinite([res["dic"], loo["elpd_loo"], loo["looic"]]).all() and 0.0 < res["hmc_accept"] <= 1.0):
                raise AssertionError(f"{model}: non-finite DIC or LOO, or no draw accepted")

            # (c) warm POST /predict at 201 points
            httpd = serve(root, port=0, model=model)  # warms mode="map" at the 64- and 256-point buckets
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            xs = np.linspace(float(x.min()), float(x.max()), 201)

            def post(mode):
                body = json.dumps({"subject": "0", "x": list(map(float, xs)), "mode": mode,
                                   "n_sample": CHAIN_N_SAMPLE}).encode()
                req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/predict", data=body,
                                             method="POST")
                return json.load(urllib.request.urlopen(req, timeout=300))

            answers = {}
            modes = (("map", check_answer, 1),)
            if model != "gnmgp_hetero_sparse":
                modes += (("sample", check_sample_answer, min(s, CHAIN_N_SAMPLE)),)
            try:
                for mode, check, times in modes:
                    answers[mode] = check(np, post(mode), 201)  # first request at this bucket
                    times_ms = []
                    for _ in range(TIMED_REQUESTS):
                        gk.reset_launches()  # a request starts here
                        t0 = time.perf_counter()
                        check(np, post(mode), 201)
                        times_ms.append((time.perf_counter() - t0) * 1e3)
                        counts[f"{model}_{mode}_request"] = gk.launches()  # a request ends here
                        if gk.launches() != expect(want["request"], times):
                            raise AssertionError(f"{model}: a {mode} request launched {gk.launches()}, expected "
                                                 f"{expect(want['request'], times)}")
                    log("sparse_models", f"{model} POST /predict mode={mode} 201 points: ok, warm latency median "
                        f"{statistics.median(times_ms):.3f} ms (min {min(times_ms):.3f}, max {max(times_ms):.3f}, "
                        f"{TIMED_REQUESTS} requests); launches per request {want['request']} x {times}")
                if model == "gnmgp_hetero_sparse":
                    try:
                        post("sample")
                    except urllib.error.HTTPError as exc:
                        refusal = (exc.code, json.load(exc)["error"])
                    else:
                        raise AssertionError(f"{model}: a mode=sample request was answered")
                    if refusal[0] != 400 or "serves mode='map' only" not in refusal[1]:
                        raise AssertionError(f"{model}: a mode=sample request got {refusal}")
                    log("sparse_models", f"{model} POST /predict mode=sample: refused as JAX's engine refuses it "
                        f"({refusal[0]}: {refusal[1]})")
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=30)
            if thread.is_alive():
                raise AssertionError("server thread did not stop")
            stored = ArtifactStore(root).load(ArtifactStore.key(model, "sim", 0, "map"))
        map_vec = res["map_vec"].cpu()
        pred = workflows._PREDICT[model]
        predict_map = pred.predict_map_hetero if model == "gnmgp_hetero_sparse" else pred.predict_map
        make_ops = (gnmgp_sparse.make_ops_hetero if model == "gnmgp_hetero_sparse"
                    else workflows._MODELS[model].make_ops)
        cpu_ops = make_ops(as_t(x, "cpu"), as_t(stored["z"], "cpu"))
        ref = predict_map(map_vec, FullData(x, y), cpu_ops, xs, device="cpu")
        for k, w_ in (("mean", ref.mean), ("std", ref.std), ("upper", ref.percentiles[:, 2])):
            rel, frac = held(np, answers["map"][k], w_.numpy(), SERVED_RTOL)
            log("sparse_models", f"{model} served 201-point map {k} vs CPU: ok, max rel err {rel:.3e}, max err "
                f"{frac:.3e} of max |CPU|")

        # (d) the card against the CPU at N=SPARSE_CHECK_N, m_z=SPARSE_CHECK_M_Z
        xc, yc, dc = model_subject(torch, SPARSE_TIER_BASE[model], seed + 110 + i, SPARSE_CHECK_N)
        for approx in ("fitc", "vfe"):
            vals = {}
            for dev in (DEVICE, "cpu"):
                nlp_c, ops_c = objective(model, FullData(as_t(xc, dev), as_t(yc, dev)), n_inducing=SPARSE_CHECK_M_Z,
                                         approx=approx)
                v_c = sparse_tier_start(torch, np, model, dc, SPARSE_CHECK_N, xc, z_of(ops_c)).to(dev)
                vals[dev] = [t_.cpu() for t_ in value_and_grad(nlp_c, v_c)]
            rel_v, _ = held(np, [vals[DEVICE][0].item()], [vals["cpu"][0].item()], OBJECTIVE_RTOL)
            rel_g, frac_g = held(np, vals[DEVICE][1].numpy(), vals["cpu"][1].numpy(), OBJECTIVE_RTOL)
            log("sparse_models", f"{model} {approx} N={SPARSE_CHECK_N} m_z={SPARSE_CHECK_M_Z} card vs CPU: value "
                f"rel {rel_v:.3e}, gradient max rel err {rel_g:.3e}, max err {frac_g:.3e} of its scale: ok at "
                f"rtol {OBJECTIVE_RTOL}")
        cfg_c = workflows.PipelineConfig(model=model, n_inducing=SPARSE_CHECK_M_Z, n_opt=CHECK_N_OPT,
                                         sparse_approx="vfe")
        runs = {dev: workflows.run_subject(xc, yc, cfg_c, device=dev, dtype=f64) for dev in (DEVICE, "cpu")}
        nlp_c, ops_c = objective(model, FullData(as_t(xc, "cpu"), as_t(yc, "cpu")), n_inducing=SPARSE_CHECK_M_Z,
                                 approx="vfe")
        with torch.no_grad():
            final = {dev: nlp_c(r["map_vec"].cpu()).item() for dev, r in runs.items()}
        rel_f, _ = held(np, [final[DEVICE]], [final["cpu"]], OBJECTIVE_RTOL)
        rel_m, frac_m = held(np, runs[DEVICE]["map_vec"].cpu().numpy(), runs["cpu"]["map_vec"].numpy(),
                             OBJECTIVE_RTOL)
        # the predictions and the LOO conditionals at one vector and one chain, the CPU's ops on both devices
        vec_c = runs["cpu"]["map_vec"]
        chain_c = vec_c + 0.01 * torch.randn(SPARSE_TIER_CHECK_DRAWS, vec_c.shape[0],
                                             generator=torch.Generator().manual_seed(seed + 120 + i), dtype=f64)
        xs_c = np.linspace(float(xc.min()), float(xc.max()), 201)
        preds, conds, samples_c = {}, {}, {}
        for dev in (DEVICE, "cpu"):
            ops_d = ops_to(ops_c, dev)
            data_d = FullData(as_t(xc, dev), as_t(yc, dev))
            preds[dev] = predict_map(vec_c, data_d, ops_d, xs_c, approx="vfe", device=dev, dtype=f64)
            conds[dev] = evaluate.chain_conditional_loglik_sparse(chain_c, data_d, ops_d, approx="vfe", model=model,
                                                                  device=dev, dtype=f64)
            if model != "gnmgp_hetero_sparse":
                noise = sample_noise(torch, SPARSE_TIER_BASE[model], torch.Generator().manual_seed(seed + 130 + i),
                                     SPARSE_TIER_CHECK_DRAWS, 201)
                samples_c[dev] = pred.predict_sample(None, chain_c, data_d, ops_d, xs_c, approx="vfe", device=dev,
                                                     dtype=f64, noise=noise).cpu().numpy()
        for k in ("mean", "std"):
            held(np, getattr(preds[DEVICE], k).cpu().numpy(), getattr(preds["cpu"], k).numpy(), SERVED_RTOL)
        rel_l, frac_l = held(np, conds[DEVICE], conds["cpu"], CHAIN_LOO_RTOL)
        if samples_c:
            held(np, samples_c[DEVICE], samples_c["cpu"], SERVED_RTOL)
        log("sparse_models", f"{model} vfe N={SPARSE_CHECK_N} m_z={SPARSE_CHECK_M_Z} run_subject card vs CPU: final "
            f"objective {final[DEVICE]:.10e} vs {final['cpu']:.10e} (rel {rel_f:.3e}); map_vec max rel err "
            f"{rel_m:.3e}, max err {frac_m:.3e} of its scale: ok at rtol {OBJECTIVE_RTOL}; predict_map"
            + (" and predict_sample (the same noise)" if samples_c else "")
            + f" at 201 points ok at rtol {SERVED_RTOL} (floor of the scale); LOO conditionals over "
            f"{SPARSE_TIER_CHECK_DRAWS} draws max rel err {rel_l:.3e}, max err {frac_l:.3e} of the scale: ok at "
            f"{CHAIN_LOO_RTOL}; the model's phase took {time.perf_counter() - t_model:.3f} s")

        # (e) one SNMGP FITC gradient under NMGP_PRECISION=mixed against float64
        if model == "snmgp_sparse":
            nlp, _, v = objectives["fitc"]
            calls = []
            real = mixed.mixed_logdet_quad
            mixed.mixed_logdet_quad = lambda *a: calls.append(1) or real(*a)
            settings.mixed_solves = True
            try:
                val_m, grad_m = value_and_grad(nlp, v)
            finally:
                settings.mixed_solves = False
                mixed.mixed_logdet_quad = real
            val_f, grad_f = value_and_grad(nlp, v)
            if not calls:
                raise AssertionError(f"{model}: the mixed objective did not take the mixed route")
            rel_v, _ = held(np, [val_m.item()], [val_f.item()], MIXED_VALUE_RTOL)
            g_err = (grad_m - grad_f).abs().max().item() / grad_f.abs().max().item()
            if not g_err <= MIXED_GRAD_TOL:
                raise AssertionError(f"{model}: the mixed gradient is off by {g_err:.3e} of the f64 gradient's scale")
            log("sparse_models", f"{model} fitc N={SPARSE_N} NMGP_PRECISION=mixed vs f64: value {val_m.item():.12e} "
                f"vs {val_f.item():.12e} (rel {rel_v:.3e}), gradient off by {g_err:.3e} of its scale: ok at "
                f"{MIXED_VALUE_RTOL} and {MIXED_GRAD_TOL}")

    # (f) the CLI with --model snmgp_sparse
    cli_out = os.path.join(out_dir, "cli_snmgp_sparse")
    t0 = time.perf_counter()
    summary = run_sim_pipeline.main(["--model", "snmgp_sparse", "--n", str(CHAIN_CHECK_N), "--n-opt", str(CHECK_N_OPT),
                                     "--n-hmc", str(CHAIN_CLI_HMC), "--out", cli_out])
    for name in ("posterior.png", "target_trace.png", "manifest.json"):
        if not os.path.getsize(os.path.join(cli_out, name)) > 0:
            raise AssertionError(f"the snmgp_sparse CLI did not write {name}")
    if not all(np.isfinite(summary.get(k, np.nan)) for k in ("deviance", "aic", "bic", "dic", "hmc_accept")):
        raise AssertionError(f"the snmgp_sparse CLI's summary lacks finite scores: {summary}")
    log("sparse_models", f"CLI --model snmgp_sparse --n {CHAIN_CHECK_N} --n-opt {CHECK_N_OPT} --n-hmc "
        f"{CHAIN_CLI_HMC} on the card: {time.perf_counter() - t0:.3f} s; summary {summary}")
    return counts


#: The sparse models in the Hadamard layout (``run_subject_hadamard`` with
#: a sparse model): the Hadamard phase's ``sim_mnts`` subject at N=SPARSE_N
#: times, M=2, each (time, channel) cell dropped with probability
#: HADAMARD_DROP (about 3,000 observations, HADAMARD_TEST_SIZE held out),
#: m_z=SPARSE_M_Z, f64.  Each tier launches per gradient, per value (a LOO
#: draw, the MAP's last value) and per prediction (a map call, each draw of
#: the chain-sample scoring) what its full layout does: the GNMGP tier K1's
#: cross form and K3, with their backward kernels; the separable tiers K1's
#: self and cross forms, with both backward kernels.  Every other kernel
#: must launch 0 times.  Each run takes the default chain (None) or that many
#: draws of 20 leapfrog steps.  The card against the CPU at
#: SPARSE_HADAMARD_CHECK_TIMES times (about 225 training observations) with
#: m_z=SPARSE_CHECK_M_Z and SPARSE_HADAMARD_CHECK_DRAWS draws.
SPARSE_HADAMARD_MODELS = ("gnmgp_sparse", "snmgp_sparse", "lmc_sparse")
SPARSE_HADAMARD_LAUNCHES = {"gnmgp_sparse": {"gradient": SPARSE_GRADIENT, "value": SPARSE_VALUE,
                                             "request": SPARSE_REQUEST},
                            "snmgp_sparse": _K1_SEPARABLE, "lmc_sparse": _K1_SEPARABLE}
SPARSE_HADAMARD_DRAWS = {"gnmgp_sparse": None, "snmgp_sparse": 25, "lmc_sparse": 25}
SPARSE_HADAMARD_CHECK_TIMES, SPARSE_HADAMARD_CHECK_DRAWS = 200, 4


def sparse_hadamard_start(torch, np, model: str, vecs: dict, x_tr, z):
    """A tier's vector at Z from ``hadamard_subject``'s truth (the training
    observations' layout, raw L-vectors): each inducing input takes the
    latents of the first training observation at its time; the LMC vector
    is N-free."""
    if model == "lmc_sparse":
        return vecs["lmc"]
    n = len(x_tr)
    idx = torch.as_tensor(np.searchsorted(x_tr, z.cpu().numpy()))  # x_tr is sorted and holds Z
    if model == "snmgp_sparse":
        v = vecs["snmgp"]
        return torch.cat([v[:n][idx], v[n:2 * n][idx], v[2 * n:]])
    v = vecs["gnmgp"]
    return torch.cat([v[:n][idx], v[n:4 * n].reshape(n, 3)[idx].reshape(-1), v[4 * n:]])


def sparse_hadamard_noise(torch, model: str, gen, s: int, g: int):
    """The normals of ``predict_test_hadamard_sample`` over ``s`` draws at
    ``g`` points: the GNMGP tier's grid sampler's (ℓ̃, the L-entries, y),
    the separable tiers' one y normal a point."""
    f64 = torch.float64
    if model == "gnmgp_sparse":
        return tuple(torch.randn(s, *shape, generator=gen, dtype=f64) for shape in ((g,), (3, g), (g, 2)))
    return torch.randn(s, g, generator=gen, dtype=f64)


def check_k1_sparse_hadamard(torch, np, gk, tiers: dict, x) -> None:
    """K1's cross form and its backward kernel at the path's own inputs (the
    training observations, tied times, against Z): the GNMGP tier's (σ = 1,
    the kriged ℓ) and the SNMGP tier's (the kriged σ and ℓ), each against its
    plain version, with their warm times.  These launches come before the
    path's counts are reset."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp_sparse, snmgp_sparse

    with torch.no_grad():
        _, ops, v = tiers["gnmgp_sparse"]
        p = gnmgp_sparse.unpack(v, ops.z.shape[0], 2)
        tl_x, _ = gnmgp_sparse.latents_at_data(p, ops, 2, gnmgp_sparse.HADAMARD_DEFAULT_HYPERS)
        ones_x, ones_z = torch.ones_like(x), torch.ones_like(ops.z)
        inputs = {"gnmgp_sparse": (ops.z, ones_x, torch.exp(tl_x), ones_z, torch.exp(p.tilde_l_z))}
        _, ops, v = tiers["snmgp_sparse"]
        p = snmgp_sparse.unpack(v, ops.z.shape[0], 2)
        tl_x, ts_x = snmgp_sparse.latents_at_data(p, ops)
        inputs["snmgp_sparse"] = (ops.z, torch.exp(ts_x), torch.exp(tl_x), torch.exp(p.tilde_sigma_z),
                                  torch.exp(p.tilde_l_z))
    gen = torch.Generator().manual_seed(9)
    ties = x.shape[0] - torch.unique(x).shape[0]
    for model, (z, sx, lx, sz, lz) in inputs.items():
        kbar = torch.randn(x.shape[0], z.shape[0], generator=gen, dtype=torch.float64).to(DEVICE)
        fwd = lambda: gk.gibbs_gram(x, sx, lx, z, sz, lz)
        plain = lambda: gk.gibbs_gram_plain(x, sx, lx, z, sz, lz)
        bwd = lambda: gk.gibbs_gram_cross_backward(x, sx, lx, z, sz, lz, kbar)
        k = fwd()
        if not torch.equal(k, plain()):
            raise AssertionError(f"K1 cross form at the {model} Hadamard path's inputs differs from its plain version "
                                 f"(max err {(k - plain()).abs().max().item():.3e})")
        got, want = bwd(), gk.gibbs_gram_cross_backward_plain(x, sx, lx, z, sz, lz, kbar)
        err = check_grad(torch, f"K1 cross-form backward, {model} Hadamard", got, want, "float64")
        rel = max((torch.where(w_ != 0, (g_ - w_).abs() / w_.abs(), 0.0)).max().item() for g_, w_ in zip(got, want))
        log("sparse_hadamard", f"K1 cross form at the {model} path's inputs ({x.shape[0]} x {z.shape[0]}, {ties} "
            f"tied times, f64): equal to its plain version, warm {time_ms(torch, fwd):.5f} ms (plain "
            f"{time_ms(torch, plain):.5f} ms); its backward kernel (σ̄, ℓ̄ both sides) max abs err {err:.3e} "
            f"(elementwise max rel err {rel:.3e}) against autograd of the plain version, warm "
            f"{time_ms(torch, bwd):.5f} ms")


def phase_sparse_hadamard(torch, np, gk, seed) -> dict:
    """The sparse models in the Hadamard layout at SPARSE_N times (about
    2,250 training observations), m_z=SPARSE_M_Z, M=2, f64, no device named:
    (a) FITC and VFE gradients of each tier's Hadamard objective with their
    exact launches, gradient evaluations/s and a profile of one gradient;
    (b) K1's cross form and its backward kernel at the path's tied inputs
    against their plain versions; (c) ``run_subject_hadamard(do_hmc=True,
    do_loo=True, n_opt=TRAIN_N_OPT)`` for each tier, each stage's launches
    counted exactly; (d) one GNMGP FITC gradient under NMGP_PRECISION=mixed
    against float64; (e) the card against the CPU at
    SPARSE_HADAMARD_CHECK_TIMES times: values and gradients under both
    approximations, run_subject_hadamard's MAP, grid prediction and scores,
    the test predictions, the LOO conditionals and the chain-sample draws
    given the same noise.  Returns each kernel's launches by label."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import evaluate, settings, workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import map as map_mod
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import as_hadamard_data
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import mixed

    f64 = torch.float64
    value_and_grad = map_mod.value_and_grad
    (x, indx, y), vecs, (x_tr, i_tr, y_tr), (x_te, i_te, _) = hadamard_subject(torch, np, seed + 150, SPARSE_N)
    log("sparse_hadamard", f"sim_mnts N={SPARSE_N} M=2, each cell dropped with probability {HADAMARD_DROP}: "
        f"{len(x)} observations at {len(np.unique(x))} times; {len(x_tr)} train ({len(x_tr) - len(np.unique(x_tr))} "
        f"tied), {len(x_te)} test")
    data = as_hadamard_data(x_tr, i_tr, y_tr, device=DEVICE, dtype=f64)
    expect = lambda model, per, times: {k: SPARSE_HADAMARD_LAUNCHES[model][per].get(k, 0) * times
                                        for k in gk.launches()}
    counts: dict = {}
    rates: dict = {}
    tiers: dict = {}

    # (a) FITC and VFE: launches per gradient, gradient evaluations/s, a profile
    for model in SPARSE_HADAMARD_MODELS:
        for approx in ("fitc", "vfe"):
            nlp, ops = workflows._MODELS[model].make_objective_hadamard(data, 2, n_inducing=SPARSE_M_Z, approx=approx)
            v = sparse_hadamard_start(torch, np, model, vecs, x_tr, ops.z).to(DEVICE)
            if approx == "fitc":
                tiers[model] = (nlp, ops, v)
            gk.reset_launches()
            val, grad = value_and_grad(nlp, v)
            torch.cuda.synchronize()
            counts[f"{model}_gradient_{approx}"] = gk.launches()
            if gk.launches() != expect(model, "gradient", 1):
                raise AssertionError(f"{model} {approx} Hadamard: one gradient launched {gk.launches()}, expected "
                                     f"{expect(model, 'gradient', 1)}")
            if not (torch.isfinite(val) and torch.isfinite(grad).all()):
                raise AssertionError(f"{model} {approx} Hadamard: non-finite objective or gradient")
            per_s = gradient_rate(torch, value_and_grad, nlp, v)
            rates[f"{model} {approx}"] = statistics.median(per_s)
            wall, device_ms, kinds, top = device_profile(torch, lambda: value_and_grad(nlp, v))
            log("sparse_hadamard", f"{model} {approx} Hadamard N_obs={len(x_tr)} m_z={ops.z.shape[0]} M=2 f64 "
                f"(P={v.shape[0]}): objective {val.item():.10e}; {rates[f'{model} {approx}']:.3f} gradient "
                f"evaluations/s (median of {RATE_BATCHES} batches of {RATE_EVALS}; min {min(per_s):.3f}, max "
                f"{max(per_s):.3f}); one gradient launched {SPARSE_HADAMARD_LAUNCHES[model]['gradient']}")
            log("profile", f"one {model} {approx} Hadamard gradient N_obs={len(x_tr)}: wall {wall:.3f} ms, device "
                f"{device_ms:.3f} ms (busy share {device_ms / wall:.3f}), {kinds} kernel kinds")
            for ms, count, key in top:
                log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")

    # (b) K1's cross form and its backward kernel at the path's tied inputs
    check_k1_sparse_hadamard(torch, np, gk, tiers, data.x)

    # (c) run_subject_hadamard, no device named, each stage's launches counted exactly
    stages: dict = {}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            before = gk.launches()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[name] = ({k: v_ - before[k] for k, v_ in gk.launches().items()}, time.perf_counter() - t0)
            return res
        return wrapped

    predictors = workflows._hadamard_predictors
    originals = (map_mod.fit_map, workflows._run_chain, evaluate.chain_conditional_loglik_sparse_hadamard)
    map_mod.fit_map = counted("map", originals[0])
    workflows._run_chain = counted("chain", originals[1])
    evaluate.chain_conditional_loglik_sparse_hadamard = counted("loo", originals[2])
    workflows._hadamard_predictors = lambda *a: [counted(k, p) for k, p in zip(
        ("pred_grid", "pred_test", "pred_test_sample"), predictors(*a))]
    try:
        for model in SPARSE_HADAMARD_MODELS:
            draws = SPARSE_HADAMARD_DRAWS[model]
            cfg = workflows.PipelineConfig(model=model, n_inducing=SPARSE_M_Z, n_opt=TRAIN_N_OPT, do_hmc=True,
                                           do_loo=True, test_size=HADAMARD_TEST_SIZE,
                                           **({} if draws is None else {"n_hmc": draws}))
            stages.clear()
            torch.cuda.reset_peak_memory_stats()
            gk.reset_launches()  # the main path starts here
            t0 = time.perf_counter()
            res = workflows.run_subject_hadamard(x, indx, y, 2, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = gk.launches()  # the main path ends here
            samples = res["hmc_samples"]
            s = samples.shape[0]
            n_grads = 1 + (cfg.n_hmc + cfg.hmc_warmup) * cfg.hmc_leapfrog
            grads_map = stages["map"][0]["gibbs_gram_cross_backward"]
            want = {"map": {k: a + b for (k, a), b in zip(expect(model, "gradient", grads_map).items(),
                                                          expect(model, "value", 1).values())},
                    "chain": expect(model, "gradient", n_grads), "loo": expect(model, "value", min(s, cfg.loo_draws)),
                    "pred_grid": expect(model, "request", 1), "pred_test": expect(model, "request", 1),
                    "pred_test_sample": expect(model, "request", s)}
            for stage, w in want.items():
                counts[f"{model}_{stage}"] = stages[stage][0]
                if stages[stage][0] != w:
                    raise AssertionError(f"{model} Hadamard: the {stage} stage launched {stages[stage][0]}, "
                                         f"expected {w}")
            counts[f"{model}_run_subject"] = run_launches
            summed = {k: sum(stages[st][0][k] for st in want) for k in run_launches}
            if run_launches != summed or grads_map < 1:
                raise AssertionError(f"{model} Hadamard: the run launched {run_launches}, its stages {summed}")
            loo = res["loo"]
            scores = [res[k] for k in ("test_rmse", "test_lpd", "test_sample_rmse", "test_sample_lpd")]
            m_z = tiers[model][1].z.shape[0]  # the same training half and n_inducing
            if (tuple(samples.shape) != (cfg.n_hmc, workflows.n_params(model, m_z, 2))
                    or samples.device.type != torch.device(DEVICE).type or not torch.isfinite(samples).all()
                    or not np.isfinite(scores + [loo["elpd_loo"], loo["looic"]]).all()
                    or not 0.0 < res["hmc_accept"] <= 1.0
                    or tuple(res["pred_grid"].percentiles.shape) != (cfg.n_grid, 3, 2)):
                raise AssertionError(f"{model} Hadamard: draws {tuple(samples.shape)} on {samples.device}, or "
                                     "non-finite LOO or scores, or no draw accepted")
            t_chain = res["timings"]["hmc"]
            log("sparse_hadamard", f"run_subject_hadamard {model} N_obs={len(x)} (train {res['n']}) m_z={m_z} "
                f"M=2 f64 n_opt={TRAIN_N_OPT} do_hmc do_loo on {samples.device} (no device named): {wall:.3f} s; "
                "stages (s): " + ", ".join(f"{k} {v_:.3f}" for k, v_ in res["timings"].items())
                + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            log("sparse_hadamard", f"{model} chain: {cfg.n_hmc} draws x {cfg.hmc_leapfrog} leapfrog steps at "
                f"{cfg.hmc_step_size}: {cfg.n_hmc / t_chain:.3f} draws/s, {n_grads / t_chain:.3f} gradients/s "
                f"({n_grads} gradients); mean acceptance {res['hmc_accept']:.6f}; loo "
                + ", ".join(f"{k} {v_:.6g}" for k, v_ in loo.items() if k != "pointwise")
                + "; " + ", ".join(f"{k} {res[k]:.6f}" for k in ("test_rmse", "test_lpd", "test_sample_rmse",
                                                                "test_sample_lpd")))
            nonzero = lambda c: {k: v_ for k, v_ in c.items() if v_}
            log("sparse_hadamard", f"{model} launches by stage: " + "; ".join(
                f"{k} {nonzero(v_[0])}" for k, v_ in stages.items()) + f" (MAP: {grads_map} gradients and one value); "
                f"the whole run {nonzero(run_launches)}")
    finally:
        map_mod.fit_map, workflows._run_chain, evaluate.chain_conditional_loglik_sparse_hadamard = originals
        workflows._hadamard_predictors = predictors

    # (d) one GNMGP FITC gradient under NMGP_PRECISION=mixed against float64
    nlp, _, v = tiers["gnmgp_sparse"]
    calls = []
    real = mixed.mixed_logdet_quad
    mixed.mixed_logdet_quad = lambda *a: calls.append(1) or real(*a)
    settings.mixed_solves = True
    try:
        val_m, grad_m = value_and_grad(nlp, v)
    finally:
        settings.mixed_solves = False
        mixed.mixed_logdet_quad = real
    val_f, grad_f = value_and_grad(nlp, v)
    if not calls:
        raise AssertionError("gnmgp_sparse Hadamard: the mixed objective did not take the mixed route")
    rel_v, _ = held(np, [val_m.item()], [val_f.item()], MIXED_VALUE_RTOL)
    g_err = (grad_m - grad_f).abs().max().item() / grad_f.abs().max().item()
    if not g_err <= MIXED_GRAD_TOL:
        raise AssertionError(f"gnmgp_sparse Hadamard: the mixed gradient is off by {g_err:.3e} of its scale")
    log("sparse_hadamard", f"gnmgp_sparse fitc Hadamard N_obs={len(x_tr)} NMGP_PRECISION=mixed vs f64: value "
        f"{val_m.item():.12e} vs {val_f.item():.12e} (rel {rel_v:.3e}), gradient off by {g_err:.3e} of its scale: ok "
        f"at {MIXED_VALUE_RTOL} and {MIXED_GRAD_TOL}")

    # (e) the card against the CPU at SPARSE_HADAMARD_CHECK_TIMES times
    (xc, ic, yc), cvecs, (xc_tr, ic_tr, yc_tr), (xc_te, ic_te, _) = hadamard_subject(
        torch, np, seed + 151, SPARSE_HADAMARD_CHECK_TIMES)
    datas = {dev: as_hadamard_data(xc_tr, ic_tr, yc_tr, device=dev, dtype=f64) for dev in (DEVICE, "cpu")}
    gen = torch.Generator().manual_seed(seed + 152)
    for model in SPARSE_HADAMARD_MODELS:
        mod = workflows._MODELS[model]
        worst = []
        for approx in ("fitc", "vfe"):
            vg = {}
            for dev in (DEVICE, "cpu"):
                nlp_c, ops_c = mod.make_objective_hadamard(datas[dev], 2, n_inducing=SPARSE_CHECK_M_Z, approx=approx)
                vg[dev] = [t_.cpu() for t_ in value_and_grad(
                    nlp_c, sparse_hadamard_start(torch, np, model, cvecs, xc_tr, ops_c.z).to(dev))]
            worst.append(held(np, [vg[DEVICE][0].item()], [vg["cpu"][0].item()], OBJECTIVE_RTOL))
            worst.append(held(np, vg[DEVICE][1].numpy(), vg["cpu"][1].numpy(), OBJECTIVE_RTOL))
        rel_o = max(r for r, _ in worst)
        cfg = workflows.PipelineConfig(model=model, n_inducing=SPARSE_CHECK_M_Z, n_opt=CHECK_N_OPT,
                                       test_size=HADAMARD_TEST_SIZE, sparse_approx="vfe")
        out = {dev: workflows.run_subject_hadamard(xc, ic, yc, 2, cfg, device=dev, dtype=f64)
               for dev in (DEVICE, "cpu")}
        rel_m, frac_m = held(np, out[DEVICE]["map_vec"].cpu().numpy(), out["cpu"]["map_vec"].numpy(), OBJECTIVE_RTOL)
        grids = {dev: out[dev]["pred_grid"] for dev in (DEVICE, "cpu")}
        worst = [held(np, getattr(grids[DEVICE], k).cpu().numpy(), getattr(grids["cpu"], k).numpy(), SERVED_RTOL)
                 for k in ("percentiles", "mean", "std")]
        worst += [held(np, [out[DEVICE][k]], [out["cpu"][k]], OBJECTIVE_RTOL) for k in ("test_rmse", "test_lpd")]
        # the test predictions, the LOO conditionals and the chain-sample draws at one vector and one chain, the
        # CPU's ops on both devices
        _, ops_c = mod.make_objective_hadamard(datas["cpu"], 2, n_inducing=SPARSE_CHECK_M_Z, approx="vfe")
        vec = out["cpu"]["map_vec"]
        chain = vec + 0.01 * torch.randn(SPARSE_HADAMARD_CHECK_DRAWS, vec.shape[0], generator=gen, dtype=f64)
        noise = sparse_hadamard_noise(torch, model, gen, SPARSE_HADAMARD_CHECK_DRAWS, len(xc_te))
        pred = workflows._PREDICT[model]
        got = {}
        for dev in (DEVICE, "cpu"):
            ops_d = ops_to(ops_c, dev)
            mean, var = pred.predict_test_hadamard(vec, datas[dev], ops_d, 2, xc_te, ic_te, approx="vfe", device=dev,
                                                   dtype=f64)
            draws = pred.predict_test_hadamard_sample(None, chain, datas[dev], ops_d, 2, xc_te, ic_te, approx="vfe",
                                                      device=dev, dtype=f64, noise=noise)
            cond = evaluate.chain_conditional_loglik_sparse_hadamard(chain, datas[dev], ops_d, 2, approx="vfe",
                                                                     model=model, device=dev, dtype=f64)
            got[dev] = [t_.cpu().numpy() for t_ in (mean, var, draws)] + [cond]
        worst += [held(np, g_, w_, SERVED_RTOL) for g_, w_ in zip(got[DEVICE][:3], got["cpu"][:3])]
        rel_c, frac_c = held(np, got[DEVICE][3], got["cpu"][3], CHAIN_LOO_RTOL)
        log("sparse_hadamard", f"{model} N_obs={len(xc)} (train {len(xc_tr)}) m_z<={SPARSE_CHECK_M_Z} card vs CPU: "
            f"FITC and VFE values and gradients max rel err {rel_o:.3e}; run_subject_hadamard (vfe, n_opt="
            f"{CHECK_N_OPT}) map_vec max rel err {rel_m:.3e} (max err {frac_m:.3e} of its scale): ok at rtol "
            f"{OBJECTIVE_RTOL}; grid and test predictions, test scores and {SPARSE_HADAMARD_CHECK_DRAWS}-draw "
            f"chain-sample draws with the same noise max rel err {max(r for r, _ in worst):.3e}, max err "
            f"{max(f_ for _, f_ in worst):.3e} of their scale: ok at rtol {SERVED_RTOL}; LOO conditionals max rel err "
            f"{rel_c:.3e}, max err {frac_c:.3e} of the scale: ok at {CHAIN_LOO_RTOL}")
    log("summary", f"sparse Hadamard gradient evaluations/s at N_obs={len(x_tr)}, m_z={SPARSE_M_Z}: "
        + ", ".join(f"{k}: {v_:.3f}" for k, v_ in rates.items()))
    return counts


#: Tempered SMC (slice 21): K3 over a batch at SMC_KERNEL_SHAPES (B, N, M) in
#: both types against B single launches (bit for bit) and the per-member
#: plain versions, timed at each and profiled at the first (the slice's
#: population: 256 particles at the JAX package's SMC scale N=200, M=2); the
#: batched GNMGP objective at B=SMC_POPULATION, N=SMC_N against the
#: per-vector one within SMC_OBJECTIVE_RTOL; the slice's path,
#: run_subject(sampler="smc", whiten="prior") with the default smc_* fields;
#: the row route once, SNMGP's smc_sample with SMC_ROW_PARTICLES particles
#: and SMC_ROW_STAGES stages at N=SMC_N, and run_subject_hadamard(sampler=
#: "smc") on a subject of SMC_HADAMARD_N times with SMC_HADAMARD_PARTICLES
#: particles and SMC_HADAMARD_SWEEPS (sweeps, leapfrog steps) a stage: at the
#: default 5 × 10 its row route ran 5,301 gradients in 58.3 s of a 165.5 s
#: phase (PERF.md §6), so its depth is cut to keep the smoke inside its
#: limit.
SMC_KERNEL_SHAPES = ((256, 200, 2), (16, 1000, 2), (8, 200, 9))
SMC_N, SMC_M, SMC_POPULATION, SMC_OBJECTIVE_RTOL = 200, 2, 256, 1e-10
SMC_ROW_PARTICLES, SMC_ROW_STAGES, SMC_HADAMARD_N, SMC_HADAMARD_PARTICLES = 16, 2, 60, 16
SMC_HADAMARD_SWEEPS = (2, 5)
#: The chunked route of the batched objective: a population of SMC_CHUNK_B
#: members at N=SMC_CHUNK_N evaluated SMC_CHUNK_ROWS members a chunk.
SMC_CHUNK_N, SMC_CHUNK_B, SMC_CHUNK_ROWS = 1000, 8, 3
SMC_KERNELS = ("svc_gram_tiled_batched", "svc_gram_tiled_batched_backward")


def smc_kernel_inputs(torch, gen, b, n, m, dtype, dev):
    """Shared x, and per member the lengthscales of ``kernel_inputs`` and a
    lower-triangular L with diagonal about 2, and a cotangent K̄."""
    f64 = torch.float64
    x = torch.sort(torch.rand(n, generator=gen, dtype=f64)).values
    ell = torch.exp(3.0 * (x - 1.0) ** 3 - 3.0 + 0.2 * torch.randn(b, n, generator=gen, dtype=f64))
    ls = torch.tril(torch.randn(b, n, m, m, generator=gen, dtype=f64)) + 2.0 * torch.eye(m, dtype=f64)
    kbar = torch.randn(b, n * m, n * m, generator=gen, dtype=f64)
    return [t.to(device=dev, dtype=dtype).contiguous() for t in (x, ell, ls, kbar)]


def smc_kernels(torch, np, gk, settings, seed) -> dict:
    """(a) K3 and its backward over a batch: each shape and type against B
    single launches bit for bit and against the per-member plain versions;
    ms, the single-launch loop's ms, the plain versions' ms and the bound;
    one call of each profiled first, at the first shape in float64.  Returns
    the kernels line's numbers from that shape."""
    jit = settings.jitter
    b, n, m = SMC_KERNEL_SHAPES[0]
    x, ell, ls, kbar = smc_kernel_inputs(torch, torch.Generator().manual_seed(seed + 2106), b, n, m, torch.float64,
                                         DEVICE)
    label = f"B={b} N={n} M={m} float64"
    kinds = {name: one_call_kernels(torch, f"{name} {label}", fn, want) for name, fn, want in (
        ("svc_gram_tiled_batched", lambda: gk.svc_gram_tiled_batched(x, ell, ls, jit), 1),
        ("svc_gram_tiled_batched_backward", lambda: gk.svc_gram_tiled_batched_backward(x, ell, ls, kbar, jit), 2))}
    del x, ell, ls, kbar
    gen = torch.Generator().manual_seed(seed + 2100)
    rows = {}
    for b, n, m in SMC_KERNEL_SHAPES:
        for dn in ("float64", "float32"):
            dtype = getattr(torch, dn)
            size = torch.tensor([], dtype=dtype).element_size()
            x, ell, ls, kbar = smc_kernel_inputs(torch, gen, b, n, m, dtype, DEVICE)
            label = f"B={b} N={n} M={m} {dn}"
            fwd = lambda: gk.svc_gram_tiled_batched(x, ell, ls, jit)
            fwd_loop = lambda: [gk.svc_gram_tiled(x, ell[i], ls[i], jit) for i in range(b)]
            fwd_plain = lambda: gk.svc_gram_tiled_batched_plain(x, ell, ls, jit)
            bwd = lambda: gk.svc_gram_tiled_batched_backward(x, ell, ls, kbar, jit)
            bwd_loop = lambda: [gk.svc_gram_tiled_backward(x, ell[i], ls[i], kbar[i], jit) for i in range(b)]
            bwd_plain = lambda: gk.svc_gram_tiled_batched_backward_plain(x, ell, ls, jit, kbar)
            got = fwd()
            if not torch.equal(got, torch.stack(fwd_loop())):
                raise AssertionError(f"svc_gram_tiled_batched {label}: differs from {b} single launches")
            err_f = check_close(torch, f"svc_gram_tiled_batched {label}", got, fwd_plain(), dn)
            singles = bwd_loop()
            got_b = bwd()
            for k, part in enumerate(("ell_bar", "ls_bar")):
                if not torch.equal(got_b[k], torch.stack([s[k] for s in singles])):
                    raise AssertionError(f"svc_gram_tiled_batched_backward {label}: {part} differs from {b} "
                                         "single launches")
            err_b = max(check_grad(torch, f"svc_gram_tiled_batched_backward {label} member {i}",
                                   (got_b[0][i], got_b[1][i]), w, dn)
                        for i, w in enumerate(zip(*bwd_plain())))
            del got, got_b, singles
            torch.cuda.synchronize()
            slow = 3 if b * (n * m) ** 2 > 2**25 or m > gk.K3_MAX_M else 5
            times = {"ms": time_ms(torch, fwd), "loop_ms": time_ms(torch, fwd_loop, 3, slow),
                     "plain_ms": time_ms(torch, fwd_plain, 3, 3),
                     "bwd_ms": time_ms(torch, bwd), "bwd_loop_ms": time_ms(torch, bwd_loop, 3, slow),
                     "bwd_plain_ms": time_ms(torch, bwd_plain, 3, 1)}
            gram = b * (n * m) ** 2
            inputs = (n + b * n + b * n * m * m) * size
            bound = {
                "svc_gram_tiled_batched": (gram * size + inputs, b * n * n * 12 + gram * 2 * m),
                "svc_gram_tiled_batched_backward": (
                    gram * size + inputs + b * (n + n * m * m) * size,
                    b * n * n * 25 + gram * ((2 * m + 1) if m > gk.K3_MAX_M else (4 * m + 3))),
            }
            for name, (ms_k, loop_k, plain_k, err) in {
                    "svc_gram_tiled_batched": ("ms", "loop_ms", "plain_ms", err_f),
                    "svc_gram_tiled_batched_backward": ("bwd_ms", "bwd_loop_ms", "bwd_plain_ms", err_b)}.items():
                nbytes, ops = bound[name]
                bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dn] * 1e3
                row = {"ms": times[ms_k], "plain_ms": times[plain_k], "max_abs_err": err,
                       "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                       "single_launch_loop_ms": times[loop_k]}
                log("smc", f"{name} {label}: equal to {b} single launches bit for bit; max_abs_err vs plain "
                    f"{err:.3e}; ms={row['ms']:.5f} (the {b} single launches {row['single_launch_loop_ms']:.5f}, "
                    f"x{row['single_launch_loop_ms'] / row['ms']:.2f}) plain_ms={row['plain_ms']:.5f} "
                    f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; bytes {bytes_ms:.5f}, operations "
                    f"{ops_ms:.5f}), {100 * row['bound_ms'] / row['ms']:.1f}% of it")
                if (b, n, m) == SMC_KERNEL_SHAPES[0] and dn == "float64":
                    rows[name] = {**row, "device_kernels_per_call": kinds[name]}
            del x, ell, ls, kbar
    return rows


def smc_population(torch, gvec, n: int, b: int, gen):
    """B GNMGP vectors around ``gvec`` (perturbed by 0.05 normals) with row 1
    a member whose plain factor fails (every L_n = [[1, 0], [1, e^-40]]:
    the rows (n, 0) and (n, 1) of its Gram are equal bit for bit, and the
    noise e^-60 is lost beside them) and row 2 a member whose factor fails
    on both rungs (lengthscales e^1000 = inf: NaN Gram)."""
    v = gvec[None, :] + 0.05 * torch.randn(b, gvec.shape[0], generator=gen, dtype=torch.float64)
    v[1, :n] = 0.0
    v[1, n : 4 * n] = torch.tensor([0.0, 1.0, -40.0], dtype=torch.float64).repeat(n)
    v[1, -1] = -60.0
    v[2, :n] = 1000.0
    return v


def population_gradient(torch, fb, vs):
    """The values (B,) and gradients (B, P) of batched objective ``fb`` at
    ``vs``: the gradient of the rows' sum."""
    vs = vs.detach().requires_grad_(True)
    val = fb(vs)
    (g,) = torch.autograd.grad(val.sum(), vs)
    return val.detach(), g


def smc_objective(torch, np, gk, settings, seed) -> tuple[dict, dict]:
    """(b) The batched GNMGP objective at B=SMC_POPULATION, N=SMC_N against
    the per-vector objective on the card, member by member: values and
    gradients within SMC_OBJECTIVE_RTOL (gradients of the row's largest
    entry), the jitter-rung member included, the failing member NaN alone;
    one population gradient launches each batched K3 kernel once, and its
    peak device memory over the inputs, in Grams a member, is at most
    ``gnmgp.BATCH_COPIES`` (what sizes the chunks).  Then the population
    gradient's wall and device time and its kernels, and the chunked route
    (:func:`smc_chunks`).  Returns the launch counts of one population
    gradient and the numbers for the log."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference.map import value_and_grad
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    f64 = torch.float64
    n, b = SMC_N, SMC_POPULATION
    x, y, gvec, _ = training_subject(torch, seed + 2101, n)
    data = FullData(*(torch.as_tensor(a, dtype=f64, device=DEVICE) for a in (x, y)))
    f, fb = gnmgp.make_objective(data), gnmgp.make_objective_batched(data)
    v = smc_population(torch, gvec, n, b, torch.Generator().manual_seed(seed + 2102)).to(DEVICE)

    pop_grad = lambda vs: population_gradient(torch, fb, vs)
    # the jitter member's plain factor fails on both routes: the single factor and in the batch
    p1 = gnmgp.unpack(v[1], n, SMC_M)
    g1 = gk.svc_gram_tiled(data.x, torch.exp(p1.tilde_l), gnmgp.chol_process(p1.ul_vecs, n, SMC_M), settings.jitter)
    g1 = torch.diagonal_scatter(g1, torch.diagonal(g1) + torch.exp(p1.tilde_sigma2_err))
    info_single = int(torch.linalg.cholesky_ex(g1)[1])
    info_batch = int(torch.linalg.cholesky_ex(torch.stack([g1, g1, g1]))[1][1])
    if info_single == 0 or info_batch == 0:
        raise AssertionError(f"the jitter member's plain factor did not fail (info {info_single}, {info_batch})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launches()
    vals, grads = pop_grad(v)
    torch.cuda.synchronize()
    counts = {k: c for k, c in gk.launches().items() if c}
    copies = (torch.cuda.max_memory_allocated() - base) / (b * (n * SMC_M) ** 2 * 8)
    if counts != {"svc_gram_tiled_batched": 1, "svc_gram_tiled_batched_backward": 1}:
        raise AssertionError(f"one population gradient launched {counts}")
    log("smc", f"one population gradient B={b} N={n} M={SMC_M} f64: peak device memory over its inputs "
        f"{copies:.4f} Grams a member (gnmgp.BATCH_COPIES {gnmgp.BATCH_COPIES})")
    if copies > gnmgp.BATCH_COPIES:
        raise AssertionError(f"a population gradient peaked at {copies:.4f} Grams a member, over BATCH_COPIES")
    worst_v = worst_g = 0.0
    for i in range(b):
        val_i, grad_i = value_and_grad(f, v[i])
        if i == 2:
            if not (torch.isnan(vals[2]) and torch.isnan(val_i) and torch.isnan(grads[2]).all()
                    and torch.isnan(grad_i).all()):
                raise AssertionError("the failing member is not NaN in both objectives")
            continue
        if not (torch.isfinite(vals[i]) and torch.isfinite(grads[i]).all()):
            raise AssertionError(f"member {i}: non-finite batched value or gradient")
        rel_v = abs(vals[i].item() - val_i.item()) / abs(val_i.item())
        rel_g = ((grads[i] - grad_i).abs().max() / grad_i.abs().max()).item()
        if not (rel_v <= SMC_OBJECTIVE_RTOL and rel_g <= SMC_OBJECTIVE_RTOL):
            raise AssertionError(f"member {i}: value off by {rel_v:.3e}, gradient by {rel_g:.3e} of its scale")
        worst_v, worst_g = max(worst_v, rel_v), max(worst_g, rel_g)
    log("smc", f"batched GNMGP objective B={b} N={n} M={SMC_M} f64 against the per-vector one, member by member: "
        f"values max rel err {worst_v:.3e}, gradients max err {worst_g:.3e} of each row's scale (ok at "
        f"{SMC_OBJECTIVE_RTOL}); the jitter member's plain factor failed (info {info_single} single, "
        f"{info_batch} batched) and both took the retry; the failing member is NaN alone; one population "
        f"gradient launched {counts}")
    wall_ms, device_ms, kinds, top = device_profile(torch, lambda: pop_grad(v), top_n=None)
    k3_ms = sum(ms for ms, _, key in top if "svc_gram_tiled" in key)
    log("profile", f"one population gradient B={b} N={n} M={SMC_M} f64: wall {wall_ms:.3f} ms, device "
        f"{device_ms:.3f} ms (busy share {device_ms / wall_ms:.3f}), {b / wall_ms * 1e3:.1f} particle "
        f"gradients/s, {kinds} kernel kinds; the batched K3 kernels {k3_ms:.4f} ms (a share "
        f"{k3_ms / device_ms:.3f} of the device time)")
    for ms, count, key in top[:12]:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    smc_chunks(torch, gk, seed)
    return counts, {"wall_ms": wall_ms, "device_ms": device_ms, "k3_ms": k3_ms, "worst_value": worst_v,
                    "worst_gradient": worst_g, "copies": copies}


def smc_chunks(torch, gk, seed) -> None:
    """The batched objective's chunked route on the card: a population of
    SMC_CHUNK_B members at N=SMC_CHUNK_N, M=2 (f64) whose gradient is taken
    whole and then SMC_CHUNK_ROWS members a chunk (``gnmgp.batch_rows``
    forced): the rows within SMC_OBJECTIVE_RTOL of the whole batch's; the
    chunked gradient launches the batched forward twice a chunk (the
    forward and its recomputation in the backward pass) and the backward
    once a chunk; the peak memory of each."""
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    n, b, step = SMC_CHUNK_N, SMC_CHUNK_B, SMC_CHUNK_ROWS
    x, y, gvec, _ = training_subject(torch, seed + 2107, n)
    data = FullData(*(torch.as_tensor(a, dtype=torch.float64, device=DEVICE) for a in (x, y)))
    fb = gnmgp.make_objective_batched(data)
    gen = torch.Generator().manual_seed(seed + 2108)
    v = (gvec[None, :] + 0.05 * torch.randn(b, gvec.shape[0], generator=gen, dtype=torch.float64)).to(DEVICE)
    out, peaks, launched = {}, {}, {}
    batch_rows = gnmgp.batch_rows
    for route in ("whole", "chunked"):
        if route == "chunked":
            gnmgp.batch_rows = lambda *args: step
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            gk.reset_launches()
            out[route] = population_gradient(torch, fb, v)
            torch.cuda.synchronize()
            launched[route] = {k: c for k, c in gk.launches().items() if c}
            peaks[route] = (torch.cuda.max_memory_allocated() - base) / 2**30
        finally:
            gnmgp.batch_rows = batch_rows
    chunks = -(-b // step)
    want = {"svc_gram_tiled_batched": 2 * chunks, "svc_gram_tiled_batched_backward": chunks}
    (wv, wg), (cv, cg) = out["whole"], out["chunked"]
    rel_v = ((cv - wv).abs() / wv.abs()).max().item()
    rel_g = ((cg - wg).abs().amax(dim=1) / wg.abs().amax(dim=1)).max().item()
    log("smc", f"chunked population gradient B={b} N={n} M=2 f64, {step} members a chunk ({chunks} chunks): values "
        f"max rel err {rel_v:.3e}, gradients {rel_g:.3e} of each row's scale against the whole batch; launched "
        f"{launched['chunked']} (whole: {launched['whole']}); peak device memory {peaks['chunked']:.3f} GiB "
        f"(whole: {peaks['whole']:.3f} GiB)")
    if launched["whole"] != {k: 1 for k in want} or launched["chunked"] != want:
        raise AssertionError(f"the chunked gradient launched {launched['chunked']}, expected {want}")
    if not (torch.isfinite(cv).all() and torch.isfinite(cg).all()) or max(rel_v, rel_g) > SMC_OBJECTIVE_RTOL:
        raise AssertionError(f"the chunked rows are off the whole batch's: {rel_v:.3e}, {rel_g:.3e}")


def smc_path(torch, np, gk, seed) -> dict:
    """(c) The slice's path: run_subject(model="gnmgp", sampler="smc",
    whiten="prior", do_hmc=True, do_loo=True) on the card, no device named,
    at N=SMC_N, M=2 with the default smc_* fields; the sampling stage's
    launches and population evaluations counted; then one stage profiled."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import smc, whiten
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import gnmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    x, y, _, _ = training_subject(torch, seed + 2103, SMC_N)
    cfg = workflows.PipelineConfig(n_opt=TRAIN_N_OPT, do_hmc=True, do_loo=True, sampler="smc", whiten="prior")
    calls = {"gradient": 0, "value": 0}
    make_batched, run_smc = gnmgp.make_objective_batched, workflows._run_chain_smc
    stage: dict = {}

    def counted_objective(*args, **kwargs):
        fn = make_batched(*args, **kwargs)

        def wrapped(vecs):
            calls["gradient" if torch.is_grad_enabled() and vecs.requires_grad else "value"] += 1
            return fn(vecs)
        return wrapped

    def counted_stage(*args, **kwargs):
        before = gk.launches()
        out = run_smc(*args, **kwargs)
        torch.cuda.synchronize()
        stage.update({k: v - before[k] for k, v in gk.launches().items()})
        return out

    gnmgp.make_objective_batched, workflows._run_chain_smc = counted_objective, counted_stage
    try:
        gk.reset_launches()  # the main path starts here
        t0 = time.perf_counter()
        res = workflows.run_subject(x, y, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gk.launches()  # the main path ends here
    finally:
        gnmgp.make_objective_batched, workflows._run_chain_smc = make_batched, run_smc
    s = res["sampling"]
    t_smc = res["timings"]["hmc"]
    pop = s["n_particles"]
    log("smc", f"run_subject gnmgp N={SMC_N} M={SMC_M} f64 sampler=smc whiten=prior n_opt={TRAIN_N_OPT} "
        f"do_loo=True on the card (no device named): {wall:.3f} s; stages (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["timings"].items()))
    log("smc", f"SMC: {pop} particles, {cfg.smc_mutations} x {cfg.smc_leapfrog} sweeps, metric {cfg.smc_metric}: "
        f"{s['n_stages']} stages, beta_final {s['beta_final']}, log_evidence {s['log_evidence']:.6f}, final "
        f"accept {s['final_accept']:.6f}, step size {s['step_size']:.6e}; {calls['gradient']} population "
        f"gradients and {calls['value']} population values in {t_smc:.3f} s: "
        f"{calls['gradient'] * pop / t_smc:.1f} particle gradients/s, {t_smc / s['n_stages']:.3f} s a stage")
    log("smc", f"sampling stage launched {stage}; the whole run launched {launches}")
    if s["beta_final"] != 1.0 or not np.isfinite(s["log_evidence"]):
        raise AssertionError(f"SMC did not reach beta = 1 with a finite evidence: {s}")
    samples = res["hmc_samples"]
    if tuple(samples.shape) != (cfg.n_hmc, gnmgp.n_params(SMC_N, SMC_M)) or not torch.isfinite(samples).all():
        raise AssertionError(f"hmc_samples {tuple(samples.shape)} or non-finite")
    if not np.isfinite(res["loo"]["elpd_loo"]):
        raise AssertionError("non-finite elpd_loo")
    want = {"svc_gram_tiled_batched": calls["gradient"] + calls["value"],
            "svc_gram_tiled_batched_backward": calls["gradient"], "svc_gram_tiled": 0, "svc_gram_tiled_backward": 0}
    got = {k: stage[k] for k in want}
    if got != want or calls["gradient"] == 0:
        raise AssertionError(f"the sampling stage launched {got}, expected {want}: one batched K3 forward a "
                             "population evaluation, one backward a population gradient, no single-member K3")
    # one stage from the prior, profiled: where a stage's time goes
    xd, yd = (torch.as_tensor(a, dtype=torch.float64, device=DEVICE) for a in (x, y))
    w = whiten.make_whitener("gnmgp", xd, SMC_N, SMC_M, cfg.hyper)
    pot = w.wrap(gnmgp.make_objective_batched(FullData(xd, yd), hyper=cfg.hyper))
    gen = torch.Generator(DEVICE).manual_seed(seed)
    one = lambda: smc.smc_sample(pot, w.n_params, gen, pop, max_stages=1, metric=cfg.smc_metric,
                                 potential_batched=True)
    wall_ms, device_ms, kinds, top = device_profile(torch, one, reps=1)
    log("profile", f"one SMC stage ({pop} particles, {cfg.smc_mutations} sweeps of {cfg.smc_leapfrog} leapfrog "
        f"steps, from the prior): wall {wall_ms:.3f} ms, device {device_ms:.3f} ms (busy share "
        f"{device_ms / wall_ms:.3f}), {kinds} kernel kinds")
    for ms, count, key in top[:12]:
        log("profile", f"  {ms:9.4f} ms x{count:<3d} {key}")
    return {"launches": got, "calls": calls, "sampling": s, "seconds": t_smc, "stage_busy": device_ms / wall_ms,
            "stage_wall_ms": wall_ms, "whole_run": launches}


def smc_rows(torch, np, gk, seed) -> dict:
    """(d) The row route, driven once: SNMGP's smc_sample (whitened) with
    SMC_ROW_PARTICLES particles and SMC_ROW_STAGES stages, K1 and its
    backward counted against rows × evaluations; run_subject_hadamard(model=
    "gnmgp", sampler="smc") on a small Hadamard subject."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import workflows
    from nonstationary_multivariate_gaussian_process_tpu_torch.inference import smc, whiten
    from nonstationary_multivariate_gaussian_process_tpu_torch.models import snmgp
    from nonstationary_multivariate_gaussian_process_tpu_torch.models.base import FullData

    x, y, _, _ = training_subject(torch, seed + 2104, SMC_N)
    xd, yd = (torch.as_tensor(a, dtype=torch.float64, device=DEVICE) for a in (x, y))
    w = whiten.make_whitener("snmgp", xd, SMC_N, SMC_M)
    nlp = snmgp.make_objective(FullData(xd, yd))
    calls = {"gradient": 0, "value": 0}

    def counted(v):
        calls["gradient" if torch.is_grad_enabled() and v.requires_grad else "value"] += 1
        return nlp(v)

    gk.reset_launches()
    t0 = time.perf_counter()
    r = smc.smc_sample(w.wrap(counted), w.n_params, torch.Generator(DEVICE).manual_seed(seed),
                       SMC_ROW_PARTICLES, max_stages=SMC_ROW_STAGES, metric="full")
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t0
    got = {k: c for k, c in gk.launches().items() if c}
    want = {"gibbs_gram": calls["gradient"] + calls["value"], "gibbs_gram_backward": calls["gradient"]}
    log("smc", f"row route: SNMGP smc_sample N={SMC_N} {SMC_ROW_PARTICLES} particles, {int(r.n_stages)} stages "
        f"(beta {float(r.beta_final):.6f}): {calls['gradient']} row gradients and {calls['value']} row values in "
        f"{t_rows:.3f} s ({calls['gradient'] / t_rows:.1f} gradients/s); launched {got}")
    if got != want or not torch.isfinite(r.particles).all():
        raise AssertionError(f"the row route launched {got}, expected {want}, or non-finite particles")

    (xh, ih, yh), _, _, _ = hadamard_subject(torch, np, seed + 2105, SMC_HADAMARD_N)
    cfg = workflows.PipelineConfig(model="gnmgp", n_opt=20, do_hmc=True, sampler="smc", whiten="prior",
                                   smc_particles=SMC_HADAMARD_PARTICLES, n_hmc=SMC_HADAMARD_PARTICLES,
                                   smc_mutations=SMC_HADAMARD_SWEEPS[0], smc_leapfrog=SMC_HADAMARD_SWEEPS[1])
    gk.reset_launches()
    out = workflows.run_subject_hadamard(xh, ih, yh, 2, cfg)
    torch.cuda.synchronize()
    hl = {k: c for k, c in gk.launches().items() if c}
    log("smc", f"run_subject_hadamard gnmgp sampler=smc whiten=prior, {len(xh)} observations, "
        f"{SMC_HADAMARD_PARTICLES} particles, {cfg.smc_mutations} x {cfg.smc_leapfrog} sweeps: stages (s) " + ", ".join(f"{k} {v:.3f}" for k, v in out["timings"].items())
        + f"; accept {out['hmc_accept']:.6f}; launched {hl}")
    if not torch.isfinite(out["hmc_samples"]).all() or out["hmc_samples"].shape[0] != SMC_HADAMARD_PARTICLES:
        raise AssertionError("run_subject_hadamard(sampler='smc'): bad samples")
    if hl.get("gibbs_gram", 0) <= 0 or hl.get("gibbs_gram_backward", 0) <= 0 or any(k in hl for k in SMC_KERNELS):
        raise AssertionError(f"run_subject_hadamard(sampler='smc') launched {hl}")
    return {"snmgp_rows": got, "hadamard": hl}


def phase_smc(torch, np, gk, seed) -> dict:
    """Tempered SMC on the card: (a) the batched K3 kernels, (b) the batched
    objective, (c) the slice's path, (d) the row route."""
    from nonstationary_multivariate_gaussian_process_tpu_torch import settings

    rows = smc_kernels(torch, np, gk, settings, seed)
    counts, objective = smc_objective(torch, np, gk, settings, seed)
    path = smc_path(torch, np, gk, seed)
    for name in SMC_KERNELS:
        rows[name]["launches_per_population_gradient"] = counts[name]
        rows[name]["launches_smc_run"] = path["launches"][name]
    return {"kernels": rows, "objective": objective, "path": path, "rows": smc_rows(torch, np, gk, seed)}


#: The phases after the build, in the order they run, and the phases whose
#: results each takes (a named phase runs those too).
PHASES = ("kernels", "serving", "drift", "objective", "training", "hmc", "chain", "models", "nuts", "hadamard",
          "precision", "samplers", "sparse", "sparse_models", "sparse_hadamard", "smc")
PHASE_NEEDS = {"drift": ("serving",), "chain": ("hmc",), "nuts": ("models",), "precision": ("hmc",),
               "samplers": ("hmc", "models")}


def selected_phases(names: str | None) -> tuple[str, ...]:
    """The phases to run for ``--phases`` (comma-separated; None: every
    phase), with those they take results from, in ``PHASES`` order."""
    if names is None:
        return PHASES
    want = {n.strip() for n in names.split(",") if n.strip()}
    unknown = want - set(PHASES)
    if unknown or not want:
        raise SystemExit(f"chip_smoke: --phases takes a comma-separated subset of {', '.join(PHASES)}; "
                         f"got {names!r}")
    todo = list(want)
    while todo:
        for need in PHASE_NEEDS.get(todo.pop(), ()):
            if need not in want:
                want.add(need)
                todo.append(need)
    return tuple(p for p in PHASES if p in want)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", help="comma-separated phases to run (default: every phase), e.g. "
                        "kernels,sparse; a phase also runs the phases whose results it takes")
    args = parser.parse_args()
    phases = selected_phases(args.phases)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nonstationary_multivariate_gaussian_process_tpu_torch import settings
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import cuda_build
    from nonstationary_multivariate_gaussian_process_tpu_torch.ops import gram_kernels as gk
    from nonstationary_multivariate_gaussian_process_tpu_torch.serving import engine

    t_smoke = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    log("env", f"{kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    gk.build()
    for name in gk.KERNEL_SOURCES:
        cuda_build.load(name)
    log("build", f"{', '.join(gk.KERNEL_SOURCES)} built and loaded in {time.perf_counter() - t0:.3f} s")

    log("env", f"phases: {', '.join(phases)}")
    res = {}  # each phase's results

    def run(name, fn, *fn_args):
        if name in phases:
            t0 = time.perf_counter()
            res[name] = fn(torch, np, gk, *fn_args)
            log(name, f"phase took {time.perf_counter() - t0:.3f} s")

    buckets = {engine._bucket(g) for g in REQUEST_SIZES + engine.WARM_GRID_SIZES}
    run("kernels", lambda torch, np, gk: phase_kernels(torch, gk, settings, sorted(buckets), args.seed))
    run("serving", phase_serving, args.seed)
    run("drift", lambda torch, np, gk: phase_drift(torch, *res["serving"][3]))
    run("objective", phase_objective, args.seed)
    run("training", phase_training, args.seed)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir, prefix="smoke_hmc_") as root:
        run("hmc", phase_hmc, args.seed, root)
        run("chain", lambda torch, np, gk: phase_chain(torch, np, gk, args.seed, root, *res["hmc"][1:]))
    run("models", phase_models, args.seed)
    run("nuts", lambda torch, np, gk: phase_nuts(torch, np, gk, args.seed, res["models"][1]))
    run("hadamard", phase_hadamard, args.seed)
    run("precision", lambda torch, np, gk: phase_precision(torch, np, gk, args.seed, res["hmc"][1]))
    run("samplers", lambda torch, np, gk: phase_samplers(torch, np, gk, args.seed, res["hmc"][1], res["models"][1]))
    run("sparse", phase_sparse, args.seed)
    run("sparse_models", phase_sparse_models, args.seed)
    run("sparse_hadamard", phase_sparse_hadamard, args.seed)
    run("smc", phase_smc, args.seed)

    pallas = "nonstationary_multivariate_gaussian_process_tpu/ops/pallas_kernels.py"
    # a backward kernel names the TPU kernel whose gradient it computes (the
    # TPU had no backward kernel: XLA differentiated the jnp Gram)
    replaces = {"gibbs_gram": f"{pallas}:55", "gibbs_gram_backward": f"{pallas}:55",
                "gibbs_gram_cross_backward": f"{pallas}:55", "svc_gram": f"{pallas}:228",
                "svc_gram_tiled": f"{pallas}:122", "svc_gram_tiled_backward": f"{pallas}:122"}
    kernels = []
    for name in TRAINING_KERNELS + ("gibbs_gram_cross_backward",) if "kernels" in res else ():
        # the served kernels count on slice 1's path, the training kernels on
        # slice 2's, K1's cross-form backward on the sparse tier's (None where
        # --phases left that phase out)
        served = name in SERVED_KERNELS
        if served:
            main_launches = res["serving"][0][name] if "serving" in res else None
        elif name in TRAINING_KERNELS:
            main_launches = res["training"][name] if "training" in res else None
        else:
            main_launches = res["sparse"]["run_subject"][name] if "sparse" in res else None
        row = {
            "name": name,
            "route": "cuda",  # the contract's: CUDA C++ (kernel_route: the schedule's route)
            "source": f"nonstationary_multivariate_gaussian_process_tpu_torch/csrc/{gk.SOURCES[name]}.cu",
            "replaces": replaces[name],
            "launches": main_launches,
            **res["kernels"][name],  # max_abs_err, ms, plain_ms, bound_ms, bound_by
            "library_ms": None,  # no single PyTorch call computes these Grams or their gradients
        }
        if served and "serving" in res:
            row["launches_per_request"] = res["serving"][0][name] / res["serving"][1]
        if name in HMC_KERNELS and "hmc" in res:
            row["launches_hmc"] = res["hmc"][0][name]  # the sampling stage of slice 3's path
        row.update(res.get("chain", {}).get(name, {}))  # the LOO stage and a sample request
        if name == "svc_gram" and "objective" in res:
            # the prediction at M > 4 (the generic route): per map call and per draw
            pr = res["objective"]["prediction"]
            row["launches_generic_prediction"] = {"map_call": pr["map"]["launches"][name],
                                                  "sample_draw": pr["sample"]["launches"][name] / pr["sample"]["draws"]}
        if "precision" in res:
            # under NMGP_PRECISION=mixed: per gradient by model, the GNMGP run_subject and its chain
            row["launches_precision"] = res["precision"].get(name, {})
        # by model: the other families' chain, DIC, LOO stage and requests; the
        # whitened NUTS chains at N=1000; the Hadamard layout by stage; the
        # sampling stages of DRHMC, ChEES and tempering; the sparse tier per
        # gradient, its run_subject and stages, NUTS and requests; the other
        # sparse tiers likewise, by tier; the sparse tiers in the Hadamard
        # layout per gradient, their run_subject_hadamard and its stages
        for phase in ("models", "nuts", "hadamard", "samplers", "sparse", "sparse_models", "sparse_hadamard"):
            if phase in res:
                counts = res[phase][0] if phase == "models" else res[phase]
                row[f"launches_{phase}"] = {label: c[name] for label, c in counts.items()}
        kernels.append(row)
    for name in SMC_KERNELS if "smc" in res else ():
        # the batched K3 kernels, on the SMC path (slice 21): the TPU kernel took one Gram
        r = res["smc"]["kernels"][name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"nonstationary_multivariate_gaussian_process_tpu_torch/csrc/{gk.SOURCES[name]}.cu",
                        "replaces": replaces["svc_gram_tiled"], "launches": r["launches_smc_run"],
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
                        "library_ms": None, "single_launch_loop_ms": r["single_launch_loop_ms"],
                        "launches_per_population_gradient": r["launches_per_population_gradient"]})
    joined = lambda counts, keep=bool: "; ".join(
        f"{label}: " + ", ".join(f"{k} {v}" for k, v in c.items() if keep(v)) for label, c in counts.items())
    if "serving" in res:
        log("summary", "warm /predict latency ms by size: "
            + ", ".join(f"{g}: {ms:.3f}" for g, ms in res["serving"][2].items()))
    if "chain" in res:
        log("summary", "launches in the LOO stage and per sample request: "
            + ", ".join(f"{k}: {v}" for k, v in res["chain"].items()))
    any_value = lambda v: any(v.values())
    for phase, what, keep in (("models", "by model (chain, DIC, LOO stage, per map and sample request)", any_value),
                              ("nuts", "in the whitened NUTS chains by model", bool),
                              ("hadamard", "in run_subject_hadamard by model and stage", any_value),
                              ("precision", "under mixed", bool), ("samplers", "in the samplers' stages", bool),
                              ("sparse", "on the sparse path", bool),
                              ("sparse_models", "on the other sparse tiers' paths", bool),
                              ("sparse_hadamard", "on the sparse tiers' Hadamard paths", bool)):
        if phase in res:
            log("summary", f"launches {what}: " + joined(res[phase][0] if phase == "models" else res[phase], keep))
    if "objective" in res:
        log("summary", "gradient evaluations/s (N=1000, M=2 unless named): "
            + ", ".join(f"{k}: {v:.3f}" for k, v in res["objective"]["rates"].items()))
        log("summary", f"GNMGP f64 prediction at N={PREDICT_N}, M={PREDICT_M}: " + ", ".join(
            f"{mode} device {r['device_ms']:.3f} ms, K2 {r['k2_ms']:.4f} ms, launches {r['launches']}"
            for mode, r in res["objective"]["prediction"].items() if mode != "seconds"))
    if "smc" in res:
        sp = res["smc"]["path"]
        log("summary", f"SMC at N={SMC_N}, {sp['sampling']['n_particles']} particles: {sp['sampling']['n_stages']} "
            f"stages in {sp['seconds']:.3f} s, {sp['calls']['gradient']} population gradients; the sampling stage "
            f"launched {sp['launches']}; the row route {res['smc']['rows']}")
    log("summary", f"the smoke took {time.perf_counter() - t_smoke:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
