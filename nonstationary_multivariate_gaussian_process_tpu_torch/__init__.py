"""nonstationary_multivariate_gaussian_process_tpu_torch: the PyTorch/CUDA port.

A second package beside the JAX one (``nonstationary_multivariate_gaussian_process_tpu``),
which stays the reference.  Module names follow the JAX package so that each
counterpart is easy to find.  The port imports torch, numpy and the standard
library only.

Ported so far:

* slice 1, the serving path of the GNMGP model in ``mode="map"``:
  ``settings``, ``ops`` (transforms, kernels, gram_kernels with the CUDA
  Gibbs and SVC Gram kernels, chol), ``models`` (base, gnmgp), ``predict``
  (latent, gnmgp), ``utils.artifacts``, ``serving`` (engine, server),
  ``data.sim`` (``sim_mnts``) and ``convert``;
* slice 2, GNMGP MAP training (``workflows.run_subject``): ``dists``,
  ``ops.kron``, the rest of ``ops.chol``, the tiled SVC Gram and the
  backward kernels in ``ops.gram_kernels``, ``models`` (gnmgp objective,
  snmgp), ``native`` (the variogram library), ``inference`` (empirical,
  init, map), ``postprocess.analysis``, ``evaluate``, ``data.preprocess``
  and ``workflows``;
* slice 3, HMC (``run_subject(do_hmc=True)``): ``inference`` (hmc, warmup,
  diagnostics), the chain summaries and the DIC;
* the chain's consumers: WAIC and PSIS-LOO (``run_subject(do_loo=True)``,
  ``evaluate``, ``inference.pathfinder``'s PSIS), ``mode="sample"``
  prediction and serving (``predict.gnmgp``, ``serving``), and the
  single-subject CLI (``examples.run_sim_pipeline`` with ``viz`` and
  ``data.io``);
* the other dense model families (``models.lmc``, ``models.gnmgp_hetero``
  and their predictors) and whitened NUTS (``inference.whiten``,
  ``inference.nuts``);
* the Hadamard layout (``workflows.run_subject_hadamard``): the models'
  Hadamard objectives, ``models.HadamardData``, ``predict.hadamard``, the
  Hadamard LOO conditionals in ``evaluate``, the splits of
  ``data.preprocess`` and ``data.io.hadamard_to_full``.
"""

from . import settings  # noqa: F401

__version__ = "0.1.0"
