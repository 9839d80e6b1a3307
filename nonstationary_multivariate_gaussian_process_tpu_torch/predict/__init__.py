"""Posterior-predictive machinery: per model family on fully observed data,
and ``hadamard`` for the Hadamard layout."""

from . import gnmgp, gnmgp_hetero, hadamard, latent, lmc, snmgp  # noqa: F401
from .snmgp import GridPrediction, SampledPrediction  # noqa: F401
