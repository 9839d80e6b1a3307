"""Model layer: the data containers and the dense models' objectives, in the
fully observed and the Hadamard layout."""

from . import base, gnmgp, gnmgp_hetero, lmc, snmgp  # noqa: F401
from .base import FullData, HadamardData, as_hadamard_data  # noqa: F401
