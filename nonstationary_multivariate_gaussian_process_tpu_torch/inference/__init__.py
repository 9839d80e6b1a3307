"""Training and sampling: the empirical initializer, the MAP inits and multichain starts, the MAP engine, the HMC, NUTS, delayed-rejection, ChEES and replica-exchange samplers with their warmup and diagnostics, and the whitened parameterizations."""
from .drhmc import DRHMCResult, drhmc_sample  # noqa: F401
from .hmc import HMCResult, estimate_mass_matrix, hmc_sample  # noqa: F401
from .map import MapResult, fit_map, multi_start_map  # noqa: F401
from .nuts import NUTSResult, nuts_sample, nuts_sample_chains  # noqa: F401
from .tempering import TemperedResult, tempered_hmc_sample  # noqa: F401
