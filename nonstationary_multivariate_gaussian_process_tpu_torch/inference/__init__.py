"""Training and sampling: the empirical initializer, the MAP inits, the MAP engine, the HMC and NUTS samplers with their warmup and diagnostics, and the whitened parameterizations."""
from .nuts import NUTSResult, nuts_sample, nuts_sample_chains  # noqa: F401
