"""Training and sampling: the empirical initializer, the MAP inits, the MAP engine and the HMC sampler with its warmup and diagnostics."""
