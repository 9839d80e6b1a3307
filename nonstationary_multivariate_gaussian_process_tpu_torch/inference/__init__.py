"""Training: the empirical initializer, the MAP inits and the MAP engine."""
