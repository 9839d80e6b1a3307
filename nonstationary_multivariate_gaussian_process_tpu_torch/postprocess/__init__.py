"""Post-processing of fitted subjects (the port's counterpart of the JAX package's ``postprocess``)."""
