"""Covariance kernels, transforms, Cholesky solves and the CUDA Gram kernels."""
