"""Posterior-predictive machinery."""
