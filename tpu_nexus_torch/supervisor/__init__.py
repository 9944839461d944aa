"""Failure classification copied from the JAX package's supervisor (taxonomy only)."""
