"""Synthetic data layer: the port's own copies of the JAX package's numpy
data modules, with the synthetic bundle of ``pipelines``."""
