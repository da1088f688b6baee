"""Likelihood operators: partitions, models, pruning, kernels."""
