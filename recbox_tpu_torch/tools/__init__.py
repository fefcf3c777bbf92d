"""Measurements of the port's kernels that the port itself never runs."""
