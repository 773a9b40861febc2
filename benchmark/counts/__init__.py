"""Frozen operation and byte counts of the kernels and the step, and the peaks."""
