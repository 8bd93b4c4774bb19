"""Hopper kernels for the block-pattern spmm and their dispatch."""
