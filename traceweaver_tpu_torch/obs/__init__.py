"""Reconstruction-quality reductions of the port."""
