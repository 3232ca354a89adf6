"""Elementwise/LUT scalar kernels (reference L2), vectorized."""
