"""Scoring functions and their CUDA kernels."""
