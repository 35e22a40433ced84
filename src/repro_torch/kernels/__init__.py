"""Radix kernels (CUDA, with plain PyTorch versions) and their wrappers."""
