"""Compute ops: XLA sweeps (portable) and Pallas-Triton kernels (the GPU
hot path)."""
