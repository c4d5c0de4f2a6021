"""Butterfly primitives, twiddle tables, precision modes and the CUDA
kernel wrappers (each beside its plain PyTorch version)."""
