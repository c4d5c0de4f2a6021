"""Verification oracles, device resolution, the kernels' nvcc build and
CUDA-event timing."""
