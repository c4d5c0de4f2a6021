"""PyTorch/CUDA port of the communication-free pi-FFT.

The counterpart of ``cs87project_msolano2_tpu`` (the JAX/Pallas package,
which stays the reference): the same funnel/tube algorithm, plan
dispatch and backend contract, with the TPU's Pallas kernels replaced by
CUDA C++ kernels written for Hopper (``csrc/``).  Subpackages mirror the
reference's names so each module's counterpart is obvious.

Every entry point that takes numpy input or builds tensors runs on the
card (``device="cuda"``) unless the caller asks for the CPU, where the
kernels' plain PyTorch versions run instead.  This package imports
torch, numpy and the standard library only — never jax, and nothing of
the reference package.
"""

__version__ = "0.1.0"
