"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point that takes numpy input or builds tensors resolves its
device here.  With no GPU and no explicit CPU request it raises; it
never carries on silently on the CPU.  A tensor input stays where it
lies, which is how the kernel wrappers pick kernel (CUDA tensor) or
plain version (CPU tensor).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` (None -> the card).  Raises
    RuntimeError when the card is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def as_planes(xr, xi, device=None):
    """Float32 contiguous (xr, xi) tensors.  Numpy input goes to
    ``resolve_device(device)``; tensors stay on their own device unless
    `device` names another."""
    def one(a):
        if isinstance(a, torch.Tensor):
            dev = a.device if device is None else resolve_device(device)
            return a.to(device=dev, dtype=torch.float32).contiguous()
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)
        ).to(resolve_device(device))

    return one(xr), one(xi)
