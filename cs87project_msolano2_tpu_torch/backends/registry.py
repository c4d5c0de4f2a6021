"""Backend registry — name -> Backend (the reference's
``backends/registry.py``).

``serial`` and ``pthreads`` (``cpu`` is pthreads) are the native C core
on the host (``backends.cpu``); ``torch``, ``torch-scan``,
``torch-unrolled``, ``cuda`` and ``einsum`` run on tensors
(``backends.torch_backend``), on the card unless ``device`` is "cpu".
"""

from __future__ import annotations

from typing import List

from .torch_backend import IMPLS, TorchBackend

#: the native core's names: "cpu" is its pthreads variant
NATIVE = {"serial": "serial", "pthreads": "pthreads", "cpu": "pthreads"}

_NAMES = ("serial", "pthreads", "cpu", "torch", "torch-scan",
          "torch-unrolled", "cuda", "einsum")


def list_backends() -> List[str]:
    return list(_NAMES)


def get_backend(name: str, device=None):
    """The backend `name`; a tensor backend runs on `device` (the card
    unless "cpu" is given), the native core on the host whatever
    `device` says."""
    if name in NATIVE:
        from .cpu import NativeBackend

        return NativeBackend(NATIVE[name])
    if name not in IMPLS:
        raise ValueError(
            f"unknown backend '{name}' (have: {', '.join(_NAMES)})")
    return TorchBackend(name, device)
