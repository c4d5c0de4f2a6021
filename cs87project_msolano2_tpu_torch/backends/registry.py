"""Backend registry — name -> Backend."""

from __future__ import annotations

from typing import List

from .torch_backend import IMPLS, TorchBackend


def list_backends() -> List[str]:
    return list(IMPLS)


def get_backend(name: str, device=None):
    """The backend `name` on `device` (the card unless "cpu" is given)."""
    if name not in IMPLS:
        raise ValueError(
            f"unknown backend '{name}' (have: {', '.join(IMPLS)})")
    return TorchBackend(name, device)
