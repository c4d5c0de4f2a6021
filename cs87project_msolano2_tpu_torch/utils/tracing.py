"""DEPRECATED shim: the profiler integration lives in the observability
subsystem — import :func:`trace` from
``cs87project_msolano2_tpu_torch.obs.profiler`` (or just ``...obs``)
instead.

Kept so callers of the JAX package's import path find its counterpart
here; new code should not import this path."""

from __future__ import annotations

import warnings

from ..obs.profiler import trace  # noqa: F401

warnings.warn(
    "cs87project_msolano2_tpu_torch.utils.tracing moved to "
    "cs87project_msolano2_tpu_torch.obs.profiler; this shim will be "
    "removed",
    DeprecationWarning,
    stacklevel=2,
)
