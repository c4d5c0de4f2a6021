"""Deprecated: the capacity probes live in the hardware plane — import
``cs87project_msolano2_tpu_torch.hw.inventory`` instead (the
reference's ``probes`` shim).

Kept so the module invocation

    python -m cs87project_msolano2_tpu_torch.probes [-v] [--cores] [--json]

keeps working; new code should not import this path."""

from __future__ import annotations

import sys
import warnings

from .hw.inventory import cpu_cores, main, probe  # noqa: F401

warnings.warn(
    "cs87project_msolano2_tpu_torch.probes moved to "
    "cs87project_msolano2_tpu_torch.hw.inventory; this shim will be "
    "removed",
    DeprecationWarning,
    stacklevel=2,
)

if __name__ == "__main__":
    sys.exit(main())
