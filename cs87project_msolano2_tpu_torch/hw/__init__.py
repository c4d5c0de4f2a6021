"""The hardware plane (the reference's ``hw/`` package): what card is
here, and the ``gpu`` plan backend's lowering family.

* ``inventory`` — :class:`DeviceInventory`: one typed probe of the card
  (name, count, SMs, shared memory, L2, persisting-L2 limit), the host's
  cores and the per-backend bandwidth ceilings (``hw probe``).
* ``lowering``  — the ``gpu`` backend's candidate ladder, static
  default and executors (``gpu-rows`` on ``csrc/gpu_rows.cu``,
  ``gpu-stages``), which ``plans.ladder`` dispatches to for keys whose
  ``backend`` is "gpu".

The reference's ``cpu-native`` family (its ctypes C core as a ladder
rung) and ``smoke`` (a two-backend failover mesh) are not ported.
"""

from __future__ import annotations

from .inventory import DeviceInventory, probe  # noqa: F401
