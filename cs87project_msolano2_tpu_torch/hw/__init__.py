"""The hardware plane (the reference's ``hw/`` package): what card is
here, and the ``gpu`` and ``cpu-native`` plan backends' lowering
families.

* ``inventory`` — :class:`DeviceInventory`: one typed probe of the card
  (name, count, SMs, shared memory, L2, persisting-L2 limit), the host's
  cores and the per-backend bandwidth ceilings (``hw probe``).
* ``lowering``  — the candidate ladders, static defaults and
  executors of the ``gpu`` backend (``gpu-rows`` on
  ``csrc/gpu_rows.cu``, ``gpu-stages``) and of the ``cpu-native``
  backend (the native C core, ``backends.cpu``, with p the raced
  parameter), which ``plans.ladder`` dispatches to for keys of those
  backends.

The reference's ``smoke`` (a two-backend failover mesh) comes with
serving.
"""

from __future__ import annotations

from .inventory import DeviceInventory, probe  # noqa: F401
