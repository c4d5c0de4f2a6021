"""Closed-loop fleet control: drift → canary → promote/rollback →
prewarm (the reference's ``fleet/`` package).

The serving mesh (serve/mesh.py) executes plans; this package decides
WHICH plans, continuously, from live evidence:

* :mod:`.drift`   — flags plans whose served latency drifted from the
  baseline the fleet last accepted, using the calibrated Mann-Whitney
  detectors in :mod:`..analyze.regress` (never ad-hoc thresholds).
* :mod:`.canary`  — re-races autotune candidates on a designated canary
  device with mirrored (shadowed, non-served) traffic, promotes into
  the shared plan cache only on a statistical verdict, and rolls back
  — byte-identically — when promotion faults or fails to help.
* :mod:`.prewarm` — a decayed per-GroupKey arrival model persisted
  beside the plan cache, so a restarted mesh warms the last run's hot
  shapes before the first request arrives.
* :mod:`.loop`    — the controller that wires the three to a
  :class:`~..serve.mesh.MeshDispatcher` via its ``fleet_tap`` hook.

``python -m cs87project_msolano2_tpu_torch fleet smoke`` drives the
whole loop end-to-end on the card (``--device cpu``: on the CPU).
"""

from .canary import CanaryController, CanaryOutcome, TrafficMirror
from .drift import DriftDetector, DriftFinding
from .loop import FleetController
from .prewarm import ArrivalModel, FleetTap, model_path

__all__ = [
    "ArrivalModel",
    "CanaryController",
    "CanaryOutcome",
    "DriftDetector",
    "DriftFinding",
    "FleetController",
    "FleetTap",
    "TrafficMirror",
    "model_path",
]
