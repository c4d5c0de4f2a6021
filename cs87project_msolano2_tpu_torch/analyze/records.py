"""Schema'd metric-record emission (the reference's
``analyze/records.py``).

The bench and the harness print one JSON line per run.  Every such
emission goes through :func:`emit_record`, which validates the
``metric``/``value``/``unit`` envelope and is the one ``json.dumps`` on
the metric path, so no record ships without its envelope or its
environment fingerprint.

The **environment fingerprint** (:func:`env_fingerprint`) is the key
rounds are grouped by before they are compared: the platform actually
used (``gpu`` or ``cpu``), the card's name and power limit, the smoke
flag, the torch and CUDA versions and the git revision, so a CPU smoke
round is never read against a card's round, nor a card capped below its
maximum power against one that is not.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Optional

__all__ = ["dump_json", "dump_record", "emit_record", "env_fingerprint",
           "validate_record"]

#: bump when the record envelope changes incompatibly
RECORD_SCHEMA_VERSION = 1

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _git_rev() -> Optional[str]:
    """Short git revision of the repo this package lives in, or None
    (no git, or not a checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=_REPO_ROOT,
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def _power_limit(index: int) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` prints it ("700.00 W"),
    or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else None


def env_fingerprint(smoke: bool = False,
                    device_kind: Optional[str] = None,
                    device="cuda") -> dict:
    """The fingerprint stamped on every emitted record:
    ``{"platform", "device_kind", "smoke", "torch", "cuda", ...}``.
    ``platform`` is "gpu" or "cpu" from `device`, the device the run
    used; on a card ``device_kind`` defaults to its name and
    ``power_limit`` is read with nvidia-smi; ``git_rev`` is best
    effort."""
    import torch

    dev = torch.device(device)
    fp = {"platform": "gpu" if dev.type == "cuda" else "cpu",
          "device_kind": device_kind, "smoke": bool(smoke),
          "torch": torch.__version__, "cuda": torch.version.cuda}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        if fp["device_kind"] is None:
            fp["device_kind"] = torch.cuda.get_device_name(index)
        fp["power_limit"] = _power_limit(index)
    rev = _git_rev()
    if rev:
        fp["git_rev"] = rev
    return fp


def validate_record(rec) -> list:
    """Problems with a metric record's envelope (empty = valid): a
    JSON-safe object carrying ``metric`` (str), ``value`` (number or
    None: a failed headline is explicit, never absent) and ``unit``
    (str)."""
    problems = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    if not isinstance(rec.get("metric"), str) or not rec.get("metric"):
        problems.append("missing/empty 'metric' name")
    if "value" not in rec:
        problems.append("missing 'value' (a failed measurement is an "
                        "explicit null, not an absent key)")
    elif (rec["value"] is not None
          and not isinstance(rec["value"], (int, float))) \
            or isinstance(rec["value"], bool):
        problems.append(f"'value' is {type(rec['value']).__name__}, "
                        "not a number")
    if not isinstance(rec.get("unit"), str) or not rec.get("unit"):
        problems.append("missing/empty 'unit'")
    env = rec.get("env")
    if env is not None:
        if not isinstance(env, dict):
            problems.append(f"'env' is {type(env).__name__}, not a "
                            "fingerprint object")
        elif "smoke" not in env:
            problems.append("'env' fingerprint lacks the 'smoke' flag")
    try:
        json.dumps(rec)
    except (TypeError, ValueError) as e:
        problems.append(f"record is not JSON-serializable: {e}")
    return problems


def dump_record(rec: dict) -> str:
    """The validated one-line JSON form of a metric record; raises
    ValueError naming every envelope problem."""
    problems = validate_record(rec)
    if problems:
        raise ValueError("refusing to emit a malformed metric record: "
                         + "; ".join(problems))
    return json.dumps(rec)


def emit_record(rec: dict, stream=None) -> dict:
    """Validate and print one metric record; returns the record."""
    print(dump_record(rec), file=stream if stream is not None
          else sys.stdout)
    return rec


def _json_default(o):
    """numpy scalars degrade to floats, anything else to its repr."""
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


def dump_json(obj, indent: int = 1) -> str:
    """Pretty JSON for reports, kept here so the bench and the harness
    have one serialization module."""
    return json.dumps(obj, indent=indent, sort_keys=True,
                      default=_json_default)
