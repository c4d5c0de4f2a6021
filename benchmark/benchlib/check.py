"""The comparison that decides ``correct``.

Each sampled call's output, as the timed path produced it, is held
against the reference's transform of the same input.  Two numbers are
compared, each the worst over the samples:

* ``rel_l2``: ||y - ref|| / ||ref||, which every error spread over the
  output moves (lower precision, rows or points left out, a wrong
  order);
* ``max_err``: max |y - ref| over the reference's root mean square
  magnitude, which one wrong point moves as much as many.

A number passes when it is at most its limit; NaN and a wrong shape
fail.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("rel_l2", "max_err")


def to_numpy(tensors) -> tuple:
    """One call's tensors as numpy arrays, in order."""
    return tuple(t.detach().cpu().numpy() for t in tensors)


def answer(outputs) -> np.ndarray:
    """One call's outputs as one numpy array: a tensor as it is, float re
    and im planes as complex128."""
    arrays = to_numpy(outputs)
    if len(arrays) == 2:
        return arrays[0].astype(np.float64) + 1j * arrays[1]
    return arrays[0]


def readings(y: np.ndarray, ref: np.ndarray) -> dict:
    """``rel_l2`` and ``max_err`` of one output against its reference."""
    if y.shape != ref.shape:
        return {k: math.inf for k in NUMBERS}
    diff = np.abs(y.astype(np.complex128) - ref)
    norm = float(np.linalg.norm(ref))
    rms = norm / math.sqrt(ref.size)
    return {"rel_l2": float(np.linalg.norm(diff)) / norm,
            "max_err": float(diff.max()) / rms}


def compare(samples, expected, reference_args: dict, limits: dict,
            planned: int | None = None) -> dict:
    """The worst readings over `samples` ((inputs, answer) of one call
    each: its input tensors as ``to_numpy`` gives them, its answer as
    one array), each with its limit, a ``passed`` flag and the count of
    samples over a limit.  A sample `planned` but not taken counts as
    failed."""
    seen = {k: [] for k in NUMBERS}
    failed = 0
    for x, y in samples:
        got = readings(y, expected(x, **reference_args))
        failed += any(not got[k] <= limits[k] for k in NUMBERS)
        for k in NUMBERS:
            seen[k].append(got[k])
    # NaN is the worst reading of all
    worst = {k: (math.nan if any(map(math.isnan, v)) else max(v, default=0.0))
             for k, v in seen.items()}
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}
    failed += max((planned or 0) - len(samples), 0)
    passed = bool(samples) and failed == 0
    return {"checks": checks, "failed": failed, "passed": passed}
