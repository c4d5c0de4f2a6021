"""Precision modes: what planes and tables are stored as, and how much
error each mode may show.

The mode table is the reference's (``ops/precision.py``), so a PlanKey
means the same contract in both packages:

    mode       storage    rel-err budget (L2, vs float64)
    ---------  ---------  ------------------------------
    bf16       bfloat16   3e-2
    default    float32    1e-2
    split3     float32    1e-5
    highest    float32    5e-6
    fp32       float32    5e-6

On the TPU the fp32-storage modes differ in how the MXU tail matmul is
computed.  The port's kernels run every level as float32 butterflies,
which meets the tightest fp32-storage budget, so all four fp32-storage
modes take the same path.  bf16 storage is not ported yet
(``ported_storage`` raises).
"""

from __future__ import annotations

import numpy as np

#: storage dtype per mode — "bfloat16" is the bytes-halving notch;
#: everything else stores float32 planes/tables
STORAGE_DTYPES = {
    "bf16": "bfloat16",
    "default": "float32",
    "split3": "float32",
    "highest": "float32",
    "fp32": "float32",
}

#: the per-mode error-budget contract: max L2 relative error vs the
#: float64 reference
ERROR_BUDGETS = {
    "bf16": 3e-2,      # storage quantization across log2(n) stages
    "default": 1e-2,   # 1-pass bf16 MXU tail on the TPU
    "split3": 1e-5,    # 3-pass error split on the TPU
    "highest": 5e-6,
    "fp32": 5e-6,
}

#: every plan-level precision mode
PRECISIONS = tuple(STORAGE_DTYPES)

#: quality-direction promotion chain, loosest budget first
PROMOTE_CHAIN = ("bf16", "default", "split3", "fp32")


def _check_mode(mode: str) -> str:
    if mode not in STORAGE_DTYPES:
        raise ValueError(
            f"unknown precision mode {mode!r} (modes: {PRECISIONS})")
    return mode


def storage_dtype(mode: str) -> str:
    """The dtype planes and twiddle tables are STORED as for `mode`."""
    return STORAGE_DTYPES[_check_mode(mode)]


def ported_storage(mode: str) -> str:
    """``storage_dtype(mode)`` for the modes this port serves; raises
    NotImplementedError for bf16 storage."""
    storage = storage_dtype(mode)
    if storage != "float32":
        raise NotImplementedError("bf16 storage is not ported yet")
    return storage


def rel_err(got_r, got_i, ref_r, ref_i) -> float:
    """L2 relative error of split-plane output vs a (float64)
    reference — the budget contract's metric.  Accepts numpy arrays or
    tensors (on any device)."""
    def f64(a):
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64)

    gr, gi, rr, ri = f64(got_r), f64(got_i), f64(ref_r), f64(ref_i)
    num = np.sqrt(np.sum((gr - rr) ** 2 + (gi - ri) ** 2))
    den = np.sqrt(np.sum(rr ** 2 + ri ** 2))
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return float(num / den)
