"""Precision modes: what planes and tables are stored as, how the
funnel's matrix products are computed, and how much error each mode may
show.

The mode table is the reference's (``ops/precision.py``), so a PlanKey
means the same contract in both packages:

    mode       storage    matrix product (dot)         rel-err budget
    ---------  ---------  ---------------------------  --------------
    bf16       bfloat16   1 bf16 product                3e-2
    default    float32    1 bf16 product                1e-2
    split3     float32    3 bf16 products (hi/lo)       1e-5
    highest    float32    6 bf16 products (hi/mid/lo)   5e-6
    fp32       float32    6 bf16 products (hi/mid/lo)   5e-6

The dot is where the modes differ: the matmul funnel (``mf``,
``csrc/mf.cu``) runs B @ X on the tensor cores as bf16 products with
float32 accumulation.  Each operand is cut into ``split_levels(mode)``
bf16 planes, each rounded to nearest even from what the planes before
it left (x = x_hi + x_lo, or x_hi + x_mid + x_lo), and the products of
plane i of one operand and plane j of the other are summed for i + j <
levels: 1 product (hi*hi) for default, 3 for split3 (the dropped lo*lo
term is about 2^-16 relative), 6 for highest and fp32 — the 6-pass
split that XLA's HIGHEST runs on the TPU's MXU, here on the tensor
cores, not as float32 FMAs (PERF.md has the error each mode measured).
bf16 products are exact in float32, so the plain ``make_dot`` below
(products of the same planes in float32) computes the same sum in
another order.

Every other level of the port runs as float32 butterflies, which meet
the tightest fp32-storage budget in every mode.  bf16 storage is not
ported yet (``ported_storage`` raises).
"""

from __future__ import annotations

from typing import Optional

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

#: quality-direction promotion chain, loosest budget first: a mode over
#: its budget promotes to the next entry; "highest" is fp32's twin
PROMOTE_CHAIN = ("bf16", "default", "split3", "fp32")

#: the error-compensated mode of the funnel's dot, and the default
SPLIT3 = "split3"

#: bf16 planes each operand of the funnel's dot is cut into, per mode
SPLIT_LEVELS = {
    "bf16": 1,
    "default": 1,
    "split3": 2,
    "highest": 3,
    "fp32": 3,
}

#: modes a tuning race for a requested mode may pin per candidate: the
#: request is an error-budget floor, so a tighter-budget storage rides
#: in the same race, never a looser one (the reference's
#: RACE_ALTERNATES; only bf16 expands, and bf16 storage is not ported)
RACE_ALTERNATES = {"bf16": ("bf16", "split3")}


def _check_mode(mode: str) -> str:
    if mode not in STORAGE_DTYPES:
        raise ValueError(
            f"unknown precision mode {mode!r} (modes: {PRECISIONS})")
    return mode


def storage_dtype(mode: str) -> str:
    """The dtype planes and twiddle tables are STORED as for `mode`."""
    return STORAGE_DTYPES[_check_mode(mode)]


def split_levels(mode: str) -> int:
    """bf16 planes each operand is cut into for `mode`'s dot (1, 2 or
    3)."""
    return SPLIT_LEVELS[_check_mode(mode)]


def dot_passes(mode: str) -> int:
    """bf16 tensor-core products per matrix product for `mode`: the
    L (L + 1) / 2 plane pairs with i + j < L, so 1 for default and bf16,
    3 for split3, 6 for highest and fp32."""
    levels = split_levels(mode)
    return levels * (levels + 1) // 2


def race_modes(mode: str) -> tuple:
    """The precision modes a tuning race for a key requesting `mode`
    tries, expected winner first."""
    return RACE_ALTERNATES.get(_check_mode(mode), (mode,))


def promote(mode: str) -> Optional[str]:
    """The next-tighter mode in the quality chain, or None at (or above)
    the top: fp32 and highest have nowhere tighter to go."""
    _check_mode(mode)
    if mode not in PROMOTE_CHAIN:
        return None
    i = PROMOTE_CHAIN.index(mode)
    return PROMOTE_CHAIN[i + 1] if i + 1 < len(PROMOTE_CHAIN) else None


def bf16_split(x, levels: int) -> list:
    """float32 tensor `x` cut into `levels` bf16 planes, each the
    round-to-nearest-even of what the planes before it left: x_hi =
    bf16(x), x_lo = bf16(x - x_hi), x_lo2 = bf16(x - x_hi - x_lo).  Each
    subtraction is exact in float32."""
    import torch

    planes, rest = [], x
    for _ in range(levels):
        p = rest.to(torch.bfloat16)
        planes.append(p)
        rest = rest - p.to(torch.float32)
    return planes


def make_dot(mode: str):
    """Plain (m, k) @ (k, n) under `mode`: both float32 operands cut by
    ``bf16_split`` into ``split_levels(mode)`` planes, and the products
    of plane i and plane j for i + j < levels summed in float32 — the
    sum the funnel kernel's tensor-core passes compute."""
    import torch

    levels = split_levels(mode)

    def dot(x, b):
        xs = [p.to(torch.float32) for p in bf16_split(x, levels)]
        bs = [p.to(torch.float32) for p in bf16_split(b, levels)]
        out = None
        # smallest terms first, as the kernel accumulates them
        for s in range(levels - 1, -1, -1):
            for i in range(s + 1):
                term = xs[i] @ bs[s - i]
                out = term if out is None else out + term
        return out

    return dot


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
