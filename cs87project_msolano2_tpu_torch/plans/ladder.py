"""The static ladder: which variant serves a key, and its executor.

Variants (the reference's names where a kernel exists):

* ``rows``   — ops.cuda_fft.fft_rows_cuda: each power-of-two row
               (128..2^16 points) through the tile kernel (rows past
               2^14 as a per-row rql); the batched hot path.
* ``rql``    — ops.cuda_fft.fft_pi_layout_cuda_rql: the long-range
               kernel, then the tile kernel; 1-D n above MAX_ROW_TILE
               and below FOURSTEP_MIN_N.
* ``fourstep`` — ops.cuda_fft.fft_pi_layout_cuda_fourstep: the whole
               transform in one cooperative launch; 1-D
               FOURSTEP_MIN_N <= n < SIXSTEP_MIN_N.
* ``sixstep`` — ops.cuda_fft.fft_pi_layout_cuda_sixstep: the whole
               transform with the long-range levels split in two, in
               one cooperative launch; 1-D n >= SIXSTEP_MIN_N.
* ``stages`` — the all-float32 stage path (models.fft.fft_planes); the
               reference calls this variant ``jnp``.  Natural order only;
               serves every shape no kernel covers.

``fused``, ``fused-alias``, ``two-kernel`` and ``mf`` are not ported
yet and raise ValueError, and so does ``separable=False`` (dense
long-range tables) for fourstep and sixstep.  The crossovers follow the
reference (``ladder.py:54-69``, ``353-386``) and depend only on the key,
never on whether a card is present, so CPU tests exercise the same
composition the card runs.  The plan parameter ``tail`` is gone: the
port's tile kernel runs its last levels as fp32 butterflies, not a
matmul tail.
"""

from __future__ import annotations

import math

from ..ops.bits import is_power_of_two
from ..ops.cuda_fft import (
    MAX_ROW_TILE,
    MAX_SMEM_TILE,
    fourstep_blocking,
    rows_plan_feasible,
    sixstep_blocking,
)
from ..ops.precision import ported_storage
from .core import PlanKey

UNPORTED = ("fused", "fused-alias", "two-kernel", "mf")

#: the reference's crossovers (its ladder.py:61 and :69): fourstep from
#: here, rql below
FOURSTEP_MIN_N = 1 << 21
#: sixstep from here, fourstep below
SIXSTEP_MIN_N = 1 << 25


def _nrows(key: PlanKey) -> int:
    return math.prod(key.batch) or 1


def _check_ported(key: PlanKey) -> None:
    ported_storage(key.precision)
    if key.domain != "c2c":
        raise ValueError(f"domain {key.domain!r} is not ported yet")
    if not is_power_of_two(key.n):
        raise ValueError(f"any-length n={key.n} (variants bluestein/"
                         f"rader/mixedradix) is not ported yet")


def _fourstep_feasible(n: int) -> bool:
    """Can the fourstep kernel serve an n-point transform at tile
    MAX_SMEM_TILE?  False once its narrowest column block no longer fits
    shared memory, so the static default never serves a plan that
    raises on first execute."""
    try:
        fourstep_blocking(n, MAX_SMEM_TILE)
    except ValueError:
        return False
    return True


def _sixstep_feasible(n: int) -> bool:
    """Can the sixstep kernel serve an n-point transform at tile
    MAX_SMEM_TILE?  Needs R = n/tile >= 4 and column blocks that fit."""
    try:
        sixstep_blocking(n, MAX_SMEM_TILE)
    except ValueError:
        return False
    return True


def static_default(key: PlanKey):
    """(variant, params) for `key`: ``rows`` for a feasible batch of
    rows; for a 1-D n above MAX_ROW_TILE (tile 2^14, the largest
    shared-memory tile; None = the automatic block or split) ``sixstep``
    from SIXSTEP_MIN_N, ``fourstep`` from FOURSTEP_MIN_N, and ``rql``
    below that or where neither is feasible; the stage path elsewhere
    (natural order only)."""
    _check_ported(key)
    if rows_plan_feasible(_nrows(key), key.n):
        return "rows", {}
    if key.batch == () and key.n > MAX_ROW_TILE:
        if key.n >= SIXSTEP_MIN_N and _sixstep_feasible(key.n):
            return "sixstep", {"tile": MAX_SMEM_TILE, "r2": None,
                               "cb1": None, "cb2": None, "separable": True}
        if FOURSTEP_MIN_N <= key.n < SIXSTEP_MIN_N and \
                _fourstep_feasible(key.n):
            return "fourstep", {"tile": MAX_SMEM_TILE, "cb": None,
                                "separable": True}
        return "rql", {"tile": MAX_SMEM_TILE, "cb": None}
    if key.layout != "natural":
        raise ValueError(
            f"pi-layout output requires a kernel-eligible shape "
            f"(power-of-two trailing axis 128..{MAX_ROW_TILE}, or a 1-D "
            f"n above it), got batch={key.batch} n={key.n}")
    return "stages", {}


def build_executor(key: PlanKey, variant: str, params: dict):
    """The (xr, xi) -> (yr, yi) executor for one ladder entry.  Raises
    ValueError for unported variants and for infeasible tile/cb before
    anything launches."""
    from ..ops import cuda_fft
    from ..ops.bits import to_natural

    _check_ported(key)
    natural = key.layout == "natural"
    if variant in UNPORTED:
        raise ValueError(f"variant {variant!r} not ported yet")
    if variant == "stages":
        if not natural:
            raise ValueError("the stage path only produces natural order")
        from ..models.fft import fft_planes

        return fft_planes
    if variant == "rows":
        def rows_run(xr, xi):
            return cuda_fft.fft_rows_cuda(xr, xi, natural=natural)

        return rows_run
    if variant not in ("rql", "fourstep", "sixstep"):
        raise ValueError(f"unknown plan variant {variant!r}")
    if key.batch != ():
        raise ValueError(f"variant {variant!r} is a 1-D whole-transform "
                         f"path; key has batch={key.batch}")
    tile = params.get("tile")
    if variant == "rql":
        cb = params.get("cb")
        cuda_fft.rql_blocking(key.n, tile, cb)

        def run(xr, xi):
            return cuda_fft.fft_pi_layout_cuda_rql(xr, xi, tile, cb)
    else:
        if not params.get("separable", True):
            raise ValueError(f"variant {variant!r} with separable=False "
                             f"(dense long-range tables) is not ported "
                             f"yet")
        if variant == "fourstep":
            cb = params.get("cb")
            fourstep_blocking(key.n, tile, cb)

            def run(xr, xi):
                return cuda_fft.fft_pi_layout_cuda_fourstep(xr, xi, tile, cb)
        else:
            r2, cb1, cb2 = (params.get(k) for k in ("r2", "cb1", "cb2"))
            sixstep_blocking(key.n, tile, r2, cb1, cb2)

            def run(xr, xi):
                return cuda_fft.fft_pi_layout_cuda_sixstep(xr, xi, tile, r2,
                                                           cb1, cb2)

    def whole_run(xr, xi):
        yr, yi = run(xr, xi)
        return to_natural(yr, yi) if natural else (yr, yi)

    return whole_run
