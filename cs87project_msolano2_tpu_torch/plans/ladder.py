"""The static ladder: which variant serves a key, and its executor.

Variants (the reference's names where a kernel exists):

* ``rows``   — ops.cuda_fft.fft_rows_cuda: each power-of-two row
               (128..2^16 points) through the tile kernel (rows past
               2^14 as a per-row rql); the batched hot path.
* ``rql``    — ops.cuda_fft.fft_pi_layout_cuda_rql: the long-range
               kernel, then the tile kernel; 1-D n above MAX_ROW_TILE.
* ``stages`` — the all-float32 stage path (models.fft.fft_planes); the
               reference calls this variant ``jnp``.  Natural order only;
               serves every shape no kernel covers.

``fused``, ``fused-alias``, ``fourstep``, ``sixstep``, ``two-kernel``
and ``mf`` are not ported yet and raise ValueError.  The crossovers
follow the reference (``ladder.py:353-386``) and depend only on the key,
never on whether a card is present, so CPU tests exercise the same
composition the card runs.  The plan parameter ``tail`` is gone: the
port's tile kernel runs its last levels as fp32 butterflies, not a
matmul tail.
"""

from __future__ import annotations

import math

from ..ops.cuda_fft import MAX_ROW_TILE, MAX_SMEM_TILE, rows_plan_feasible
from ..ops.bits import is_power_of_two
from ..ops.precision import ported_storage
from .core import PlanKey

UNPORTED = ("fused", "fused-alias", "fourstep", "sixstep", "two-kernel",
            "mf")


def _nrows(key: PlanKey) -> int:
    return math.prod(key.batch) or 1


def _check_ported(key: PlanKey) -> None:
    ported_storage(key.precision)
    if key.domain != "c2c":
        raise ValueError(f"domain {key.domain!r} is not ported yet")
    if not is_power_of_two(key.n):
        raise ValueError(f"any-length n={key.n} (variants bluestein/"
                         f"rader/mixedradix) is not ported yet")


def static_default(key: PlanKey):
    """(variant, params) for `key`: ``rows`` for a feasible batch of
    rows, ``rql`` for a 1-D n above MAX_ROW_TILE (tile 2^14, the
    largest shared-memory tile; cb None = the auto column block), the
    stage path elsewhere (natural order only)."""
    _check_ported(key)
    if rows_plan_feasible(_nrows(key), key.n):
        return "rows", {}
    if key.batch == () and key.n > MAX_ROW_TILE:
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
    if variant != "rql":
        raise ValueError(f"unknown plan variant {variant!r}")
    if key.batch != ():
        raise ValueError(f"variant 'rql' is a 1-D whole-transform path; "
                         f"key has batch={key.batch}")
    tile, cb = params.get("tile"), params.get("cb")
    cuda_fft.rql_blocking(key.n, tile, cb)

    def rql_run(xr, xi):
        yr, yi = cuda_fft.fft_pi_layout_cuda_rql(xr, xi, tile, cb)
        return to_natural(yr, yi) if natural else (yr, yi)

    return rql_run
