"""Debug checks (the reference's ``utils/debug.py``).

The pi-FFT is correct by construction: disjoint write segments and no
locks.  What the port adds on top:

* ``enable_checks()`` / ``disable_checks()`` — the counterpart of the
  reference's ``jax_debug_nans``/``jax_debug_infs``: while on, the
  backends' ``run`` and ``Plan.execute`` check that each phase's output
  is finite and raise ``FloatingPointError`` naming the phase, so a bad
  twiddle or an overflow stops at the phase that produced it instead of
  corrupting a benchmark.  The check reads the planes back to the host,
  so a call under it cannot be captured in a CUDA graph; it is off by
  default.
* ``assert_disjoint_cover(...)`` — a static check that a grid of
  contiguous row blocks tiles its output exactly.
"""

from __future__ import annotations

#: whether ``check_finite`` checks; set by enable_checks/disable_checks
_CHECKS = {"on": False}


def enable_checks() -> None:
    _CHECKS["on"] = True


def disable_checks() -> None:
    _CHECKS["on"] = False


def check_finite(phase: str, *planes) -> None:
    """Raise FloatingPointError when checks are on and any of `planes`
    (tensors or numpy arrays) holds a NaN or an infinity."""
    if not _CHECKS["on"]:
        return
    import numpy as np
    import torch

    for a in planes:
        finite = (bool(torch.isfinite(a).all()) if isinstance(a, torch.Tensor)
                  else bool(np.isfinite(a).all()))
        if not finite:
            raise FloatingPointError(
                f"non-finite values in the output of the {phase} phase")


def assert_disjoint_cover(total_rows: int, block_rows: int, ntiles: int):
    """A grid of `ntiles` contiguous blocks of `block_rows` rows must
    cover [0, total_rows) exactly once.  Contiguous blocks cannot
    overlap, so the product check is the whole assertion."""
    if block_rows * ntiles != total_rows:
        raise AssertionError(
            f"grid does not tile output: {ntiles} x {block_rows} != "
            f"{total_rows}"
        )
