"""3-D spectral Poisson solver with slab decomposition (BASELINE config
5; the reference's ``parallel/poisson3d.py``): solve lap(u) = f on a
periodic [0, 2 pi)^3 grid.

A thin shim: the slab pipeline — per-slab FFTs over axes 1-2, one
all_to_all transpose to localize axis 0, the axis-0 FFT, a real
spectral multiplier, the inverted pipeline — lives in ``apps/pde.py``
as ``solve_spectral_sharded``.  This module keeps the Poisson names
and adds the recovery loop (:func:`poisson_solve_sharded_resilient`).
"""

from __future__ import annotations

from ..utils.device import as_plane


def poisson_solve_sharded(f, mesh, axis: str = "p"):
    """u with lap(u) = f, zero-mean: `f` this rank's real (n1/p, n2, n3)
    slab; returns its slab of u.  n1 and n2 must be divisible by the
    axis size."""
    from ..apps.pde import poisson_multiplier, solve_spectral_sharded

    return solve_spectral_sharded(f, mesh, axis, poisson_multiplier)


def poisson_solve_sharded_resilient(f, mesh, axis: str = "p",
                                    deadline_s: float | None = None,
                                    abort_waits: int | None = None):
    """Self-healing slab Poisson solve: `f` the whole real (n1, n2, n3)
    field on every rank; the two-transpose pipeline runs on the rank's
    slab under collective supervision and escapes to the collective-free
    path when a transpose wedges or a position of the mesh is reported
    unhealthy.  Returns ``(u, ShardedRunReport)``: `u` this rank's
    (n1/p, n2, n3) slab, bit-identical either way."""
    from .escape import poisson_solve_collective_free, run_with_escape
    from .fft2d import block

    f = as_plane(f, mesh.device)
    n1, n2, n3 = f.shape
    p = mesh.shape[axis]

    def primary():
        return block(poisson_solve_sharded(mesh.block(f, axis), mesh, axis))

    def escape():
        return poisson_solve_collective_free(f, mesh, axis)

    return run_with_escape(
        primary, escape,
        f"poisson3d all_to_all ({n1}x{n2}x{n3}, p={p})", mesh,
        deadline_s=deadline_s, abort_waits=abort_waits)
