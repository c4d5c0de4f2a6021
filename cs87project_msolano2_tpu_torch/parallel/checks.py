"""The rank programs of the local jobs that hold the parallel layer
against the reference's on the CPU (``tests/test_torch_parallel.py``,
``tests/test_torch_multichip_recovery.py``).

Each is a module-level function of the port handed to
``multihost.spawn_local``, so a spawned rank imports the port and
nothing of its caller's.  A rank builds its meshes, takes its blocks of
the whole inputs (``Mesh.block``), runs every case's entry point and
returns ``{label: multihost.call_record(...)}``; the caller assembles
the ranks' blocks and compares them.
"""

from __future__ import annotations


def parallel_rank(x: dict) -> dict:
    """The sharded configs on this rank (a job of 8: the 2-D mesh is
    2 x 4).  `x`: the whole inputs by case — ``pi``, ``pi_batched``,
    ``batched_fwd``, ``batched_pi``, ``fft2``, ``fft2_rt`` as
    (re, im) planes; ``batched``, ``rfft``, ``poisson``, ``solve`` as
    one array."""
    from ..apps.pde import helmholtz_solve_sharded, spectral_step_sharded
    from .batched import (
        fft_batched_planes,
        fft_batched_sharded,
        rfft_batched_sharded,
    )
    from .fft2d import fft2_sharded
    from .mesh import make_mesh, make_mesh2d
    from .multihost import call_record, loaded_packages
    from .pi_shard import pi_fft_sharded, pi_fft_sharded_batched
    from .poisson3d import poisson_solve_sharded

    mesh, data = make_mesh(), make_mesh(axis="data")
    mesh2 = make_mesh2d(2, mesh.size // 2)

    def rows(a, m=data, axis="data"):
        return m.block(a, axis).copy()

    def row_planes(key, m=data, axis="data"):
        return tuple(rows(a, m, axis) for a in x[key])

    def slab(key):
        return rows(x[key], mesh, "p")

    r = {"pi": call_record(pi_fft_sharded, *x["pi"], mesh),
         "pi_batched": call_record(pi_fft_sharded_batched,
                                   *row_planes("pi_batched", mesh2), mesh2),
         "batched": call_record(fft_batched_sharded, rows(x["batched"]),
                                data),
         "batched_fwd": call_record(fft_batched_planes,
                                    *row_planes("batched_fwd"), data),
         "batched_inv": call_record(fft_batched_planes,
                                    *row_planes("batched_fwd"), data,
                                    inverse=True),
         "batched_pi": call_record(fft_batched_planes,
                                   *row_planes("batched_pi"), data,
                                   natural=False),
         "rfft": call_record(rfft_batched_sharded, rows(x["rfft"]), data),
         "fft2": call_record(fft2_sharded, slab("fft2"), mesh),
         "fft2_rt": call_record(fft2_sharded, slab("fft2_rt"), mesh),
         "poisson": call_record(poisson_solve_sharded, slab("poisson"),
                                mesh),
         "helmholtz": call_record(helmholtz_solve_sharded, slab("solve"),
                                  mesh, alpha=2.5),
         "heat": call_record(spectral_step_sharded, slab("solve"), mesh,
                             nu=0.3, dt=0.01, steps=3)}
    # the round trips: each rank's rows of the forward result straight
    # into the inverse (both entries take and return the rank's rows)
    r["batched_rt"] = call_record(fft_batched_planes,
                                  *r["batched_fwd"]["out"], data,
                                  inverse=True)
    r["fft2_back"] = call_record(fft2_sharded, r["fft2_rt"]["out"], mesh,
                                 inverse=True)
    r["packages"] = call_record(loaded_packages)
    return r


def recovery_rank(x: dict, drill: dict) -> dict:
    """The escape against the primary path on this rank, and the stall
    drills (`drill`: their supervision and stall).  `x`: ``fft2`` the
    whole complex (R, C) input, ``poisson`` the whole real field, and
    the drills' ``fft2_drill`` and ``poisson_drill``."""
    from .escape import (
        fft2_collective_free_planes,
        poisson_solve_collective_free,
        stall_drill,
    )
    from .fft2d import fft2_sharded_planes
    from .mesh import make_mesh
    from .multihost import call_record
    from .poisson3d import poisson_solve_sharded

    mesh = make_mesh()
    xr, xi = x["fft2"].real.copy(), x["fft2"].imag.copy()
    r = {}
    for label, inverse in (("fft2", False), ("ifft2", True)):
        r[label] = call_record(fft2_sharded_planes, mesh.block(xr, "p"),
                               mesh.block(xi, "p"), mesh, inverse=inverse)
        r[label + "_escape"] = call_record(fft2_collective_free_planes, xr,
                                           xi, mesh, inverse=inverse)
    r["poisson"] = call_record(poisson_solve_sharded,
                               mesh.block(x["poisson"], "p").copy(), mesh)
    r["poisson_escape"] = call_record(poisson_solve_collective_free,
                                      x["poisson"], mesh)
    for entry in ("fft2", "poisson"):
        r[entry + "_drill"] = call_record(stall_drill, entry,
                                          x[entry + "_drill"], mesh,
                                          **drill)
    return r


def consensus_rank(label: str, deadline_s: float) -> dict:
    """This rank's ``agree_on_fallback`` through the job's store."""
    from .multihost import agree_on_fallback, call_record

    return call_record(agree_on_fallback, label, reason="test",
                       deadline_s=deadline_s)
