"""The one collective-call layer of the port (the reference's
``parallel/collectives.py``, its check rule PIF108).

Every inter-rank collective the port dispatches goes through this
module: a collective call site scattered elsewhere would be one the
supervisor cannot see and the escape path cannot re-plan around.  The
entry points that dispatch one arm supervision around it
(``resilience.supervise_collective``); the helper here is the dispatch
they guard.  ``multihost.py``'s process-group set-up and its store
(the fallback consensus) are the only other users of
``torch.distributed``.

No policy lives here: tiled-transpose semantics only, so the escape
path (``parallel/escape.py``) can reproduce the dataflow without the
collective.  :data:`COLLECTIVE_CALLS` counts every dispatch: it is the
port's counterpart of the reference's check that a compiled program
holds (or lacks) collective ops.
"""

from __future__ import annotations

import torch

#: collectives this process has dispatched (read it as
#: ``collectives.COLLECTIVE_CALLS``)
COLLECTIVE_CALLS = 0


def all_to_all(v, axis: str, split_axis: int, concat_axis: int, *,
               mesh):
    """Tiled ``all_to_all`` over the mesh axis `axis` (the semantics of
    ``jax.lax.all_to_all(..., tiled=True)``): `v` is split along
    `split_axis` into p chunks, chunk j goes to the axis's rank j, and
    the chunks received are concatenated along `concat_axis` in the
    order of their senders.  The 2-D FFT's and the slab Poisson
    solve's transpose.  One ``all_to_all_single`` over a contiguous
    buffer of the p chunks."""
    import torch.distributed as dist

    global COLLECTIVE_CALLS
    p = mesh.shape[axis]
    d = v.shape[split_axis]
    if d % p:
        raise ValueError(f"all_to_all: axis {split_axis} of length {d} "
                         f"does not split into {p} chunks")
    group = mesh.group(axis)
    moved = v.movedim(split_axis, 0)
    send = moved.reshape((p, d // p) + tuple(moved.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    COLLECTIVE_CALLS += 1
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat([c.movedim(0, split_axis) for c in recv.unbind(0)],
                     dim=concat_axis)
