"""Device meshes for multi-process SPMD (the reference's
``parallel/mesh.py``).

The reference runs one controller over a ``jax.sharding.Mesh`` and maps
a body over its devices with ``shard_map``.  The port runs one process
(rank) per mesh position on ``torch.distributed``: a :class:`Mesh` is
this rank's view of the job — the size of each named axis
(``mesh.shape``), this rank's coordinate on each (``mesh.axis_index``,
the counterpart of ``jax.lax.axis_index``), one process group per axis
(the ranks that share every other coordinate) and the rank's device,
the card unless the caller asks for the CPU.  The sharded entry points
take and return this rank's blocks, as the reference's per-device bodies
do.

A mesh built without process groups (``Mesh(...)`` directly) stands for
one position of a mesh in a process of its own: the collective-free
paths (the pi-FFT, the batched FFT, the escape) run on it, and any
collective raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

#: the device a launcher (``multihost.spawn_local``) gave this process's
#: meshes; None: the card
_LAUNCH_DEVICE: list = [None]


@contextlib.contextmanager
def launch_device(device):
    """Make `device` the default of ``make_mesh``/``make_mesh2d`` within
    the block (what ``multihost.spawn_local`` does for each rank)."""
    saved = _LAUNCH_DEVICE[0]
    _LAUNCH_DEVICE[0] = device
    try:
        yield
    finally:
        _LAUNCH_DEVICE[0] = saved


def _position_device(device, rank: int) -> torch.device:
    """The device of the mesh position held by `rank`: `device` (default
    the launcher's, else the card), a card with no index taking card
    ``rank % count`` — one rank a card where the cards suffice, ranks
    sharing them where they do not."""
    from ..utils.device import resolve_device

    dev = resolve_device(_LAUNCH_DEVICE[0] if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class Mesh:
    """This rank's view of a named-axis mesh: ``shape`` (axis -> size,
    in axis order), ``axis_index(axis)``, ``group(axis)``, ``device``
    and ``devices`` (the device of every position, in rank order).
    `device` None is the launcher's device, else the card (raising
    where there is none); pass ``"cpu"`` to run on the host."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 coords: Sequence[int], device=None,
                 groups: Optional[dict] = None,
                 devices: Optional[Sequence] = None):
        if len(axis_names) != len(sizes) or len(sizes) != len(coords):
            raise ValueError("axis_names, sizes and coords differ in "
                             "length")
        for name, size, c in zip(axis_names, sizes, coords):
            if not 0 <= c < size:
                raise ValueError(f"coordinate {c} outside axis {name!r} "
                                 f"of size {size}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self._coords = dict(zip(self.axis_names, (int(c) for c in coords)))
        flat = 0
        for name in self.axis_names:
            flat = flat * self.shape[name] + self._coords[name]
        self.device = _position_device(device, flat)
        self._groups = dict(groups or {})
        self.devices = tuple(str(d) for d in devices) if devices \
            else (str(self.device),) * self.size

    @property
    def size(self) -> int:
        out = 1
        for s in self.shape.values():
            out *= s
        return out

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self._coords[axis]

    def block(self, v, axis: str, dim: int = 0):
        """This rank's block of `v` (a tensor or a numpy array): its
        share of dimension `dim` split evenly over mesh axis `axis` (a
        view)."""
        p, i = self.shape[axis], self._coords[axis]
        b = v.shape[dim] // p
        return v[(slice(None),) * dim + (slice(i * b, (i + 1) * b),)]

    def group(self, axis: str):
        """The process group of `axis` (this rank and the ranks that
        share its other coordinates)."""
        if axis not in self._groups:
            raise RuntimeError(
                f"mesh axis {axis!r} has no process group: this mesh is "
                f"one position without a job (build it with make_mesh "
                f"under init_distributed or spawn_local to dispatch "
                f"collectives)")
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, at {self._coords}, on "
                f"{self.device})")


def _job() -> tuple:
    """(world size, rank) of this process's job; (1, 0) outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: Optional[int] = None, axis: str = "p",
              device=None) -> Mesh:
    """1-D mesh over the job's ranks (n_devices, default all of them,
    must be the world size: every rank holds one position)."""
    import torch.distributed as dist

    world, rank = _job()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"need {n_devices} devices, have {world} ranks "
                         f"(a rank-local mesh spans the whole job)")
    groups = {axis: dist.group.WORLD} if dist.is_initialized() else {}
    return Mesh((axis,), (world,), (rank,), _position_device(device, rank),
                groups,
                [_position_device(device, r) for r in range(world)])


def make_mesh2d(dp: int, p: int, axes: Sequence[str] = ("data", "p"),
                device=None) -> Mesh:
    """(dp x p) mesh: data-parallel batches x pi-decomposition segments.
    Rank r sits at (r // p, r % p).  Every rank creates every axis group
    in the same order (``dist.new_group`` is collective over the job)
    and keeps the two it belongs to."""
    import torch.distributed as dist

    world, rank = _job()
    if dp * p != world:
        raise ValueError(f"need {dp * p} devices, have {world} ranks")
    data_axis, seq_axis = axes
    groups = {}
    if dist.is_initialized():
        for d in range(dp):
            g = dist.new_group([d * p + j for j in range(p)])
            if rank // p == d:
                groups[seq_axis] = g
        for j in range(p):
            g = dist.new_group([d * p + j for d in range(dp)])
            if rank % p == j:
                groups[data_axis] = g
    return Mesh(tuple(axes), (dp, p), (rank // p, rank % p),
                _position_device(device, rank), groups,
                [_position_device(device, r) for r in range(world)])


def how_many_devices() -> int:
    """The job's world size, 1 outside a job (the reference's capacity
    probe counts its devices)."""
    return _job()[0]
