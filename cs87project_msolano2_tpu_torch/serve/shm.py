"""The same-host shared-memory lane: a slot ring of staging planes (the
reference's ``serve/shm.py``).

A sidecar caller on the serving host should not pay the socket for
megabyte planes.  The shm lane moves only CONTROL over the framed
socket: the client writes its request planes into a slot of a
shared-memory ring, sends a binary REQUEST frame with ``F_SHM`` and the
slot index (``payload_len`` 0), and the server maps the slot as float32
views.  Results are written back into the SAME slot and answered with an
``F_SHM`` RESPONSE; the client owns the slot again once the response
frame arrives.

Lifecycle: the ring is per connection.  The server creates it when a
HELLO carries ``F_WANT_SHM`` and the front was started with ``serve
--shm``; the HELLO_ACK grants the segment name (payload), slot count
(``n``) and slot size (``width``); the client attaches by name.  The
server closes AND unlinks the segment when the connection ends, so a
vanished client cannot leak host memory.  The credit window bounds
in-flight requests, so a well-behaved client never needs more slots
than credits.

The slot write/read-back copies are the transport itself, not a decode:
they are not charged to the host-copy meter (``serve/wire.py``), and the
wire smoke asserts the shm round trip's metered delta is zero.
"""

from __future__ import annotations

import secrets
from multiprocessing import shared_memory
from typing import Optional

import numpy as np


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """Take the segment out of the resource tracker's hands: CPython
    registers ATTACHING handles too (bpo-38119), so a client exit
    would warn about — and may unlink — a segment the server still
    owns, and a same-process attach (tests, the wire smoke) would
    unbalance the tracker's cache.  Lifecycle here is explicit
    instead: the owning server closes AND unlinks on connection end."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # pragma: no cover - tracker internals moved
        pass


class ShmRing:
    """``slots`` fixed-size byte slots over one SharedMemory segment.

    Each slot holds two contiguous float32 planes (``xr`` then ``xi``)
    of up to ``slot_bytes // 8`` elements each."""

    def __init__(self, shm: shared_memory.SharedMemory, slots: int,
                 slot_bytes: int, owner: bool):
        self._shm = shm
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.owner = owner

    @property
    def name(self) -> str:
        return self._shm.name

    @classmethod
    def create(cls, slots: int, slot_bytes: int) -> "ShmRing":
        if slots < 1 or slot_bytes < 8:
            raise ValueError(f"shm ring needs >=1 slot of >=8 bytes, "
                             f"got {slots}x{slot_bytes}")
        name = f"pifft-{secrets.token_hex(6)}"
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=slots * slot_bytes)
        _untrack(shm)
        return cls(shm, slots, slot_bytes, owner=True)

    @classmethod
    def attach(cls, name: str, slots: int, slot_bytes: int) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name)
        if slots < 1 or slot_bytes < 8 or slots * slot_bytes > shm.size:
            # the geometry arrived over the wire (HELLO_ACK); a ring
            # that does not fit the mapped segment would hand out slot
            # views past the end of the buffer
            shm.close()
            raise ValueError(f"ring geometry {slots}x{slot_bytes} does "
                             f"not fit the {shm.size}-byte segment")
        _untrack(shm)
        return cls(shm, slots, slot_bytes, owner=False)

    def _slot_view(self, slot: int) -> memoryview:
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range "
                             f"(ring has {self.slots})")
        base = slot * self.slot_bytes
        return self._shm.buf[base:base + self.slot_bytes]

    def slot_planes(self, slot: int, width: int,
                    no_xi: bool = False):
        """Zero-copy float32 ``(xr, xi)`` views over one slot — the
        server-side landing, same contract as
        :func:`~.buffers.landing_views`."""
        need = width * 4 * (1 if no_xi else 2)
        if need > self.slot_bytes:
            raise ValueError(f"width {width} needs {need} bytes, slot "
                             f"holds {self.slot_bytes}")
        view = self._slot_view(slot)
        xr = np.frombuffer(view, np.float32, count=width)
        xi = None if no_xi else np.frombuffer(
            view, np.float32, count=width, offset=width * 4)
        return xr, xi

    def write_planes(self, slot: int, xr: np.ndarray,
                     xi: Optional[np.ndarray] = None) -> None:
        """Land request planes in a slot (the client-side transport
        write — it replaces the socket's kernel copy)."""
        width = int(xr.shape[-1])
        dr, di = self.slot_planes(slot, width, no_xi=xi is None)
        np.copyto(dr, xr)
        if xi is not None:
            np.copyto(di, xi)

    def read_planes(self, slot: int, width: int,
                    no_xi: bool = False):
        """Client-side result views after the RESPONSE frame (copy
        them out before reusing the slot)."""
        return self.slot_planes(slot, width, no_xi=no_xi)

    def close(self) -> None:
        try:
            self._shm.close()
        except BufferError:
            # plane views over the segment usually die with their
            # request, but asyncio tasks park exceptions/callbacks in
            # reference cycles — collect and retry before giving up
            # (a still-held client view then keeps its mapping alive
            # until IT dies, which is the right behavior anyway)
            import gc

            gc.collect()
            try:
                self._shm.close()
            except BufferError:  # pragma: no cover - a view outlived us
                pass

    def unlink(self) -> None:
        """Owner-only: release the segment name (idempotent)."""
        if not self.owner:
            return
        # stdlib unlink() unconditionally UNregisters with the
        # tracker; balance the books for the registration _untrack
        # removed, or the tracker daemon logs a KeyError at exit
        try:
            from multiprocessing import resource_tracker

            resource_tracker.register(self._shm._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker internals moved
            pass
        try:
            self._shm.unlink()
        except FileNotFoundError:  # pragma: no cover - already gone
            pass
