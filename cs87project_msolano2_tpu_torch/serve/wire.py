"""The binary wire dialect: fixed-header frames, zero-copy payloads (the
reference's ``serve/wire.py``; frames are byte-identical to its own).

The JSON front (:mod:`.protocol`) is the protocol seam, not a
throughput path: at 2^20 floats per request, parsing JSON float lists
costs more than the FFT it feeds.  This module is the hot path: a
versioned little-endian header followed by the raw float planes, laid
out so the server lands client bytes directly as ``np.frombuffer``
views with no intermediate copy (no ``json.loads``, no per-element
Python floats); the batcher's staging copy into its pooled (pinned)
planes is the one host copy a request pays before the card.

Frame layout (``HEADER``, 48 bytes, little-endian)::

    offset  size  field        meaning
    0       4     magic        b"PIFB"
    4       2     version      wire version (1)
    6       2     flags        F_* bits below
    8       1     msg_type     MSG_* below
    9       1     op           index into WIRE_OPS
    10      1     domain       index into WIRE_DOMAINS
    11      1     precision    index into WIRE_PRECISIONS (0 = unset)
    12      1     priority     index into WIRE_PRIORITIES
    13      1     inverse      0/1
    14      1     dtype        0 = float32, 1 = bfloat16 (wire storage)
    15      1     (pad)        zero
    16      8     rid          request id (client-chosen, echoed back)
    24      4     n            transform length
    28      4     width        plane width in elements (n//2+1 for c2r)
    32      4     extras_len   UTF-8 JSON metadata blob length
    36      4     slot         shm slot index / stream chunk seq /
                               HELLO_ACK credit window
    40      8     payload_len  raw plane bytes after the extras blob

A frame is ``header + extras + payload``.  ``extras`` is a small JSON
metadata blob (tenant, trace context, the response's latency split),
bounded by ``MAX_EXTRAS_BYTES`` and not plane payload, so it is not
charged to the host-copy meter.  ``payload`` is the contiguous planes:
``xr`` then ``xi`` (``F_NO_XI`` when the imaginary plane is absent),
each ``width`` elements of the wire dtype.

Negotiation: the JSON dialect's length prefix is a 4-byte big-endian
length capped at ``protocol.MAX_FRAME_BYTES`` (2^28); ``b"PIFB"`` read
as a big-endian u32 is about 1.35e9, far above the cap, so the first
four bytes of a connection decide the dialect.  A binary client opens
with HELLO (its max version); the server answers HELLO_ACK with the
negotiated version and the credit window (``slot``), plus the shm lane
grant when negotiated.  A HELLO with an unsupported version is answered
with a JSON frame: the connection falls back to the JSON dialect with a
``serve_wire_fallback`` event; a malformed binary header closes the
connection with ``serve_conn_lost``; a frame truncated mid-payload is a
tolerated client disconnect, never a hang.

Flow control: the HELLO_ACK's credit window bounds in-flight requests
per connection.  A request consumes one credit; any terminal reply
(RESPONSE, ERROR, STREAM_END) returns it.  A client exceeding the
window gets a structured ``flow_control`` ERROR for the offending rid;
the connection survives.

The host-copy meter: ``pifft_host_copy_bytes_total{site}`` charges every
sanctioned copy of plane payload bytes on the serve front (the JSON
dialect's decode and encode, the bfloat16 wire upcast, streaming
reassembly).  The binary float32 path charges zero: the wire smoke
reads that from the meter.
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Optional

import numpy as np

MAGIC = b"PIFB"
WIRE_VERSION = 1

#: header: magic, version, flags, msg_type, op, domain, precision,
#: priority, inverse, dtype, pad, rid, n, width, extras_len, slot,
#: payload_len  (module docstring has the offset table)
HEADER = struct.Struct("<4sHHBBBBBBBBQIIIIQ")

#: metadata blob cap: extras are tenant/trace/latency metadata, never
#: plane data — a kilobyte-scale bound keeps a hostile header from
#: turning the metadata lane into an allocation vector
MAX_EXTRAS_BYTES = 1 << 16

#: plane payload cap (matches the JSON front's frame cap rationale)
MAX_PAYLOAD_BYTES = 1 << 30

#: transform-length / plane-width caps: ``n`` and ``width`` are header
#: fields a hostile client picks and downstream code spends as
#: ``frombuffer`` counts and staging sizes, so they are bounds-checked
#: HERE, at the decode boundary, before any size arithmetic sees them
#: (the reference's check rule PIF118).  Two float32 planes of ``width`` elements must
#: fit the payload cap; ``n`` bounds the transform any dispatcher
#: would admit.
MAX_WIRE_N = 1 << 28
MAX_WIRE_WIDTH = MAX_PAYLOAD_BYTES // 8

#: shm grant caps: HELLO_ACK reuses ``n``/``width`` as slot count and
#: slot bytes; a client must not size its free-slot list or map a ring
#: from a hostile server's numbers unchecked
MAX_SHM_SLOTS = 4096

#: per-connection flow-control window granted in HELLO_ACK
DEFAULT_CREDITS = 32

#: streaming responses chunk the payload at this size (overlap-save
#: results are long; a chunk bounds client reassembly buffers)
STREAM_CHUNK_BYTES = 1 << 18

# message types
MSG_HELLO = 1
MSG_HELLO_ACK = 2
MSG_REQUEST = 3
MSG_RESPONSE = 4
MSG_ERROR = 5
MSG_STREAM_CHUNK = 6
MSG_STREAM_END = 7
MSG_PING = 8
MSG_PONG = 9

# flags
F_NO_XI = 1 << 0      #: request/response carries only the real plane
F_PI = 1 << 1         #: pi layout (natural otherwise)
F_SHM = 1 << 2        #: payload lives in shm slot ``slot``, not inline
F_STREAM = 1 << 3     #: request: the client accepts chunked responses
F_DEGRADED = 1 << 4   #: response: served degraded (trail in extras)
F_WANT_SHM = 1 << 5   #: HELLO: client asks for the shm lane

# wire dtypes
DTYPE_F32 = 0
DTYPE_BF16 = 1

#: FROZEN wire vocabularies — indexes travel the wire, so these tuples
#: are part of wire version 1 and may only grow, never reorder
WIRE_OPS = ("fft", "conv", "corr", "solve")
WIRE_DOMAINS = ("c2c", "r2c", "c2r")
WIRE_PRECISIONS = ("", "bf16", "default", "split3", "highest", "fp32")
WIRE_PRIORITIES = ("low", "normal", "high")


class WireError(ValueError):
    """A malformed or out-of-contract binary frame."""


def _nbytes(buf) -> int:
    return buf.nbytes if isinstance(buf, memoryview) else len(buf)


def as_bytes_view(arr: np.ndarray) -> memoryview:
    """The array's memory as a flat byte view — what the transport
    writes, with no Python-level copy."""
    return memoryview(arr).cast("B")


def charge_host_copy(nbytes: int, site: str) -> None:
    """Charge one sanctioned host copy of plane-payload bytes to the
    ``pifft_host_copy_bytes_total`` meter.

    Every place the serve front copies request/response PLANE bytes on
    the host (JSON decode/encode, the bfloat16 wire upcast, streaming
    reassembly) charges here, so the meter is the ground truth the
    wire-smoke asserts a zero delta on for the binary float32 path."""
    from ..obs import metrics

    metrics.inc("pifft_host_copy_bytes_total", float(nbytes), site=site)


def count_frame(protocol: str, direction: str = "in") -> None:
    """Per-protocol front-door traffic counter
    (``pifft_serve_wire_frames_total{protocol,direction}``)."""
    from ..obs import metrics

    metrics.inc("pifft_serve_wire_frames_total", protocol=protocol,
                direction=direction)


def _index(value: str, vocab, field: str) -> int:
    try:
        return vocab.index(value)
    except ValueError:
        raise WireError(f"{field}={value!r} is not in the wire "
                        f"vocabulary {vocab}") from None


def _lookup(idx: int, vocab, field: str) -> str:
    if not 0 <= idx < len(vocab):
        raise WireError(f"{field} index {idx} out of range for {vocab}")
    return vocab[idx]


class Frame:
    """One decoded binary frame (header fields + extras + payload)."""

    __slots__ = ("msg_type", "flags", "op", "domain", "precision",
                 "priority", "inverse", "dtype", "rid", "n", "width",
                 "slot", "extras", "payload", "version")

    def __init__(self, msg_type, flags, op, domain, precision,
                 priority, inverse, dtype, rid, n, width, slot,
                 extras, payload, version=WIRE_VERSION):
        self.msg_type = msg_type
        self.flags = flags
        self.op = op
        self.domain = domain
        self.precision = precision
        self.priority = priority
        self.inverse = inverse
        self.dtype = dtype
        self.rid = rid
        self.n = n
        self.width = width
        self.slot = slot
        self.extras = extras
        self.payload = payload
        self.version = version


def encode_frame(msg_type: int, *, flags: int = 0, op: str = "fft",
                 domain: str = "c2c", precision: Optional[str] = None,
                 priority: str = "normal", inverse: bool = False,
                 dtype: int = DTYPE_F32, rid: int = 0, n: int = 0,
                 width: int = 0, slot: int = 0,
                 extras: Optional[dict] = None,
                 payload: bytes = b"",
                 version: int = WIRE_VERSION) -> list:
    """Header + extras + payload as a list of buffers.

    Returned as separate buffers (not concatenated) so callers can
    hand numpy plane memory straight to ``writer.write`` without a
    Python-level join copy."""
    blob = b""
    if extras:
        blob = json.dumps(extras, separators=(",", ":")).encode("utf-8")
        if len(blob) > MAX_EXTRAS_BYTES:
            raise WireError(f"extras blob {len(blob)} bytes exceeds "
                            f"the {MAX_EXTRAS_BYTES}-byte cap")
    payload_len = sum(_nbytes(p) for p in payload) \
        if isinstance(payload, (list, tuple)) else _nbytes(payload)
    if payload_len > MAX_PAYLOAD_BYTES:
        raise WireError(f"payload {payload_len} bytes exceeds the "
                        f"{MAX_PAYLOAD_BYTES}-byte cap")
    head = HEADER.pack(
        MAGIC, version, flags, msg_type,
        _index(op, WIRE_OPS, "op"),
        _index(domain, WIRE_DOMAINS, "domain"),
        _index(precision or "", WIRE_PRECISIONS, "precision"),
        _index(priority, WIRE_PRIORITIES, "priority"),
        1 if inverse else 0, dtype, 0, rid, n, width, len(blob), slot,
        payload_len)
    out = [head]
    if blob:
        out.append(blob)
    if isinstance(payload, (list, tuple)):
        out.extend(p for p in payload if _nbytes(p))
    elif _nbytes(payload):
        out.append(payload)
    return out


def parse_header(head: bytes) -> Frame:
    """A :class:`Frame` from 48 header bytes.  ``extras`` and
    ``payload`` hold the BYTE COUNTS still on the wire (ints) — the
    frame reader replaces them with the decoded blob and raw bytes.
    Raises :class:`WireError` on anything out of contract — the server
    answers that with ``serve_conn_lost`` + close, never a hang."""
    (magic, version, flags, msg_type, op_i, dom_i, prec_i, prio_i,
     inverse, dtype, _pad, rid, n, width, extras_len, slot,
     payload_len) = HEADER.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if msg_type not in (MSG_HELLO, MSG_HELLO_ACK, MSG_REQUEST,
                        MSG_RESPONSE, MSG_ERROR, MSG_STREAM_CHUNK,
                        MSG_STREAM_END, MSG_PING, MSG_PONG):
        raise WireError(f"unknown msg_type {msg_type}")
    if dtype not in (DTYPE_F32, DTYPE_BF16):
        raise WireError(f"unknown wire dtype {dtype}")
    if extras_len > MAX_EXTRAS_BYTES:
        raise WireError(f"extras_len {extras_len} exceeds the "
                        f"{MAX_EXTRAS_BYTES}-byte cap")
    if payload_len > MAX_PAYLOAD_BYTES:
        raise WireError(f"payload_len {payload_len} exceeds the "
                        f"{MAX_PAYLOAD_BYTES}-byte cap")
    if n > MAX_WIRE_N:
        raise WireError(f"n {n} exceeds the {MAX_WIRE_N} cap")
    if width > MAX_WIRE_WIDTH:
        raise WireError(f"width {width} exceeds the "
                        f"{MAX_WIRE_WIDTH} cap")
    return Frame(
        msg_type, flags,
        _lookup(op_i, WIRE_OPS, "op"),
        _lookup(dom_i, WIRE_DOMAINS, "domain"),
        _lookup(prec_i, WIRE_PRECISIONS, "precision") or None,
        _lookup(prio_i, WIRE_PRIORITIES, "priority"),
        bool(inverse), dtype, rid, n, width, slot, extras_len,
        payload_len, version=version)


def decode_extras(blob: bytes) -> dict:
    """The metadata blob (tenant/trace/latency split) — bounded JSON
    metadata, NOT plane payload, so it rides outside the host-copy
    meter (module docstring)."""
    if not blob:
        return {}
    try:
        out = json.loads(blob.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"undecodable extras blob: {e}") from None
    if not isinstance(out, dict):
        raise WireError(f"extras blob is {type(out).__name__}, "
                        f"want object")
    return out


async def read_wire_frame(reader, head: Optional[bytes] = None) -> \
        Optional[Frame]:
    """The next binary frame, or None on clean EOF between frames.
    `head` is the already-peeked header prefix (dialect detection).
    A truncation mid-frame raises ``asyncio.IncompleteReadError`` —
    the tolerated client-went-away shape; a malformed header raises
    :class:`WireError`."""
    if head is None:
        try:
            head = await reader.readexactly(HEADER.size)
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None
            raise
    elif len(head) < HEADER.size:
        head = head + await reader.readexactly(HEADER.size - len(head))
    frame = parse_header(head)
    extras_len, payload_len = frame.extras, frame.payload
    frame.extras = decode_extras(
        await reader.readexactly(extras_len) if extras_len else b"")
    frame.payload = await reader.readexactly(payload_len) \
        if payload_len else b""
    return frame


# ------------------------------------------------------- plane codecs


def plane_to_wire(arr, dtype: int = DTYPE_F32):
    """One response plane as a write-ready buffer.  float32 planes go
    out as their own memory (no Python-level copy); the bfloat16 wire
    dtype truncates mantissas — a real copy, charged to the meter."""
    a = np.ascontiguousarray(np.asarray(arr, np.float32))
    if dtype == DTYPE_F32:
        return as_bytes_view(a)
    bits = a.view(np.uint32)
    out = ((bits + 0x8000) >> 16).astype(np.uint16)
    charge_host_copy(out.nbytes, site="bf16_wire")
    return as_bytes_view(out)


def wire_dtype_width(dtype: int) -> int:
    return 4 if dtype == DTYPE_F32 else 2


# ------------------------------------------------------------- client


class WireClient:
    """One multiplexed binary connection: HELLO/HELLO_ACK negotiation,
    rid-keyed concurrent requests under the credit window, streaming
    reassembly, and the optional shm lane.

    After :meth:`connect`, ``dialect`` says what the server granted:
    ``"binary"`` — or ``"json"`` when the server refused the offered
    version (the caller then speaks the JSON dialect on the same
    connection; :func:`~.protocol.request_over_socket` style)."""

    def __init__(self):
        self.reader = None
        self.writer = None
        self.dialect = None
        self.credits = 0
        self.window = 0
        self.shm = None          # client-side ShmRing view, when granted
        self._free_slots: list = []
        self._pending: dict = {}     # rid -> Future
        self._chunks: dict = {}      # rid -> list of payload chunks
        self._rid = 0
        self._credit_free = asyncio.Event()
        self._slot_free = asyncio.Event()
        self._reader_task = None
        self._write_lock = asyncio.Lock()
        self._conn_error: Optional[BaseException] = None

    @classmethod
    async def connect(cls, host: str, port: int, *,
                      want_shm: bool = False,
                      version: int = WIRE_VERSION) -> "WireClient":
        self = cls()
        self.reader, self.writer = await asyncio.open_connection(
            host, port)
        flags = F_WANT_SHM if want_shm else 0
        for buf in encode_frame(MSG_HELLO, flags=flags,
                                version=version):
            self.writer.write(buf)
        await self.writer.drain()
        head = await self.reader.readexactly(4)
        if head == MAGIC:
            ack = await read_wire_frame(self.reader, head=head)
            if ack is None or ack.msg_type != MSG_HELLO_ACK:
                raise WireError("server answered HELLO with "
                                f"msg_type {ack and ack.msg_type}")
            self.dialect = "binary"
            self.window = self.credits = max(1, ack.slot)
            self._credit_free.set()
            if ack.flags & F_SHM and ack.payload:
                from .shm import ShmRing

                # the grant numbers come off the wire: a hostile server
                # must not size our free-slot list or the ring mapping
                if not 1 <= ack.n <= MAX_SHM_SLOTS or ack.width < 8:
                    raise WireError(
                        f"shm grant out of contract: {ack.n} slot(s) "
                        f"x {ack.width} byte(s)")
                self.shm = ShmRing.attach(
                    bytes(ack.payload).decode("utf-8"),
                    slots=ack.n, slot_bytes=ack.width)
                self._free_slots = list(range(ack.n))
            self._reader_task = asyncio.ensure_future(self._read_loop())
        else:
            # version fallback: the server answered in the JSON
            # dialect — `head` is the big-endian length prefix of its
            # fallback frame; drain it so the caller starts clean
            (length,) = struct.unpack(">I", head)
            body = await self.reader.readexactly(length)
            self.dialect = "json"
            self.fallback = json.loads(body.decode("utf-8"))
        return self

    async def _read_loop(self):
        try:
            while True:
                frame = await read_wire_frame(self.reader)
                if frame is None:
                    break
                self._dispatch(frame)
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, WireError) as e:
            self._conn_error = e
        finally:
            err = self._conn_error or ConnectionError(
                "server closed the connection")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            self._credit_free.set()
            self._slot_free.set()  # wake slot-waiters into the error

    def _dispatch(self, frame: Frame):
        if frame.msg_type == MSG_STREAM_CHUNK:
            # streaming reassembly IS a sanctioned host copy: chunks
            # land in a growing client-side buffer, charged per chunk
            charge_host_copy(len(frame.payload),
                             site="stream_reassemble")
            self._chunks.setdefault(frame.rid, []).append(frame.payload)
            return
        if frame.msg_type == MSG_STREAM_END:
            frame.payload = b"".join(self._chunks.pop(frame.rid, []))
            frame.msg_type = MSG_RESPONSE
        fut = self._pending.pop(frame.rid, None)
        if frame.msg_type in (MSG_RESPONSE, MSG_ERROR):
            # a terminal reply returns its request's credit (PONGs are
            # free: pings never consumed one)
            self.credits = min(self.window, self.credits + 1)
            self._credit_free.set()
        if fut is not None and not fut.done():
            fut.set_result(frame)

    def _next_rid(self) -> int:
        self._rid += 1
        return self._rid

    async def _acquire_credit(self):
        while self.credits <= 0:
            self._credit_free.clear()
            await self._credit_free.wait()
            if self._conn_error is not None:
                raise self._conn_error
        self.credits -= 1

    async def request(self, xr, xi=None, *, op: str = "fft",
                      layout: str = "natural",
                      precision: Optional[str] = None,
                      inverse: bool = False, domain: str = "c2c",
                      priority: str = "normal",
                      tenant: Optional[str] = None,
                      trace=None, stream: bool = False,
                      dtype: int = DTYPE_F32,
                      use_shm: bool = False) -> dict:
        """One request over the multiplexed connection.  Returns the
        response record (``ok``/latency split/``degraded``/``trace``)
        with ``yr``/``yi`` as float32 arrays — zero-copy views over
        the receive buffer on the float32 path."""
        if self.dialect != "binary":
            raise WireError("connection negotiated the JSON dialect")
        xr = np.ascontiguousarray(np.asarray(xr, np.float32))
        xi_arr = None if xi is None \
            else np.ascontiguousarray(np.asarray(xi, np.float32))
        n = int(xr.shape[-1])
        if domain == "c2r":
            n = 2 * (n - 1)
        flags = (F_PI if layout == "pi" else 0) \
            | (F_STREAM if stream else 0) \
            | (0 if xi_arr is not None else F_NO_XI)
        extras = {}
        if tenant:
            extras["tenant"] = tenant
        if trace is not None:
            extras["trace"] = trace
        rid = self._next_rid()
        await self._acquire_credit()
        slot = 0
        if use_shm:
            if self.shm is None:
                raise WireError("shm lane was not granted in HELLO_ACK")
            # a credit does not imply a slot YET: the response frame
            # returns the credit before the awaiting request coroutine
            # resumes and recycles its slot — wait, don't fail
            while not self._free_slots:
                self._slot_free.clear()
                await self._slot_free.wait()
                if self._conn_error is not None:
                    raise self._conn_error
            slot = self._free_slots.pop()
            self.shm.write_planes(slot, xr, xi_arr)
            flags |= F_SHM
            payload = []
        elif dtype == DTYPE_BF16:
            payload = [plane_to_wire(xr, dtype)] \
                + ([plane_to_wire(xi_arr, dtype)]
                   if xi_arr is not None else [])
        else:
            payload = [as_bytes_view(xr)] \
                + ([as_bytes_view(xi_arr)] if xi_arr is not None
                   else [])
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        bufs = encode_frame(
            MSG_REQUEST, flags=flags, op=op, domain=domain,
            precision=precision, priority=priority, inverse=inverse,
            dtype=dtype, rid=rid, n=n, width=int(xr.shape[-1]),
            slot=slot, extras=extras, payload=payload)
        try:
            async with self._write_lock:
                for buf in bufs:
                    self.writer.write(buf)
                await self.writer.drain()
            frame = await fut
            # build the record (copying shm results OUT of the slot)
            # BEFORE the finally recycles the slot — a waiting request
            # must not overwrite planes we haven't read yet
            return self._record(frame)
        finally:
            self._pending.pop(rid, None)
            if use_shm:
                self._free_slots.append(slot)
                self._slot_free.set()

    def _record(self, frame: Frame) -> dict:
        rec = dict(frame.extras or {})
        rec.setdefault("id", frame.rid)
        if frame.msg_type == MSG_ERROR:
            rec.setdefault("ok", False)
            return rec
        rec["ok"] = True
        rec["degraded"] = bool(frame.flags & F_DEGRADED) \
            or bool(rec.get("degraded"))
        if frame.flags & F_SHM and self.shm is not None:
            yr, yi = self.shm.read_planes(
                frame.slot, frame.width,
                no_xi=bool(frame.flags & F_NO_XI))
            # the slot is recycled the moment this response resolves:
            # materialize the result planes out of it (the shm lane's
            # read-back IS the transport — not a metered decode copy,
            # serve/shm.py module docstring)
            yr = np.array(yr)
            yi = np.array(yi) if yi is not None else None
        else:
            elem = wire_dtype_width(frame.dtype)
            plane = frame.width * elem
            raw = frame.payload
            if frame.dtype == DTYPE_BF16:
                bits = np.frombuffer(raw, np.uint16).astype(np.uint32)
                charge_host_copy(bits.nbytes * 2, site="bf16_wire")
                full = (bits << 16).view(np.float32)
                yr = full[:frame.width]
                yi = None if frame.flags & F_NO_XI \
                    else full[frame.width:2 * frame.width]
            else:
                yr = np.frombuffer(raw, np.float32, count=frame.width)
                yi = None if frame.flags & F_NO_XI else np.frombuffer(
                    raw, np.float32, count=frame.width, offset=plane)
        rec["yr"] = yr
        rec["yi"] = yi if yi is not None else np.zeros_like(yr)
        return rec

    async def ping(self) -> bool:
        rid = self._next_rid()
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        async with self._write_lock:
            for buf in encode_frame(MSG_PING, rid=rid):
                self.writer.write(buf)
            await self.writer.drain()
        frame = await fut
        return frame.msg_type == MSG_PONG

    async def close(self):
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
        if self.shm is not None:
            self.shm.close()
            self.shm = None
        if self.writer is not None:
            self.writer.close()
