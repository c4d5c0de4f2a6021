"""The wire front: one port, two dialects, framed binary and JSON (the
reference's ``serve/protocol.py``).

The first four bytes of a connection pick the dialect.  The binary
dialect (:mod:`.wire`) opens with the magic ``b"PIFB"``: a fixed
48-byte little-endian header, a small JSON metadata blob and the raw
float32 planes, landed server-side as ``np.frombuffer`` views with no
intermediate copy.  Anything else is the JSON dialect's 4-byte
big-endian length prefix (capped far below the magic's big-endian
value, so the two never collide) and a UTF-8 JSON body.  Requests:

    {"op": "fft", "id": 7, "xr": [...], "xi": [...],
     "layout": "natural", "precision": "split3", "inverse": false,
     "domain": "c2c", "priority": "normal", "tenant": "acme"}
    {"op": "conv", "id": 8, "xr": [...signal...], "xi": [...kernel...]}
    {"op": "stats"}
    {"op": "ping"}

``op`` names the served operation: "fft" (the bare transform), or the
fused spectral ops: "conv"/"corr" take the real signal in ``xr`` and the
real kernel in ``xi`` (circular at n), "solve" the real field in
``xr``.  An op outside the vocabulary is refused with a structured
``bad_request``, never served as a bare transform.  ``domain`` is
optional (default "c2c"); ``"r2c"`` requests may omit ``xi``.
``priority`` (low/normal/high) and ``tenant`` feed the admission
classes.  ``trace`` continues the client's trace
(``{"trace_id": ..., "span_id": ...}`` or ``"<trace_id>-<span_id>"``);
omitted or malformed, the dispatcher mints one.  On the binary dialect
tenant and trace ride the header's metadata blob.

Responses mirror :meth:`~.dispatcher.Response.to_record` (the result
planes as ``yr``/``yi`` float lists, serialized float32-faithfully so
both dialects decode bit-identical planes) on success, or

    {"id": 7, "ok": false, "error": {"type": "queue_full",
     "message": "...", "retry_after_ms": 12.5}}

on a structured :class:`~.dispatcher.ServeError`: backpressure, faults
and degradation travel the wire, never flattened into a generic error.
The server is asyncio end to end, with one dispatcher shared by every
connection and dialect: the coalescer sees ALL concurrent clients.

The JSON dialect's whole-body parse is a metered host copy
(``pifft_host_copy_bytes_total``, ``serve/wire.py``); the binary float32
path charges zero.  Negotiation, credits, streaming responses and the
same-host shm lane are the binary dialect's contract (``serve/wire.py``,
``serve/shm.py``).
"""

from __future__ import annotations

import asyncio
import json
import struct
from typing import Optional

import numpy as np

from ..obs.spans import clock
from . import wire
from .dispatcher import Dispatcher, ServeError

#: frame length prefix: 4-byte big-endian unsigned
_LEN = struct.Struct(">I")

#: refuse absurd frames before allocating for them (a 2^27-point
#: request in JSON floats is ~2 GiB of text; cap generously above any
#: sane served shape).  Kept strictly below ``b"PIFB"`` read as a
#: big-endian u32 (~1.35e9), so a JSON length can never be mistaken
#: for the binary magic.
MAX_FRAME_BYTES = 1 << 28


def encode_frame(obj) -> bytes:
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(f"frame body {len(body)} bytes exceeds the "
                         f"{MAX_FRAME_BYTES}-byte cap")
    # the whole JSON body is materialized host-side — the sanctioned
    # encode copy the host-copy meter charges
    wire.charge_host_copy(len(body), site="json_encode")
    return _LEN.pack(len(body)) + body


async def read_frame(reader, head: Optional[bytes] = None) -> \
        Optional[dict]:
    """The next decoded frame, or None on clean EOF.  `head` is an
    already-read length-prefix prefix (dialect detection peeks it).
    Decoded request objects carry the reserved ``"_t_recv"`` stamp —
    the arrival clock BEFORE the JSON parse, so the parse cost lands
    in the request's queue phase (tail attribution sees the front
    door); :func:`request_over_socket` strips it
    client-side."""
    if head is None:
        try:
            head = await reader.readexactly(_LEN.size)
        except asyncio.IncompleteReadError as e:
            if not e.partial:
                return None  # clean EOF between frames
            raise ValueError(f"truncated frame header "
                             f"({len(e.partial)}/{_LEN.size} bytes)") \
                from e
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {length} exceeds the "
                         f"{MAX_FRAME_BYTES}-byte cap")
    body = await reader.readexactly(length)
    t_recv = clock()
    # the sanctioned decode copy: the whole body becomes Python
    # objects (per-element floats and all) — charged, so the JSON-vs-
    # binary host-copy delta is a measured fact, not a slogan
    wire.charge_host_copy(len(body), site="json_decode")
    obj = json.loads(body.decode("utf-8"))
    if isinstance(obj, dict):
        obj["_t_recv"] = t_recv
    return obj


async def _handle_one(dispatcher: Dispatcher, msg: dict) -> dict:
    from ..utils.roofline import SPECTRAL_OPS

    rid = msg.get("id")
    op = msg.get("op")
    t_recv = msg.pop("_t_recv", None)
    if op == "ping":
        return {"id": rid, "ok": True, "pong": True}
    if op == "stats":
        return {"id": rid, "ok": True,
                "stats": dispatcher.stats.summary(),
                "buffers": dispatcher.buffer_stats()}
    if op not in SPECTRAL_OPS:
        # unknown ops are refused with a structured error — never
        # silently served as a bare transform
        return {"id": rid, "ok": False,
                "error": {"type": "bad_request",
                          "message": f"unknown op {op!r} (serveable: "
                                     f"{SPECTRAL_OPS + ('ping', 'stats')})"}}
    try:
        xi = msg.get("xi")
        resp = await dispatcher.submit(
            np.asarray(msg.get("xr", ()), np.float32),
            np.asarray(xi, np.float32) if xi is not None else None,
            layout=msg.get("layout", "natural"),
            precision=msg.get("precision"),
            inverse=bool(msg.get("inverse", False)),
            domain=msg.get("domain", "c2c"),
            priority=msg.get("priority") or "normal",
            tenant=msg.get("tenant") or "default",
            op=op,
            trace=msg.get("trace"),
            t_recv=t_recv)
    except ServeError as e:
        return {"id": rid, "ok": False, "error": e.to_record()}
    rec = resp.to_record(arrays=True)
    rec["id"] = rid if rid is not None else rec["id"]
    return rec


#: the client-went-away family: a write/drain dying of one of these is
#: the CLIENT's disconnect, not a server fault — the handler closes
#: that one connection with a warn event and the accept loop (and the
#: sibling connections it serves) never sees it
_DISCONNECTS = (ConnectionResetError, BrokenPipeError,
                ConnectionAbortedError)


class _ConnState:
    """Per-connection write discipline shared by both dialects:
    serialized writes, in-flight reply tasks, and the peer-went-away
    latch with its one ``serve_conn_lost`` event."""

    def __init__(self, writer):
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.pending: set = set()
        self.lost = asyncio.Event()

    def note_lost(self, e: Exception) -> None:
        if self.lost.is_set():
            return
        self.lost.set()
        from ..obs import events, metrics
        from ..plans.core import warn

        peer = None
        try:
            peer = self.writer.get_extra_info("peername")
        except Exception:  # pragma: no cover - transport gone entirely
            pass
        metrics.inc("pifft_serve_conn_lost_total")
        events.emit("serve_conn_lost", peer=str(peer),
                    error=f"{type(e).__name__}: {str(e)[:200]}")
        warn(f"serve: client {peer} disconnected mid-write "
             f"({type(e).__name__}); closing that connection")

    async def write_bufs(self, bufs) -> bool:
        """Serialized multi-buffer frame write; False once the peer is
        gone.  Buffers are handed to the transport as-is — response
        planes go out as their own memory, no join copy."""
        if self.lost.is_set():
            return False
        async with self.write_lock:
            if self.lost.is_set():
                return False
            try:
                for buf in bufs:
                    self.writer.write(buf)
                await self.writer.drain()
            except _DISCONNECTS as e:
                self.note_lost(e)
                return False
        return True

    async def write_json(self, reply) -> bool:
        return await self.write_bufs([encode_frame(reply)])

    def spawn(self, coro):
        task = asyncio.ensure_future(coro)
        self.pending.add(task)
        task.add_done_callback(self.pending.discard)

    async def drain_pending(self):
        if self.pending:
            await asyncio.gather(*self.pending, return_exceptions=True)


async def handle_connection(dispatcher: Dispatcher, reader, writer,
                            shm_config: Optional[dict] = None) -> None:
    """One client connection: frames in, frames out, until EOF.
    The first four bytes pick the dialect (module docstring).
    Requests on one connection are served CONCURRENTLY (a queue-full
    rejection must not wait behind a coalescing window), with writes
    serialized through a lock.  A client disconnecting mid-write
    (``ConnectionResetError``/``BrokenPipeError`` out of ``drain()``)
    closes THIS connection with a ``serve_conn_lost`` warn event —
    it never propagates into the accept loop."""
    st = _ConnState(writer)
    try:
        try:
            head = await reader.readexactly(4)
        except asyncio.IncompleteReadError:
            return  # nothing (or a sub-prefix fragment) then EOF
        except _DISCONNECTS as e:
            st.note_lost(e)
            return
        if head == wire.MAGIC:
            await _serve_binary(dispatcher, reader, st, head,
                                shm_config)
        else:
            await _serve_json(dispatcher, reader, st, head)
        await st.drain_pending()
    finally:
        try:
            writer.close()
        except _DISCONNECTS as e:  # pragma: no cover - already gone
            st.note_lost(e)


# ------------------------------------------------------- JSON dialect


async def _serve_json(dispatcher: Dispatcher, reader, st: _ConnState,
                      head: Optional[bytes]) -> None:
    async def serve_one(msg):
        try:
            reply = await _handle_one(dispatcher, msg)
        except Exception as e:  # a reply is owed even for the unforeseen
            from ..resilience import classify

            reply = {"id": msg.get("id"), "ok": False,
                     "error": {"type": "internal",
                               "kind": classify(e).value,
                               "message":
                                   f"{type(e).__name__}: {str(e)[:200]}"}}
        await st.write_json(reply)

    while not st.lost.is_set():
        try:
            msg = await read_frame(reader, head=head)
        except _DISCONNECTS as e:
            st.note_lost(e)
            break
        except (ValueError, json.JSONDecodeError) as e:
            await st.write_json(
                {"ok": False,
                 "error": {"type": "bad_frame",
                           "message": str(e)[:200]}})
            break  # framing is lost; the connection cannot recover
        except asyncio.IncompleteReadError as e:
            st.note_lost(e)
            break
        finally:
            head = None
        if msg is None:
            break
        wire.count_frame("json")
        st.spawn(serve_one(msg))


# ----------------------------------------------------- binary dialect


async def _serve_binary(dispatcher: Dispatcher, reader, st: _ConnState,
                        head: bytes, shm_config: Optional[dict]) -> None:
    from ..obs import events
    from .shm import ShmRing

    try:
        hello = await wire.read_wire_frame(reader, head=head)
    except (wire.WireError, asyncio.IncompleteReadError) as e:
        st.note_lost(e)
        return
    if hello is None:
        return
    if hello.msg_type != wire.MSG_HELLO \
            or hello.version > wire.WIRE_VERSION or hello.version < 1:
        # unknown version (or a frame out of handshake order): FALL
        # BACK to the JSON dialect on the same connection, with a
        # structured warning — an old server must stay reachable by a
        # newer client, just slower
        from ..plans.core import warn

        events.emit("serve_wire_fallback", offered=hello.version,
                    supported=wire.WIRE_VERSION,
                    msg_type=hello.msg_type)
        warn(f"serve: binary HELLO offered wire version "
             f"{hello.version} (supported: {wire.WIRE_VERSION}); "
             f"falling back to the JSON dialect")
        await st.write_json({"ok": True, "dialect": "json",
                             "wire_version": wire.WIRE_VERSION})
        await _serve_json(dispatcher, reader, st, None)
        return

    window = wire.DEFAULT_CREDITS
    ring = None
    ack_flags = 0
    ack_payload = b""
    slots = slot_bytes = 0
    if (hello.flags & wire.F_WANT_SHM) and shm_config:
        ring = ShmRing.create(shm_config["slots"],
                              shm_config["slot_bytes"])
        ack_flags |= wire.F_SHM
        ack_payload = ring.name.encode("utf-8")
        slots, slot_bytes = ring.slots, ring.slot_bytes
        window = min(window, ring.slots)
    await st.write_bufs(wire.encode_frame(
        wire.MSG_HELLO_ACK, flags=ack_flags, n=slots,
        width=slot_bytes, slot=window, payload=ack_payload))
    events.emit("serve_wire_negotiated", protocol="binary",
                version=min(hello.version, wire.WIRE_VERSION),
                credits=window, shm=ring is not None)

    inflight = 0

    async def serve_one(frame, t_recv):
        nonlocal inflight
        try:
            bufs = await _handle_binary(dispatcher, frame, ring,
                                        t_recv)
        except Exception as e:  # a reply is owed even for the unforeseen
            from ..resilience import classify

            bufs = _error_frame(frame.rid, {
                "type": "internal", "kind": classify(e).value,
                "message": f"{type(e).__name__}: {str(e)[:200]}"})
        finally:
            inflight -= 1
        await st.write_bufs(bufs)

    try:
        while not st.lost.is_set():
            try:
                frame = await wire.read_wire_frame(reader)
            except wire.WireError as e:
                # a malformed header: framing is lost and cannot
                # recover — serve_conn_lost + close, never a hang
                st.note_lost(e)
                break
            except asyncio.IncompleteReadError as e:
                # truncated mid-frame: the client went away; tolerated
                if e.partial:
                    st.note_lost(e)
                break
            except _DISCONNECTS as e:
                st.note_lost(e)
                break
            if frame is None:
                break
            if frame.msg_type == wire.MSG_PING:
                await st.write_bufs(wire.encode_frame(
                    wire.MSG_PONG, rid=frame.rid))
                continue
            if frame.msg_type != wire.MSG_REQUEST:
                await st.write_bufs(_error_frame(frame.rid, {
                    "type": "bad_request",
                    "message": f"unexpected msg_type "
                               f"{frame.msg_type} mid-stream"}))
                continue
            wire.count_frame("binary")
            if inflight >= window:
                # flow-control violation: a structured wire error for
                # THIS rid — the connection (and its other in-flight
                # requests) survives
                await st.write_bufs(_error_frame(frame.rid, {
                    "type": "flow_control",
                    "message": f"credit window exceeded "
                               f"({inflight}/{window} in flight)"}))
                continue
            inflight += 1
            st.spawn(serve_one(frame, clock()))
    finally:
        await st.drain_pending()
        if ring is not None:
            ring.close()
            ring.unlink()


def _error_frame(rid: int, error: dict) -> list:
    return wire.encode_frame(wire.MSG_ERROR, rid=rid,
                             extras={"id": rid, "ok": False,
                                     "error": error})


async def _handle_binary(dispatcher: Dispatcher, frame, ring,
                         t_recv) -> list:
    """One binary REQUEST -> the reply frame's buffer list (a single
    RESPONSE/ERROR frame, or a STREAM_CHUNK sequence + STREAM_END).
    The request planes are ZERO-COPY views — over the receive buffer
    (inline payload) or the shm slot — handed straight to the
    dispatcher; the batcher's staging copy into the pooled planes
    (serve/buffers.py) is the one landing memcpy both dialects
    share."""
    from .buffers import landing_views

    no_xi = bool(frame.flags & wire.F_NO_XI)
    extras = frame.extras or {}
    try:
        if frame.flags & wire.F_SHM:
            if ring is None:
                raise wire.WireError("shm flag on a connection with "
                                     "no shm lane granted")
            xr, xi = ring.slot_planes(frame.slot, frame.width,
                                      no_xi=no_xi)
        else:
            expect = frame.width * wire.wire_dtype_width(frame.dtype) \
                * (1 if no_xi else 2)
            if len(frame.payload) != expect:
                raise wire.WireError(
                    f"payload is {len(frame.payload)} bytes, header "
                    f"promises {expect}")
            xr, xi = landing_views(frame.payload, frame.width,
                                   no_xi=no_xi, dtype=frame.dtype)
    except (wire.WireError, ValueError) as e:
        return _error_frame(frame.rid, {"type": "bad_request",
                                        "message": str(e)[:200]})
    try:
        resp = await dispatcher.submit(
            xr, xi,
            layout="pi" if frame.flags & wire.F_PI else "natural",
            precision=frame.precision,
            inverse=frame.inverse,
            domain=frame.domain,
            priority=frame.priority,
            tenant=extras.get("tenant") or "default",
            op=frame.op,
            trace=extras.get("trace"),
            t_recv=t_recv)
    except ServeError as e:
        return _error_frame(frame.rid, e.to_record())

    meta = resp.to_record(arrays=False)
    meta["id"] = frame.rid
    yr = np.ascontiguousarray(np.asarray(resp.yr, np.float32))
    yi = np.ascontiguousarray(np.asarray(resp.yi, np.float32))
    width = int(yr.shape[-1])
    flags = wire.F_DEGRADED if resp.degraded else 0

    if ring is not None and frame.flags & wire.F_SHM \
            and width * 8 <= ring.slot_bytes:
        # the shm lane answers in place: results land in the request's
        # slot, the RESPONSE frame carries only control
        dr, di = ring.slot_planes(frame.slot, width)
        np.copyto(dr, yr)
        np.copyto(di, yi)
        return wire.encode_frame(
            wire.MSG_RESPONSE, flags=flags | wire.F_SHM,
            rid=frame.rid, n=frame.n, width=width, slot=frame.slot,
            extras=meta)

    payload = [wire.plane_to_wire(yr, frame.dtype),
               wire.plane_to_wire(yi, frame.dtype)]
    total = sum(p.nbytes for p in payload)
    if frame.flags & wire.F_STREAM and total > wire.STREAM_CHUNK_BYTES:
        return _stream_frames(frame, flags, width, payload, meta)
    return wire.encode_frame(
        wire.MSG_RESPONSE, flags=flags, rid=frame.rid,
        dtype=frame.dtype, n=frame.n, width=width, extras=meta,
        payload=payload)


def _stream_frames(frame, flags: int, width: int, payload,
                   meta: dict) -> list:
    """A chunked response: STREAM_CHUNK frames (``slot`` = sequence
    number) then the STREAM_END carrying the metadata — overlap-save
    results stop owing one giant buffer to the transport."""
    raw = b"".join(bytes(p) for p in payload)
    bufs = []
    seq = 0
    for off in range(0, len(raw), wire.STREAM_CHUNK_BYTES):
        bufs.extend(wire.encode_frame(
            wire.MSG_STREAM_CHUNK, rid=frame.rid, dtype=frame.dtype,
            n=frame.n, width=width, slot=seq,
            payload=raw[off:off + wire.STREAM_CHUNK_BYTES]))
        seq += 1
    bufs.extend(wire.encode_frame(
        wire.MSG_STREAM_END, flags=flags, rid=frame.rid,
        dtype=frame.dtype, n=frame.n, width=width, slot=seq,
        extras=meta))
    return bufs


async def serve_socket(dispatcher: Dispatcher, host: str = "127.0.0.1",
                       port: int = 8571,
                       shm_config: Optional[dict] = None):
    """Run the socket front until cancelled.  Returns the
    ``asyncio.Server`` via context management inside.  `shm_config`
    (``{"slots", "slot_bytes"}``) arms the same-host shared-memory
    lane (``serve --shm``)."""
    server = await asyncio.start_server(
        lambda r, w: handle_connection(dispatcher, r, w,
                                       shm_config=shm_config),
        host, port)
    addrs = ", ".join(str(s.getsockname()) for s in server.sockets)
    from ..plans.core import warn

    warn(f"serve listening on {addrs}")
    async with server:
        await server.serve_forever()


async def request_over_socket(host: str, port: int, xr, xi=None,
                              layout: str = "natural",
                              precision: Optional[str] = None,
                              inverse: bool = False,
                              domain: str = "c2c",
                              op: str = "fft",
                              trace=None) -> dict:
    """Client helper: one JSON-dialect request over a fresh connection
    (tests and the CLI demo; a real client keeps the connection open —
    the binary dialect's :class:`~.wire.WireClient` multiplexes).
    `op` rides the frame's op field — "fft" (default) or the spectral
    ops "conv"/"corr"/"solve"; `trace` the optional
    trace-context field (module docstring)."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        frame = {
            "op": op, "id": 0,
            "xr": np.asarray(xr, np.float64).tolist(),
            "layout": layout, "precision": precision,
            "inverse": inverse, "domain": domain}
        if xi is not None:
            frame["xi"] = np.asarray(xi, np.float64).tolist()
        if trace is not None:
            frame["trace"] = trace
        writer.write(encode_frame(frame))
        await writer.drain()
        reply = await read_frame(reader)
        if reply is None:
            raise ConnectionError("server closed before replying")
        reply.pop("_t_recv", None)
        return reply
    finally:
        writer.close()
