"""The port's binary front door (``serve/wire.py``, ``serve/shm.py``,
``serve/protocol.py``) on the CPU, case for case against the reference's
``tests/test_wire.py`` (less its arrival-process, PIF117 and loader
cases, which belong to the load generator, the checker and analyze):
frame codec round trips, dialect negotiation (version fallback,
malformed-header close, truncation tolerance), bit-identity of served
planes across the JSON and binary dialects, per-connection flow control,
streaming reassembly, the same-host shm lane, the host-copy meter's zero
on the binary float32 path, and header fuzzing.

Across packages: ``wire.encode_frame`` gives the reference's bytes for
the same fields (and each decodes the other's), and over a real socket
the reference's clients (``WireClient`` and the JSON helper) talk to the
port's server and the port's clients to the reference's server."""

import asyncio
import struct

import numpy as np
import pytest

from cs87project_msolano2_tpu import obs as ref_obs
from cs87project_msolano2_tpu import serve as ref_serve
from cs87project_msolano2_tpu.serve import protocol as ref_protocol
from cs87project_msolano2_tpu.serve import wire as ref_wire
from cs87project_msolano2_tpu_torch import obs
from cs87project_msolano2_tpu_torch.serve import (
    Dispatcher,
    ServeConfig,
    ShapeSpec,
)
from cs87project_msolano2_tpu_torch.serve import protocol, wire

CPU = "cpu"
N = 256


def planes(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def run_async(coro, timeout_s=120.0):
    async def bounded():
        return await asyncio.wait_for(coro, timeout=timeout_s)

    return asyncio.run(bounded())


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    for var in ("PIFFT_OBS", "PIFFT_OBS_EVENTS", "PIFFT_FAULT"):
        monkeypatch.delenv(var, raising=False)
    yield
    for o in (obs, ref_obs):
        if o.enabled():
            o.disable()
        o.metrics.reset()


@pytest.fixture
def obs_run():
    obs.enable()
    yield obs
    obs.disable()


def host_copy_total() -> float:
    from cs87project_msolano2_tpu_torch.obs import metrics

    return sum(v for k, v in metrics.snapshot()["counters"].items()
               if k.startswith("pifft_host_copy_bytes_total"))


class _BufReader:
    """A minimal asyncio.StreamReader stand-in over in-memory bytes."""

    def __init__(self, data: bytes):
        self._data = memoryview(data)
        self._pos = 0

    async def readexactly(self, n: int) -> bytes:
        chunk = bytes(self._data[self._pos:self._pos + n])
        if len(chunk) < n:
            raise asyncio.IncompleteReadError(chunk, n)
        self._pos += n
        return chunk


# ------------------------------------------------------- frame codec


def test_frame_codec_round_trip_preserves_planes_and_fields():
    xr, xi = planes()
    bufs = wire.encode_frame(
        wire.MSG_REQUEST, flags=wire.F_STREAM, op="conv", domain="r2c",
        precision="bf16", priority="high", inverse=True, rid=77,
        n=N, width=N, slot=3, extras={"tenant": "batch"},
        payload=[wire.as_bytes_view(xr), wire.as_bytes_view(xi)])
    frame = run_async(wire.read_wire_frame(
        _BufReader(b"".join(bytes(b) for b in bufs))))
    assert frame.msg_type == wire.MSG_REQUEST
    assert frame.flags & wire.F_STREAM
    assert (frame.op, frame.domain, frame.precision,
            frame.priority) == ("conv", "r2c", "bf16", "high")
    assert frame.inverse and frame.rid == 77 and frame.slot == 3
    assert frame.extras == {"tenant": "batch"}
    data = np.frombuffer(frame.payload, np.float32)
    assert data[:N].tobytes() == xr.tobytes()
    assert data[N:].tobytes() == xi.tobytes()


def test_parse_header_rejects_out_of_contract_frames():
    good = bytes(wire.encode_frame(wire.MSG_PING)[0])
    assert wire.parse_header(good).msg_type == wire.MSG_PING
    with pytest.raises(wire.WireError):
        wire.parse_header(b"JUNK" + good[4:])
    bad_type = bytearray(good)
    bad_type[8] = 200
    with pytest.raises(wire.WireError):
        wire.parse_header(bytes(bad_type))
    with pytest.raises(wire.WireError):
        wire.encode_frame(wire.MSG_REQUEST, op="not-an-op")
    with pytest.raises(wire.WireError):
        wire.encode_frame(
            wire.MSG_REQUEST,
            extras={"pad": "x" * (wire.MAX_EXTRAS_BYTES + 1)})


def test_json_length_prefix_and_magic_never_collide():
    (magic_as_len,) = struct.unpack(">I", wire.MAGIC)
    assert magic_as_len > protocol.MAX_FRAME_BYTES


#: frames of every message type and field the two packages must encode
#: to the same bytes
FRAMES = (
    (wire.MSG_HELLO, {}), (wire.MSG_HELLO, {"flags": wire.F_WANT_SHM}),
    (wire.MSG_HELLO_ACK, {"flags": wire.F_SHM, "n": 8, "width": 1 << 20,
                          "slot": 8, "payload": b"pifft-0123abcd"}),
    (wire.MSG_REQUEST, {"op": "conv", "domain": "r2c", "precision": "bf16",
                        "priority": "high", "inverse": True, "rid": 77,
                        "n": N, "width": N, "slot": 3,
                        "extras": {"tenant": "batch",
                                   "trace": "ab-cd"}}),
    (wire.MSG_REQUEST, {"flags": wire.F_PI | wire.F_NO_XI, "rid": 2 ** 40,
                        "n": 1 << 20, "width": 1 << 20, "dtype": 1}),
    (wire.MSG_RESPONSE, {"flags": wire.F_DEGRADED, "rid": 5, "n": N,
                         "width": N // 2 + 1, "domain": "c2r",
                         "extras": {"id": 5, "ok": True,
                                    "degrade": ["overload:window"]}}),
    (wire.MSG_ERROR, {"rid": 9, "extras": {"id": 9, "ok": False,
                                           "error": {"type": "queue_full",
                                                     "retry_after_ms":
                                                         12.5}}}),
    (wire.MSG_STREAM_CHUNK, {"rid": 4, "slot": 2, "payload": b"\x01" * 64}),
    (wire.MSG_STREAM_END, {"rid": 4, "slot": 3, "precision": "fp32"}),
    (wire.MSG_PING, {"rid": 1}), (wire.MSG_PONG, {"rid": 1}),
    (wire.MSG_HELLO, {"version": wire.WIRE_VERSION + 7}))


@pytest.mark.parametrize("msg_type,fields", FRAMES)
def test_encode_frame_bytes_equal_the_reference(msg_type, fields):
    xr, xi = planes()
    if msg_type == wire.MSG_REQUEST and "payload" not in fields:
        fields = dict(fields, payload=[wire.as_bytes_view(xr),
                                       wire.as_bytes_view(xi)])
    ours = b"".join(bytes(b) for b in wire.encode_frame(msg_type, **fields))
    ref = b"".join(bytes(b) for b in ref_wire.encode_frame(msg_type,
                                                           **fields))
    assert ours == ref
    for reader_mod, data in ((ref_wire, ours), (wire, ref)):
        frame = run_async(reader_mod.read_wire_frame(_BufReader(data)))
        assert frame.msg_type == msg_type
        assert frame.rid == fields.get("rid", 0)


def test_wire_vocabularies_equal_the_reference():
    for name in ("WIRE_OPS", "WIRE_DOMAINS", "WIRE_PRECISIONS",
                 "WIRE_PRIORITIES", "MAGIC", "WIRE_VERSION",
                 "DEFAULT_CREDITS", "STREAM_CHUNK_BYTES", "MAX_WIRE_N",
                 "MAX_WIRE_WIDTH", "MAX_EXTRAS_BYTES", "MAX_PAYLOAD_BYTES"):
        assert getattr(wire, name) == getattr(ref_wire, name), name
    assert wire.HEADER.format == ref_wire.HEADER.format
    assert protocol.MAX_FRAME_BYTES == ref_protocol.MAX_FRAME_BYTES


def test_bf16_plane_codec_equals_the_reference():
    xr, _ = planes()
    ours = bytes(wire.plane_to_wire(xr, wire.DTYPE_BF16))
    assert ours == bytes(ref_wire.plane_to_wire(xr, ref_wire.DTYPE_BF16))
    from cs87project_msolano2_tpu.serve.buffers import (
        landing_views as ref_landing,
    )
    from cs87project_msolano2_tpu_torch.serve.buffers import landing_views

    payload = ours + ours
    a = landing_views(payload, N, dtype=wire.DTYPE_BF16)
    b = ref_landing(payload, N, dtype=ref_wire.DTYPE_BF16)
    assert a[0].tobytes() == b[0].tobytes()
    assert a[1].tobytes() == b[1].tobytes()


# ------------------------------------- both dialects over one socket


async def _start_server(cfg=None, specs=None, shm_config=None):
    d = Dispatcher(cfg or ServeConfig(max_batch=4, max_wait_ms=1.0),
                   specs or [ShapeSpec(n=N)], device=CPU)
    await d.__aenter__()
    server = await asyncio.start_server(
        lambda r, w: protocol.handle_connection(d, r, w,
                                                shm_config=shm_config),
        "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    return d, server, port


async def _stop(d, server):
    server.close()
    await server.wait_closed()
    await d.close()


def test_binary_and_json_dialects_serve_bit_identical_planes(obs_run):
    xr, xi = planes()

    async def main():
        d, server, port = await _start_server()
        try:
            direct = await d.submit(xr.copy(), xi.copy())
            jrec = await protocol.request_over_socket(
                "127.0.0.1", port, xr, xi)
            before = host_copy_total()
            client = await wire.WireClient.connect("127.0.0.1", port)
            try:
                assert client.dialect == "binary"
                assert await client.ping()
                brec = await client.request(xr, xi)
            finally:
                await client.close()
            binary_delta = host_copy_total() - before
            return direct, jrec, brec, binary_delta
        finally:
            await _stop(d, server)

    direct, jrec, brec, binary_delta = run_async(main())
    want_r = np.asarray(direct.yr, np.float32).tobytes()
    want_i = np.asarray(direct.yi, np.float32).tobytes()
    assert np.asarray(jrec["yr"], np.float32).tobytes() == want_r
    assert np.asarray(jrec["yi"], np.float32).tobytes() == want_i
    assert brec["ok"] and not brec["degraded"]
    assert np.asarray(brec["yr"], np.float32).tobytes() == want_r
    assert np.asarray(brec["yi"], np.float32).tobytes() == want_i
    assert binary_delta == 0.0


def test_json_dialect_charges_the_host_copy_meter(obs_run):
    xr, xi = planes()

    async def main():
        d, server, port = await _start_server()
        try:
            before = host_copy_total()
            await protocol.request_over_socket("127.0.0.1", port, xr, xi)
            return host_copy_total() - before
        finally:
            await _stop(d, server)

    assert run_async(main()) > 0


def test_wire_smoke_cli(capsys):
    import json

    from cs87project_msolano2_tpu_torch.serve.cli import serve_main

    rc = serve_main(["--wire-smoke", "--json", "--device", CPU])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out["problems"]
    assert out["binary_host_copy_delta"] == 0
    assert out["json_host_copy_delta"] > 0
    assert out["dialect"] == "binary" and out["shm_granted"]
    assert out["fallback_dialect"] == "json"
    assert out["schema_invalid_events"] == 0


# -------------------------------------------------------- negotiation


def test_unknown_wire_version_falls_back_to_json_dialect(obs_run):
    xr, xi = planes()

    async def main():
        d, server, port = await _start_server()
        try:
            client = await wire.WireClient.connect(
                "127.0.0.1", port, version=wire.WIRE_VERSION + 7)
            assert client.dialect == "json"
            assert client.fallback.get("dialect") == "json"
            frame = {"op": "fft", "id": 1, "xr": xr.tolist(),
                     "xi": xi.tolist(), "layout": "natural",
                     "domain": "c2c", "inverse": False,
                     "precision": None}
            client.writer.write(protocol.encode_frame(frame))
            await client.writer.drain()
            reply = await protocol.read_frame(client.reader)
            client.writer.close()
            return reply
        finally:
            await _stop(d, server)

    reply = run_async(main())
    reply.pop("_t_recv", None)
    assert reply["ok"]
    fallback = next(e for e in obs_run.events.snapshot()
                    if e["kind"] == "serve_wire_fallback")
    assert fallback["payload"]["offered"] == wire.WIRE_VERSION + 7
    assert fallback["payload"]["supported"] == wire.WIRE_VERSION


def test_malformed_header_closes_with_conn_lost_never_hangs(obs_run):
    async def main():
        d, server, port = await _start_server()
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           port)
            writer.write(wire.MAGIC + b"\xff" * 60)
            await writer.drain()
            data = await asyncio.wait_for(reader.read(), timeout=10.0)
            writer.close()
            client = await wire.WireClient.connect("127.0.0.1", port)
            assert await client.ping()
            await client.close()
            return data
        finally:
            await _stop(d, server)

    assert run_async(main()) == b""
    kinds = [e["kind"] for e in obs_run.events.snapshot()]
    assert "serve_conn_lost" in kinds


def test_truncated_frame_is_a_tolerated_disconnect(obs_run):
    async def main():
        d, server, port = await _start_server()
        try:
            _reader, writer = await asyncio.open_connection("127.0.0.1",
                                                            port)
            for buf in wire.encode_frame(wire.MSG_HELLO):
                writer.write(buf)
            writer.write(wire.MAGIC + b"\x01")
            await writer.drain()
            writer.close()
            await asyncio.sleep(0.1)
            client = await wire.WireClient.connect("127.0.0.1", port)
            assert await client.ping()
            await client.close()
        finally:
            await _stop(d, server)

    run_async(main())


def test_negotiated_event_names_protocol_and_credits(obs_run):
    from cs87project_msolano2_tpu_torch.obs import events as obs_events

    async def main():
        d, server, port = await _start_server()
        try:
            client = await wire.WireClient.connect("127.0.0.1", port)
            window = client.window
            await client.close()
            return window
        finally:
            await _stop(d, server)

    window = run_async(main())
    assert window == wire.DEFAULT_CREDITS
    neg = [e for e in obs_run.events.snapshot()
           if e["kind"] == "serve_wire_negotiated"]
    assert neg and neg[0]["payload"]["protocol"] == "binary"
    assert neg[0]["payload"]["credits"] == window
    for e in obs_run.events.snapshot():
        assert obs_events.validate_event(e) == []


# ------------------------------------------------------- flow control


def test_flow_control_violation_is_structured_not_fatal():
    xr, xi = planes()

    async def main():
        # a long batching window holds requests in flight while the
        # burst lands, so exceeding the credit window is deterministic
        cfg = ServeConfig(max_batch=64, max_wait_ms=200.0, queue_depth=128)
        d, server, port = await _start_server(cfg=cfg)
        try:
            client = await wire.WireClient.connect("127.0.0.1", port)
            try:
                burst = client.window + 4
                futs = {}
                for _ in range(burst):
                    rid = client._next_rid()
                    futs[rid] = asyncio.get_running_loop().create_future()
                    client._pending[rid] = futs[rid]
                    for buf in wire.encode_frame(
                            wire.MSG_REQUEST, rid=rid, n=N, width=N,
                            payload=[wire.as_bytes_view(xr),
                                     wire.as_bytes_view(xi)]):
                        client.writer.write(buf)
                await client.writer.drain()
                frames = await asyncio.gather(*futs.values())
                errors = [f for f in frames if f.msg_type == wire.MSG_ERROR]
                ok = [f for f in frames if f.msg_type == wire.MSG_RESPONSE]
                assert errors, "burst never exceeded the window"
                for f in errors:
                    assert f.extras["error"]["type"] == "flow_control"
                assert len(ok) >= client.window
                assert await client.ping()
            finally:
                await client.close()
        finally:
            await _stop(d, server)

    run_async(main())


# ------------------------------------------- streaming and the shm lane


def test_streaming_response_reassembles_bit_identically(obs_run):
    n = 1 << 16  # 2 planes * 256 KiB > STREAM_CHUNK_BYTES: must chunk
    xr, xi = planes(n=n)

    async def main():
        d, server, port = await _start_server(specs=[ShapeSpec(n=n)])
        try:
            client = await wire.WireClient.connect("127.0.0.1", port)
            try:
                inline = await client.request(xr, xi)
                streamed = await client.request(xr, xi, stream=True)
            finally:
                await client.close()
            return inline, streamed
        finally:
            await _stop(d, server)

    inline, streamed = run_async(main())
    assert streamed["yr"].tobytes() == inline["yr"].tobytes()
    assert streamed["yi"].tobytes() == inline["yi"].tobytes()


def test_shm_lane_round_trip_matches_inline(obs_run):
    xr, xi = planes()

    async def main():
        d, server, port = await _start_server(
            shm_config={"slots": 4, "slot_bytes": N * 8})
        try:
            client = await wire.WireClient.connect("127.0.0.1", port,
                                                   want_shm=True)
            try:
                assert client.shm is not None
                inline = await client.request(xr, xi)
                over_shm = await client.request(xr, xi, use_shm=True)
                for _ in range(6):  # slots recycle: more than 4 in turn
                    again = await client.request(xr, xi, use_shm=True)
                    assert again["yr"].tobytes() == inline["yr"].tobytes()
            finally:
                await client.close()
            return inline, over_shm
        finally:
            await _stop(d, server)

    inline, over_shm = run_async(main())
    assert over_shm["yr"].tobytes() == inline["yr"].tobytes()
    assert over_shm["yi"].tobytes() == inline["yi"].tobytes()


def test_shm_attach_rejects_out_of_contract_geometry():
    from cs87project_msolano2_tpu_torch.serve.shm import ShmRing

    ring = ShmRing.create(slots=2, slot_bytes=64)
    try:
        with pytest.raises(ValueError):
            ShmRing.attach(ring.name, slots=4, slot_bytes=64)
        with pytest.raises(ValueError):
            ShmRing.attach(ring.name, slots=0, slot_bytes=64)
        peer = ShmRing.attach(ring.name, slots=2, slot_bytes=64)
        peer.close()
    finally:
        ring.close()
        ring.unlink()


# ------------------------------------------------- header fuzzing

#: (offset, size) of the size-bearing header fields in the packed
#: 48-byte layout ("<4sHHBBBBBBBBQIIIIQ")
FIELD_OFFSETS = {
    "n": (24, 4),
    "width": (28, 4),
    "extras_len": (32, 4),
    "slot": (36, 4),
    "payload_len": (40, 8),
}


def _parse_or_wire_error(parse, buf):
    """parse_header must be TOTAL over corrupted input: a Frame or a
    WireError, never any other exception."""
    try:
        return parse(bytes(buf))
    except (wire.WireError, ref_wire.WireError):
        return None


def _fields(frame):
    return None if frame is None else (
        frame.msg_type, frame.flags, frame.op, frame.domain,
        frame.precision, frame.priority, frame.inverse, frame.dtype,
        frame.rid, frame.n, frame.width, frame.slot, frame.extras,
        frame.payload, frame.version)


def test_header_bit_flip_fuzz_is_total():
    """All 384 single-bit corruptions of a valid header either decode
    or raise WireError; whatever decodes respects the decode-boundary
    caps, and the reference decides each one the same way."""
    good = bytes(wire.encode_frame(wire.MSG_REQUEST, rid=7, n=N,
                                   width=N)[0])
    assert len(good) == wire.HEADER.size == 48
    for byte in range(len(good)):
        for bit in range(8):
            mutated = bytearray(good)
            mutated[byte] ^= 1 << bit
            frame = _parse_or_wire_error(wire.parse_header, mutated)
            ref = _parse_or_wire_error(ref_wire.parse_header, mutated)
            assert _fields(frame) == _fields(ref), (byte, bit)
            if frame is not None:
                assert frame.n <= wire.MAX_WIRE_N
                assert frame.width <= wire.MAX_WIRE_WIDTH
                assert frame.extras <= wire.MAX_EXTRAS_BYTES
                assert frame.payload <= wire.MAX_PAYLOAD_BYTES


def test_header_boundary_value_fuzz_is_total():
    """Boundary values planted in every size-bearing field: values past a
    cap are rejected; everything else decodes with the value intact."""
    good = bytes(wire.encode_frame(wire.MSG_REQUEST, n=N, width=N)[0])
    caps = {"n": wire.MAX_WIRE_N, "width": wire.MAX_WIRE_WIDTH,
            "extras_len": wire.MAX_EXTRAS_BYTES,
            "payload_len": wire.MAX_PAYLOAD_BYTES, "slot": None}
    for name, (off, size) in sorted(FIELD_OFFSETS.items()):
        cap = caps[name]
        values = [0, 1, 2**31 - 1, 2**32 - 1, 2**(8 * size) - 1]
        if cap is not None:
            values += [cap - 1, cap, cap + 1]
        for value in values:
            if value >= 1 << (8 * size):
                continue
            mutated = bytearray(good)
            mutated[off:off + size] = value.to_bytes(size, "little")
            frame = _parse_or_wire_error(wire.parse_header, mutated)
            if cap is not None and value > cap:
                assert frame is None, (name, value)
            else:
                assert frame is not None, (name, value)
                decoded = {"n": frame.n, "width": frame.width,
                           "extras_len": frame.extras, "slot": frame.slot,
                           "payload_len": frame.payload}[name]
                assert decoded == value


def test_fuzzed_headers_never_kill_the_server(obs_run):
    """A seeded battery of corrupted headers against a live server: every
    connection ends in a structured reply or a clean close, and the
    server stays alive for the next well-formed client."""
    rng = np.random.default_rng(0x11F)
    good = bytes(wire.encode_frame(wire.MSG_REQUEST, n=N, width=N)[0])
    mutants = []
    for _ in range(10):
        m = bytearray(good)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(4, len(m)))] ^= 1 << int(rng.integers(8))
        mutants.append(bytes(m))
    for name, (off, size) in sorted(FIELD_OFFSETS.items()):
        m = bytearray(good)
        m[off:off + size] = (2**(8 * size) - 1).to_bytes(size, "little")
        mutants.append(bytes(m))

    async def main():
        d, server, port = await _start_server()
        try:
            for m in mutants:
                reader, writer = await asyncio.open_connection("127.0.0.1",
                                                               port)
                writer.write(m)
                if writer.can_write_eof():
                    writer.write_eof()
                await writer.drain()
                await asyncio.wait_for(reader.read(), timeout=15.0)
                writer.close()
            client = await wire.WireClient.connect("127.0.0.1", port)
            assert await client.ping()
            await client.close()
        finally:
            await _stop(d, server)

    run_async(main())


# ---------------------------------------- across packages, over a socket


async def _ref_server():
    d = ref_serve.Dispatcher(ref_serve.ServeConfig(max_batch=4,
                                                   max_wait_ms=1.0))
    await d.__aenter__()
    server = await asyncio.start_server(
        lambda r, w: ref_protocol.handle_connection(
            d, r, w, shm_config={"slots": 4, "slot_bytes": N * 8}),
        "127.0.0.1", 0)
    return d, server, server.sockets[0].getsockname()[1]


def _close_planes(a, b):
    ga = np.asarray(a["yr"], np.float64) + 1j * np.asarray(a["yi"],
                                                           np.float64)
    gb = np.asarray(b["yr"], np.float64) + 1j * np.asarray(b["yi"],
                                                           np.float64)
    return float(np.linalg.norm(ga - gb) / np.linalg.norm(gb))


def test_reference_clients_against_the_port_server():
    """The reference's WireClient (binary, then the shm lane) and JSON
    helper against the port's server: served, and the two dialects'
    planes byte-identical to each other."""
    xr, xi = planes(seed=3)

    async def main():
        d, server, port = await _start_server(
            shm_config={"slots": 4, "slot_bytes": N * 8})
        try:
            c = await ref_wire.WireClient.connect("127.0.0.1", port,
                                                  want_shm=True)
            try:
                assert c.dialect == "binary" and c.shm is not None
                assert await c.ping()
                b = await c.request(xr, xi)
                s = await c.request(xr, xi, use_shm=True)
                r = await c.request(xr, None, domain="r2c")
            finally:
                await c.close()
            j = await ref_protocol.request_over_socket("127.0.0.1", port,
                                                       xr, xi)
            return b, s, r, j
        finally:
            await _stop(d, server)

    b, s, r, j = run_async(main())
    assert b["ok"] and s["ok"] and r["ok"] and j["ok"]
    assert np.asarray(j["yr"], np.float32).tobytes() == b["yr"].tobytes()
    assert np.asarray(j["yi"], np.float32).tobytes() == b["yi"].tobytes()
    assert s["yr"].tobytes() == b["yr"].tobytes()
    assert r["yr"].shape == (N // 2 + 1,)
    ref = np.fft.fft(xr.astype(np.complex128) + 1j * xi)
    assert np.linalg.norm(b["yr"] + 1j * b["yi"] - ref) \
        / np.linalg.norm(ref) < 1e-5


def test_port_clients_against_the_reference_server():
    """The port's WireClient (binary, the shm lane, the version fallback)
    and JSON helper against the reference's server: served, the dialects
    byte-identical to each other, within the split3 budget of the port's
    own answer."""
    xr, xi = planes(seed=4)

    async def main():
        d, server, port = await _ref_server()
        try:
            c = await wire.WireClient.connect("127.0.0.1", port,
                                              want_shm=True)
            try:
                assert c.dialect == "binary" and c.shm is not None
                b = await c.request(xr, xi)
                s = await c.request(xr, xi, use_shm=True)
            finally:
                await c.close()
            j = await protocol.request_over_socket("127.0.0.1", port, xr,
                                                   xi)
            f = await wire.WireClient.connect(
                "127.0.0.1", port, version=wire.WIRE_VERSION + 7)
            dialect = f.dialect
            await f.close()
        finally:
            server.close()
            await server.wait_closed()
            await d.close()
        ours, pserver, pport = await _start_server()
        try:
            mine = await protocol.request_over_socket("127.0.0.1", pport,
                                                      xr, xi)
        finally:
            await _stop(ours, pserver)
        return b, s, j, dialect, mine

    b, s, j, dialect, mine = run_async(main())
    assert b["ok"] and s["ok"] and j["ok"] and dialect == "json"
    assert np.asarray(j["yr"], np.float32).tobytes() == b["yr"].tobytes()
    assert s["yr"].tobytes() == b["yr"].tobytes()
    assert _close_planes(mine, b) <= 1e-5
