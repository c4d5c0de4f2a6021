"""``python -m cs87project_msolano2_tpu_torch serve``: run the serving
front door, or its smokes (the reference's ``serve/cli.py``).

Server mode binds the socket front (:mod:`.protocol`: the JSON and
binary dialects on one port) on ``--host``/``--port``, warms
``--shapes`` at startup, and serves until interrupted.
``--telemetry-port`` arms the live plane (``obs.http``: /metrics,
/healthz, /slo) and ``--slo-objectives`` the burn-rate monitor whose
alerts force admission-time degradation, tagged ``slo:*``.  ``--shm``
arms the same-host shared-memory lane.  Everything runs on ``--device``
(the card by default; ``cpu`` runs the kernels' plain versions).
``--devices`` and ``--mesh-smoke`` come with the mesh slice of the port.

``--smoke`` is the in-process gate: a dispatcher is hit with k
concurrent same-shape requests plus mixed-shape traffic, and the run
FAILS unless

* coalescing happened: the k same-shape requests were served by fewer
  invocations than k, read from the ``pifft_serve_*`` counters;
* every natural-layout response verifies against ``numpy.fft`` within
  its precision mode's budget (a padded coalesced batch that returns the
  wrong rows would otherwise pass);
* every emitted event validates against the obs schema;
* the per-shape SLO table (p50/p99 queue wait and compute) is
  reportable.

``--wire-smoke`` is the wire gate (:func:`_wire_smoke`): both dialects
over a real socket give byte-identical planes, the binary float32 path
charges zero metered host-copy bytes, negotiation and fallback,
streaming and the shm lane round-trip.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np

from .batcher import GroupKey
from .dispatcher import Dispatcher, ServeConfig
from .shapes import ShapeSpec, load_shapes
from .slo import format_summary

#: the smoke's served set: one coalescing-burst shape and mixed traffic
#: (a second n, a pi-layout shape and a half-spectrum r2c shape, whose
#: responses are checked against numpy.fft.rfft and half-width)
SMOKE_SPECS = (ShapeSpec(n=4096), ShapeSpec(n=1024),
               ShapeSpec(n=2048, layout="pi"),
               ShapeSpec(n=1024, domain="r2c"))

#: what --devices and --mesh-smoke answer: the mesh dispatcher, its
#: router and its smoke are the next serving slice
MESH_REFUSAL = ("the device mesh (--devices, --mesh-smoke) comes with the "
                "mesh slice of the port; serve on one card")


def _build_config(args) -> ServeConfig:
    cfg = ServeConfig()
    if args.max_batch is not None:
        cfg.max_batch = args.max_batch
    if args.max_wait_ms is not None:
        cfg.max_wait_ms = args.max_wait_ms
    if args.queue_depth is not None:
        cfg.queue_depth = args.queue_depth
    cfg.strict_shapes = bool(args.strict)
    cfg.slo_objectives = getattr(args, "slo_objectives", None)
    return cfg


def serve_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch serve",
        description="async batched FFT-as-a-service on one card: bounded "
                    "queues, request coalescing, warm plans, graceful "
                    "degradation")
    ap.add_argument("--smoke", action="store_true",
                    help="in-process gate: concurrent mixed-shape "
                         "requests, coalescing and schema assertions, "
                         "per-shape p50/p99 report")
    ap.add_argument("--mesh-smoke", action="store_true",
                    help="the mesh gate (comes with the mesh slice)")
    ap.add_argument("--wire-smoke", action="store_true",
                    help="wire gate: both dialects over a real socket "
                         "return byte-identical planes, the binary path "
                         "charges ZERO metered host-copy bytes, and "
                         "negotiation/fallback, streaming and the shm "
                         "lane round-trip")
    ap.add_argument("--shm", action="store_true",
                    help="server mode: arm the same-host shared-memory "
                         "lane (serve/shm.py)")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve on a device mesh of this size (comes with "
                         "the mesh slice)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8571)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve the live telemetry plane (/metrics "
                         "/healthz /slo) on this HTTP port (0 = "
                         "ephemeral); arms in-process observability "
                         "when not already enabled")
    ap.add_argument("--slo-objectives", default=None, metavar="FILE",
                    help="burn-rate SLO objectives (YAML/JSON, "
                         "obs/slomon.py): sustained error-budget burn "
                         "forces admission-time degradation, tagged "
                         "slo:*")
    ap.add_argument("--shapes", default=None, metavar="FILE",
                    help="served shape set (JSONL of {n, batch, "
                         "precision, layout, domain, op}); warmed at "
                         "startup")
    ap.add_argument("--strict", action="store_true",
                    help="reject shapes outside the warmed set "
                         "(shape_not_served) instead of serving cold")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-wait-ms", type=float, default=None)
    ap.add_argument("--queue-depth", type=int, default=None)
    ap.add_argument("-k", type=int, default=12,
                    help="smoke: concurrent same-shape requests "
                         "(default 12)")
    ap.add_argument("--json", action="store_true",
                    help="smoke: machine-readable report")
    args = ap.parse_args(argv)

    if args.mesh_smoke or (args.devices is not None and args.devices > 1):
        print(f"error: {MESH_REFUSAL}", file=sys.stderr)
        return 2
    from ..utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    cfg = _build_config(args)
    if args.shapes:
        try:
            specs = load_shapes(args.shapes)
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    else:
        specs = list(SMOKE_SPECS) if args.smoke else []

    if args.wire_smoke:
        return _wire_smoke(cfg, args, device)
    if args.smoke:
        return _smoke(cfg, specs, args, device)

    from .protocol import serve_socket

    shm_config = None
    if args.shm:
        # a slot holds two float32 planes of the largest served shape
        # (8 MiB when serving cold: no warmed set to size from)
        slot_bytes = max([s.n * 8 for s in specs] or [1 << 23])
        shm_config = {"slots": 8, "slot_bytes": slot_bytes}

    dispatcher = Dispatcher(cfg, specs, device=device)
    telemetry = None
    if args.telemetry_port is not None:
        # the live plane reads the metrics registry and the streaming SLO
        # reservoir: without observability armed both are empty
        from .. import obs
        from ..obs.http import TelemetryServer

        if not obs.enabled():
            obs.enable()
        telemetry = TelemetryServer(dispatcher, host=args.host,
                                    port=args.telemetry_port).start()

    async def main():
        async with dispatcher:
            await serve_socket(dispatcher, args.host, args.port,
                               shm_config=shm_config)

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        print("# serve: interrupted, shutting down", file=sys.stderr)
    finally:
        if telemetry is not None:
            telemetry.stop()
    return 0


def planes_for(spec, rng):
    """(xr, xi) request planes for one spec's domain and op: both planes
    for c2c, a real signal and zeros for r2c, half-spectrum bins for c2r;
    op specs send their operands (signal and kernel for conv/corr, the
    field for solve)."""
    if spec.op in ("conv", "corr"):
        return (rng.standard_normal(spec.n).astype(np.float32),
                rng.standard_normal(spec.n).astype(np.float32))
    if spec.op == "solve":
        xr = rng.standard_normal(spec.n).astype(np.float32)
        return xr, np.zeros_like(xr)
    if spec.domain == "c2r":
        spec_ref = np.fft.rfft(
            rng.standard_normal(spec.n).astype(np.float64))
        return (spec_ref.real.astype(np.float32),
                spec_ref.imag.astype(np.float32))
    xr = rng.standard_normal(spec.n).astype(np.float32)
    if spec.domain == "r2c":
        return xr, np.zeros_like(xr)
    return xr, rng.standard_normal(spec.n).astype(np.float32)


def check_response(spec, xr, xi, yr, yi, rid="?"):
    """Problem string, or None: a response of `spec` against the numpy
    oracle of its domain and op within max(1e-4, the mode's budget);
    half-spectrum responses must be half-width, pi-layout ones are read
    through the bit reversal."""
    from ..ops.bits import bit_reverse_indices
    from ..ops.precision import error_budget
    from ..utils import verify

    tol = max(1e-4, error_budget(spec.precision))
    if spec.op != "fft":
        from ..apps.spectral import numpy_oracle

        ref = numpy_oracle(spec.op, xr.astype(np.float64),
                           xi.astype(np.float64), spec.n)
        err = verify.rel_err(np.asarray(yr, np.float64), ref)
        if err > tol:
            return (f"response {rid} wrong: rel err {err:.3e} > "
                    f"{tol:.0e} vs numpy {spec.op} oracle "
                    f"({spec.precision} budget)")
        return None
    got = np.asarray(yr) + 1j * np.asarray(yi)
    if spec.domain == "r2c":
        if got.shape[-1] != spec.n // 2 + 1:
            return (f"response {rid}: r2c answer is {got.shape[-1]} "
                    f"bins, want {spec.n // 2 + 1} (half-spectrum)")
        ref = np.fft.rfft(xr.astype(np.float64))
    elif spec.domain == "c2r":
        got = np.asarray(yr)
        ref = np.fft.irfft(xr.astype(np.float64)
                           + 1j * xi.astype(np.float64), n=spec.n)
    else:
        ref = np.fft.fft(xr.astype(np.complex128)
                         + 1j * xi.astype(np.complex128))
        if spec.layout == "pi":
            ref = ref[bit_reverse_indices(spec.n)]
    err = verify.rel_err(got, ref)
    if err > tol:
        return (f"response {rid} wrong: rel err {err:.3e} > {tol:.0e} vs "
                f"numpy {spec.domain} ({spec.precision} budget)")
    return None


def _smoke(cfg: ServeConfig, specs, args, device) -> int:
    from .. import obs
    from ..obs import events as obs_events
    from ..obs import metrics

    owned = not obs.enabled()
    if owned:
        obs.enable()

    # a generous window, and the burst enqueued before the worker first
    # runs, make coalescing deterministic on any host
    if args.max_wait_ms is None:
        cfg.max_wait_ms = 25.0
    k = max(2, args.k)
    burst = specs[0]
    rng = np.random.default_rng(0)
    inputs = [planes_for(burst, rng) for _ in range(k)]
    mixed = [(s, *planes_for(s, rng)) for s in specs[1:] for _ in range(2)]

    async def main():
        async with Dispatcher(cfg, specs, device=device) as d:
            calls = [d.submit(xr, xi, layout=burst.layout,
                              precision=burst.precision,
                              domain=burst.domain, op=burst.op)
                     for xr, xi in inputs]
            calls += [d.submit(xr, xi, layout=s.layout,
                               precision=s.precision, domain=s.domain,
                               op=s.op)
                      for s, xr, xi in mixed]
            responses = await asyncio.gather(*calls)
            return d, responses

    d, responses = asyncio.run(main())

    problems = []
    # every response must verify: a padded coalesced batch that hands
    # back the wrong rows is the one bug a latency report never catches
    for (xr, xi), resp in zip(inputs, responses[:k]):
        problem = check_response(burst, xr, xi, resp.yr, resp.yi, resp.rid)
        if problem:
            problems.append(problem)
            break
    for (s, xr, xi), resp in zip(mixed, responses[k:]):
        problem = check_response(s, xr, xi, resp.yr, resp.yi, resp.rid)
        if problem:
            problems.append(problem)
            break

    label = GroupKey(n=burst.n, layout=burst.layout,
                     precision=burst.precision,
                     domain=burst.domain, op=burst.op).label()
    reqs = int(metrics.counter_value("pifft_serve_requests_total",
                                     shape=label))
    batches = int(metrics.counter_value("pifft_serve_batches_total",
                                        shape=label))
    if not (0 < batches < k):
        problems.append(
            f"no coalescing: {reqs} concurrent {label} requests were "
            f"served by {batches} invocation(s) (want 0 < invocations < "
            f"{k})")

    bad_events = 0
    snapshot = obs_events.snapshot()
    for rec in snapshot:
        for p in obs_events.validate_event(rec):
            bad_events += 1
            problems.append(f"event seq={rec.get('seq')}: {p}")

    summary = d.stats.summary()
    if owned:
        obs.disable()

    if args.json:
        print(json.dumps({
            "ok": not problems,
            "device": str(device),
            "same_shape_requests": k,
            "same_shape_batches": batches,
            "events": len(snapshot),
            "schema_invalid_events": bad_events,
            "stats": summary,
            "buffers": d.buffer_stats(),
            "problems": problems,
        }, indent=1, sort_keys=True))
    else:
        print(format_summary(summary))
        print(f"# serve smoke: {k} concurrent {label} requests -> "
              f"{batches} invocation(s); {len(snapshot)} event(s), "
              f"{bad_events} schema-invalid; buffers {d.buffer_stats()}")
        for p in problems:
            print(f"# FAIL: {p}", file=sys.stderr)
    if problems:
        return 1
    print("# serve smoke ok", file=sys.stderr)
    return 0


def _wire_smoke(cfg: ServeConfig, args, device) -> int:
    """The wire gate: every claim the wire makes, asserted over a REAL
    socket in one process —

    * both dialects return BYTE-IDENTICAL float32 planes for one request
      (the JSON dialect's float32-faithful serialization);
    * the binary float32 path's metered ``pifft_host_copy_bytes_total``
      delta is exactly ZERO (the JSON path's is not: the meter works);
    * the shm lane round-trips byte-identically, and streaming
      reassembly gives the inline response's bytes;
    * an unknown-version HELLO falls back to the JSON dialect with a
      ``serve_wire_fallback`` event; a malformed header closes the
      connection (``serve_conn_lost``), never hangs;
    * every emitted event validates against the obs schema.
    """
    from .. import obs
    from ..obs import events as obs_events
    from ..obs import metrics
    from . import protocol as proto_mod
    from . import wire

    owned = not obs.enabled()
    if owned:
        obs.enable()
    if args.max_wait_ms is None:
        cfg.max_wait_ms = 2.0

    n_small, n_big = 4096, 1 << 16
    specs = [ShapeSpec(n=n_small), ShapeSpec(n=1024, domain="r2c"),
             ShapeSpec(n=n_big)]
    rng = np.random.default_rng(7)
    problems: list = []
    report: dict = {"device": str(device)}

    def hc_total() -> float:
        return sum(v for k, v in metrics.snapshot()["counters"].items()
                   if k.startswith("pifft_host_copy_bytes_total"))

    async def main():
        async with Dispatcher(cfg, specs, device=device) as d:
            server = await asyncio.start_server(
                lambda r, w: proto_mod.handle_connection(
                    d, r, w,
                    shm_config={"slots": 8, "slot_bytes": n_big * 8}),
                "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            try:
                xr = rng.standard_normal(n_small).astype(np.float32)
                xi = rng.standard_normal(n_small).astype(np.float32)
                # the first batch's set-up outside any metered window
                await d.submit(xr, xi)

                j0 = hc_total()
                rj = await proto_mod.request_over_socket(
                    "127.0.0.1", port, xr, xi)
                report["json_host_copy_delta"] = hc_total() - j0
                if not rj.get("ok"):
                    problems.append(f"JSON dialect refused the request: "
                                    f"{rj}")
                if report["json_host_copy_delta"] <= 0:
                    problems.append(
                        "the JSON dialect charged no host-copy bytes: the "
                        "meter is dead, so the binary zero below would "
                        "be vacuous")

                c = await wire.WireClient.connect("127.0.0.1", port,
                                                  want_shm=True)
                report["dialect"] = c.dialect
                report["credits"] = c.window
                report["shm_granted"] = c.shm is not None
                if c.dialect != "binary":
                    problems.append(f"HELLO v{wire.WIRE_VERSION} was "
                                    f"answered in {c.dialect}")
                b0 = hc_total()
                rb = await c.request(xr, xi)
                report["binary_host_copy_delta"] = hc_total() - b0
                if report["binary_host_copy_delta"] != 0:
                    problems.append(
                        f"binary f32 path charged "
                        f"{report['binary_host_copy_delta']} metered "
                        f"host-copy bytes (want exactly 0)")
                if not rb.get("ok"):
                    problems.append(f"binary dialect refused the request: "
                                    f"{rb}")
                elif rj.get("ok"):
                    jr = np.asarray(rj["yr"], np.float64).astype(
                        np.float32)
                    ji = np.asarray(rj["yi"], np.float64).astype(
                        np.float32)
                    if jr.tobytes() != rb["yr"].tobytes() \
                            or ji.tobytes() != rb["yi"].tobytes():
                        problems.append("JSON and binary dialects returned "
                                        "DIFFERENT plane bytes for the "
                                        "same request")

                # the r2c no-xi path: a header flag instead of a plane
                xr2 = rng.standard_normal(1024).astype(np.float32)
                rr_b = await c.request(xr2, None, domain="r2c")
                rr_j = await proto_mod.request_over_socket(
                    "127.0.0.1", port, xr2, np.zeros_like(xr2),
                    domain="r2c")
                if rr_b.get("ok") and rr_j.get("ok"):
                    if np.asarray(rr_j["yr"], np.float64).astype(
                            np.float32).tobytes() != rr_b["yr"].tobytes():
                        problems.append("r2c planes differ between "
                                        "dialects")
                else:
                    problems.append(f"r2c request failed: "
                                    f"binary={rr_b.get('ok')} "
                                    f"json={rr_j.get('ok')}")

                # the shm round trip equals the inline binary answer
                rs = await c.request(xr, xi, use_shm=True)
                if not rs.get("ok"):
                    problems.append(f"shm request failed: {rs}")
                elif rb.get("ok") and rs["yr"].tobytes() \
                        != rb["yr"].tobytes():
                    problems.append("shm lane returned different plane "
                                    "bytes than the inline binary path")

                # streaming reassembly == inline, byte for byte
                big_r = rng.standard_normal(n_big).astype(np.float32)
                big_i = rng.standard_normal(n_big).astype(np.float32)
                await d.submit(big_r, big_i)
                r_inline = await c.request(big_r, big_i)
                r_stream = await c.request(big_r, big_i, stream=True)
                if r_inline.get("ok") and r_stream.get("ok"):
                    if r_inline["yr"].tobytes() \
                            != r_stream["yr"].tobytes():
                        problems.append("streamed response reassembled to "
                                        "different bytes")
                else:
                    problems.append(
                        f"streaming cell failed: inline="
                        f"{r_inline.get('ok')} "
                        f"stream={r_stream.get('ok')}")
                await c.close()

                # negotiation: a future version must land on JSON
                cf = await wire.WireClient.connect(
                    "127.0.0.1", port, version=wire.WIRE_VERSION + 7)
                report["fallback_dialect"] = cf.dialect
                if cf.dialect != "json":
                    problems.append(f"unknown-version HELLO negotiated "
                                    f"{cf.dialect!r}, want the JSON "
                                    f"fallback")
                await cf.close()

                # a malformed header: closed with an event, not a hang
                r0, w0 = await asyncio.open_connection("127.0.0.1", port)
                w0.write(wire.MAGIC + b"\xff" * 60)
                await w0.drain()
                data = await asyncio.wait_for(r0.read(64), timeout=5.0)
                if data:
                    problems.append("malformed header got a reply instead "
                                    "of a close")
                w0.close()
            finally:
                server.close()
                await server.wait_closed()

    asyncio.run(main())

    snapshot = obs_events.snapshot()
    kinds = [e.get("kind") for e in snapshot]
    if "serve_wire_fallback" not in kinds:
        problems.append("no serve_wire_fallback event for the "
                        "unknown-version HELLO")
    if "serve_conn_lost" not in kinds:
        problems.append("no serve_conn_lost event for the malformed "
                        "header")
    bad_events = 0
    for rec in snapshot:
        for p in obs_events.validate_event(rec):
            bad_events += 1
            problems.append(f"event seq={rec.get('seq')}: {p}")
    report["events"] = len(snapshot)
    report["schema_invalid_events"] = bad_events

    if owned:
        obs.disable()

    if args.json:
        print(json.dumps({"ok": not problems, **report,
                          "problems": problems},
                         indent=1, sort_keys=True))
    else:
        print(f"# wire smoke: dialect={report.get('dialect')} "
              f"credits={report.get('credits')} "
              f"shm={report.get('shm_granted')} "
              f"binary host-copy delta="
              f"{report.get('binary_host_copy_delta')} "
              f"json delta={report.get('json_host_copy_delta')}; "
              f"{report['events']} event(s), {bad_events} schema-invalid")
        for p in problems:
            print(f"# FAIL: {p}", file=sys.stderr)
    if problems:
        return 1
    print("# wire smoke ok", file=sys.stderr)
    return 0
