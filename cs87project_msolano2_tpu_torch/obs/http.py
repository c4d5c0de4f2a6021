"""The live telemetry plane: streaming /metrics, /healthz and /slo
over a stdlib HTTP thread.

Until this module every observability surface was post-hoc — the JSONL
sink summarized after the run, the SLO table printed at shutdown.  A
serving mesh needs its numbers WHILE it runs:

* ``GET /metrics`` — the live metrics registry in the Prometheus
  exposition format (the same :func:`~.export.prometheus_text` the
  offline exporter uses, over :func:`metrics.snapshot` instead of a
  finished stream);
* ``GET /healthz`` — liveness + the serving state: per-device health
  and queue depths (mesh state where a :class:`~..serve.mesh.
  MeshDispatcher` is attached), staging-buffer stats, dropped-event
  count, the SLO monitor's alert state.  200 while serving, 503 once
  the dispatcher is closed or every device is dead — the shape a
  k8s-style prober expects;
* ``GET /slo`` — the SLIDING-WINDOW per-(op, shape, domain, precision,
  device) p50/p99 table from :class:`~..serve.slo.LatencyStats`'
  streaming reservoir — live percentiles, not end-of-run ones.

The server is a daemon thread on ``ThreadingHTTPServer`` — deliberate
sync-threaded code OUTSIDE the asyncio serving path (it only READS
shared state: queue depths, metric snapshots, reservoir copies — every
read is a snapshot under the owning lock or an atomic read).  Until
the serving layer is ported the dispatcher stays duck-typed: a bare
server (``dispatcher=None``) answers /metrics, /healthz and an empty
/slo.

``pifft obs top`` renders the same snapshot as a refreshing terminal
table (:func:`format_top`), polling these endpoints over HTTP — the
one-command live view.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import events, metrics
from .export import prometheus_text
from .spans import clock


class TelemetryServer:
    """The /metrics + /healthz + /slo thread.  ``port=0`` binds an
    ephemeral port (read it back from :attr:`port`); `dispatcher` is
    any object with the Dispatcher surface (``stats``, ``_queues``,
    ``buffer_stats()``; the mesh adds ``devices``/``utilization()``)
    — or None for a bare metrics endpoint."""

    def __init__(self, dispatcher=None, host: str = "127.0.0.1",
                 port: int = 0):
        self.dispatcher = dispatcher
        self.t_start = clock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # one handler class per server instance so the closure
            # carries the dispatcher without module-global state
            def log_message(self, fmt, *args):  # silence per-request
                pass

            def do_GET(self):  # noqa: N802 - http.server contract
                try:
                    outer._route(self)
                except BrokenPipeError:
                    pass  # client went away mid-reply; nothing to do

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ lifecycle

    def start(self) -> "TelemetryServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"pifft-telemetry-{self.port}")
        self._thread.start()
        from ..plans.core import warn

        warn(f"telemetry plane listening on "
             f"http://{self.host}:{self.port} "
             f"(/metrics /healthz /slo)")
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._thread = None

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # ------------------------------------------------------- routing

    def _route(self, handler) -> None:
        path = handler.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self._reply(handler, 200, prometheus_text(),
                        "text/plain; version=0.0.4")
        elif path == "/healthz":
            doc = self.health()
            self._reply(handler, 200 if doc["ok"] else 503,
                        json.dumps(doc, indent=1, sort_keys=True)
                        + "\n", "application/json")
        elif path == "/slo":
            doc = self.slo()
            self._reply(handler, 200,
                        json.dumps(doc, indent=1, sort_keys=True)
                        + "\n", "application/json")
        else:
            self._reply(handler, 404,
                        '{"error": "unknown path; serving /metrics '
                        '/healthz /slo"}\n', "application/json")

    @staticmethod
    def _reply(handler, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    # ------------------------------------------------------ snapshots

    def health(self) -> dict:
        """The /healthz body: serving yes/no plus where the pressure
        is (device liveness, queue depths, buffers, dropped events,
        SLO alert state)."""
        doc = {"ok": True, "uptime_s": round(clock() - self.t_start, 3),
               "obs_enabled": events.enabled(),
               "events_dropped": events.dropped()}
        run = events.run_id()
        if run:
            doc["run"] = run
        d = self.dispatcher
        if d is None:
            return doc
        if getattr(d, "_closing", False):
            doc["ok"] = False
            doc["closing"] = True
        queues = {}
        for key, q in list(getattr(d, "_queues", {}).items()):
            if isinstance(key, tuple):  # mesh: (device_id, group)
                label = f"{key[0]}/{key[1].label()}"
            else:
                label = key.label()
            queues[label] = q.qsize()
        doc["queues"] = queues
        doc["queued"] = sum(queues.values())
        try:
            doc["buffers"] = d.buffer_stats()
        except Exception as e:  # pragma: no cover - stats must not 503  # a health probe must answer even when a stats surface is mid-teardown
            doc["buffers"] = {"error": type(e).__name__}
        devices = getattr(d, "devices", None)
        if devices is not None:
            doc["devices"] = [dev.describe() for dev in devices]
            alive = [dev for dev in devices
                     if dev.state in ("healthy", "draining")]
            doc["devices_alive"] = len(alive)
            if not alive:
                doc["ok"] = False
        slomon = getattr(d, "slomon", None)
        if slomon is not None:
            doc["slo"] = slomon.describe()
            if any(slomon.alerting().values()):
                doc["slo_alerting"] = True
        return doc

    def slo(self) -> dict:
        """The /slo body: the sliding-window percentile table."""
        d = self.dispatcher
        if d is None or not hasattr(d, "stats"):
            return {"window_s": None, "rows": {}}
        summary = d.stats.window_summary()
        return {"window_s": d.stats.window_s, "rows": summary}


# ----------------------------------------------------------- obs top


def fetch_text(url: str, timeout: float = 2.0) -> str:
    """One endpoint fetch, raw body (stdlib urllib — /metrics is
    text, not JSON)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def fetch_json(url: str, timeout: float = 2.0) -> dict:
    """One endpoint fetch (stdlib urllib; the CLI's poll loop)."""
    return json.loads(fetch_text(url, timeout))


def format_top(slo: dict, health: dict) -> str:
    """The `pifft obs top` frame: the live SLO table plus the health
    line, rendered like the serve smoke's summary table."""
    lines = []
    ok = "SERVING" if health.get("ok") else "NOT SERVING"
    lines.append(
        f"pifft live telemetry — {ok}"
        + (f"  run={health['run']}" if health.get("run") else "")
        + f"  uptime={health.get('uptime_s', 0):.0f}s"
        + f"  queued={health.get('queued', 0)}"
        + (f"  dropped_events={health['events_dropped']}"
           if health.get("events_dropped") else ""))
    devices = health.get("devices")
    if devices:
        alive = health.get("devices_alive", 0)
        states = {}
        for dev in devices:
            states[dev["state"]] = states.get(dev["state"], 0) + 1
        lines.append(f"devices: {alive}/{len(devices)} alive ("
                     + ", ".join(f"{k}={v}"
                                 for k, v in sorted(states.items()))
                     + ")")
    slo_doc = health.get("slo")
    if slo_doc:
        for obj in slo_doc.get("objectives", ()):
            state = "FIRING" if obj.get("alerting") else "ok"
            lines.append(f"slo {obj['name']:<20} {state:<7} "
                         f"target p99 {obj['p99_target_ms']:g} ms, "
                         f"budget {obj['error_budget']:g}")
        if slo_doc.get("forced_level"):
            lines.append(f"slo degradation ACTIVE: "
                         f"{slo_doc['forced_level']}")
    rows = slo.get("rows") or {}
    window = slo.get("window_s")
    header = (f"window {window:g}s  " if window else "") \
        + "shape".ljust(34) + "  " \
        + "  ".join(c.rjust(8) for c in
                    ("reqs", "degr", "q_p99", "c_p99", "tot_p50",
                     "tot_p99"))
    lines.append(header)
    for label in sorted(rows):
        row = rows[label]

        def ms(key):
            v = row.get(key)
            return f"{v:.3f}" if v is not None else "-"

        lines.append(
            label.ljust(34 + (len(f"window {window:g}s  ")
                              if window else 0))
            + "  " + "  ".join(v.rjust(8) for v in (
                str(row.get("requests", 0)),
                str(row.get("degraded", 0)),
                ms("queue_p99_ms"), ms("compute_p99_ms"),
                ms("total_p50_ms"), ms("total_p99_ms"))))
    if not rows:
        lines.append("  (no requests in window)")
    return "\n".join(lines)
