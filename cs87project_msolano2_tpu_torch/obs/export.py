"""Exporters: Chrome trace JSON, Prometheus textfile, human summary.

All three read the SAME artifact — the structured event stream
(:mod:`.events`), either live (the in-process buffer) or from the JSONL
sink a run wrote (``bench --events``, ``PIFFT_OBS_EVENTS``).  The CLI
front end is ``python -m cs87project_msolano2_tpu_torch obs {summary,
export, validate}``.

* **Chrome trace** — span events become complete ("ph": "X") trace
  events with microsecond ts/dur keyed by pid/tid, loadable in
  Perfetto / chrome://tracing; nesting falls out of the ts/dur
  containment per thread.
* **Prometheus textfile** — the metrics snapshot (the final
  ``kind="metrics"`` event of a run, or the live registry) in the
  node-exporter textfile-collector format.
* **Summary** — event counts by kind, per-span-name rollups, warn/
  retry/demotion tallies, and the headline metric series, as a small
  human table (or ``--json``).
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

from . import events as events_mod
from . import metrics as metrics_mod


def spans_from_events(records: Iterable[dict]) -> list:
    """The span payloads of an event stream (kind == "span"), with the
    envelope's run/cell identity folded in."""
    out = []
    for rec in records:
        if rec.get("kind") != "span":
            continue
        payload = dict(rec.get("payload") or {})
        if "cell" in rec and "cell" not in payload:
            payload["cell"] = rec["cell"]
        payload.setdefault("run", rec.get("run"))
        out.append(payload)
    return out


def chrome_trace(spans: Optional[Iterable[dict]] = None,
                 pid: int = 1) -> dict:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` form)
    from finished-span records (default: the live in-process buffer).

    Each span becomes one complete event: ``ph="X"``, ``ts``/``dur`` in
    microseconds, ``tid`` = the recording thread, span attributes and
    cell identity under ``args`` — the keys Perfetto needs to render a
    nested flame.

    Spans carrying ``links`` (the batcher's fan-in edge: the request
    span ids its coalesced batch served — obs/trace.py) additionally
    emit **flow events** (``ph: "s"`` at each linked source span,
    ``ph: "f"`` with ``bp: "e"`` at the linking span), so Perfetto
    draws the request→batch arrows across threads."""
    if spans is None:
        spans = events_mod.span_snapshot()
    spans = list(spans)
    by_sid = {sp["sid"]: sp for sp in spans if sp.get("sid")}
    trace = []
    flow_seq = 0
    for sp in spans:
        args = dict(sp.get("args") or {})
        for key in ("cell", "parent", "depth", "run", "error", "sid",
                    "trace", "links"):
            if sp.get(key) is not None:
                args[key] = sp[key]
        ts = round(float(sp.get("ts_s", 0.0)) * 1e6, 3)
        trace.append({
            "name": sp.get("name", "span"),
            "ph": "X",
            "ts": ts,
            "dur": round(float(sp.get("dur_s", 0.0)) * 1e6, 3),
            "pid": pid,
            "tid": sp.get("tid", 0),
            "cat": "pifft",
            "args": args,
        })
        for lid in (sp.get("links") or ()):
            src = by_sid.get(lid)
            if src is None:
                continue  # the linked span fell outside this export
            flow_seq += 1
            common = {"name": "fanin", "cat": "pifft_flow",
                      "id": flow_seq, "pid": pid}
            trace.append({**common, "ph": "s",
                          "ts": round(float(src.get("ts_s", 0.0))
                                      * 1e6, 3),
                          "tid": src.get("tid", 0)})
            trace.append({**common, "ph": "f", "bp": "e", "ts": ts,
                          "tid": sp.get("tid", 0)})
    trace.sort(key=lambda e: (e["tid"], e["ts"],
                              -e.get("dur", 0)))
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def last_metrics_snapshot(records: Iterable[dict]) -> Optional[dict]:
    """The newest ``kind="metrics"`` snapshot in an event stream, or
    None (a run that died before its final flush)."""
    snap = None
    for rec in records:
        if rec.get("kind") == "metrics":
            payload = rec.get("payload") or {}
            if isinstance(payload.get("snapshot"), dict):
                snap = payload["snapshot"]
    return snap


def _split_series(series: str) -> tuple:
    """('name', '{labels}') — labels part may be empty."""
    if "{" in series:
        name, _, rest = series.partition("{")
        return name, "{" + rest
    return series, ""


def prometheus_text(snapshot: Optional[dict] = None) -> str:
    """The node-exporter textfile-collector format for a metrics
    snapshot (default: the live registry).  One ``# TYPE`` line per
    metric name, series lines beneath; histograms expand to
    ``_bucket{le=...}`` / ``_sum`` / ``_count``."""
    snap = snapshot if snapshot is not None else metrics_mod.snapshot()
    lines = []
    for family, typ in (("counters", "counter"), ("gauges", "gauge")):
        typed = set()
        for series in sorted(snap.get(family) or {}):
            name, labels = _split_series(series)
            if name not in typed:
                lines.append(f"# TYPE {name} {typ}")
                typed.add(name)
            value = snap[family][series]
            lines.append(f"{name}{labels} {value:g}")
    typed = set()
    for series in sorted(snap.get("histograms") or {}):
        name, labels = _split_series(series)
        if name not in typed:
            lines.append(f"# TYPE {name} histogram")
            typed.add(name)
        h = snap["histograms"][series]
        base = labels[1:-1] if labels else ""
        for bound, cum in h["buckets"].items():
            le = bound if bound == "+Inf" else f"{float(bound):g}"
            sep = "," if base else ""
            lines.append(f'{name}_bucket{{{base}{sep}le="{le}"}} {cum}')
        lines.append(f"{name}_sum{labels} {h['sum']:g}")
        lines.append(f"{name}_count{labels} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def summarize(records: list, dropped_lines: int = 0) -> dict:
    """The machine form of `pifft obs summary`: totals, per-kind
    counts, span rollups, and the final metrics snapshot."""
    kinds: dict = {}
    runs: list = []
    spans: dict = {}
    for rec in records:
        kinds[rec.get("kind", "?")] = kinds.get(rec.get("kind", "?"), 0) + 1
        run = rec.get("run")
        if run and run not in runs:
            runs.append(run)
    for sp in spans_from_events(records):
        name = sp.get("name", "span")
        agg = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                      "max_s": 0.0})
        agg["count"] += 1
        dur = float(sp.get("dur_s", 0.0))
        agg["total_s"] += dur
        agg["max_s"] = max(agg["max_s"], dur)
    for agg in spans.values():
        agg["mean_s"] = agg["total_s"] / max(agg["count"], 1)
        for key in ("total_s", "max_s", "mean_s"):
            agg[key] = round(agg[key], 6)
    snap = last_metrics_snapshot(records)
    # silent event loss is the one hole a summary must not paper over:
    # surface the buffer-overflow drop count (live when this process
    # is the armed one, else the counter the finished stream carries)
    dropped_events = events_mod.dropped()
    if not dropped_events and snap:
        dropped_events = int((snap.get("counters") or {})
                             .get("pifft_obs_dropped_total", 0))
    return {
        "event_count": len(records),
        "dropped_lines": dropped_lines,
        "dropped_events": dropped_events,
        "runs": runs,
        "kinds": dict(sorted(kinds.items())),
        "spans": dict(sorted(spans.items())),
        "metrics": snap or {"counters": {}, "gauges": {},
                            "histograms": {}},
    }


def format_summary(summary: dict) -> str:
    """The human table for `pifft obs summary`."""
    lines = [f"events: {summary['event_count']}"
             + (f" ({summary['dropped_lines']} corrupt line(s) skipped)"
                if summary.get("dropped_lines") else "")]
    if summary.get("dropped_events"):
        lines.append(f"WARNING: {summary['dropped_events']} event(s) "
                     f"DROPPED to buffer overflow — the stream is "
                     f"incomplete (pifft_obs_dropped_total)")
    if summary.get("runs"):
        lines.append(f"runs:   {', '.join(summary['runs'])}")
    if summary["kinds"]:
        lines.append("by kind:")
        for kind, count in summary["kinds"].items():
            lines.append(f"  {kind:<22} {count}")
    if summary["spans"]:
        lines.append("spans (count / total / mean / max, seconds):")
        for name, agg in summary["spans"].items():
            lines.append(f"  {name:<22} {agg['count']:>5}  "
                         f"{agg['total_s']:>10.4f}  {agg['mean_s']:>9.4f}"
                         f"  {agg['max_s']:>9.4f}")
    counters = summary["metrics"].get("counters") or {}
    if counters:
        lines.append("counters:")
        for series in sorted(counters):
            lines.append(f"  {series:<46} {counters[series]:g}")
    gauges = summary["metrics"].get("gauges") or {}
    if gauges:
        lines.append("gauges:")
        for series in sorted(gauges):
            lines.append(f"  {series:<46} {gauges[series]:g}")
    return "\n".join(lines)


def validate_stream(records: list) -> list:
    """(seq-or-index, problem) pairs for every schema violation in an
    event stream — empty means the whole stream validates."""
    problems = []
    for i, rec in enumerate(records):
        for problem in events_mod.validate_event(rec):
            ident = rec.get("seq", i) if isinstance(rec, dict) else i
            problems.append((ident, problem))
    return problems


def write_chrome_trace(path: str,
                       spans: Optional[Iterable[dict]] = None) -> str:
    """Write the Chrome trace JSON for `spans` (default: the live
    buffer) to `path`; returns the path."""
    doc = chrome_trace(spans)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path
