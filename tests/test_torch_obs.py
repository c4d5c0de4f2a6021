"""The port's observability subsystem (``cs87project_msolano2_tpu_torch.obs``)
on the CPU, case for case against the reference's ``tests/test_obs.py``
and the obs-only cases of ``tests/test_telemetry.py``: the disabled path
is a true no-op, spans nest per thread and unwind on errors, the JSONL
sink survives a torn tail, the exporters give valid Chrome-trace and
Prometheus output, the trace context mints/adopts/samples, the burn-rate
monitor fires and resolves, the bare telemetry server answers and stops
cleanly, and the port's wiring counts what the reference's counts.

Parity: the same emits, spans and metric calls through both packages
give the same records (``run``, ``t``, ``ts_s``, ``dur_s`` and ``tid``
dropped), the same Prometheus text and the same summary, and each
package's ``validate_stream`` accepts the other's stream; both benches'
``--smoke --events`` runs name the same spans and metric series.  The
CPU ``obs.profiler.trace`` case finds the ``record_function`` ranges of
annotated spans in the written trace.
"""

import glob
import json
import os
import threading
import urllib.error

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import obs as ref_obs
from cs87project_msolano2_tpu.obs import export as ref_export
from cs87project_msolano2_tpu_torch import obs
from cs87project_msolano2_tpu_torch.obs import (
    events,
    export,
    metrics,
    profiler,
    spans,
)
from cs87project_msolano2_tpu_torch.obs import trace as trace_mod
from cs87project_msolano2_tpu_torch.obs.slomon import (
    Objective,
    SloMonitor,
    load_objectives,
)

CPU = "cpu"
#: the keys that differ between two runs of the same calls
VOLATILE = ("run", "t", "ts_s", "dur_s", "tid")


@pytest.fixture(autouse=True)
def _clean_env_and_state(monkeypatch):
    """Neither package arms from the environment here, each test starts
    from empty registries (a disarm keeps the counters an earlier test
    file's owned arming left), and no test leaves either armed."""
    for var in ("PIFFT_OBS", "PIFFT_OBS_EVENTS", "PIFFT_TRACE_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    for o in (obs, ref_obs):
        o.metrics.reset()
    yield
    for o in (obs, ref_obs):
        if o.enabled():
            o.disable()
        o.metrics.reset()


@pytest.fixture
def obs_run():
    """An armed run of the port's obs, torn down clean even on failure."""
    rid = obs.enable()
    yield rid
    obs.disable()
    metrics.reset()


def _bench_smoke(bench_mod, monkeypatch, argv):
    monkeypatch.setattr(bench_mod, "SMOKE_N", 1 << 9)
    monkeypatch.setattr(bench_mod, "SMOKE_LARGE_LOGNS", (10,))
    return bench_mod.main(argv)


# ------------------------------------------------------- disabled path


def test_disabled_path_is_true_noop():
    assert not obs.enabled()
    assert obs.run_id() is None
    assert obs.emit("anything", x=1) is None
    assert events.snapshot() == []
    # zero object churn: every disabled span() is the SAME singleton
    s1, s2 = obs.span("a", cell={"n": 8}), obs.span("b", annotate=True)
    assert s1 is s2 is spans.NOOP_SPAN
    with s1 as sp:
        assert sp.dur_s is None
    metrics.inc("c")
    metrics.set_gauge("g", 1.0)
    metrics.observe("h", 0.5)
    assert metrics.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}


def test_bench_smoke_disabled_emits_zero_events(capsys, monkeypatch):
    """The OFF half: the bench run with observability disabled emits
    zero events and touches no metric."""
    from cs87project_msolano2_tpu_torch import bench

    metrics.reset()
    assert _bench_smoke(bench, monkeypatch, ["--smoke", "--device",
                                             CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "run" not in rec
    # the metered rows are absent while the meter is disarmed
    assert "conv2^10_hbm_bytes" not in rec
    assert not obs.enabled()
    assert events.snapshot() == [] and events.span_snapshot() == []
    assert metrics.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}


def test_armed_is_owned():
    """``obs.armed()`` arms a disarmed run for the block and disarms it
    after, even on an error; an armed run it leaves armed, with its run
    id and its events."""
    with obs.armed() as o:
        assert o is obs and obs.enabled()
        metrics.inc("pifft_demo_total")
        assert metrics.counter_value("pifft_demo_total") == 1
    assert not obs.enabled()
    with pytest.raises(RuntimeError), obs.armed():
        raise RuntimeError("inside")
    assert not obs.enabled()
    rid = obs.enable()
    obs.emit("before")
    with obs.armed():
        obs.emit("inside")
    assert obs.enabled() and obs.run_id() == rid
    assert [e["kind"] for e in events.snapshot()] == ["before", "inside"]
    obs.disable()


# ------------------------------------------------------ events + schema


def test_emit_envelope_and_validation(obs_run):
    rec = obs.emit("demo", cell={"n": 64, "p": 8}, value=3)
    assert rec["run"] == obs_run and rec["kind"] == "demo"
    assert rec["cell"] == {"n": 64, "p": 8}
    assert rec["payload"] == {"value": 3}
    assert rec["v"] == events.SCHEMA_VERSION == 1
    assert events.validate_event(rec) == []
    rec2 = obs.emit("demo2")
    assert rec2["seq"] == rec["seq"] + 1 and rec2["t"] >= rec["t"]


@pytest.mark.parametrize("broken, fragment", [
    ({"v": 1, "run": "r", "seq": 0, "t": 0.0}, "kind"),
    ({"v": 1, "run": "r", "seq": -1, "t": 0.0, "kind": "x"}, "negative"),
    ({"v": 99, "run": "r", "seq": 0, "t": 0.0, "kind": "x"}, "version"),
    ({"v": 1, "run": 7, "seq": 0, "t": 0.0, "kind": "x"}, "run"),
    ({"v": 1, "run": "r", "seq": 0, "t": 0.0, "kind": "span",
      "payload": {"name": "a"}}, "payload"),
    ("not a dict", "object"),
])
def test_validate_event_rejects(broken, fragment):
    problems = events.validate_event(broken)
    assert problems and any(fragment in p for p in problems), problems


def test_jsonl_sink_tolerates_half_written_tail(tmp_path):
    path = str(tmp_path / "events.jsonl")
    rid = obs.enable(events_path=path)
    for i in range(3):
        obs.emit("tick", i=i)
    obs.flush()
    obs.disable()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"v": 1, "run": "' + rid + '", "seq": 3, "t"')  # kill
    recs, dropped = events.load_events(path)
    assert len(recs) == 3 and dropped == 1
    assert export.validate_stream(recs) == []
    assert [r["payload"]["i"] for r in recs] == [0, 1, 2]


def test_warn_mirrors_into_event_stream(obs_run, capsys):
    from cs87project_msolano2_tpu_torch.plans import warn

    warn("observability mirror check")
    assert "# observability mirror check" in capsys.readouterr().err
    evs = [e for e in events.snapshot() if e["kind"] == "warn"]
    assert evs and evs[-1]["payload"]["msg"] == "observability mirror check"


def test_sink_truncates_by_default_appends_on_request(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    obs.enable(events_path=path)
    obs.emit("one")
    obs.disable()
    rid2 = obs.enable(events_path=path)  # reused path: fresh stream
    obs.emit("two")
    obs.disable()
    recs, _ = events.load_events(path)
    assert [r["kind"] for r in recs] == ["two"]
    assert all(r["run"] == rid2 for r in recs)
    obs.enable(events_path=path, append=True)  # deliberate accumulation
    obs.emit("three")
    obs.disable()
    recs, _ = events.load_events(path)
    assert [r["kind"] for r in recs] == ["two", "three"]


def test_non_json_payload_keeps_sink_alive(tmp_path, capsys):
    path = str(tmp_path / "ev.jsonl")
    obs.enable(events_path=path)
    obs.emit("good1")
    obs.emit("bad", value=object())  # not JSON-serializable
    obs.emit("good2")
    obs.disable()
    recs, dropped = events.load_events(path)
    kinds = [r["kind"] for r in recs]
    assert [k for k in kinds if k != "warn"] == ["good1", "good2"]
    assert "warn" in kinds and dropped == 0
    assert "obs sink write failed" in capsys.readouterr().err


def test_buffer_overflow_drops_oldest_and_counts():
    obs.enable(buffer_max=4)
    for i in range(6):
        obs.emit("tick", i=i)
    snap = events.snapshot()
    assert len(snap) == 4
    ticks = [r["payload"]["i"] for r in snap if r["kind"] == "tick"]
    assert ticks == [3, 4, 5]
    assert sum(1 for r in snap if r["kind"] == "warn") == 1
    # 2 tick drops + the warn's own displacement, all counted
    assert events.dropped() == 3
    assert metrics.counter_value("pifft_obs_dropped_total") == 3


def test_dropped_events_counted_warned_and_summarized(capsys):
    obs.enable(buffer_max=8)
    for i in range(20):
        obs.emit("spam", i=i)
    assert events.dropped() > 0
    assert metrics.counter_value("pifft_obs_dropped_total") \
        == events.dropped()
    assert capsys.readouterr().err.count("obs buffer overflowed") == 1
    obs.emit("metrics", snapshot=metrics.snapshot())
    summary = export.summarize(events.snapshot())
    assert summary["dropped_events"] == events.dropped()
    assert "DROPPED" in export.format_summary(summary)


def test_no_drop_no_warning(obs_run, capsys):
    obs.emit("fine")
    summary = export.summarize(events.snapshot())
    assert summary["dropped_events"] == 0
    assert "DROPPED" not in export.format_summary(summary)
    assert "overflowed" not in capsys.readouterr().err


# -------------------------------------------------------------- spans


def test_span_nesting_and_attributes(obs_run):
    with obs.span("outer", cell={"n": 64}) as outer:
        with obs.span("inner") as inner:
            inner.set(extra=1)
    assert outer.dur_s >= inner.dur_s >= 0.0
    by_name = {r["name"]: r for r in events.span_snapshot()}
    assert by_name["inner"]["parent"] == "outer"
    assert by_name["inner"]["depth"] == 1
    assert by_name["inner"]["args"] == {"extra": 1}
    assert by_name["outer"]["depth"] == 0 and "parent" not in by_name["outer"]
    span_events = [e for e in events.snapshot() if e["kind"] == "span"]
    assert len(span_events) == 2
    assert all(events.validate_event(e) == [] for e in span_events)


def test_span_nesting_is_thread_local(obs_run):
    barrier = threading.Barrier(2)

    def worker(tag):
        with obs.span(f"outer-{tag}"):
            barrier.wait(timeout=30)  # both outers open concurrently
            with obs.span(f"inner-{tag}"):
                pass

    threads = [threading.Thread(target=worker, args=(t,))
               for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = events.span_snapshot()
    assert len(recs) == 4
    by_name = {r["name"]: r for r in recs}
    for tag in ("a", "b"):
        inner, outer = by_name[f"inner-{tag}"], by_name[f"outer-{tag}"]
        assert inner["parent"] == f"outer-{tag}"
        assert inner["tid"] == outer["tid"]
    assert by_name["outer-a"]["tid"] != by_name["outer-b"]["tid"]


def test_span_records_error_and_unwinds(obs_run):
    with pytest.raises(ValueError):
        with obs.span("doomed", annotate=True):
            raise ValueError("boom")
    assert spans.current_depth() == 0
    rec = events.span_snapshot()[-1]
    assert rec["name"] == "doomed" and rec["error"] == "ValueError"


def test_span_out_of_order_exit_is_tolerated(obs_run):
    a = obs.span("a")
    b = obs.span("b")
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)  # the outer closes first
    b.__exit__(None, None, None)
    assert spans.current_depth() == 0
    assert [r["name"] for r in events.span_snapshot()] == ["a", "b"]


def test_span_sync_failure_still_unwinds(obs_run):
    def bad_sync():
        raise RuntimeError("fetch failed")

    with pytest.raises(RuntimeError, match="fetch failed"):
        with obs.span("synced", sync=bad_sync):
            pass
    assert spans.current_depth() == 0
    rec = events.span_snapshot()[-1]
    assert rec["name"] == "synced" and rec["error"] == "RuntimeError"
    with obs.span("after"):
        pass
    after = events.span_snapshot()[-1]
    assert after["depth"] == 0 and "parent" not in after


def test_span_sync_of_cpu_tensors_is_a_noop(obs_run):
    x = torch.ones(4)
    with obs.span("cpu", sync=[x, {"y": x}]):
        pass
    with obs.span("callable", sync=lambda: (x, x)):
        pass
    assert [r["name"] for r in events.span_snapshot()] == ["cpu", "callable"]
    assert all("error" not in r for r in events.span_snapshot())


def test_span_sync_inside_graph_capture_raises_after_unwinding(
        obs_run, monkeypatch):
    """A span in a captured CUDA graph must not synchronize: sync= there
    raises a clear error once the span has unwound and recorded."""
    monkeypatch.setattr(spans, "_cuda_devices",
                        lambda value, out: {torch.device("cuda", 0)})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        with obs.span("captured", sync=torch.ones(1)):
            pass
    assert spans.current_depth() == 0
    rec = events.span_snapshot()[-1]
    assert rec["name"] == "captured" and rec["error"] == "RuntimeError"


def test_traced_decorator(obs_run):
    @obs.traced("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert [r["name"] for r in events.span_snapshot()] == ["decorated"]


# ----------------------------------------------------------- exporters


def test_chrome_trace_is_valid_and_nested(obs_run):
    with obs.span("cell", cell={"n": 64}):
        with obs.span("funnel"):
            pass
        with obs.span("tube"):
            pass
    doc = json.loads(json.dumps(export.chrome_trace()))
    evs = doc["traceEvents"]
    assert len(evs) == 3
    for e in evs:
        assert e["ph"] == "X"
        assert isinstance(e["ts"], (int, float))
        assert isinstance(e["dur"], (int, float))
        assert e["name"] and e["pid"] and "tid" in e
    cell = next(e for e in evs if e["name"] == "cell")
    for phase in ("funnel", "tube"):
        ph = next(e for e in evs if e["name"] == phase)
        assert cell["ts"] <= ph["ts"]
        assert ph["ts"] + ph["dur"] <= cell["ts"] + cell["dur"] + 1e-3
        assert ph["args"]["parent"] == "cell"


def test_chrome_flow_events_from_links(obs_run):
    """Spans that fan in (``links``) draw flow arrows from each linked
    source span, forward in time."""
    for i in range(4):
        with obs.span("request", sid=f"r{i}", trace_id="t"):
            pass
    with obs.span("batch", links=[f"r{i}" for i in range(4)] + ["gone"]):
        pass
    doc = export.chrome_trace()
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "pifft_flow"]
    starts = [e for e in flows if e["ph"] == "s"]
    finishes = [e for e in flows if e["ph"] == "f"]
    assert len(starts) == len(finishes) == 4  # the unknown link is skipped
    assert all(e.get("bp") == "e" for e in finishes)
    by_id = {e["id"]: e for e in starts}
    for fin in finishes:
        assert by_id[fin["id"]]["ts"] <= fin["ts"]
    json.dumps(doc)


def test_spans_from_events_passes_links_through(obs_run):
    with obs.span("fanin", links=["a1", "b2"], sid="s0"):
        pass
    target = [s for s in export.spans_from_events(events.snapshot())
              if s.get("name") == "fanin"]
    assert target and target[0]["links"] == ["a1", "b2"]
    assert target[0]["sid"] == "s0"


def test_prometheus_textfile_format(obs_run):
    metrics.inc("pifft_plan_cache_hits_total", 2, level="memory")
    metrics.inc("pifft_plan_cache_misses_total")
    metrics.set_gauge("pifft_roofline_util", 0.41, n="2^22")
    metrics.observe("pifft_cell_seconds", 0.3)
    metrics.observe("pifft_cell_seconds", 7.0)
    lines = export.prometheus_text().splitlines()
    assert '# TYPE pifft_plan_cache_hits_total counter' in lines
    assert 'pifft_plan_cache_hits_total{level="memory"} 2' in lines
    assert 'pifft_plan_cache_misses_total 1' in lines
    assert '# TYPE pifft_roofline_util gauge' in lines
    assert 'pifft_roofline_util{n="2^22"} 0.41' in lines
    assert '# TYPE pifft_cell_seconds histogram' in lines
    assert 'pifft_cell_seconds_bucket{le="+Inf"} 2' in lines
    assert 'pifft_cell_seconds_bucket{le="0.5"} 1' in lines
    assert 'pifft_cell_seconds_count 2' in lines
    assert 'pifft_cell_seconds_sum 7.3' in lines
    for line in lines:
        if not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            float(value)
            assert series


def test_prometheus_label_values_escaped(obs_run):
    metrics.inc("pifft_test_total",
                shape='with"quote', note="back\\slash\nnewline")
    line = [ln for ln in export.prometheus_text().splitlines()
            if ln.startswith("pifft_test_total")][0]
    assert 'shape="with\\"quote"' in line
    assert "back\\\\slash\\nnewline" in line
    assert "\n" not in line


def test_histogram_buckets_cumulative_and_inf_terminated(obs_run):
    for v in (0.003, 0.03, 0.3, 3.0, 30.0):
        metrics.observe("pifft_test_seconds", v, shape="s")
    text = export.prometheus_text()
    buckets = [ln for ln in text.splitlines()
               if ln.startswith("pifft_test_seconds_bucket")]
    counts = [float(ln.rsplit(" ", 1)[1]) for ln in buckets]
    assert counts == sorted(counts)
    assert 'le="+Inf"' in buckets[-1] and counts[-1] == 5.0
    assert "pifft_test_seconds_sum" in text
    assert "pifft_test_seconds_count" in text
    assert all('shape="s"' in ln for ln in buckets)


def test_summary_rollup(obs_run):
    with obs.span("cell"):
        pass
    metrics.inc("pifft_plan_cache_misses_total")
    obs.emit("metrics", snapshot=metrics.snapshot())
    summary = export.summarize(events.snapshot())
    assert summary["event_count"] == 2
    assert summary["runs"] == [obs_run]
    assert summary["kinds"] == {"metrics": 1, "span": 1}
    assert summary["spans"]["cell"]["count"] == 1
    assert summary["metrics"]["counters"][
        "pifft_plan_cache_misses_total"] == 1
    assert "pifft_plan_cache_misses_total" in export.format_summary(summary)


# ------------------------------------------------------- trace context


def test_disabled_trace_mint_is_noop_singleton():
    assert not obs.enabled()
    t1, t2 = trace_mod.mint(), trace_mod.ensure()
    assert t1 is t2 is trace_mod.NOOP_TRACE
    assert not t1.live
    assert trace_mod.adopt({"trace_id": "abc"}) is trace_mod.NOOP_TRACE
    assert t1.child() is trace_mod.NOOP_TRACE


def test_mint_child_and_adopt(obs_run):
    t = trace_mod.mint()
    assert t.live and t.sampled and t.parent_id is None
    c = t.child()
    assert c.trace_id == t.trace_id and c.parent_id == t.span_id
    assert c.span_id != t.span_id
    w = trace_mod.adopt({"trace_id": "feedface", "span_id": "c11e"})
    assert w.trace_id == "feedface" and w.parent_id == "c11e"
    assert trace_mod.adopt("feedface-c11e").parent_id == "c11e"
    assert trace_mod.adopt({"bogus": 1}).live
    assert trace_mod.adopt("").live
    assert w.to_wire()["parent_id"] == "c11e"


def test_sample_rate_env(obs_run, monkeypatch):
    monkeypatch.setenv(trace_mod.SAMPLE_ENV, "0")
    assert not trace_mod.mint().sampled
    monkeypatch.setenv(trace_mod.SAMPLE_ENV, "1.0")
    assert trace_mod.mint().sampled
    monkeypatch.setenv(trace_mod.SAMPLE_ENV, "not-a-number")
    assert trace_mod.sample_rate() == 1.0


def test_sample_rate_parses_once_per_value(obs_run, monkeypatch, capsys):
    monkeypatch.setenv(trace_mod.SAMPLE_ENV, "bogus")
    assert trace_mod.sample_rate() == 1.0
    for _ in range(5):
        trace_mod.mint()
    assert capsys.readouterr().err.count("is not a number") == 1


def test_contextvar_carry(obs_run):
    t = trace_mod.mint()
    assert trace_mod.current() is None
    with trace_mod.use(t):
        assert trace_mod.current() is t
        child = trace_mod.ensure()
        assert child.trace_id == t.trace_id
        assert child.parent_id == t.span_id
    assert trace_mod.current() is None


def test_request_span_records_sum_exactly(obs_run):
    t = trace_mod.mint()
    recs = trace_mod.request_span_records(
        t, label="1024:natural:split3", rid=7, t_submit=10.0,
        t_dequeue=10.002, t_exec=10.005, compute_s=0.003,
        t_done=10.0085, tags=["slo:torch-fft"],
        marks=[("failover:vdev2", 10.004)])
    assert [r["name"] for r in recs] == [
        "serve_request", "queue", "window", "compute",
        "degrade:slo:torch-fft", "failover:vdev2"]
    by = {r["name"]: r for r in recs}
    assert by["queue"]["dur_s"] == pytest.approx(0.002)
    assert by["window"]["dur_s"] == pytest.approx(0.003)
    assert by["compute"]["dur_s"] == pytest.approx(0.003)
    for r in recs[1:]:
        assert r["parent_sid"] == t.span_id and r["trace"] == t.trace_id


def test_emit_respects_sampling_and_tail_upgrade(obs_run):
    unsampled = trace_mod.TraceContext("tid", "sid", sampled=False)
    recs = trace_mod.request_span_records(
        unsampled, label="l", rid=0, t_submit=0.0, t_dequeue=0.0,
        t_exec=0.0, compute_s=0.0, t_done=0.0)
    assert not trace_mod.emit_request_trace(unsampled, recs)
    assert events.span_snapshot() == []
    assert trace_mod.emit_request_trace(unsampled, recs, forced=True)
    assert len(events.span_snapshot()) == len(recs)
    tree = trace_mod.wire_tree(unsampled, recs, emitted=True)
    assert tree["trace_id"] == "tid" and tree["spans"]
    assert "spans" not in trace_mod.wire_tree(unsampled, recs,
                                              emitted=False)


def test_shed_record_leaves_a_root_span(obs_run):
    t = trace_mod.mint()
    trace_mod.shed_record(t, label="l", t_submit=spans.clock(),
                          reason="queue_full")
    rec = events.span_snapshot()[-1]
    assert rec["name"] == "serve_request" and rec["error"] == "queue_full"
    assert rec["args"]["shed"] is True


# ---------------------------------------------------- burn-rate alerts


def test_objective_validation_and_load(tmp_path):
    with pytest.raises(ValueError):
        Objective("x", -1.0)
    with pytest.raises(ValueError):
        Objective("x", 10.0, error_budget=0.0)
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({
        "windows": [2, 10],
        "objectives": [{"name": "conv", "match": "conv",
                        "p99_target_ms": 40, "error_budget": 0.02}]}))
    objectives, windows = load_objectives(str(path))
    assert windows == (2.0, 10.0)
    assert objectives[0].applies("conv", "whatever")
    assert not objectives[0].applies("fft", "other")
    bad = tmp_path / "bad.json"
    bad.write_text("{\"objectives\": []}")
    with pytest.raises(ValueError):
        load_objectives(str(bad))
    with pytest.raises(ValueError, match="duplicate"):
        SloMonitor([Objective("dup", 10.0), Objective("dup", 20.0)])


def test_forced_level_refreshes_across_idle_gap(obs_run):
    mon = SloMonitor([Objective("o", 20.0, 0.05)], windows=(10, 30))
    t0 = 1000.0
    for i in range(6):
        mon.observe("fft", "l", 100.0, t=t0 + i)
    mon.evaluate(t=t0 + 6)
    # the port's cheap rung is the degrade chain's torch-fft
    assert mon.forced_level(t=t0 + 6) == "torch-fft"
    assert mon.forced_level(t=t0 + 600) is None
    assert not mon.alerting()["o"]


def test_burn_rate_fires_and_resolves(obs_run):
    mon = SloMonitor([Objective("o", 20.0, 0.05)], windows=(10.0, 30.0))
    t0 = 1000.0
    for i in range(6):
        mon.observe("fft", "l", 100.0, t=t0 + i)
    mon.evaluate(t=t0 + 6)
    assert mon.alerting()["o"]
    assert mon.forced_level(t=t0 + 6) == "torch-fft"
    assert metrics.counter_value("pifft_slo_alerts_total",
                                 objective="o", state="firing") == 1
    assert any(k.startswith("pifft_slo_burn_rate")
               for k in metrics.snapshot()["gauges"])
    for i in range(8):
        mon.observe("fft", "l", 1.0, t=t0 + 40 + i)
    mon.evaluate(t=t0 + 48)
    assert not mon.alerting()["o"]
    assert mon.forced_level(t=t0 + 48) is None
    gauges = metrics.snapshot()["gauges"]
    burn = [v for k, v in gauges.items()
            if k.startswith("pifft_slo_burn_rate")]
    assert burn and all(v == 0.0 for v in burn), gauges
    alerts = [e for e in obs.snapshot() if e.get("kind") == "slo_alert"]
    assert [e["payload"]["state"] for e in alerts] == ["firing",
                                                      "resolved"]
    assert not [p for e in alerts for p in events.validate_event(e)]


def test_too_few_samples_never_alert(obs_run):
    mon = SloMonitor([Objective("o", 20.0, 0.05)], windows=(10, 30))
    mon.observe("fft", "l", 999.0, t=1.0)
    mon.evaluate(t=1.5)
    assert not mon.alerting()["o"]


def test_slomon_describe_round_trips_json():
    mon = SloMonitor([Objective("o", 20.0)], windows=(5, 60))
    json.dumps(mon.describe())


# ------------------------------------------------------- live endpoints


def test_telemetry_server_without_dispatcher(obs_run):
    """The bare plane: /metrics serves the live registry, /healthz 200
    with the run, /slo an empty table, anything else 404."""
    from cs87project_msolano2_tpu_torch.obs.http import (
        TelemetryServer,
        fetch_json,
        fetch_text,
    )

    metrics.inc("pifft_plan_cache_hits_total", level="memory")
    server = TelemetryServer(None).start()
    try:
        text = fetch_text(server.url("/metrics"))
        assert 'pifft_plan_cache_hits_total{level="memory"} 1' in text
        health = fetch_json(server.url("/healthz"))
        assert health["ok"] and health["obs_enabled"]
        assert health["run"] == obs_run
        assert fetch_json(server.url("/slo")) == {"window_s": None,
                                                  "rows": {}}
        with pytest.raises(urllib.error.HTTPError) as e:
            fetch_text(server.url("/nope"))
        assert e.value.code == 404
    finally:
        server.stop()


def test_format_top_renders():
    from cs87project_msolano2_tpu_torch.obs.http import format_top

    frame = format_top(
        {"window_s": 60.0,
         "rows": {"1024:natural:split3": {
             "requests": 3, "degraded": 1, "queue_p99_ms": 1.0,
             "compute_p99_ms": 2.0, "total_p50_ms": 2.5,
             "total_p99_ms": 3.0}}},
        {"ok": True, "uptime_s": 12.0, "queued": 0,
         "devices": [{"state": "healthy"}], "devices_alive": 1})
    assert "SERVING" in frame and "1024:natural:split3" in frame
    assert "NOT SERVING" in format_top({"rows": {}}, {"ok": False})


def test_obs_top_once_renders_live_server(obs_run, capsys):
    from cs87project_msolano2_tpu_torch.cli import main as cli_main
    from cs87project_msolano2_tpu_torch.obs.http import TelemetryServer

    server = TelemetryServer(None).start()
    try:
        rc = cli_main(["obs", "top", "--once", "--url", server.url()])
    finally:
        server.stop()
    assert rc == 0
    assert "pifft live telemetry" in capsys.readouterr().out
    assert cli_main(["obs", "top", "--once",
                     "--url", "http://127.0.0.1:9"]) == 1
    assert "no telemetry plane" in capsys.readouterr().err


def test_telemetry_server_stops_cleanly(obs_run):
    import socket

    from cs87project_msolano2_tpu_torch.obs.http import TelemetryServer

    server = TelemetryServer(None).start()
    port = server.port
    server.stop()
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()


# ------------------------------------------------------ wiring (units)


def test_retry_wiring(obs_run):
    from cs87project_msolano2_tpu_torch import resilience

    state = {"calls": 0}

    def flaky():
        state["calls"] += 1
        if state["calls"] == 1:
            raise ConnectionError("connection reset by peer")
        return 42

    out = resilience.call_with_retry(
        flaky, policy=resilience.FAST_POLICY, sleep=lambda s: None,
        label="obs test")
    assert out == 42
    assert metrics.counter_value("pifft_retries_total",
                                 kind="transient") == 1
    retry = [e for e in events.snapshot() if e["kind"] == "retry"]
    assert retry and retry[0]["payload"]["label"] == "obs test"

    def dead():
        raise ConnectionError("connection reset by peer")

    with pytest.raises(ConnectionError):
        resilience.call_with_retry(dead, policy=resilience.FAST_POLICY,
                                   sleep=lambda s: None, label="dead")
    exhausted = [e for e in events.snapshot()
                 if e["kind"] == "retry_exhausted"]
    assert exhausted and exhausted[-1]["payload"]["label"] == "dead"


def test_demotion_wiring(obs_run):
    from cs87project_msolano2_tpu_torch import plans, resilience

    plans.cache.clear(memory=True)
    key = plans.make_key(256, layout="pi", device=CPU)
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    try:
        with resilience.inject("tube", "capacity"):
            plan = plans.get_plan(key, CPU)
            plan.execute(xr, xi)
        assert plan.degraded
        rung = plan.demotions[-1]["to"]
        assert metrics.counter_value("pifft_demotions_total", to=rung) == 1
        demo = [e for e in events.snapshot() if e["kind"] == "demotion"]
        assert demo and demo[-1]["payload"]["to"] == rung
        assert demo[-1]["cell"] == {"n": 256, "variant": plan.variant}
    finally:
        plans.cache.clear(memory=True)  # never leak the degraded plan


def test_plan_cache_metrics_wiring(obs_run):
    from cs87project_msolano2_tpu_torch import plans

    plans.cache.clear(memory=True)
    key = plans.make_key(128, layout="pi", device=CPU)
    plans.get_plan(key, CPU)   # miss -> static default memoized
    plans.get_plan(key, CPU)   # memory hit
    assert metrics.counter_value("pifft_plan_cache_misses_total") >= 1
    assert metrics.counter_value("pifft_plan_cache_hits_total",
                                 level="memory") >= 1
    plans.cache.clear(memory=True)


def test_autotune_span_fates_and_plan_tuned(obs_run):
    """The race with an injected timer: one ``autotune`` span, every
    candidate's fate counted, one ``plan_tuned`` event."""
    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.plans import autotune, ladder

    key = plans.make_key(1 << 20, layout="pi", device=CPU)
    cands = ladder.candidates(key)
    timer_calls = []

    def timer(fn, k):
        timer_calls.append(1)
        if len(timer_calls) == 1:
            raise ValueError("refused for the test")
        return float(len(timer_calls))

    try:
        plan = autotune.tune(key, force=True, persist=False, timer=timer,
                             verbose=False, allow_offline=True, device=CPU)
    finally:
        plans.cache.clear(memory=True)
    assert [s["name"] for s in events.span_snapshot()] == ["autotune"]
    fates = {k: v for k, v in metrics.snapshot()["counters"].items()
             if k.startswith("pifft_autotune_candidates_total{")}
    assert sum(fates.values()) == len(cands)
    assert any('status="rejected"' in k for k in fates)
    tuned = [e for e in events.snapshot() if e["kind"] == "plan_tuned"]
    assert len(tuned) == 1
    assert tuned[0]["cell"] == {"n": key.n, "variant": plan.variant}
    assert len(tuned[0]["payload"]["candidates"]) == len(cands)


def test_pi_fft_phase_spans(obs_run):
    from cs87project_msolano2_tpu_torch.models.pi_fft import (
        pi_fft_pi_layout,
        pi_fft_pi_layout_scan,
    )

    x = torch.zeros(256)
    pi_fft_pi_layout(x, x, 8)
    pi_fft_pi_layout_scan(x, x, 4)
    recs = events.span_snapshot()
    assert [r["name"] for r in recs] == ["funnel", "tube", "funnel", "tube"]
    assert [r["cell"] for r in recs] == [{"n": 256, "p": 8}] * 2 \
        + [{"n": 256, "p": 4}] * 2


def test_harness_sweep_emits_cell_events_and_eta(tmp_path, obs_run):
    from cs87project_msolano2_tpu_torch.harness.run_experiments import sweep

    path = sweep("torch", [64], [1], 2, str(tmp_path), True, 0, device=CPU)
    assert path.startswith(str(tmp_path))
    evs = events.snapshot()
    cells = [e for e in evs if e["kind"] == "sweep_cell"]
    assert len(cells) == 2
    for e in cells:
        assert e["cell"]["n"] == 64 and e["cell"]["p"] == 1
        assert e["payload"]["total_ms"] > 0 and e["payload"]["dur_s"] >= 0
    prog = [e for e in evs if e["kind"] == "sweep_progress"]
    assert prog
    last = prog[-1]["payload"]
    assert last["completed"] == last["todo"] == 2 and last["eta_s"] == 0.0
    names = [s["name"] for s in events.span_snapshot()]
    assert names.count("sweep_cell") == 2


def test_spawned_ranks_append_to_one_sink(tmp_path, monkeypatch):
    """``PIFFT_OBS_EVENTS`` arms every rank of a ``spawn_local`` job at
    import: the ranks append to one sink, each with its own run id, and
    their collective spans and events validate."""
    from cs87project_msolano2_tpu_torch.parallel.checks import (
        consensus_rank,
    )
    from cs87project_msolano2_tpu_torch.parallel.multihost import (
        spawn_local,
    )

    path = str(tmp_path / "ranks.jsonl")
    monkeypatch.setenv("PIFFT_OBS_EVENTS", path)
    ranks = spawn_local(consensus_rank, 2, "gloo", CPU, "env-ranks", 20.0)
    assert [r["out"] for r in ranks] == [1, 1]
    assert all(r["events"] == ["fallback_consensus"] for r in ranks)
    recs, dropped = events.load_events(path)
    assert dropped == 0 and export.validate_stream(recs) == []
    runs = {r["run"] for r in recs}
    assert len(runs) == 2
    for run in runs:
        kinds = {r["kind"] for r in recs if r["run"] == run}
        assert {"distributed_init", "fallback_consensus"} <= kinds
    assert {"collective:init_distributed",
            "collective:fallback_consensus"} <= {
        s["name"] for s in export.spans_from_events(recs)}


def test_profiler_shim_still_works():
    import importlib
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        import cs87project_msolano2_tpu_torch.utils.tracing as shim

        importlib.reload(shim)
    assert shim.trace is profiler.trace
    with shim.trace(None):  # the disabled path is a pure no-op
        pass


# --------------------------------------------- torch.profiler on the CPU


def _trace_names(outdir) -> set:
    files = glob.glob(os.path.join(str(outdir), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return {e.get("name") for e in json.load(fh)["traceEvents"]}


def test_profiler_trace_holds_annotated_spans(tmp_path, obs_run):
    """``obs.profiler.trace`` writes a torch.profiler Chrome trace whose
    ``record_function`` ranges name the annotated funnel/tube spans."""
    from cs87project_msolano2_tpu_torch.models.pi_fft import pi_fft_pi_layout

    x = torch.ones(512)
    with profiler.trace(str(tmp_path / "armed")):
        pi_fft_pi_layout(x, x, 8)
    assert {"funnel", "tube"} <= _trace_names(tmp_path / "armed")
    kinds = [e["kind"] for e in events.snapshot()]
    assert "profile_start" in kinds and "profile_written" in kinds


def test_profiler_trace_names_nothing_while_disarmed(tmp_path):
    """Disarmed spans enter no record_function: the off state is one
    attribute read."""
    from cs87project_msolano2_tpu_torch.models.pi_fft import pi_fft_pi_layout

    x = torch.ones(512)
    with profiler.trace(str(tmp_path)):
        pi_fft_pi_layout(x, x, 8)
    assert not {"funnel", "tube"} & _trace_names(tmp_path)


def test_profiler_unavailable_runs_the_block(tmp_path, obs_run, monkeypatch,
                                             capsys):
    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with profiler.trace(str(tmp_path)):
        ran.append(1)
    assert ran == [1]
    assert "profiling unavailable" in capsys.readouterr().err
    kinds = [e["kind"] for e in events.snapshot()]
    assert kinds == ["profile_unavailable"]


# ------------------------------------------- parity with the reference


def _drive(o):
    """One fixed sequence of emits, spans and metric calls through the
    `o` package's obs."""
    o.emit("demo", cell={"n": 64, "p": 8}, value=3)
    with o.span("cell", cell={"name": "flagship", "n": 64}, backend="x"):
        with o.span("funnel", cell={"n": 64, "p": 8}) as sp:
            sp.set(extra=1)
        with o.span("tube", cell={"n": 64, "p": 8}, links=["a"], sid="s1",
                    trace_id="t1"):
            pass
    try:
        with o.span("doomed"):
            raise ValueError("boom")
    except ValueError:
        pass
    o.metrics.inc("pifft_plan_cache_hits_total", 2, level="memory")
    o.metrics.inc("pifft_plan_cache_misses_total")
    o.metrics.inc("pifft_test_total", shape='with"quote', note="a\nb")
    o.metrics.set_gauge("pifft_roofline_util", 0.41, n="2^22")
    for v in (0.003, 0.3, 7.0):
        o.metrics.observe("pifft_cell_seconds", v, phase="tube")
    o.emit("retry", label="x", kind="transient", attempt=1)
    o.emit("metrics", snapshot=o.metrics.snapshot())
    return o.snapshot()


def _steady(rec: dict) -> dict:
    """`rec` without the keys that differ between two runs."""
    out = {k: v for k, v in rec.items() if k not in VOLATILE}
    if isinstance(out.get("payload"), dict):
        out["payload"] = {k: v for k, v in out["payload"].items()
                          if k not in VOLATILE}
    return out


def _zeroed(rec: dict) -> dict:
    out = dict(rec, run="r", t=0.0)
    if out.get("kind") == "span":
        out["payload"] = dict(out["payload"], ts_s=0.0, dur_s=0.0, tid=0)
    return out


def test_records_prometheus_and_summary_match_the_reference(tmp_path):
    port_path, ref_path = str(tmp_path / "port.jsonl"), \
        str(tmp_path / "ref.jsonl")
    obs.enable(events_path=port_path)
    ref_obs.enable(events_path=ref_path)
    port = _drive(obs)
    ref = _drive(ref_obs)
    assert [_steady(r) for r in port] == [_steady(r) for r in ref]
    assert export.prometheus_text() == ref_export.prometheus_text()
    assert export.summarize([_zeroed(r) for r in port]) \
        == ref_export.summarize([_zeroed(r) for r in ref])
    obs.disable()
    ref_obs.disable()
    # each package validates the other's stream, as written to disk
    port_file, _ = events.load_events(port_path)
    ref_file, _ = ref_obs.events.load_events(ref_path)
    assert port_file and ref_file
    assert ref_export.validate_stream(port_file) == []
    assert export.validate_stream(ref_file) == []
    assert export.chrome_trace(export.spans_from_events(port_file))[
        "traceEvents"][0].keys() == ref_export.chrome_trace(
        ref_export.spans_from_events(ref_file))["traceEvents"][0].keys()


def test_wiring_records_match_the_reference():
    """The retry layer's events and counters, through both packages."""
    from cs87project_msolano2_tpu import resilience as ref_resilience
    from cs87project_msolano2_tpu_torch import resilience

    def run(o, res):
        o.enable()
        state = {"calls": 0}

        def flaky():
            state["calls"] += 1
            if state["calls"] < 3:
                raise ConnectionError("connection reset by peer")
            return 1

        res.call_with_retry(flaky, policy=res.FAST_POLICY,
                            sleep=lambda s: None, rng=lambda: 0.5,
                            label="parity")
        recs = [_steady(r) for r in o.snapshot()
                if r["kind"] in ("retry", "retry_exhausted")]
        text = o.export.prometheus_text()
        o.disable()
        return recs, text

    assert run(obs, resilience) == run(ref_obs, ref_resilience)


def test_bench_smoke_events_match_the_reference(tmp_path, capsys,
                                                monkeypatch):
    """Both benches' ``--smoke --events`` runs on the CPU name the same
    spans and metric series; the port leaves out only the reference's
    forced sixstep cell (its serving suites do not run under --smoke)
    and adds exactly its transform path's spans and counters
    (``obs.TRANSFORM_PATH``), less ``kernel.launch`` (the CPU launches
    no kernel) and the protective-copy counter (no CPU plan writes over
    its input).  The port's stream validates, its record carries the run id every
    event shares, its cell spans nest the funnel/tube probe, the
    ``metrics`` event comes last, and ``--trace-out`` and the ``obs``
    CLI read it."""
    import bench as ref_bench

    from cs87project_msolano2_tpu import plans as ref_plans
    from cs87project_msolano2_tpu.apps import spectral as ref_spectral
    from cs87project_msolano2_tpu.ops import anylen as ref_anylen
    from cs87project_msolano2_tpu_torch import bench, plans
    from cs87project_msolano2_tpu_torch.apps import spectral
    from cs87project_msolano2_tpu_torch.cli import main as cli_main
    from cs87project_msolano2_tpu_torch.ops import anylen, bits

    def run(bench_mod, o, argv, name):
        # both runs start from empty in-process caches: a hit or a miss
        # is a series of its own
        for clear in (plans.cache.clear, ref_plans.cache.clear):
            clear(memory=True)
        for clear in (spectral.kernel_spectrum_cache_clear,
                      spectral.fused_cache_clear,
                      ref_spectral.kernel_spectrum_cache_clear,
                      anylen.chirp_cache_clear, ref_anylen.chirp_cache_clear,
                      ref_spectral._FUSED_CACHE.clear,
                      bits._index_tensor.cache_clear):
            clear()
        epath = str(tmp_path / f"{name}.jsonl")
        assert _bench_smoke(bench_mod, monkeypatch, argv + [
            "--smoke", "--events", epath,
            "--trace-out", str(tmp_path / f"{name}.json")]) == 0
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        o.disable()
        recs, dropped = o.events.load_events(epath)
        assert dropped == 0 and recs
        return rec, recs, epath

    rec, recs, epath = run(bench, obs, ["--device", CPU], "port")
    _, ref_recs, _ = run(ref_bench, ref_obs, [], "ref")

    def names(rs, drop_cells=()):
        sps = [s for s in export.spans_from_events(rs)
               if (s.get("cell") or {}).get("name") not in drop_cells]
        return {s["name"] for s in sps}

    def series(rs):
        snap = export.last_metrics_snapshot(rs)
        return {k for fam in ("counters", "gauges", "histograms")
                for k in snap[fam]}

    # the forced sixstep cell (the port's 2^25-2^27 card rows run
    # sixstep instead) adds its span and, where its plan demotes (the
    # reference's sixstep kernel does not lower on jax 0.9), the
    # demotion's series
    assert [s for s in export.spans_from_events(ref_recs)
            if (s.get("cell") or {}).get("name") == "sixstep_smoke"]
    sixstep_demotions = {
        f'pifft_demotions_total{{to="{e["payload"]["to"]}"}}'
        for e in ref_recs if e["kind"] == "demotion"
        and (e.get("cell") or {}).get("variant") == "sixstep"}
    path = set(obs.TRANSFORM_PATH)
    path_counters = {n for n in path if n.startswith("pifft_")}
    assert names(recs) == (names(ref_recs) - {"sixstep"}) \
        | (path - path_counters - {"kernel.launch"})
    assert series(recs) == (series(ref_recs) - sixstep_demotions) \
        | (path_counters - {"pifft_plan_input_copies_total"})

    # the port's stream on its own
    assert export.validate_stream(recs) == []
    assert rec["run"] and all(e["run"] == rec["run"] for e in recs)
    assert recs[-1]["kind"] == "metrics" and recs[-2]["kind"] == "env"
    cells = [s for s in export.spans_from_events(recs) if s["name"] == "cell"]
    phases = [s for s in export.spans_from_events(recs)
              if s["name"] in ("funnel", "tube")]
    assert cells and phases and all(p["parent"] == "cell" for p in phases)
    snap = export.last_metrics_snapshot(recs)
    assert sum(v for k, v in snap["counters"].items()
               if k.startswith("pifft_plan_cache_")) > 0
    assert rec["conv2^10_hbm_bytes"] > 0
    with open(tmp_path / "port.json") as fh:
        assert {e["name"] for e in json.load(fh)["traceEvents"]} >= \
            {"cell", "funnel", "tube"}
    assert cli_main(["obs", "validate", "--events", epath]) == 0
    assert cli_main(["obs", "summary", "--events", epath, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert summary["runs"] == [rec["run"]]
    assert cli_main(["obs", "export", "--format", "prom", "--events",
                     epath, "--out", str(tmp_path / "m.prom")]) == 0
    with open(tmp_path / "m.prom") as fh:
        for line in fh.read().splitlines():
            if not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])


# ------------------------------------- the live plane in the serve rules
#
# The reference's tests/test_telemetry.py:725-763 on the port's checker.


def test_obs_http_in_pif107_and_pif112_scope():
    """The live plane sits inside the serve concurrency rules' scope:
    both configs name obs/http.py."""
    import fnmatch

    from cs87project_msolano2_tpu_torch.check.rules import (
        BlockingCallInAsyncServePath,
    )
    from cs87project_msolano2_tpu_torch.check.rules_flow import (
        UnguardedSharedStateWrite,
    )

    path = "/repo/cs87project_msolano2_tpu_torch/obs/http.py"
    for rule in (BlockingCallInAsyncServePath, UnguardedSharedStateWrite):
        pats = rule.default_config["paths"]
        assert any(fnmatch.fnmatch(path, p) for p in pats), (rule.id, pats)


def test_pif107_flags_async_blocking_in_obs_http(tmp_path):
    """A constructed async time.sleep (or a device sync) in an
    obs/http.py path is a finding; the shipped module stays clean."""
    from cs87project_msolano2_tpu_torch.check.engine import check_paths
    import cs87project_msolano2_tpu_torch.obs.http as http_mod

    target = tmp_path / "obs" / "http.py"
    target.parent.mkdir()
    target.write_text("import time\n\n\nasync def handler(t):\n"
                      "    time.sleep(1)\n    return t.item()\n")
    findings = check_paths([str(target)], rules=["PIF107"])
    assert [f.rule for f in findings] == ["PIF107", "PIF107"]
    assert not check_paths([http_mod.__file__], rules=["PIF107", "PIF112"])
