"""The transform path's spans and counters (``obs.TRANSFORM_PATH``) on
the CPU: off, the entries build no span and record nothing; on, each
call records exactly its tree, whose self times partition ``fft.call``,
on the Unix-nanosecond clock; a torch.profiler session records the same
spans with observability off; the counters count the plan's protective
copies and the gather's index builds.  ``kernel.launch`` is checked on a
card only (the CPU runs the plain versions, which launch nothing)."""

import threading
import time

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu_torch import obs, plans
from cs87project_msolano2_tpu_torch.models.fft import fft, fft_planes_fast
from cs87project_msolano2_tpu_torch.models.real import rfft
from cs87project_msolano2_tpu_torch.obs import events, metrics, spans
from cs87project_msolano2_tpu_torch.ops import bits
from cs87project_msolano2_tpu_torch.plans import Plan

CPU = "cpu"
SPANS = tuple(n for n in obs.TRANSFORM_PATH if not n.startswith("pifft_"))

#: (name, parent, depth) of each span of one call, in the order they
#: close, on the CPU's static plans
C2C_TREE = [("fft.split", "fft.call", 1), ("plan.lookup", "fft.call", 1),
            ("fft.gather", "plan.execute", 2),
            ("plan.execute", "fft.call", 1), ("fft.join", "fft.call", 1),
            ("fft.call", None, 0)]
PI_TREE = [("fft.split", "fft.call", 1), ("plan.lookup", "fft.call", 1),
           ("plan.execute", "fft.call", 1), ("fft.call", None, 0)]
R2C_TREE = [("fft.split", "fft.call", 1), ("plan.lookup", "fft.call", 1),
            ("real.pack", "plan.execute", 2),
            ("fft.gather", "plan.execute", 2),
            ("real.merge", "plan.execute", 2),
            ("plan.execute", "fft.call", 1), ("fft.join", "fft.call", 1),
            ("fft.call", None, 0)]


@pytest.fixture(autouse=True)
def _off_and_clean(monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", "off")
    for var in ("PIFFT_OBS", "PIFFT_OBS_EVENTS"):
        monkeypatch.delenv(var, raising=False)
    metrics.reset()
    yield
    if obs.enabled():
        obs.disable()
    spans._REC = None
    metrics.reset()


def _calls():
    """One call of each entry, with its expected tree."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 256, dtype=torch.complex64, generator=gen)
    xr, xi = torch.randn(2, 1024, generator=gen)
    real = torch.randn(4, 512, generator=gen)
    return [(lambda: fft(x), C2C_TREE),
            (lambda: fft_planes_fast(xr, xi, natural=False), PI_TREE),
            (lambda: rfft(real), R2C_TREE)]


def _tree(recs):
    return [(r["name"], r.get("parent"), r["depth"]) for r in recs]


@pytest.mark.parametrize("entry", ["fft", "fft_planes_fast", "rfft"])
def test_off_the_entries_build_no_span_and_record_nothing(entry,
                                                          monkeypatch):
    call, _ = _calls()[["fft", "fft_planes_fast", "rfft"].index(entry)]
    call()  # plans and indexes resolved once, as a warm caller has them
    built = []

    class Counted(spans._PathSpan):
        __slots__ = ()

        def __init__(self, name):
            built.append(name)
            super().__init__(name)

    monkeypatch.setattr(spans, "_PathSpan", Counted)
    monkeypatch.setattr(spans, "Span", None)  # a general span would raise
    for _ in range(3):
        call()
    assert built == [] and spans._REC is None
    assert obs.intervals() == [] and events.snapshot() == []
    assert metrics.snapshot()["counters"] == {}


@pytest.mark.parametrize("entry", ["fft", "fft_planes_fast", "rfft"])
def test_on_each_call_records_exactly_its_tree(entry):
    call, tree = _calls()[["fft", "fft_planes_fast", "rfft"].index(entry)]
    call()
    obs.enable()
    call()
    call()
    recs = events.span_snapshot()
    assert _tree(recs) == tree * 2
    assert {r["name"] for r in recs} <= set(SPANS)
    # the stream's records keep the envelope every span has had
    for r in recs:
        assert set(r) <= {"name", "ts_s", "dur_s", "tid", "depth", "parent"}
        assert r["dur_s"] >= 0 and r["ts_s"] >= 0
    assert [e["payload"]["name"] for e in events.snapshot()
            if e["kind"] == "span"] == [r["name"] for r in recs]
    assert events.validate_event(events.snapshot()[0]) == []


def _self_times(ivs):
    """{index: self ns} of each interval: its duration less its direct
    children's, the children found by nesting on one thread."""
    order = sorted(range(len(ivs)), key=lambda i: (ivs[i][3], ivs[i][4],
                                                   -ivs[i][5]))
    self_ns = {i: ivs[i][5] - ivs[i][4] for i in order}
    stack = []
    for i in order:
        _, _, _, tid, start, end = ivs[i]
        while stack and (ivs[stack[-1]][3] != tid
                         or ivs[stack[-1]][5] <= start):
            stack.pop()
        if stack:
            parent = ivs[stack[-1]]
            assert parent[4] <= start and end <= parent[5]
            assert ivs[i][1] == parent[0]
            self_ns[stack[-1]] -= end - start
        stack.append(i)
    return self_ns


def test_self_times_partition_fft_call():
    calls = _calls()
    for call, _ in calls:
        call()
    obs.enable()
    for call, _ in calls:
        call()
    ivs = obs.intervals()
    roots = [iv for iv in ivs if iv[0] == "fft.call"]
    assert len(roots) == 3
    self_ns = _self_times(ivs)
    assert all(v >= 0 for v in self_ns.values())
    assert sum(self_ns.values()) == sum(iv[5] - iv[4] for iv in roots)


def test_intervals_lie_on_the_unix_ns_clock():
    call, tree = _calls()[0]
    call()
    obs.enable()
    before = time.time_ns()
    call()
    after = time.time_ns()
    ivs = obs.intervals()
    assert [iv[0] for iv in ivs] == [name for name, _, _ in tree]
    # the anchor's rounding and the two clocks' rates: a few us at most
    slack = 50_000
    for name, parent, depth, tid, start, end in ivs:
        assert before - slack <= start <= end <= after + slack
        assert tid == threading.get_ident()


def test_a_profiler_session_records_with_observability_off():
    from torch.profiler import ProfilerActivity, profile

    call, tree = _calls()[0]
    call()
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
        call()
    after = time.time_ns()
    ivs = obs.intervals()
    assert [(n, p, d) for n, p, d, *_ in ivs] == tree * 2
    assert all(before <= iv[4] <= iv[5] <= after for iv in ivs)
    # nothing reaches the event stream or the counters
    assert not obs.enabled() and events.snapshot() == []
    assert metrics.snapshot()["counters"] == {}
    # the first call after the session closes ends the recording
    call()
    assert spans._REC is None and obs.intervals() == []


def test_a_profiler_recorder_keeps_the_newest_spans():
    spans._REC = spans.Recorder(4)
    for i in range(6):
        with spans.path_span(f"s{i}"):
            pass
    assert [iv[0] for iv in obs.intervals()] == ["s2", "s3", "s4", "s5"]
    assert spans._REC.lost == 2


def test_a_full_stream_recorder_drains_into_the_stream():
    obs.enable(buffer_max=4)
    for i in range(10):
        with spans.path_span(f"s{i}"):
            pass
    assert [r["name"] for r in events.span_snapshot()] == \
        ["s6", "s7", "s8", "s9"]
    # ten span events and the overflow's warning, four kept
    assert events.dropped() == 10 + 1 - 4


def test_plan_input_copies_count_a_fused_alias_clone():
    n = 1 << 12
    key = plans.make_key(n, layout="pi", device=CPU)
    pl = Plan(key=key, variant="fused-alias", params={"tile": 256, "qb": 1})
    assert pl.fn.consumes_input
    gen = torch.Generator().manual_seed(3)
    xr, xi = torch.randn(2, n, generator=gen)
    keep = xr.clone(), xi.clone()
    obs.enable()
    pl.execute(xr, xi)
    # both of the caller's planes were copied, and left as they were
    assert metrics.counter_value("pifft_plan_input_copies_total") == 2
    assert torch.equal(xr, keep[0]) and torch.equal(xi, keep[1])
    # a numpy input may share memory with planes on the CPU: copied too
    pl.execute(xr.clone(), xi.clone(), source=np.zeros(1))
    assert metrics.counter_value("pifft_plan_input_copies_total") == 2 + 2
    # planes split for the call from a tensor of the caller's: no copy
    pl.execute(xr.clone(), xi.clone(), source=torch.zeros(1))
    assert metrics.counter_value("pifft_plan_input_copies_total") == 4


def test_gather_index_builds_count_one_per_n_and_device():
    bits._index_tensor.cache_clear()
    obs.enable()
    for n in (16, 32, 16, 32, 64):
        y = torch.arange(n, dtype=torch.float32)
        bits.to_natural(y, y)
    assert metrics.counter_value("pifft_gather_index_builds_total") == 3
    recs = events.span_snapshot()
    assert [r["name"] for r in recs] == ["fft.gather"] * 5


@pytest.mark.cuda
def test_kernel_launch_spans_match_the_launch_counts():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: kernels launch on the card only")
    from cs87project_msolano2_tpu_torch.ops import cuda_fft

    x = torch.randn(64, 4096, dtype=torch.complex64, device="cuda")
    fft(x)
    torch.cuda.synchronize()
    before = sum(cuda_fft.launch_counts().values())
    obs.enable()
    fft(x)
    fft(x)
    torch.cuda.synchronize()
    launched = sum(cuda_fft.launch_counts().values()) - before
    recs = events.span_snapshot()
    launches = [r for r in recs if r["name"] == "kernel.launch"]
    assert launched > 0 and len(launches) == launched
    assert all(r["parent"] is not None for r in launches)
