"""The port's own spans in the traced run: every cell's traced CPU run at
a small size carries the transform path's spans on the clock of the
benchmark's spans, the host metrics that read them partition a call,
and the idle-gap tagging names the innermost program span."""

import pytest

from benchlib import cell, inputs, program, spec, trace

from test_benchmark_cells import SMALL, WORKLOADS

HOST = ("api_host_us", "plan_lookup_us", "execute_host_us", "launch_host_us")


def _traced_run(workload, monkeypatch):
    """(result, Trace, the port's intervals) of one traced CPU run."""
    kept = []
    traced = trace.traced

    def keep(fn, port_kernels):
        result, tr = traced(fn, port_kernels)
        kept.append(tr)
        return result, tr

    monkeypatch.setattr(trace, "traced", keep)
    c = spec.load_cell(workload)
    result, _ = cell.run_cell(c, 2**31 + 29, 0.1, True, device="cpu",
                              shape=SMALL[c.config["name"]])
    ivs = inputs.port("obs.spans").intervals()
    return result, kept[0], ivs


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_cpu_run_carries_program_spans(workload, monkeypatch):
    result, tr, ivs = _traced_run(workload, monkeypatch)
    assert result["correct"]
    calls = [iv for iv in ivs if iv[0] == "fft.call"]
    assert calls and len(calls) == result["attempted"]
    # every call lies inside the harness's span of it, on one clock
    issues = tr.spans["bench.issue"]
    slack = 20_000
    for _, _, _, _, start, end in calls:
        assert any(s - slack <= start and end <= e + slack
                   for s, e in issues)
    # the host metrics partition the mean call, which the harness's own
    # span of the call holds
    metrics = result["metrics"]
    suffix = ".sync" if workload.endswith(".sync") else ""
    host = [metrics[name + suffix]["value"] for name in HOST]
    mean_call_us = sum(e - s for *_, s, e in calls) / len(calls) / 1e3
    assert all(v >= 0 for v in host)
    assert sum(host) == pytest.approx(mean_call_us, rel=1e-9)
    assert metrics["launch_host_us" + suffix]["value"] == 0.0
    issue_us = sum(e - s for s, e in issues) / len(issues) / 1e3
    assert mean_call_us <= issue_us
    # the CPU has no device trace to set the idle share against
    assert "entry_idle_pct" + suffix not in metrics


def _synthetic():
    """A 100 us window: device busy [0, 10) and [60, 100); the host in
    one call [5, 95), its execute [20, 80) and a gather [30, 50)."""
    us = 1000
    tr = trace.Trace(window=(0, 100 * us),
                     device=[("k", 0, 10 * us), ("k", 60 * us, 100 * us)],
                     spans={"bench.window": [(0, 100 * us)],
                            "bench.issue": [(4 * us, 96 * us)],
                            "bench.wait": []},
                     port_kernels=("k",))
    ivs = [("fft.call", None, 0, 1, 5 * us, 95 * us),
           ("plan.execute", "fft.call", 1, 1, 20 * us, 80 * us),
           ("fft.gather", "plan.execute", 2, 1, 30 * us, 50 * us)]
    return tr, ivs


def test_idle_gaps_name_the_innermost_program_span():
    tr, ivs = _synthetic()
    # the one gap, [10, 60) us, has its middle at 35 us: in the gather
    assert program.idle_gaps(tr, ivs) == [["fft.gather", 50e-6]]
    assert program.innermost(ivs, 15_000) == "fft.call"
    assert program.innermost(ivs, 99_000) is None
    # with no program span there, the harness's own names stay
    assert program.idle_gaps(tr, []) == [["bench.issue", 50e-6]]
    assert program.entry_idle_ns(tr, ivs) == 50_000


def test_host_split_partitions_the_call(monkeypatch):
    tr, ivs = _synthetic()
    ivs = ivs + [("kernel.launch", "plan.execute", 2, 1, 55_000, 58_000),
                 ("plan.lookup", "fft.call", 1, 1, 6_000, 8_000),
                 ("other", None, 0, 1, 96_000, 99_000)]

    class Run:
        trace = tr

    monkeypatch.setattr(inputs.port("obs.spans"), "intervals", lambda: ivs)
    split = program.host_split(Run())
    assert split == {"api": 90 - 60 - 2, "lookup": 2.0,
                     "execute": 60 - 3, "launch": 3.0}
