"""The port's self-healing multi-rank layer, case for case against the
reference's ``tests/test_multichip_recovery.py``: collective supervision
(heartbeats, strict deadline validation, supervised abort and
cancellation), stall injection, the collective-free escape's bit parity
and its zero collectives, fallback consensus on a real store, the
stall -> abort -> consensus -> escape chain, and the sharded harness's
journaled resume.

The multi-rank cases run on gloo jobs of CPU ranks
(``multihost.spawn_local``), one job per world size in a module
fixture; the stall is injected on every rank.  The collective layer's
events and counters are read from the port's obs, armed around each
case that counts them.
"""

import datetime
import json
import os
import time

import numpy as np
import pytest

from cs87project_msolano2_tpu_torch import obs
from cs87project_msolano2_tpu_torch.parallel.mesh import Mesh
from cs87project_msolano2_tpu_torch.parallel.checks import (
    consensus_rank,
    recovery_rank,
)
from cs87project_msolano2_tpu_torch.parallel.multihost import (
    agree_on_fallback,
    init_distributed,
    spawn_local,
)
from cs87project_msolano2_tpu_torch.resilience import (
    CancellationToken,
    CollectiveAborted,
    CollectiveTimeout,
    FaultSpec,
    HostDesyncError,
    Journal,
    collective_watchdog,
    inject,
    maybe_fault,
    rendezvous_deadline_s,
    supervise_collective,
    watchdog,
)
from cs87project_msolano2_tpu_torch.resilience.watchdog import (
    DEFAULT_RENDEZVOUS_DEADLINE_S,
    abort_waits_default,
)

PORT = "cs87project_msolano2_tpu_torch"
WORLD = 8
#: the drills' supervision: a deadline long enough for 8 ranks on a busy
#: host (the test workers share its cores) to reach the consensus within
#: it, a stall past two of them
DRILL = {"deadline_s": 1.0, "abort_waits": 2, "stall_s": 3.0}
WANTED = ("collective_heartbeat", "collective_abandoned",
          "fallback_consensus", "demotion", "collective_escape_completed")


def rand_c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


X2 = rand_c64((64, 64), 0)
X_CHAOS = rand_c64((32, 32), 1)
F3 = np.random.default_rng(3).standard_normal((16, 16, 8)).astype(np.float32)
F_CHAOS = np.random.default_rng(5).standard_normal((16, 16, 8)).astype(
    np.float32)


def planes(x):
    return np.real(x).astype(np.float32), np.imag(x).astype(np.float32)


#: the whole inputs of the job's cases (``parallel.checks.recovery_rank``)
INPUTS = {"fft2": X2, "poisson": F3, "fft2_drill": X_CHAOS,
          "poisson_drill": F_CHAOS}


@pytest.fixture(scope="module")
def job():
    """label -> the ranks' records (rank order) of the case's call."""
    ranks = spawn_local(recovery_rank, WORLD, "gloo", "cpu", INPUTS, DRILL)
    return {label: [r[label] for r in ranks] for label in ranks[0]}


@pytest.fixture
def records():
    """The port's obs armed for the case: the collective layer's events
    and counters start empty and are dropped after."""
    obs.enable()
    yield
    obs.disable()
    obs.metrics.reset()


def collective_events():
    """The collective layer's events so far, in order."""
    return [r for r in obs.snapshot()
            if r["kind"] in watchdog.COLLECTIVE_KINDS]


def kinds():
    return [r["kind"] for r in collective_events()]


# ------------------------------------------- deadline/knob validation


def test_deadline_env_validated_at_arm_time(monkeypatch, capsys):
    for bad in ("soon", "0", "-5", "inf", "nan"):
        monkeypatch.setenv("PIFFT_RENDEZVOUS_DEADLINE_S", bad)
        assert rendezvous_deadline_s() == DEFAULT_RENDEZVOUS_DEADLINE_S
        err = capsys.readouterr().err
        # the diagnostic names the raw value and the served value
        assert repr(bad) in err and "60" in err
        # strict mode: a malformed knob fails at arm time
        with pytest.raises(ValueError, match="positive finite"):
            rendezvous_deadline_s(strict=True)
        with pytest.raises(ValueError, match="positive finite"):
            with collective_watchdog("region", strict=True):
                pass  # pragma: no cover — arm raises first
    monkeypatch.setenv("PIFFT_RENDEZVOUS_DEADLINE_S", "2.5")
    assert rendezvous_deadline_s(strict=True) == 2.5


def test_abort_waits_env_validated(monkeypatch, capsys):
    monkeypatch.setenv("PIFFT_COLLECTIVE_ABORT_WAITS", "3")
    assert abort_waits_default() == 3
    monkeypatch.setenv("PIFFT_COLLECTIVE_ABORT_WAITS", "zero")
    assert abort_waits_default() == 2
    assert "PIFFT_COLLECTIVE_ABORT_WAITS" in capsys.readouterr().err


def test_init_that_never_forms_is_a_collective_timeout(tmp_path):
    """A job whose other rank never arrives raises CollectiveTimeout
    within the deadline (a file store, and a TCP store with no
    server)."""
    import torch.distributed as dist

    for coordinator in (f"file://{tmp_path / 'store'}",
                        "tcp://127.0.0.1:1"):
        t0 = time.perf_counter()
        with pytest.raises(CollectiveTimeout, match="did not form"):
            init_distributed(coordinator, 2, 1 if "tcp" in coordinator
                             else 0, "gloo", timeout_s=0.5)
        assert time.perf_counter() - t0 < 30
        assert not dist.is_initialized()


# -------------------------------------------------- stall fault specs


def test_stall_spec_parse_and_fire():
    spec = FaultSpec.parse("collective:stall=0.01:1.0:2")
    assert spec.kind == "stall" and spec.stall_s == 0.01
    assert spec.prob == 1.0 and spec.count == 2
    assert FaultSpec.parse("collective:stall").stall_s > 0
    with pytest.raises(ValueError, match="stall"):
        FaultSpec.parse("collective:stall=abc")
    with pytest.raises(ValueError, match="> 0"):
        FaultSpec.parse("collective:stall=-1")
    # a stall delays, never raises, and respects its firing cap
    with inject("collective", "stall", stall_s=0.01, count=2) as live:
        for _ in range(4):
            maybe_fault("collective")
        assert live.fired == 2


# --------------------------------------------------------- supervisor


def test_supervise_collective_fast_region_is_untouched(records):
    value, report = supervise_collective(lambda: 42, "fast",
                                         deadline_s=5.0)
    assert value == 42
    assert report.fired == 0 and not report.aborted
    assert not report.recovered
    assert kinds() == []


def test_supervise_collective_recovers_and_emits(records, capsys):
    with inject("collective", "stall", stall_s=0.3):
        value, report = supervise_collective(
            lambda: "done", "stuck-then-unstuck",
            deadline_s=0.05, abort_waits=50)
    assert value == "done"
    assert report.recovered and report.fired >= 1
    recs = [r for r in collective_events()
            if r["kind"] == "collective_recovered"]
    assert recs and recs[-1]["payload"]["waits"] == report.fired
    assert recs[-1]["payload"]["deadline_s"] == 0.05
    assert obs.metrics.counter_value("pifft_collective_recoveries_total",
                                     label="stuck-then-unstuck") == 1
    assert "collective_recovered" in capsys.readouterr().err


def test_supervise_collective_aborts_past_budget(records):
    # the region itself wedges (a sleep the supervisor cannot interrupt)
    # and outlives the abort budget
    token = CancellationToken()
    with pytest.raises(CollectiveAborted) as exc_info:
        supervise_collective(lambda: time.sleep(0.5) or "late",
                             "wedged", deadline_s=0.05, abort_waits=2,
                             token=token)
    report = exc_info.value.report
    assert report.aborted and report.fired >= 2
    assert token.cancelled()
    assert "collective_heartbeat" in kinds()
    assert "collective_abandoned" in kinds()
    assert obs.metrics.counter_value("pifft_collective_aborts_total",
                                     label="wedged") == 1
    # the abandoned worker finishes anyway and records its late
    # completion instead of losing it
    time.sleep(0.8)
    assert "collective_late_completion" in kinds()


def test_supervised_abort_at_safe_point_never_dispatches(records):
    """A stall before the region (the probe site) cancels at the safe
    point: the region body itself never runs."""
    ran = []
    with inject("collective", "stall", stall_s=0.5):
        with pytest.raises(CollectiveAborted):
            supervise_collective(lambda: ran.append(1), "pre-wedged",
                                 deadline_s=0.05, abort_waits=2)
    time.sleep(0.6)  # let the worker drain past its stall
    assert ran == [], "cancelled region was still dispatched"


def test_cancellation_token_checkpoint_is_a_safe_point():
    token = CancellationToken()
    token.checkpoint("region")  # not cancelled: no-op
    token.cancel("operator said stop")
    with pytest.raises(CollectiveAborted, match="operator said stop"):
        token.checkpoint("region")
    with pytest.raises(CollectiveAborted):
        supervise_collective(lambda: "unreachable", "cancelled-early",
                             deadline_s=5.0, token=token)


def test_supervised_region_exceptions_propagate():
    with pytest.raises(ZeroDivisionError):
        supervise_collective(lambda: 1 // 0, "raises", deadline_s=5.0)


def test_straggler_note_names_co_armed_regions(capsys):
    from cs87project_msolano2_tpu_torch.resilience.watchdog import (
        active_regions,
    )

    with collective_watchdog("regionA", deadline_s=30.0):
        assert "regionA" in active_regions()
        with collective_watchdog("regionB", deadline_s=0.05):
            time.sleep(0.15)  # regionB overruns while regionA is armed
    err = capsys.readouterr().err
    assert "co-armed regions still waiting: regionA" in err
    assert active_regions() == []


# --------------------------------------------------- fallback consensus


class _FakeStore:
    def __init__(self, fail=False):
        self.kv = {}
        self.waits = []
        self.fail = fail

    def set(self, key, value):
        self.kv[key] = value

    def wait(self, keys, timeout):
        if self.fail:
            raise RuntimeError("Wait timeout")
        self.waits.append((list(keys), timeout))


def test_consensus_single_process_trivially_agrees(records):
    epoch = agree_on_fallback("test-label", reason="unit test")
    assert isinstance(epoch, int) and epoch >= 1
    recs = [r for r in collective_events()
            if r["kind"] == "fallback_consensus"]
    assert recs and recs[-1]["payload"]["agreed"] is True


def test_consensus_multiprocess_uses_kv_and_barrier():
    store = _FakeStore()
    epoch = agree_on_fallback("test-label", reason="stall",
                              deadline_s=1.5, store=store, processes=4,
                              rank=0)
    keys = [f"pifft/fallback/{epoch}/{r}" for r in range(4)]
    assert store.waits == [(keys, datetime.timedelta(seconds=1.5))]
    (key, value), = store.kv.items()
    assert key == keys[0]
    assert "test-label" in value


def test_consensus_two_ranks_on_a_real_store(tmp_path):
    """Two ranks of a real job agree on their first epoch through the
    job's store; one rank alone on a real store times out as a
    HostDesyncError."""
    import torch.distributed as dist

    ranks = spawn_local(consensus_rank, 2, "gloo", "cpu", "two-ranks", 20.0)
    assert [r["out"] for r in ranks] == [1, 1]
    assert all(r["events"] == ["fallback_consensus"] for r in ranks)
    store = dist.FileStore(str(tmp_path / "store"), 2)
    with pytest.raises(HostDesyncError, match="did not form"):
        agree_on_fallback("alone", deadline_s=0.2, store=store,
                          processes=2, rank=0)


def test_consensus_timeout_is_a_classified_desync(records):
    with pytest.raises(HostDesyncError, match="fallback consensus"):
        agree_on_fallback("test-label", deadline_s=0.1,
                          store=_FakeStore(fail=True), processes=2, rank=0)
    recs = [r for r in collective_events()
            if r["kind"] == "fallback_consensus"]
    assert recs and recs[-1]["payload"]["agreed"] is False


# ------------------------------------ escape path: parity + no collective


@pytest.mark.parametrize("primary,escape", [("fft2", "fft2_escape"),
                                            ("ifft2", "ifft2_escape")])
def test_fft2_escape_parity_bit_for_bit(job, primary, escape):
    """The escape matches the all_to_all path BIT FOR BIT on every rank —
    the same per-shard plans on the same values, only the data movement
    re-planned — and is right, not merely self-consistent."""
    for a, b in zip(job[primary], job[escape]):
        assert np.array_equal(a["out"][0], b["out"][0])
        assert np.array_equal(a["out"][1], b["out"][1])
    y = np.concatenate([r["out"][0] + 1j * r["out"][1]
                        for r in job[escape]])
    x = X2.astype(np.complex128)
    ref = np.fft.fft2(x) if primary == "fft2" else np.fft.ifft2(x)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5


def test_poisson_escape_parity_bit_for_bit(job):
    for a, b in zip(job["poisson"], job["poisson_escape"]):
        assert np.array_equal(a["out"], b["out"])


def test_escape_is_collective_free(job, monkeypatch):
    """The escape's whole point: no collective on any rank of the job
    (the primary paths made four each), and every position computes its
    block again here on a mesh with no process group, with
    torch.distributed's all_to_all patched to raise."""
    import torch.distributed as dist

    for label in ("fft2_escape", "ifft2_escape", "poisson_escape"):
        assert [r["collectives"] for r in job[label]] == [0] * WORLD
    assert [r["collectives"] for r in job["fft2"]] == [4] * WORLD
    assert [r["collectives"] for r in job["poisson"]] == [4] * WORLD

    def refused(*a, **k):
        raise AssertionError("a collective was dispatched")

    monkeypatch.setattr(dist, "all_to_all_single", refused)
    from cs87project_msolano2_tpu_torch.parallel.escape import (
        fft2_collective_free_planes,
        poisson_solve_collective_free,
    )

    for i in (0, WORLD - 1):
        mesh = Mesh(("p",), (WORLD,), (i,), "cpu")
        yr, yi = fft2_collective_free_planes(*planes(X2), mesh)
        np.testing.assert_allclose(yr.numpy(),
                                   job["fft2_escape"][i]["out"][0],
                                   rtol=0, atol=1e-4)
        u = poisson_solve_collective_free(F3, mesh)
        np.testing.assert_allclose(u.numpy(),
                                   job["poisson_escape"][i]["out"],
                                   rtol=0, atol=1e-5)


# ----------------------------------------------- the chaos recovery loop


@pytest.mark.parametrize("drill,x", [("fft2_drill", X_CHAOS),
                                     ("poisson_drill", F_CHAOS)])
def test_chaos_stall_abort_escape_end_to_end(job, drill, x):
    """The acceptance loop on every rank: injected stall -> supervised
    abort -> consensus -> collective_free escape -> bit-identical
    result, with the degrade trail and the records in place (rc=0 is
    the CLI's form of this check: `multichip smoke`)."""
    epochs = set()
    for rec in job[drill]:
        d = rec["out"]
        assert not d["report_ok"]["escaped"]
        assert not d["report_ok"]["degraded"]
        rep = d["report"]
        assert rep["escaped"] and rep["degraded"]
        assert rep["waits"] >= 2
        assert [t["to"] for t in rep["trail"]] == ["collective_free"]
        assert rep["trail"][0]["from"] == "all_to_all"
        epochs.add(rep["epoch"])
        assert np.array_equal(d["healthy"], d["escaped"])
        assert d["collectives"] == 0
        json.dumps(rep)
        for wanted in WANTED:
            assert wanted in d["events"], (wanted, d["events"])
    assert len(epochs) == 1 and isinstance(epochs.pop(), int)
    y = np.concatenate([rec["out"]["escaped"] for rec in job[drill]])
    if drill == "fft2_drill":
        ref = np.fft.fft2(x.astype(np.complex128))
        assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5
    else:
        assert y.shape == x.shape and np.isfinite(y).all()


def test_unhealthy_device_skips_doomed_dispatch(records, monkeypatch):
    """An out-of-band unhealthy report escapes DIRECTLY: the primary
    collective is never dispatched (no deadline wait to pay), on a mesh
    position with no process group at all."""
    from cs87project_msolano2_tpu_torch.parallel import escape as escape_mod
    from cs87project_msolano2_tpu_torch.parallel.fft2d import (
        fft2_sharded_resilient,
    )

    def never(*a, **k):  # pragma: no cover — the check is that
        raise AssertionError("primary was dispatched")

    monkeypatch.setattr(escape_mod, "supervise_collective", never)
    escape_mod.report_unhealthy("cpu", "operator: ECC errors")
    try:
        x = rand_c64((32, 32), 2)
        blocks = []
        for i in range(WORLD):
            mesh = Mesh(("p",), (WORLD,), (i,), "cpu")
            y, rep = fft2_sharded_resilient(x, mesh)
            assert rep.escaped and rep.waits == 0
            assert rep.trail and rep.trail[0]["to"] == "collective_free"
            assert "unhealthy" in rep.trail[0]["reason"]
            blocks.append(y.numpy())
        ref = np.fft.fft2(x.astype(np.complex128))
        y = np.concatenate(blocks)
        assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5
        assert "device_unhealthy" in kinds()
        assert "collective_heartbeat" not in kinds()
    finally:
        escape_mod.clear_unhealthy()


def test_escape_is_transport_only_other_faults_propagate():
    """A non-stall fault inside the primary body belongs to the plan
    degradation chain or the retry layer, not to the transport
    escape."""
    from cs87project_msolano2_tpu_torch.parallel.escape import (
        run_with_escape,
    )

    mesh = Mesh(("p",), (WORLD,), (0,), "cpu")

    def primary():
        raise ZeroDivisionError("not a collective problem")

    with pytest.raises(ZeroDivisionError):
        run_with_escape(primary, lambda: None, "label", mesh,
                        deadline_s=5.0)


def test_multichip_smoke_cli(capsys):
    """`multichip smoke` on a small local job: exit 0, the chain
    printed."""
    from cs87project_msolano2_tpu_torch.cli import main

    rc = main(["multichip", "smoke", "-n", "32", "--world", "2",
               "--deadline", "0.5", "--stall", "1.5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "multichip smoke ok" in out and "collective_free" in out


# -------------------------------------------------- journal run config


def test_journal_guard_config(tmp_path):
    j = Journal(str(tmp_path / "j.jsonl"))
    j.guard_config({"dataset": "sharded", "full": False})
    j2 = Journal(str(tmp_path / "j.jsonl"))
    j2.guard_config({"dataset": "sharded", "full": False})
    # a journal may carry extra config keys a newer writer added
    j3 = Journal(str(tmp_path / "j.jsonl"))
    j3.guard_config({"dataset": "sharded"})
    with pytest.raises(ValueError, match="different run configuration"):
        Journal(str(tmp_path / "j.jsonl")).guard_config(
            {"dataset": "sharded", "full": True})


# ------------------------------------- sharded sweep: journaled resume


@pytest.fixture(scope="module")
def sharded_harness():
    import importlib

    return importlib.import_module(
        f"{PORT}.harness.run_sharded_experiments")


def _argv(out, p_grid="1,2", reps="2"):
    return ["--n-grid", "1024", "--p-grid", p_grid, "-T", reps, "--out",
            out, "--device", "cpu", "--world", "2"]


def test_sharded_sweep_resume_recomputes_nothing(sharded_harness,
                                                 tmp_path, monkeypatch):
    """Kill a sharded sweep mid-cell and the resume must recompute no
    completed cell — and preserve the collective cross-check's degrade
    trail instead of re-risking the wedge."""
    mod = sharded_harness
    out = str(tmp_path)
    argv = _argv(out)
    assert mod.main(argv) == 0
    tsv = os.path.join(out, "fourier-parallel-pi-sharded-results.tsv")
    rows_ = open(tsv).read().splitlines()
    assert len(rows_) == 4  # 2 cells x 2 reps
    cells = mod.journal_for(tsv).load()
    assert "collective_crosscheck" in cells
    trail_before = cells["collective_crosscheck"]

    # the kill that truncates the TSV's last line mid-write: the fsynced
    # journal still holds the rep, so nothing re-runs
    with open(tsv, "w") as fh:
        fh.write("\n".join(rows_[:-1]) + "\n1024\t2\t0.0")

    calls = []
    real_phase_ms = mod.phase_ms
    monkeypatch.setattr(mod, "phase_ms",
                        lambda *a, **k: calls.append(1)
                        or real_phase_ms(*a, **k))
    assert mod.main(argv) == 0
    assert calls == [], "resume recomputed completed cells"
    assert mod.journal_for(tsv).load()["collective_crosscheck"] \
        == trail_before


def test_sharded_sweep_no_resume_starts_fresh(sharded_harness, tmp_path,
                                              monkeypatch):
    """--no-resume is a fresh dataset: the grid re-runs and the
    append-only TSV rotates — two runs' timings never splice into one
    per-cell replication count."""
    mod = sharded_harness
    out = str(tmp_path)
    argv = _argv(out, p_grid="1", reps="1")
    assert mod.main(argv) == 0
    tsv = os.path.join(out, "fourier-parallel-pi-sharded-results.tsv")
    calls = []
    real_phase_ms = mod.phase_ms
    monkeypatch.setattr(mod, "phase_ms",
                        lambda *a, **k: calls.append(1)
                        or real_phase_ms(*a, **k))
    assert mod.main(argv + ["--no-resume"]) == 0
    assert calls, "--no-resume must re-run the grid"
    rows_ = [ln for ln in open(tsv).read().splitlines() if ln.strip()]
    assert len(rows_) == 1, f"TSV spliced two runs: {rows_}"
