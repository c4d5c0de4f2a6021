"""The port's bench entry (``cs87project_msolano2_tpu_torch.bench``) on
the CPU, mirroring the reference's bench tests in
tests/test_resilience.py: ``--smoke --device cpu`` prints one valid
record with every row kind, the chaos run (``PIFFT_FAULT`` armed)
completes degraded with the demotion trail, the four ``--resume``
cases, the environment fingerprint, ``plans.measured_ms`` with an
injected timer, and the reference's own loader reading the port's
record (n, domain, precision and backend of each row); the cpu-native
rows under ``--smoke`` and ``c_ms``/``vs_baseline`` against the native
core at a small N; the spectral-op rows (``conv2^K``, ``os2^K``,
``conv_np<n>``) with the reference's field names, parsed with their op
by the reference's loader."""

import json
import os
import subprocess

import pytest
import torch

from cs87project_msolano2_tpu.analyze import loader as ref_loader
from cs87project_msolano2_tpu_torch import bench, obs, plans
from cs87project_msolano2_tpu_torch.analyze import records
from cs87project_msolano2_tpu_torch.resilience import (
    InjectedFault,
    Journal,
    TransientBackendError,
    inject,
)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Small sizes, an empty in-process plan cache, no armed fault, and
    obs disarmed after (``--events`` leaves the bench's run armed)."""
    monkeypatch.setattr(bench, "SMOKE_N", 1 << 9)
    monkeypatch.setattr(bench, "SMOKE_LARGE_LOGNS", (10,))
    monkeypatch.delenv("PIFFT_FAULT", raising=False)
    plans.cache.clear(memory=True)
    yield
    plans.cache.clear(memory=True)
    obs.disable()
    obs.metrics.reset()


def _bench_record(capsys, argv):
    rc = bench.main(argv + ["--device", CPU])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


ROWS = ["n2^10_ms", "n2^10_library_ms", "n2^10_vs_library",
        "rfft2^10_ms", "bf16_2^10_ms", "gpu2^8_ms", "gpu2^10_ms"]
ROW_FIELDS = ("ms", "gflops", "plan", "carry_passes", "roofline_ceiling",
              "hbm_bytes")


def test_bench_smoke_prints_one_valid_record(capsys):
    rc, rec = _bench_record(capsys, ["--smoke"])
    assert rc == 0
    assert records.validate_record(rec) == []
    assert rec["metric"] == "fft1d_n2^9_complex64_gflops"
    assert rec["library"] == "torch.fft.fft"
    assert {"ms", "library_fft_ms", "vs_library_fft", "plan",
            "roofline_ceiling"} <= set(rec)
    assert not any(k.startswith("xla") or "_vs_xla" in k for k in rec)
    assert all(r in rec for r in ROWS)
    for tag in ("n2^10", "rfft2^10", "bf16_2^10", "gpu2^8", "gpu2^10"):
        assert all(f"{tag}_{f}" in rec for f in ROW_FIELDS), tag
    assert rec["rfft2^10_domain"] == "r2c"
    assert rec["bf16_2^10_precision"] == "bf16"
    assert rec["gpu2^8_backend"] == "gpu"
    assert rec["gpu2^8_plan"]["variant"] == "gpu-rows"
    # the bytes the plans declare: r2c and bf16 move half of c2c's
    assert rec["rfft2^10_hbm_bytes"] * 2 == rec["n2^10_hbm_bytes"]
    assert rec["bf16_2^10_hbm_bytes"] * 2 == rec["n2^10_hbm_bytes"]
    assert rec["rfft2^10_parity_relerr"] < 1e-5
    assert rec["bf16_2^10_parity_relerr"] < 3e-2
    assert rec["gpu2^10_parity_relerr"] < 1e-5
    assert rec["smoke"] is True and "degraded" not in rec
    assert rec["env"]["platform"] == "cpu" and rec["env"]["smoke"] is True


def test_bench_smoke_chaos_degrades_and_completes(capsys, monkeypatch):
    """The chaos run in miniature: every kernel entry dies of CAPACITY,
    the bench still exits 0, the record is tagged degraded and carries
    the demotion trail."""
    monkeypatch.setenv("PIFFT_FAULT", "tube:capacity:1.0")
    rc, rec = _bench_record(capsys, ["--smoke"])
    assert rc == 0
    assert rec.get("degraded") is True
    assert rec["plan"]["degraded"] is True
    assert rec["plan"]["demotions"][-1]["to"] == "torch-fft"
    assert rec["n2^10_degraded"] is True
    # a demoted row is judged by the rung that served it
    assert "n2^10_carry_passes" not in rec


def test_bench_chaos_subprocess_exits_zero():
    """``PIFFT_FAULT=tube:capacity:1.0 python -m ...bench --smoke`` as
    the command line runs it."""
    env = dict(os.environ, PIFFT_FAULT="tube:capacity:1.0",
               PIFFT_PLAN_CACHE="off")
    proc = subprocess.run(
        ["python", "-m", "cs87project_msolano2_tpu_torch.bench", "--smoke",
         "--device", CPU], capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["degraded"] is True and rec["plan"]["demotions"]
    assert "DEGRADED" in proc.stderr


def test_bench_resume_same_cells_without_recompute(tmp_path, capsys,
                                                   monkeypatch):
    """A journaled run and its --resume re-run give the same cells, and
    completed cells are not measured again."""
    jpath = str(tmp_path / "bench-journal.jsonl")
    rc1, rec1 = _bench_record(capsys, ["--smoke", "--journal", jpath])
    assert rc1 == 0

    def must_not_run(*a, **k):
        raise AssertionError("completed cell re-executed under --resume")

    for name in ("measure_fft_ms", "measure_library_ms", "_measure"):
        monkeypatch.setattr(bench, name, must_not_run)
    rc2, rec2 = _bench_record(capsys, ["--smoke", "--journal", jpath,
                                       "--resume"])
    assert rc2 == 0
    rec1.pop("env"), rec2.pop("env")
    assert rec1 == rec2


def test_bench_resume_recomputes_only_killed_cell(tmp_path, capsys):
    """The journal's last line half-written by a kill: --resume measures
    that cell again and the record carries the same cells."""
    jpath = str(tmp_path / "bench-journal.jsonl")
    rc1, rec1 = _bench_record(capsys, ["--smoke", "--journal", jpath])
    assert rc1 == 0
    lines = open(jpath).read().splitlines()
    # the last cell of a smoke run: the last backend row
    assert json.loads(lines[-1])["cell"] == "cpun2^10"
    with open(jpath, "w") as fh:
        fh.write("\n".join(lines[:-1]))
        fh.write('\n{"cell": "cpun2^10", "cpun2^10_ms"')  # cut by a kill
    rc2, rec2 = _bench_record(capsys, ["--smoke", "--journal", jpath,
                                       "--resume"])
    assert rc2 == 0
    assert set(rec1) == set(rec2)
    assert Journal(jpath).get("cpun2^10")["cpun2^10_ms"] == \
        rec2["cpun2^10_ms"]


def test_bench_resume_refuses_mismatched_config(tmp_path, capsys,
                                                monkeypatch):
    """A journal written by another configuration (smoke against full)
    is refused before any measurement."""
    jpath = str(tmp_path / "bench-journal.jsonl")
    rc1, _ = _bench_record(capsys, ["--smoke", "--journal", jpath])
    assert rc1 == 0

    def must_not_run(*a, **k):
        raise AssertionError("measured despite config mismatch")

    for name in ("measure_fft_ms", "measure_library_ms", "_measure"):
        monkeypatch.setattr(bench, name, must_not_run)
    rc = bench.main(["--journal", jpath, "--resume", "--device", CPU])
    assert rc == 2
    assert "different bench configuration" in capsys.readouterr().err


def test_bench_failed_row_is_not_canonized_by_resume(tmp_path, capsys,
                                                     monkeypatch):
    """A row whose measurement failed outright is dropped with a warning
    and not journaled, so --resume measures it again."""
    jpath = str(tmp_path / "bench-journal.jsonl")
    real = bench.measure_fft_ms

    def flagship_only(n, *a, **k):
        if n == 1 << 10:
            raise RuntimeError("CUDA error: out of memory")
        return real(n, *a, **k)

    monkeypatch.setattr(bench, "measure_fft_ms", flagship_only)
    rc1, rec1 = _bench_record(capsys, ["--smoke", "--journal", jpath])
    assert rc1 == 0 and "n2^10_ms" not in rec1
    assert "n2^10" not in Journal(jpath).load()
    monkeypatch.setattr(bench, "measure_fft_ms", real)
    rc2, rec2 = _bench_record(capsys, ["--smoke", "--journal", jpath,
                                       "--resume"])
    assert rc2 == 0 and "n2^10_ms" in rec2


def test_env_fingerprint_fields(monkeypatch):
    fp = records.env_fingerprint(smoke=True, device_kind="cpu", device=CPU)
    assert fp["platform"] == "cpu" and fp["device_kind"] == "cpu"
    assert fp["smoke"] is True and fp["torch"] == torch.__version__
    assert "cuda" in fp and "power_limit" not in fp
    # on a card: its name and its power limit as nvidia-smi prints it
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(records, "_power_limit", lambda i: "700.00 W")
    fp = records.env_fingerprint(device="cuda")
    assert fp["platform"] == "gpu" and fp["smoke"] is False
    assert fp["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert fp["power_limit"] == "700.00 W"
    assert records.validate_record({"metric": "m", "value": 1.0,
                                    "unit": "u", "env": fp}) == []
    assert records.validate_record({"metric": "m", "unit": "u"})
    with pytest.raises(ValueError):
        records.dump_record({"metric": "m", "value": True, "unit": "u"})


def _counting_timer(ms=0.25):
    calls = []

    def timer(fn, key):
        calls.append(key)
        n = key.n
        fn(torch.ones(n), torch.zeros(n))
        return ms

    return timer, calls


def test_measured_ms_times_the_static_plan_with_the_injected_timer():
    key = plans.make_key(1 << 12, layout="pi", device=CPU)
    timer, calls = _counting_timer()
    ms, plan = plans.measured_ms(key, device=CPU, timer=timer,
                                 verbose=False)
    assert ms == 0.25 and calls == [key]
    assert plan.source == "static" and not plan.degraded


def test_measured_ms_takes_a_fresh_race_s_time():
    key = plans.make_key(1 << 12, layout="pi", device=CPU)
    tuned = plans.tune(key, timer=lambda fn, k: 0.5, allow_offline=True,
                       persist=False, verbose=False)
    timer, calls = _counting_timer()
    ms, plan = plans.measured_ms(key, device=CPU, timer=timer,
                                 verbose=False)
    assert plan is tuned and ms == 0.5 and not calls


def test_measured_ms_keeps_a_degraded_time_where_no_race_runs(capsys):
    """A plan that demotes while timed: the re-race is refused on the
    CPU, so the degraded time stands, tagged on the plan."""
    key = plans.make_key(1 << 12, layout="pi", device=CPU)
    timer, _ = _counting_timer()
    with inject("tube", "capacity"):
        ms, plan = plans.measured_ms(key, device=CPU, timer=timer)
    assert ms == 0.25 and plan.degraded
    assert plan.demotions[-1]["to"] == "torch-fft"


def test_measured_ms_reraises_transient_and_unraced_failures():
    key = plans.make_key(1 << 12, layout="pi", device=CPU)

    def transient(fn, key):
        raise TransientBackendError("busy")

    with pytest.raises(TransientBackendError):
        plans.measured_ms(key, device=CPU, timer=transient, verbose=False)
    with inject("plan", "transient"):
        def via_execute(fn, k):
            plans.get_plan(k, CPU).execute(torch.ones(k.n),
                                           torch.zeros(k.n))
            return 1.0

        with pytest.raises(InjectedFault):
            plans.measured_ms(key, device=CPU, timer=via_execute,
                              verbose=False)

    def broken(fn, key):
        raise ValueError("no such blocking")

    # nothing was raced on the CPU: the failure propagates
    with pytest.raises(ValueError):
        plans.measured_ms(key, device=CPU, timer=broken, verbose=False)


def test_measured_ms_times_the_stored_winner(tmp_path, monkeypatch):
    """A winner a past process stored is read back, not raced again,
    and timed by the race's timer (the reference reads its cache so)."""
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = plans.make_key(1 << 12, layout="pi", device=CPU)
    plans.tune(key, timer=lambda fn, k: 0.5, allow_offline=True,
               verbose=False)
    plans.cache.clear(memory=True)
    timer, calls = _counting_timer(0.75)
    ms, plan = plans.measured_ms(key, device=CPU, timer=timer)
    assert plan.source == "cache" and ms == 0.75 and calls == [key]


def test_reference_loader_reads_the_port_s_record(tmp_path, capsys):
    rc, rec = _bench_record(capsys, ["--smoke"])
    assert rc == 0
    path = tmp_path / "BENCH_r07.json"
    path.write_text(json.dumps(rec))
    rnd = ref_loader.load_bench_round(str(path))
    assert rnd.fingerprint.smoke is True
    assert rnd.metrics[rec["metric"]] == rec["value"]
    samples = {s.metric: s for s in ref_loader.bench_samples(rnd)}
    s = samples["n2^10_ms"]
    assert (s.n, s.domain, s.precision, s.backend) == (1024, "c2c",
                                                       "split3", "tpu")
    s = samples["rfft2^10_ms"]
    assert (s.n, s.domain) == (1024, "r2c")
    s = samples["bf16_2^10_ms"]
    assert (s.n, s.precision) == (1024, "bf16")
    s = samples["gpu2^8_ms"]
    assert (s.n, s.backend) == (256, "gpu")
    assert samples["n2^10_vs_library"].n == 1024


def test_bench_smoke_cpu_native_rows(capsys):
    rc, rec = _bench_record(capsys, ["--smoke"])
    assert rc == 0 and records.validate_record(rec) == []
    for tag in ("cpun2^8", "cpun2^10"):
        # the C core's stages are no path of the carry model (the
        # reference's table leaves it out): no carries, no ceiling
        assert all(f"{tag}_{f}" in rec for f in ("ms", "gflops", "plan",
                                                  "hbm_bytes",
                                                  "roofline_util")), tag
        assert f"{tag}_roofline_ceiling" not in rec
        assert rec[f"{tag}_backend"] == "cpu-native"
        assert rec[f"{tag}_plan"]["variant"] == "cpu-native"
        assert rec[f"{tag}_ms"] > 0 and f"{tag}_degraded" not in rec
    # a smoke run's toy-n flagship makes the C ratio meaningless
    assert "c_ms" not in rec and "vs_baseline" not in rec


def test_measure_c_baseline_ms_at_a_small_n(monkeypatch):
    monkeypatch.setattr(bench, "N", 1 << 12)
    ms = bench.measure_c_baseline_ms()
    assert 0 < ms < 1e4


def test_bench_record_carries_vs_baseline(capsys, monkeypatch):
    """A full (non-smoke) record at small sizes, its plan times injected:
    c_ms is the native core's at N and vs_baseline = c_ms / ms."""
    monkeypatch.setattr(bench, "N", 1 << 9)
    monkeypatch.setattr(bench, "LARGE_LOGNS", (10,))

    def measured_ms(key, device="cuda", **kw):
        return 0.25, plans.get_plan(key, str(device))

    monkeypatch.setattr(plans, "measured_ms", measured_ms)
    monkeypatch.setattr(bench, "measure_library_ms",
                        lambda n, device, smoke=False: 0.5)
    calls = []
    real = bench.measure_c_baseline_ms

    def c_baseline():
        calls.append(bench.N)
        return real()

    monkeypatch.setattr(bench, "measure_c_baseline_ms", c_baseline)
    rc, rec = _bench_record(capsys, [])
    assert rc == 0 and calls == [1 << 9]
    assert records.validate_record(rec) == []
    assert rec["c_ms"] > 0
    assert rec["vs_baseline"] == round(rec["c_ms"] / 0.25, 1)
    assert rec["cpun2^8_ms"] == 0.25 and rec["gpu2^10_ms"] == 0.25
    assert "smoke" not in rec


def test_bench_smoke_op_rows(tmp_path, capsys, monkeypatch):
    """The spectral-op rows of the default smoke size, with the
    reference's field names; the reference's loader parses them with
    their op (its TestBenchAndLoader); conv_np's metered bytes sit below
    its pad-to-pow2 control's (the meter counts while ``--events`` arms
    obs)."""
    from cs87project_msolano2_tpu_torch.apps.stream import chunk_count

    monkeypatch.setattr(bench, "SMOKE_LARGE_LOGNS", (13,))
    rc, rec = _bench_record(capsys, ["--smoke", "--events",
                                     str(tmp_path / "events.jsonl")])
    assert rc == 0 and records.validate_record(rec) == []
    assert "degraded" not in rec
    for tag, n in (("conv2^13", 1 << 13), ("conv_np768", 768)):
        assert rec[f"{tag}_op"] == "conv" and rec[f"{tag}_ms"] > 0
        assert rec[f"{tag}_gflops"] >= 0 and rec[f"{tag}_event_ms"] > 0
        assert rec[f"{tag}_parity_relerr"] < 1e-5
        assert rec[f"{tag}_hbm_bytes"] == 4 * (2 * n + 2 * (n // 2 + 1))
        assert f"{tag}_degraded" not in rec
    assert rec["conv_np768_plan"]["variant"] == "mixedradix"
    assert rec["conv_np768_hbm_bytes"] < rec["conv_np768_pow2_hbm_bytes"]
    assert rec["os2^13_op"] == "conv"
    assert rec["os2^13_block"] == 1 << 13
    assert rec["os2^13_signal_n"] == 1 << 15
    assert rec["os2^13_chunks"] == chunk_count(1 << 15, 129, 1 << 13)
    assert 0 < rec["os2^13_overlap_waste"] < 1
    assert rec["os2^13_parity_relerr"] < 1e-5
    path = tmp_path / "BENCH_r15.json"
    path.write_text(json.dumps(rec))
    samples = {s.metric: s for s in ref_loader.bench_samples(
        ref_loader.load_bench_round(str(path)))}
    assert (samples["conv2^13_ms"].op, samples["conv2^13_ms"].n) \
        == ("conv", 1 << 13)
    assert (samples["os2^13_chunks"].op, samples["os2^13_chunks"].n) \
        == ("conv", 1 << 13)
    assert (samples["conv_np768_ms"].op, samples["conv_np768_ms"].n) \
        == ("conv", 768)
    assert samples["n2^13_ms"].op == "fft"


def test_bench_os_rows_past_max_block_are_skipped(capsys):
    """The os2^K rows past ``apps.stream.MAX_BLOCK`` (every one of the
    full bench's) are skipped with the reference's diagnostic."""
    assert bench.measure_os_row(19, CPU) == {}
    assert "overlap-save 2^19 skipped: block past the raced-candidate " \
        "ceiling MAX_BLOCK=2^18" in capsys.readouterr().err
