"""The cells as BENCHMARK.json names them: their files, counts, runs on
the CPU at a small size, the no-JAX rule, and one short run on a card."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchlib import cell, counts, spec

import run as bench_run

SPEC = spec.load_json(spec.SPEC_PATH)
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
#: the CPU stands in for each cell at a size a test run holds
SMALL = {"fft1d-2p24": (1 << 12,), "rows-4096x4096": (16, 256)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_by_name(workload):
    c = spec.load_cell(workload)
    assert c.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == workload)
    for name in ("make_inputs", "bind", "flops"):
        assert callable(getattr(c.entry, name))
    assert callable(c.reference())
    assert set(c.limits) == {"rel_l2", "max_err"}
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_spec_keeps_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))[
            "reduced"] == c["reduced"]
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in SPEC["per_layer"]}
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in moves
        assert m["layer"] in layers
        # every cell it names reports the end-to-end metric it moves
        for w in m.get("workloads", WORKLOADS):
            assert w in WORKLOADS and any(
                e["name"] == m["moves"] for e in spec.load_cell(w).end_to_end)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def test_flops_at_small_n():
    assert counts.transform_flops((8,), "c2c") == 5 * 8 * 3
    assert counts.transform_flops((4, 16), "c2c") == 4 * 5 * 16 * 4
    assert counts.transform_flops((4, 16), "r2c") == 4 * 2.5 * 16 * 4


def test_least_bytes_at_small_n():
    n = 16
    x = torch.zeros(n, dtype=torch.complex64)
    assert counts.least_bytes((x,), (x,)) == 16 * n
    planes = (torch.zeros(n), torch.zeros(n))
    assert counts.least_bytes(planes, planes) == 16 * n
    real = torch.zeros(3, n)
    half = torch.zeros(3, n // 2 + 1, dtype=torch.complex64)
    assert counts.least_bytes((real,), (half,)) == 3 * (4 * n + 8 * (n // 2 + 1))


def test_peak_table():
    assert counts.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert counts.peak_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert counts.peak_bytes_per_s("cpu") is None


def test_no_jax_check_compares_whole_top_level_names():
    assert bench_run.forbidden_modules(
        ["cs87project_msolano2_tpu_torch", "cs87project_msolano2_tpu_torch.ops",
         "jaxtyping", "flaxen.x", "numpy"]) == []
    assert bench_run.forbidden_modules(
        ["cs87project_msolano2_tpu.ops.bits", "jax.numpy", "jaxlib",
         "flax"]) == ["cs87project_msolano2_tpu", "flax", "jax", "jaxlib"]


def test_a_cpu_run_loads_no_jax():
    """A whole run of the harness at a small size in a fresh process,
    then the modules it holds."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from benchlib import spec, cell\n"
        "c = spec.load_cell('fft1d-2p24.natural')\n"
        "cell.run_cell(c, 5, 0.05, True, device='cpu', shape=(256,))\n"
        "import run\n"
        "print(run.forbidden_modules())\n" % (spec.ROOT, spec.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PIFFT_PLAN_CACHE="off"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cpu_run_is_correct_and_reports(workload, traced):
    c = spec.load_cell(workload)
    result, notes = cell.run_cell(c, 2**31 + 17, 0.1, traced, device="cpu",
                                  shape=SMALL[c.config["name"]])
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]
    want = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    got = set(result["metrics"])
    if traced:
        # the CPU has no device trace: only the spans and the counter read
        assert got == {m["name"] for m in c.per_layer
                       if m["source"] in ("host_clock", "program_counter")}
        assert got and result["device"]["window_s"] > 0
    else:
        assert got == want
        assert all(v["value"] > 0 for v in result["metrics"].values())
    assert any(n.startswith("# plan ") for n in notes)


def test_same_seed_same_inputs_and_samples():
    c = spec.load_cell("fft1d-2p24.pi")
    a = c.entry.make_inputs((64,), 2, 2**31 + 3, "cpu", c.config)
    b = c.entry.make_inputs((64,), 2, 2**31 + 3, "cpu", c.config)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], a[1][0])
    assert cell.keep_fractions(9, 6, 4) == cell.keep_fractions(9, 6, 4)
    assert all(0 <= f < 0.9 for f in cell.keep_fractions(9, 6, 4))


@pytest.mark.parametrize("seed", [1, 2**31 + 11, 2**40 + 3])
def test_samples_hold_one_round_of_consecutive_calls(seed):
    fractions = cell.keep_fractions(seed, 8, 4)
    assert len(fractions) == 8
    start = max(set(fractions), key=fractions.count)
    assert fractions.count(start) >= 4 and start < 0.8
    assert len(cell.keep_fractions(seed, 2, 4)) == 4


def test_isolate_applies_the_traffic_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_AUTOTUNE", "1")
    monkeypatch.setenv("PIFFT_FAULT", "x")
    monkeypatch.setenv("PIFFT_PLAN_CACHE", "off")
    for name in ("PIFFT_OBS", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.delenv(name, raising=False)   # put back afterwards
    fresh = bench_run.isolate({"PIFFT_PLAN_CACHE": bench_run.FRESH_DIR,
                               "PIFFT_OBS": "0",
                               "PIFFT_PLAN_AUTOTUNE": None}, str(tmp_path))
    assert fresh == [os.environ["PIFFT_PLAN_CACHE"]]
    assert os.path.isdir(fresh[0]) and fresh[0].startswith(str(tmp_path))
    assert os.environ["PIFFT_OBS"] == "0"
    assert "PIFFT_PLAN_AUTOTUNE" not in os.environ
    assert "PIFFT_FAULT" not in os.environ
    assert os.environ["TRITON_CACHE_DIR"].startswith(spec.ROOT)


def _run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=600)


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    args = ("--workload", WORKLOADS[0], "--seed", "1", "--seconds", "0.1",
            "--trace", "0")
    if not torch.cuda.is_available():
        out = _run_py(spec.ROOT, *args)
        assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(spec.SPEC_PATH, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, *args)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
def test_one_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cell runs on the card only")
    out = _run_py(spec.ROOT, "--workload", "rows-4096x4096.c2c", "--seed",
                  str(2**31 + 99), "--seconds", "1", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert math.isfinite(result["metrics"]["gflops"]["value"])
