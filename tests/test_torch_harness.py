"""The port's experiment harness
(``cs87project_msolano2_tpu_torch.harness.run_experiments``) on the CPU,
held against the reference's ``harness/run_experiments.py``: the grid
and path helpers, the 5-column TSV contract, resume from the TSV and
the journal, the stale journal that dies with its TSV, ``DEGRADED``
rows, the ``harness`` injection site, ``verify_pass`` on the ``torch``
backend, and the sweep's output against the reference ``jax``
backend's at (n, p) = (2^10, 1) and (2^10, 8); the registry against the
reference's, ``-b <each> -t`` and ``--verify``, the sweep on the native,
scan and einsum backends with the native core's capacity clipping the
p-grid, and ``utils.debug.enable_checks`` stopping a NaN at its
phase."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.backends.registry import (
    get_backend as ref_get_backend,
)
from cs87project_msolano2_tpu_torch.backends.base import RunResult
from cs87project_msolano2_tpu_torch.backends.registry import get_backend
from cs87project_msolano2_tpu_torch.cli import make_input
from cs87project_msolano2_tpu_torch.harness import run_experiments as he
from cs87project_msolano2_tpu_torch.models import pi_fft
from cs87project_msolano2_tpu_torch.ops.twiddle import device_tables
from cs87project_msolano2_tpu_torch.resilience import InjectedFault, inject

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_harness():
    spec = importlib.util.spec_from_file_location(
        "run_experiments", os.path.join(REPO, "harness",
                                        "run_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_he():
    return _reference_harness()


def _rows(path):
    with open(path) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


@pytest.mark.parametrize("spec", ["1024,2048", "1024..8192", "1..256",
                                  "65536,1048576,16777216", "4..4"])
def test_parse_grid_matches_the_reference(spec, ref_he):
    assert he.parse_grid(spec) == ref_he.parse_grid(spec)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("outdir", ["out", "results/sweep"])
def test_result_path_matches_the_reference(backend, full, outdir, ref_he,
                                           tmp_path):
    """The names ``main`` can reach (``--full`` or not; the port has no
    ``--oversubscribe``) equal the reference's."""
    assert he.result_path(str(tmp_path / outdir), backend, full) == \
        ref_he.result_path(str(tmp_path / outdir), backend, full=full)
    assert he.result_path("out", backend).endswith(
        f"fourier-parallel-pi-{backend}-results.tsv")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_sweep_row_contract(backend, tmp_path):
    path = he.sweep(backend, [256, 1024], [1, 4, 512], reps=2,
                    outdir=str(tmp_path), resume=True, seed=0, device=CPU)
    assert path == he.result_path(str(tmp_path), backend)
    rows = _rows(path)
    # p <= n only: (256, 512) is not a cell
    cells = [(int(r[0]), int(r[1])) for r in rows]
    assert sorted(set(cells)) == [(256, 1), (256, 4), (1024, 1), (1024, 4),
                                  (1024, 512)]
    assert len(rows) == 2 * 5
    for r in rows:
        assert len(r) == 5
        total, funnel, tube = (float(v) for v in r[2:])
        assert total == pytest.approx(funnel + tube, abs=2e-6)
        assert funnel >= 0 and tube > 0


def test_resume_skips_done_cells(tmp_path):
    out = str(tmp_path)
    path = he.sweep("torch", [256], [1, 2], reps=2, outdir=out,
                    resume=True, seed=0, device=CPU)
    assert len(_rows(path)) == 4
    he.sweep("torch", [256], [1, 2], reps=3, outdir=out, resume=True,
             seed=0, device=CPU)
    assert len(_rows(path)) == 6  # one more rep per cell, no rerun
    he.sweep("torch", [256], [1, 2], reps=1, outdir=out, resume=False,
             seed=0, device=CPU)
    assert len(_rows(path)) == 8  # --no-resume appends every cell


def test_done_counts_merges_tsv_and_journal(tmp_path):
    tsv = str(tmp_path / "fourier-parallel-pi-torch-results.tsv")
    with open(tsv, "w") as fh:
        fh.write("1024\t2\t1.0\t0.5\t0.5\n1024\t2\t1.1\t0.5\t0.6\n"
                 "1024\t4\t0.9\t0.4\t0.5\tDEGRADED\n")
    journal = he.journal_for(tsv)
    journal.record("1024:4:0", {"total_ms": 0.9})
    journal.record("1024:4:1", {"total_ms": 0.8})
    journal.record("1024:2:0", {"total_ms": 1.0})
    done = he.done_counts(tsv, journal)
    assert done[(1024, 2)] == 2  # the TSV's count wins
    assert done[(1024, 4)] == 2  # the journal's count wins


def test_stale_journal_dies_with_its_tsv(tmp_path):
    """A deleted sweep TSV takes its journal with it: the redone sweep
    runs every cell again."""
    out = str(tmp_path)
    path = he.sweep("torch", [1024], [1, 2], reps=2, outdir=out,
                    resume=True, seed=0, device=CPU)
    assert len(_rows(path)) == 4
    os.remove(path)
    path2 = he.sweep("torch", [1024], [1, 2], reps=2, outdir=out,
                     resume=True, seed=0, device=CPU)
    assert path2 == path and len(_rows(path)) == 4


def test_torn_tsv_row_stays_a_line_of_its_own(tmp_path):
    out = str(tmp_path)
    path = he.sweep("torch", [256], [1], reps=1, outdir=out, resume=True,
                    seed=0, device=CPU)
    with open(path, "a") as fh:
        fh.write("256\t1\t0.9")  # a row a kill cut
    he.sweep("torch", [256], [1], reps=2, outdir=out, resume=True, seed=0,
             device=CPU)
    rows = _rows(path)
    assert [len(r) for r in rows] == [5, 3, 5]
    assert he.done_counts(path)[(256, 1)] == 2


def test_degraded_rows_are_marked(tmp_path, monkeypatch):
    """A run whose slope could not be resolved (events timing) lands in
    the TSV with the DEGRADED mark the analysis excludes."""
    backend = get_backend("torch", CPU)
    real_run = backend.run

    def degraded_run(x, p, **kw):
        res = real_run(x, p, **kw)
        return RunResult(res.out, res.total_ms, res.funnel_ms, res.tube_ms,
                         degraded=p == 2)

    monkeypatch.setattr(backend, "run", degraded_run)
    monkeypatch.setattr(he, "get_backend", lambda name, device: backend)
    path = he.sweep("torch", [256], [1, 2], reps=1, outdir=str(tmp_path),
                    resume=True, seed=0, device=CPU)
    rows = _rows(path)
    assert [r[1] for r in rows if len(r) == 6 and r[5] == "DEGRADED"] == \
        ["2"]
    assert he.done_counts(path)[(256, 2)] == 1


def test_harness_fault_site(tmp_path, monkeypatch):
    """The ``harness`` site: a CAPACITY fault re-raises at once and
    writes no row; a transient one is retried and the row lands."""
    out = str(tmp_path)
    with inject("harness", "capacity"), pytest.raises(InjectedFault):
        he.sweep("torch", [256], [1], reps=1, outdir=out, resume=True,
                 seed=0, device=CPU)
    path = he.result_path(out, "torch")
    assert _rows(path) == []
    monkeypatch.setattr(he, "call_with_retry", functools.partial(
        he.call_with_retry, sleep=lambda s: None))
    with inject("harness", "transient", count=2) as spec:
        he.sweep("torch", [256], [1], reps=1, outdir=out, resume=True,
                 seed=0, device=CPU)
    assert spec.fired == 2 and len(_rows(path)) == 1


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_verify_pass(backend, capsys):
    assert he.verify_pass(backend, [256, 4096], [1, 2, 16], 0, CPU) == 6
    assert "verified 6/6" in capsys.readouterr().err


def test_verify_pass_catches_a_wrong_cell(monkeypatch):
    backend = get_backend("torch", CPU)
    real_run = backend.run

    def wrong_run(x, p, **kw):
        res = real_run(x, p, **kw)
        res.out = res.out[::-1].copy()
        return res

    monkeypatch.setattr(backend, "run", wrong_run)
    monkeypatch.setattr(he, "get_backend", lambda name, device: backend)
    with pytest.raises(AssertionError, match="rel err"):
        he.verify_pass("torch", [256], [2], 0, CPU)


@pytest.mark.parametrize("n,p,batch", [(1 << 12, 64, ()), (1 << 12, 16, (3,)),
                                       (1 << 10, 8, (2, 2))])
def test_blocked_funnel_is_the_same_bits(n, p, batch, monkeypatch):
    """The funnel's stages over blocks of processor rows (what bounds its
    memory at n = 2^24, p = 256 on the card) give the unblocked bits."""
    rng = np.random.default_rng(1)
    xr, xi = (torch.from_numpy(rng.standard_normal(batch + (n,))
                               .astype(np.float32)) for _ in range(2))
    tables = device_tables(n, CPU)
    whole = pi_fft.funnel(xr, xi, p, tables)
    monkeypatch.setattr(pi_fft, "FUNNEL_BLOCK_ELEMENTS", 37)
    blocked = pi_fft.funnel(xr, xi, p, tables)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocked))
    assert blocked[0].shape == batch + (p, n // p)


@pytest.mark.parametrize("n,p", [(1 << 10, 1), (1 << 10, 8)])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_output_matches_the_reference_jax_backend(n, p, backend):
    x = make_input(n, 0)
    got = get_backend(backend, CPU).run(x, p, fetch=True, timers=False)
    ref = ref_get_backend("jax").run(x, p, fetch=True, timers=False)
    err = np.max(np.abs(got.out - ref.out)) / np.max(np.abs(ref.out))
    assert err <= 1e-6


def test_main_sweeps_then_verifies(tmp_path, capsys):
    assert he.main(["--backends", "torch,cuda", "--n-grid", "256,512",
                    "--p-grid", "1..4", "-T", "1", "--verify", "--device",
                    CPU, "--out", str(tmp_path)]) == 0
    printed = capsys.readouterr()
    for backend in ("torch", "cuda"):
        path = he.result_path(str(tmp_path), backend)
        assert path in printed.out and len(_rows(path)) == 6
        assert f"# {backend}: verified 6/6" in printed.err


# ------------------------------------------- the registry's new backends

REGISTRY = ("serial", "pthreads", "cpu", "torch", "torch-scan",
            "torch-unrolled", "cuda", "einsum")
#: the reference's name for each port backend (the "pallas" of the
#: reference is the port's "cuda", its "jax*" the port's "torch*")
REF_NAME = {"serial": "serial", "pthreads": "pthreads", "cpu": "cpu",
            "torch": "jax", "torch-scan": "jax-scan",
            "torch-unrolled": "jax-unrolled", "cuda": "pallas",
            "einsum": "einsum"}


def test_registry_lists_every_backend():
    from cs87project_msolano2_tpu.backends.registry import (
        list_backends as ref_list_backends,
    )
    from cs87project_msolano2_tpu_torch.backends.registry import (
        list_backends,
    )

    assert tuple(list_backends()) == REGISTRY
    assert sorted(REF_NAME[b] for b in REGISTRY) == sorted(
        ref_list_backends())
    for name in REGISTRY:
        b = get_backend(name, CPU)
        ref = ref_get_backend(REF_NAME[name])
        assert getattr(ref, "golden_atol", 0.0) == b.golden_atol
    with pytest.raises(ValueError, match="unknown backend"):
        get_backend("jax", CPU)


@pytest.mark.parametrize("backend", REGISTRY)
def test_cli_golden_and_verify_on_every_backend(backend, capsys):
    from cs87project_msolano2_tpu_torch.cli import main as cli_main

    assert cli_main(["-t", "-b", backend, "--device", CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.rsplit(" ", 1)[-1] for line in out] == ["PASSED"] * 4
    assert cli_main(["-n", "1024", "-p", "4", "-b", backend, "--verify",
                     "-o", "--device", CPU]) == 0
    printed = capsys.readouterr()
    assert "# verified vs numpy fft" in printed.err
    assert printed.out.split("\t")[:2] == ["1024", "4"]


def test_cli_refuses_p_above_capacity(capsys):
    from cs87project_msolano2_tpu_torch.backends.cpu import num_cores
    from cs87project_msolano2_tpu_torch.cli import main as cli_main

    p = 1 << num_cores().bit_length()  # the first power of two above
    assert cli_main(["-n", str(4 * p), "-p", str(p), "-b", "pthreads"]) == 2
    assert "exceeds backend 'pthreads' capacity" in capsys.readouterr().err


def test_main_on_the_new_backends(tmp_path, capsys):
    from cs87project_msolano2_tpu_torch.backends.cpu import num_cores

    backends = ("serial", "pthreads", "torch-scan", "einsum")
    assert he.main(["--backends", ",".join(backends), "--n-grid",
                    "256,1024", "--p-grid", "1,4,64", "-T", "1",
                    "--verify", "--device", CPU, "--out",
                    str(tmp_path)]) == 0
    printed = capsys.readouterr()
    for backend in backends:
        rows = _rows(he.result_path(str(tmp_path), backend))
        ps = {int(r[1]) for r in rows}
        if backend == "pthreads":
            # probe and clip: p above the core's capacity is no cell
            assert ps == {p for p in (1, 4, 64) if p <= num_cores()}
        else:
            assert ps == {1, 4, 64}
        assert all(len(r) == 5 for r in rows)
        assert f"# {backend}: verified {len(rows)}/{len(rows)}" \
            in printed.err


@pytest.mark.parametrize("backend", ["serial", "pthreads", "einsum"])
def test_new_backends_match_the_reference_s(backend):
    x = make_input(1 << 10, 4)
    got = get_backend(backend, CPU).run(x, 4, fetch=True, timers=False)
    ref = ref_get_backend(backend).run(x, 4, fetch=True, timers=False)
    if backend == "einsum":
        # float32 products in two libraries: within the split3 budget
        err = np.max(np.abs(got.out - ref.out)) / np.max(np.abs(ref.out))
        assert err <= 1e-5
    else:
        assert np.array_equal(got.out, ref.out)


@pytest.mark.parametrize("backend,phase", [("torch", "funnel"),
                                           ("einsum", "funnel"),
                                           ("serial", "tube")])
def test_debug_checks_stop_a_nan_at_its_phase(backend, phase):
    from cs87project_msolano2_tpu_torch.utils import debug

    x = make_input(256, 0)
    x[7] = np.nan
    run = get_backend(backend, CPU).run
    assert np.isnan(run(x, 4, timers=False).out).any()  # checks off
    debug.enable_checks()
    try:
        with pytest.raises(FloatingPointError, match=f"the {phase} phase"):
            run(x, 4, timers=False)
    finally:
        debug.disable_checks()
    assert np.isnan(run(x, 4, timers=False).out).any()  # off again


def test_debug_checks_stop_a_nan_in_a_plan():
    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.utils import debug

    plan = plans.plan_for((4, 256), layout="pi", device=CPU)
    xr = np.ones((4, 256), np.float32)
    xr[1, 3] = np.inf
    debug.enable_checks()
    try:
        with pytest.raises(FloatingPointError, match="plan rows"):
            plan.execute(xr, np.zeros_like(xr))
        plan.execute(np.ones_like(xr), np.zeros_like(xr))
    finally:
        debug.disable_checks()
    debug.assert_disjoint_cover(64, 8, 8)
    with pytest.raises(AssertionError, match="does not tile"):
        debug.assert_disjoint_cover(64, 8, 7)
