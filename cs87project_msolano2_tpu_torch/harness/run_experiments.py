"""Experiment harness: sweep (T reps x n grid x p grid) per backend,
append TSV rows, estimate the time left, optionally verify every cell
(the reference's ``harness/run_experiments.py``, the paper's (n, p)
experiment).

    python -m cs87project_msolano2_tpu_torch.harness.run_experiments \\
        --backends cuda --n-grid 65536,1048576,16777216 --p-grid 1..256 \\
        -T 3 --verify [--device cpu] [--out DIR] [--events PATH]

TSV contract: ``n  p  total_ms  funnel_ms  tube_ms`` (5 columns, the
native core's), one file per backend, ``DEGRADED`` as a sixth column
where the backend's timers fell back from the loop slope to CUDA events
(``RunResult.degraded``).  Resume: completed (n, p, rep) cells are
skipped, journaled in an atomic per-cell JSONL beside the append-only
TSV (a TSV row is synced to disk before the journal claims it, and a
deleted TSV takes its journal with it).  Every cell runs under
``resilience.call_with_retry`` after a ``maybe_fault("harness")``
probe: TRANSIENT faults retry on the 30/60/120 s ladder, CAPACITY and
PERMANENT ones (ValueError's infeasible cell among them) re-raise at
once.  All timing runs before any verification, as in the reference.
The backends are the registry's (``backends.registry``): the native C
core's ``serial`` and ``pthreads`` (``cpu``) on the host, and the tensor
backends ``torch`` (the plain funnel and stage tube), ``torch-scan``
(the constant-geometry tube), ``torch-unrolled``, ``cuda`` (the funnel
as tensor ops, the tube on the kernels) and ``einsum`` (the phased
einsum model), on the card unless ``--device cpu``.  Each backend's
capacity is probed and the p-grid clipped to it (the reference's
probe-and-clip: ``pthreads`` takes at most the core's
``pifft_capacity``); a cell the backend refuses (an einsum cell past
its capacity) is skipped with a note.  ``--events PATH`` writes the
observability event stream: each cell under a ``sweep_cell`` span and
its ``sweep_cell`` event, ``sweep_progress`` with the estimate of the
time left, the ``env`` event first and the ``metrics`` snapshot last.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

import numpy as np

from .. import obs
from ..backends.registry import get_backend
from ..cli import make_input
from ..obs.spans import clock
from ..resilience import Journal, call_with_retry, classify, maybe_fault
from ..resilience.journal import torn_tail
from ..utils.verify import pi_layout_to_natural, rel_err


def parse_grid(spec: str) -> list[int]:
    """'1024,2048' or '1024..8192' (powers-of-two range, inclusive)."""
    if ".." in spec:
        lo, hi = (int(v) for v in spec.split(".."))
        out = []
        v = lo
        while v <= hi:
            out.append(v)
            v *= 2
        return out
    return [int(v) for v in spec.split(",")]


def result_path(outdir: str, backend: str, full: bool = False) -> str:
    """The sweep's TSV: ``fourier-parallel-pi-<backend>-results.tsv``
    (``-results-full.tsv`` for the deep-replication dataset), the
    reference's names."""
    tail = "-results-full.tsv" if full else "-results.tsv"
    return os.path.join(outdir, f"fourier-parallel-pi-{backend}{tail}")


def journal_for(path: str) -> Journal:
    """The per-cell JSONL journal beside a sweep TSV."""
    return Journal(f"{path}.journal.jsonl")


def done_counts(path: str, journal: Journal | None = None) -> Counter:
    """(n, p) -> completed replications: the TSV scan and the journal
    merged per cell by max, so a TSV written without a journal still
    resumes and a kill that truncated the TSV's last line cannot erase
    a rep the fsynced journal committed."""
    done: Counter = Counter()
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) in (5, 6) and parts[0].isdigit():
                    done[(int(parts[0]), int(parts[1]))] += 1
    if journal is not None:
        from_journal: Counter = Counter()
        for cell_id in journal.load():
            parts = cell_id.split(":")
            if len(parts) == 3 and parts[0].isdigit() and parts[1].isdigit():
                from_journal[(int(parts[0]), int(parts[1]))] += 1
        for cell_key, count in from_journal.items():
            done[cell_key] = max(done[cell_key], count)
    return done


def grid_cells(backend_name: str, ns: list[int], ps: list[int],
               device=None):
    """(backend, cells): every (n, p) of the grids with p <= n, p
    clipped to the backend's capacity where it has one (the native
    ``pthreads`` core's; virtual processors have none)."""
    backend = get_backend(backend_name, device)
    cap = backend.capacity()
    ps_eff = [p for p in ps if cap is None or p <= cap]
    if len(ps_eff) < len(ps):
        print(f"# {backend_name}: capacity {cap} clips p-grid to {ps_eff}",
              file=sys.stderr)
    return backend, [(n, p) for n in ns for p in ps_eff if p <= n]


def _on_retry(exc: BaseException, attempt: int, pause: float) -> None:
    print(f"# {classify(exc).value} backend error ({type(exc).__name__}: "
          f"{str(exc)[:120]}); retry {attempt} in {pause:.0f}s",
          file=sys.stderr)


def run_cell(backend, x, p, fetch: bool = False, timers: bool = True):
    """``backend.run`` under the shared retry policy, after the
    ``harness`` injection probe."""

    def attempt():
        maybe_fault("harness")  # resilience injection site
        return backend.run(x, p, fetch=fetch, timers=timers)

    return call_with_retry(attempt, on_retry=_on_retry,
                           label=f"cell n={x.shape[-1]} p={p}")


def sweep(backend_name: str, ns: list[int], ps: list[int], reps: int,
          outdir: str, resume: bool, seed: int, full: bool = False,
          device=None) -> str:
    """Timing pass: append TSV rows, fetch no result.  Returns the TSV's
    path."""
    os.makedirs(outdir, exist_ok=True)
    backend, cells = grid_cells(backend_name, ns, ps, device)
    path = result_path(outdir, backend_name, full=full)
    journal = journal_for(path)
    if not os.path.exists(path):
        # a deleted or rotated TSV invalidates its journal: the journal
        # may only claim cells whose rows exist
        journal.reset()
    done = done_counts(path, journal) if resume else Counter()

    todo = sum(max(reps - done[c], 0) for c in cells)
    # wall seconds of the completed cells, for the estimate of the time
    # left (display only: the rows' times come from the backend)
    cell_s: list = []
    completed = 0
    torn = torn_tail(path)
    with open(path, "a") as fh:
        if torn:
            fh.write("\n")  # the row a kill cut stays a line of its own
        for n, p in cells:
            x = make_input(n, seed)
            for rep in range(done[(n, p)], reps):
                cell_id = {"n": n, "p": p, "rep": rep}
                t0 = clock()
                try:
                    with obs.span("sweep_cell", cell=cell_id,
                                  backend=backend_name):
                        res = run_cell(backend, x, p)
                except ValueError as e:
                    # an infeasible (n, p) is a property of the cell
                    print(f"# {backend_name} n={n} p={p} skipped: {e}",
                          file=sys.stderr)
                    obs.emit("sweep_cell_skipped", cell=cell_id,
                             backend=backend_name, reason=str(e)[:200])
                    todo -= reps - rep
                    break
                mark = "\tDEGRADED" if res.degraded else ""
                fh.write(f"{n}\t{p}\t{res.total_ms:.6f}\t{res.funnel_ms:.6f}"
                         f"\t{res.tube_ms:.6f}{mark}\n")
                fh.flush()
                # the row reaches the disk before the (fsynced) journal
                # claims it, so the journal never claims a lost row
                os.fsync(fh.fileno())
                journal.record(f"{n}:{p}:{rep}", {"total_ms": res.total_ms})
                cell_s.append(clock() - t0)
                obs.emit("sweep_cell", cell=cell_id, backend=backend_name,
                         total_ms=res.total_ms, funnel_ms=res.funnel_ms,
                         tube_ms=res.tube_ms, degraded=bool(res.degraded),
                         dur_s=round(cell_s[-1], 6))
                completed += 1
                if completed % 10 == 0 or completed == todo:
                    eta = sum(cell_s) / len(cell_s) * (todo - completed)
                    print(f"# {backend_name} {completed}/{todo} "
                          f"(n={n} p={p}) eta {eta:5.0f}s", file=sys.stderr)
                    obs.emit("sweep_progress", backend=backend_name,
                             completed=completed, todo=todo,
                             eta_s=round(eta, 1))
    return path


def verify_pass(backend_name: str, ns: list[int], ps: list[int],
                seed: int, device=None) -> int:
    """Correctness pass: one fetched run per cell, checked against numpy
    (rel err <= 1e-5 after ``pi_layout_to_natural``); raises
    AssertionError on the first cell over.  Returns the cells verified."""
    backend, cells = grid_cells(backend_name, ns, ps, device)
    skipped = 0
    x = ref = None
    for n, p in cells:
        if x is None or x.shape[-1] != n:
            # one input and one numpy reference per n (cells run by n)
            x = make_input(n, seed)
            ref = np.fft.fft(x.astype(np.complex128))
        try:
            res = run_cell(backend, x, p, fetch=True, timers=False)
        except ValueError as e:
            print(f"# {backend_name} n={n} p={p} verify skipped: {e}",
                  file=sys.stderr)
            skipped += 1
            continue
        err = rel_err(pi_layout_to_natural(res.out), ref)
        if err > 1e-5:
            raise AssertionError(
                f"{backend_name} n={n} p={p}: rel err {err:.2e}")
    print(f"# {backend_name}: verified {len(cells) - skipped}/{len(cells)} "
          f"cells vs numpy fft ({skipped} skipped)", file=sys.stderr)
    return len(cells) - skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch.harness."
             "run_experiments",
        description=__doc__.splitlines()[0])
    ap.add_argument("--backends", default="cuda",
                    help="comma-separated backend list (serial, pthreads, "
                         "cpu, torch, torch-scan, torch-unrolled, cuda, "
                         "einsum)")
    ap.add_argument("--n-grid", default="1024..8192",
                    help="'a,b,c' or 'lo..hi' powers of two")
    ap.add_argument("--p-grid", default="1..32")
    ap.add_argument("-T", "--reps", type=int, default=10,
                    help="replications per cell (the reference's default)")
    ap.add_argument("--out", default="results",
                    help="directory of the TSVs (default: ./results)")
    ap.add_argument("--no-resume", action="store_true",
                    help="re-run cells already present in the TSV")
    ap.add_argument("--verify", action="store_true",
                    help="check every cell against numpy's FFT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="write the deep-replication ...-results-full.tsv")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="write the structured observability event "
                         "stream (per-cell events, progress and the time "
                         "left, the final metrics snapshot) to a JSONL "
                         "file")
    args = ap.parse_args(argv)

    if args.events:
        from ..analyze.records import env_fingerprint

        obs.enable(events_path=args.events)
        # fingerprint the stream, so a reader knows which environment
        # its cells are comparable within
        obs.emit("env", **env_fingerprint(device=args.device))

    ns = parse_grid(args.n_grid)
    ps = parse_grid(args.p_grid)
    backends = [b.strip() for b in args.backends.split(",")]
    # all timing before any verification fetch
    for b in backends:
        print(sweep(b, ns, ps, args.reps, args.out, not args.no_resume,
                    args.seed, args.full, args.device))
    if args.verify:
        for b in backends:
            verify_pass(b, ns, ps, args.seed, args.device)
    if obs.enabled():
        from ..obs import metrics

        obs.emit("metrics", snapshot=metrics.snapshot())
        obs.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
