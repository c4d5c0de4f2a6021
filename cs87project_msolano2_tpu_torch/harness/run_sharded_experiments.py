"""The sharded pi-FFT's (n, p) dataset: per-rank phase times of the
communication-free decomposition (the reference's
``harness/run_sharded_experiments.py``).

    python -m cs87project_msolano2_tpu_torch.harness.run_sharded_experiments \\
        --n-grid 1048576,16777216 --p-grid 1,4,16,64 -T 3 --verify \\
        [--device cpu] [--world 4] [--out DIR]

Because the sharded pi-FFT (``parallel/pi_shard.py``) makes no
collective, rank i's time on a p-rank job IS the time of its rank-local
program: the ranks never wait on each other.  So the sweep times that
program (``device_fns``: processor 0's ``funnel_single`` chain, then the
tube ``pi_fft_sharded`` runs — the plan of the (n/p,)-point segment
above ``PLAN_SEGMENT_MIN``, else the stage tube) on one device per (n,
p), and records the per-processor phase times in the reference's TSV
contract ``n  p  total_ms  funnel_ms  tube_ms``, with ``DEGRADED`` as a
sixth column where the loop slope could not be resolved and CUDA events
timed the cell.  On the card each phase is timed by the loop slope
(``utils.timing.fitted_slope_ms``), on the CPU by the host clock; p = 1
charges no funnel.  (The reference's harness times its stage or scan
tube at every segment length, not the plan its sharded path runs above
PLAN_SEGMENT_MIN.)

Before timing, a real job (``parallel.multihost.spawn_local``, `--world`
ranks, gloo unless each rank has a card of its own) cross-checks the
mesh: the ranks' ``pi_fft_sharded`` segments must equal the single-device
pi-FFT (``mesh_crosscheck``), with no collective; and the supervised
all_to_all 2-D FFT runs through ``fft2_sharded_resilient``
(``collective_crosscheck``), its report — the degrade trail included —
journaled, so a resumed sweep keeps it instead of re-risking a wedge.
``--verify`` then checks every cell: all p processors' segments of the
rank-local program against numpy (rel err <= 1e-5).

Output: ``<out>/fourier-parallel-pi-sharded-results.tsv`` (``--out``
defaults to ``results/``).  Resume: per-cell completion is journaled to
an fsynced JSONL beside the append-only TSV, as in
``harness/run_experiments.py``; ``--no-resume`` starts a fresh dataset.
``--events PATH`` writes the observability event stream: each cell
under a ``sweep_cell`` span with its ``sweep_cell`` event, the
``metrics`` snapshot last.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

import numpy as np
import torch

from .. import obs
from ..models.pi_fft import pi_fft_pi_layout, resolve_tube_plan
from ..ops.twiddle import device_tables
from ..parallel.pi_shard import PLAN_SEGMENT_MIN, rank_body
from ..utils.device import as_planes, resolve_device
from ..utils.timing import SlopeUnresolved, fitted_slope_ms, time_ms
from ..utils.verify import pi_layout_to_natural, rel_err
from .run_experiments import done_counts, journal_for, parse_grid

#: the cross-checks' inputs: the pi-FFT's length and the 2-D side
CROSSCHECK_N = 1 << 12
CROSSCHECK_SIDE = 64


def crosscheck_rank(xr, xi, x2):
    """One rank of the cross-check job: its ``pi_fft_sharded`` segment
    and the collectives that made (none), then, where `x2` is given, the
    supervised 2-D FFT of `x2` through ``fft2_sharded_resilient`` (its
    rows and report)."""
    from ..parallel import collectives
    from ..parallel.fft2d import fft2_sharded_resilient
    from ..parallel.mesh import make_mesh
    from ..parallel.pi_shard import pi_fft_sharded

    mesh = make_mesh()
    calls0 = collectives.COLLECTIVE_CALLS
    sr, si = pi_fft_sharded(xr, xi, mesh)
    out = {"pi": (sr.cpu().numpy(), si.cpu().numpy()),
           "pi_collectives": collectives.COLLECTIVE_CALLS - calls0}
    if x2 is not None:
        y, report = fft2_sharded_resilient(x2, mesh)
        out["fft2"] = (y.cpu().numpy(), report.to_record())
    return out


def mesh_crosscheck(xr, xi, ranks, device) -> float:
    """The job's segments (`ranks`: the cross-check job's results) must
    reproduce the single-device pi-FFT of (xr, xi) at p = the world size
    (rel err < 1e-6), with no collective made.  Returns the error."""
    world = len(ranks)
    got = np.concatenate([r["pi"][0] + 1j * r["pi"][1] for r in ranks])
    xr_t, xi_t = as_planes(xr, xi, device)
    rr, ri = pi_fft_pi_layout(xr_t, xi_t, world)
    ref = rr.cpu().numpy() + 1j * ri.cpu().numpy()
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    calls = [r["pi_collectives"] for r in ranks]
    assert err < 1e-6, f"mesh cross-check failed: {err:.2e}"
    assert calls == [0] * world, f"the sharded pi-FFT made collectives: {calls}"
    print(f"# {world}-rank mesh cross-check ok (n={xr.shape[-1]}, rel err "
          f"{err:.1e}, collectives {calls})", file=sys.stderr)
    return err


def collective_crosscheck(journal, x, ranks):
    """The supervised collective cross-check: the ranks' rows of the
    all_to_all 2-D FFT of `x` through the self-healing entry must match
    numpy (< 1e-5), and what happened — the degrade trail included — is
    journaled, so a sweep that escaped says so on every later resume.
    A journaled cell is not re-run (`ranks` is then None): the trail is
    preserved."""
    prior = journal.get("collective_crosscheck")
    if prior is not None:
        trail = prior.get("trail") or []
        print(f"# collective cross-check preserved from journal "
              f"(degraded={bool(prior.get('degraded'))}"
              + (f", trail={[t.get('to') for t in trail]}" if trail
                 else "") + ")", file=sys.stderr)
        return prior
    y = np.concatenate([r["fft2"][0] for r in ranks])
    report = ranks[0]["fft2"][1]
    ref = np.fft.fft2(x.astype(np.complex128))
    err = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    assert err < 1e-5, f"collective cross-check failed: rel err {err:.2e}"
    rec = journal.record("collective_crosscheck", {**report, "rel_err": err})
    trail = report["trail"]
    print(f"# collective cross-check ok (supervised all_to_all, "
          f"degraded={report['degraded']}"
          + (f", escaped via {[t.get('to') for t in trail]}" if trail
             else "") + f", rel err {err:.1e})", file=sys.stderr)
    return rec


def run_crosschecks(journal, world: int, device, backend=None,
                    seed: int = 0):
    """Both cross-checks on one ``spawn_local`` job of `world` ranks."""
    from ..parallel.multihost import spawn_local

    rng = np.random.default_rng(seed)
    xr = rng.standard_normal(CROSSCHECK_N).astype(np.float32)
    xi = rng.standard_normal(CROSSCHECK_N).astype(np.float32)
    x2 = None
    if journal.get("collective_crosscheck") is None:
        rng2 = np.random.default_rng(seed + 1)
        shape = (CROSSCHECK_SIDE, CROSSCHECK_SIDE)
        x2 = (rng2.standard_normal(shape)
              + 1j * rng2.standard_normal(shape)).astype(np.complex64)
    ranks = spawn_local(crosscheck_rank, world, backend, device, xr, xi, x2)
    mesh_crosscheck(xr, xi, ranks, device)
    collective_crosscheck(journal, x2, None if x2 is None else ranks)


def device_fns(n: int, p: int, device="cuda"):
    """(funnel_f, tube_only, full) of processor 0 of a p-rank job on
    `device`: its ``funnel_single`` chain, the tube ``pi_fft_sharded``
    runs on the (n/p,) segment (the segment's plan above
    PLAN_SEGMENT_MIN, else the stage tube), and the two composed — the
    body ``pi_fft_sharded`` runs on rank 0 (every rank does work of the
    same shapes)."""
    from ..models.pi_fft import funnel_single, tube

    dev = resolve_device(device)
    tables = device_tables(n, dev)
    plan = resolve_tube_plan((n // p,), None, min_segment=PLAN_SEGMENT_MIN,
                             device=dev)

    def funnel_f(xr, xi):
        return funnel_single(xr, xi, 0, p, tables)

    def tube_only(fr, fi):
        if plan is not None:
            return plan.execute(fr, fi)
        return tube(fr, fi, n, p, tables)

    def full(xr, xi):
        return rank_body(xr, xi, 0, p, plan, tables)

    return funnel_f, tube_only, full


def phase_ms(fn, *args) -> tuple:
    """(ms a call, degraded) of one phase, one reading a TSV rep as the
    backends time theirs (``backends/torch_backend.py``): the loop
    slope on the card (CUDA events, and degraded, where it cannot be
    resolved), the host clock on the CPU."""
    if args[0].device.type != "cuda":
        return time_ms(fn, *args, reps=3)[0], False
    try:
        return fitted_slope_ms(fn, *args, reps=1), False
    except SlopeUnresolved as e:
        print(f"# loop slope unresolved: {e}; timing by CUDA events",
              file=sys.stderr)
        return time_ms(fn, *args, reps=3)[0], True


def _input(n: int, rng, device):
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    return as_planes(xr, xi, device)


def verify_pass(cells, seed: int, device) -> int:
    """Every cell's rank-local program, for all p processors, against
    numpy (rel err <= 1e-5 after the pi-layout unscramble); raises
    AssertionError on the first cell over.  Returns the cells verified."""
    rng = np.random.default_rng(seed)
    for n, p in cells:
        xr, xi = _input(n, rng, device)
        tables = device_tables(n, xr.device)
        plan = resolve_tube_plan((n // p,), None,
                                 min_segment=PLAN_SEGMENT_MIN,
                                 device=xr.device)
        segs = [rank_body(xr, xi, pi, p, plan, tables) for pi in range(p)]
        got = torch.complex(torch.cat([s[0] for s in segs]),
                            torch.cat([s[1] for s in segs])).cpu().numpy()
        del segs
        x = xr.cpu().numpy().astype(np.complex128)
        x.imag = xi.cpu().numpy()
        err = rel_err(pi_layout_to_natural(got), np.fft.fft(x))
        if err > 1e-5:
            raise AssertionError(f"sharded n={n} p={p}: rel err {err:.2e}")
    print(f"# sharded: verified {len(cells)}/{len(cells)} cells vs numpy "
          f"fft", file=sys.stderr)
    return len(cells)


def result_path(outdir: str, full: bool = False) -> str:
    stem = "-results-full.tsv" if full else "-results.tsv"
    return os.path.join(outdir, f"fourier-parallel-pi-sharded{stem}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch.harness."
             "run_sharded_experiments",
        description=__doc__.splitlines()[0])
    ap.add_argument("--n-grid", default="2048..131072",
                    help="'a,b,c' or 'lo..hi' powers of two (default: the "
                         "reference's Xeon Phi sweep)")
    ap.add_argument("--p-grid", default="1..32")
    ap.add_argument("-T", "--reps", type=int, default=10)
    ap.add_argument("--out", default="results",
                    help="directory of the TSV (default: ./results)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="write the deep-replication ...-results-full.tsv")
    ap.add_argument("--no-resume", action="store_true",
                    help="start a fresh dataset: rotate the TSV and "
                         "journal and re-run every cell")
    ap.add_argument("--verify", action="store_true",
                    help="check every cell against numpy's FFT")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks of the cross-check job (default 8)")
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="write the structured observability event "
                         "stream to a JSONL file")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.events:
        obs.enable(events_path=args.events)
    os.makedirs(args.out, exist_ok=True)
    path = result_path(args.out, args.full)
    journal = journal_for(path)
    if not os.path.exists(path):
        # a rotated/deleted TSV invalidates the sidecar: the journal may
        # only ever claim cells whose data exists
        journal.reset()
    resume = not args.no_resume
    if not resume:
        # a fresh run starts a fresh dataset: two runs' timings must
        # never splice into one per-cell replication count
        if os.path.exists(path):
            os.remove(path)
        journal.reset()
    journal.guard_config({"dataset": "sharded", "full": bool(args.full)})
    run_crosschecks(journal, args.world, device, seed=args.seed)
    done = done_counts(path, journal) if resume else Counter()

    cells = [(n, p) for n in parse_grid(args.n_grid)
             for p in parse_grid(args.p_grid) if p <= n]
    rng = np.random.default_rng(args.seed)
    with open(path, "a") as fh:
        for n, p in cells:
            start_rep = done[(n, p)]
            if start_rep >= args.reps:
                continue
            xr, xi = _input(n, rng, device)
            funnel_f, tube_only, _ = device_fns(n, p, device)
            fr, fi = (t.contiguous() for t in funnel_f(xr, xi))
            for rep in range(start_rep, args.reps):
                cell_id = {"n": n, "p": p, "rep": rep}
                with obs.span("sweep_cell", cell=cell_id,
                              backend="sharded"):
                    # total := funnel + tube, the reference's
                    # nested-timer contract; p = 1 is an empty chain
                    funnel_ms, deg_f = (0.0, False) if p == 1 \
                        else phase_ms(funnel_f, xr, xi)
                    tube_ms, deg_t = phase_ms(tube_only, fr, fi)
                mark = "\tDEGRADED" if deg_f or deg_t else ""
                fh.write(f"{n}\t{p}\t{funnel_ms + tube_ms:.6f}"
                         f"\t{funnel_ms:.6f}\t{tube_ms:.6f}{mark}\n")
                fh.flush()
                # the row reaches the disk before the (fsynced) journal
                # claims it
                os.fsync(fh.fileno())
                journal.record(f"{n}:{p}:{rep}",
                               {"total_ms": funnel_ms + tube_ms})
                obs.emit("sweep_cell", cell=cell_id, backend="sharded",
                         total_ms=funnel_ms + tube_ms,
                         funnel_ms=funnel_ms, tube_ms=tube_ms)
            del xr, xi, fr, fi
            print(f"# sharded n={n} p={p} done", file=sys.stderr)
    if args.verify:
        verify_pass(cells, args.seed, device)
    if obs.enabled():
        from ..obs import metrics

        obs.emit("metrics", snapshot=metrics.snapshot())
        obs.flush()
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
