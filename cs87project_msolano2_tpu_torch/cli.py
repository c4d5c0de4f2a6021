"""Command line: the reference-parity pi-FFT run and the plan store.

    python -m cs87project_msolano2_tpu_torch -n 1048576 -p 4 -b cuda --verify
    python -m cs87project_msolano2_tpu_torch -t -b cuda
    python -m cs87project_msolano2_tpu_torch plan {show|warm|clear|sweep}
        [--backend {cuda,gpu}]
    python -m cs87project_msolano2_tpu_torch hw probe [--json | -v | --cores]

The run prints the reference's 5-column TSV (n, p, total_ms, funnel_ms,
tube_ms); ``-t`` runs the exact 8-point golden test for p in {1,2,4,8};
``plan`` manages the persistent plan store (``plans.cache``); ``hw
probe`` prints the device inventory (``hw.inventory``).  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .backends.registry import get_backend, list_backends
from .utils import verify


def make_input(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-random input with amplitude 1/sqrt(n), as
    the reference's CLI makes it."""
    rng = np.random.default_rng(seed)
    amp = 1.0 / np.sqrt(n)
    x = (rng.uniform(-amp, amp, n) + 1j * rng.uniform(-amp, amp, n))
    return x.astype(np.complex64)


def run_golden(backend_name: str, device=None) -> int:
    b = get_backend(backend_name, device)
    ok_all = True
    for p in (1, 2, 4, 8):
        res = b.run(verify.golden_input(), p)
        nat = verify.pi_layout_to_natural(res.out)
        ok = verify.golden_check_tol(nat, b.golden_atol)
        print(f"golden test: backend={backend_name} n=8 p={p} ... "
              f"{'PASSED' if ok else 'FAILED'}")
        ok_all &= ok
    return 0 if ok_all else 1


def _parse_n(s: str) -> int:
    """Accept plain ints and the 2^k spelling the bench docs use."""
    if "^" in s:
        base, exp = s.split("^", 1)
        return int(base) ** int(exp)
    return int(s, 0)


def plan_main(argv) -> int:
    """`plan {show|warm|clear|sweep}` — manage the persistent FFT plan
    store (`sweep` tunes a large-n trajectory and reports the measured
    fourstep AND sixstep crossovers), as the reference's ``plan``."""
    from .ops.precision import PRECISIONS

    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch plan",
        description="show / warm / clear / sweep the FFT plan store "
                    "(tune once per card, serve forever)",
    )
    ap.add_argument("action", choices=("show", "warm", "clear", "sweep"))
    ap.add_argument("--shapes", default=None, metavar="FILE",
                    help="warm a served shape set (not ported yet)")
    ap.add_argument("-n", type=_parse_n, default=1 << 20,
                    help="transform length for warm (int or 2^k)")
    ap.add_argument("--ns", type=_parse_n, nargs="*",
                    default=[1 << 20, 1 << 22, 1 << 24, 1 << 25, 1 << 26],
                    help="sweep: transform lengths to tune (default: the "
                         "bench trajectory through the fourstep AND "
                         "sixstep crossovers)")
    ap.add_argument("--batch", type=int, nargs="*", default=[],
                    help="leading batch dims for warm (default: none)")
    ap.add_argument("--layout", choices=("natural", "pi"), default="pi",
                    help="output order the plan is tuned for")
    ap.add_argument("--precision", choices=PRECISIONS, default=None,
                    help="precision mode to tune for (bf16 storage is not "
                         "ported yet)")
    ap.add_argument("--force", action="store_true",
                    help="warm/sweep: re-tune even on a cache hit")
    ap.add_argument("--backend", choices=("cuda", "gpu"), default=None,
                    help="plan backend: cuda (the port's kernels, the "
                         "default for warm/sweep) or gpu (hw.lowering); "
                         "show lists every backend unless one is given")
    args = ap.parse_args(argv)

    from . import plans

    backend = args.backend or "cuda"

    if args.shapes:
        print("error: --shapes (warming a served shape set) comes with "
              "the serving slice of the port; warm one -n at a time",
              file=sys.stderr)
        return 2

    if args.action == "clear":
        removed = plans.cache.clear(memory=True, disk=True)
        for path in removed:
            print(f"removed {path}")
        if not removed:
            print("plan cache already empty "
                  f"(dir: {plans.cache.cache_dir() or 'disabled'})")
        return 0

    kind = plans.current_device_kind("cuda")
    if args.action == "show":
        path = plans.cache.store_path(kind)
        print(f"device kind:  {kind}")
        print(f"cache dir:    {plans.cache.cache_dir() or 'DISABLED'} "
              f"(PIFFT_PLAN_CACHE overrides)")
        entries = plans.cache.disk_entries(kind)
        if not entries:
            print("store:        empty (plans will come from static "
                  "defaults until warmed)")
            return 0
        print(f"store:        {path} ({len(entries)} plan(s))")
        from .ops.precision import ERROR_BUDGETS, storage_dtype

        shown = 0
        for token, rec in sorted(entries.items()):
            key = plans.PlanKey.from_token(token)
            if args.backend is not None and key.backend != args.backend:
                continue
            shown += 1
            ms = rec.get("ms")
            print(f"  n={key.n} domain={key.domain} backend={key.backend} "
                  f"batch={key.batch} "
                  f"{key.layout} {key.precision} "
                  f"[{storage_dtype(key.precision)}, budget "
                  f"{ERROR_BUDGETS[key.precision]:.0e}]: "
                  f"{rec['variant']} {rec['params']}"
                  + (f" ({ms:.4f} ms)" if ms is not None else ""))
        if not shown:
            print(f"  (no {args.backend} plans)")
        return 0

    if args.action == "sweep":
        try:
            tuned, cross = plans.tune_sweep(
                args.ns, layout=args.layout, precision=args.precision,
                force=args.force, backend=backend)
        except (plans.TuningUnavailable, plans.TuningError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        for p in tuned:
            ms = f" ({p.ms:.4f} ms)" if p.ms is not None else ""
            print(f"  n={p.key.n}: {p.variant} {p.params}{ms}")
        print(f"measured fourstep crossover: "
              f"{cross if cross is not None else 'none (never won)'}")
        cross6 = plans.sixstep_crossover(tuned)
        print(f"measured sixstep crossover: "
              f"{cross6 if cross6 is not None else 'none (never won)'}")
        return 0

    # warm
    try:
        key = plans.make_key(args.n, tuple(args.batch), layout=args.layout,
                             precision=args.precision, backend=backend)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        plan = plans.tune(key, force=args.force)
    except plans.TuningUnavailable as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except plans.TuningError as e:
        print(f"error: {e}", file=sys.stderr)
        for r in e.results:
            print(f"  {r.variant} {r.params}: {r.reason}", file=sys.stderr)
        return 1
    except (ValueError, NotImplementedError) as e:
        # a key the port does not serve yet (bf16, real domains)
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"warmed {key.token()}\n  -> {plan.describe()}")
    return 0


def hw_main(argv) -> int:
    """``hw probe`` — the device inventory (``hw.inventory.main``)."""
    if not argv or argv[0] != "probe":
        print("usage: cs87project_msolano2_tpu_torch hw probe "
              "[--json | -v | --cores]", file=sys.stderr)
        return 2
    from .hw.inventory import main as inventory_main

    return inventory_main(argv[1:])


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "plan":
        return plan_main(argv[1:])
    if argv and argv[0] == "hw":
        return hw_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch",
        description="communication-free pi-FFT on PyTorch/CUDA",
    )
    ap.add_argument("-n", type=int, help="input length (power of two)")
    ap.add_argument("-p", type=int,
                    help="virtual processors (power of two, <= n)")
    ap.add_argument("-t", action="store_true", help="golden test mode")
    ap.add_argument("-o", action="store_true", help="omit TSV header")
    ap.add_argument("-b", "--backend", default="cuda",
                    choices=list_backends())
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions (median)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="also check the result against numpy's FFT")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    if args.t:
        return run_golden(args.backend, args.device)
    if not args.n or not args.p:
        ap.print_usage(sys.stderr)
        return 2

    b = get_backend(args.backend, args.device)
    x = make_input(args.n, args.seed)
    try:
        res = b.run(x, args.p, reps=args.reps)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.verify:
        ref = np.fft.fft(x.astype(np.complex128))
        err = verify.rel_err(verify.pi_layout_to_natural(res.out), ref)
        if err > 1e-5:
            print(f"error: verification failed, rel err {err:.3e} > 1e-5",
                  file=sys.stderr)
            return 1
        print(f"# verified vs numpy fft: rel err {err:.3e}", file=sys.stderr)

    if not args.o:
        print("n\tp\ttotal_ms\tfunnel_ms\ttube_ms")
    print(f"{args.n}\t{args.p}\t{res.total_ms:.6f}\t{res.funnel_ms:.6f}\t"
          f"{res.tube_ms:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
