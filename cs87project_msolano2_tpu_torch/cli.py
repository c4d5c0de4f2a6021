"""Command line: the reference-parity pi-FFT run and the plan store.

    python -m cs87project_msolano2_tpu_torch -n 1048576 -p 4 -b cuda --verify
        [--trace DIR]
    python -m cs87project_msolano2_tpu_torch -t -b cuda
    python -m cs87project_msolano2_tpu_torch -n 65536 -p 4 -b pthreads
    python -m cs87project_msolano2_tpu_torch plan {show|warm|clear|sweep}
        [--backend {cuda,gpu,cpu-native}]
    python -m cs87project_msolano2_tpu_torch hw probe [--json | -v | --cores]
    python -m cs87project_msolano2_tpu_torch faults {list|inject <spec>}
    python -m cs87project_msolano2_tpu_torch multichip smoke [-n N]
        [--deadline S] [--stall S] [--world W] [--device D]
    python -m cs87project_msolano2_tpu_torch apps {conv,corr,solve}
        [--smoke] [--json] [-n N] [--device D]
    python -m cs87project_msolano2_tpu_torch obs {summary|export|validate|top}
        [--events FILE] [--format {chrome,prom}] [--out FILE] [--json]
        [--url URL] [--once]

The run prints the reference's 5-column TSV (n, p, total_ms, funnel_ms,
tube_ms) for any backend of the registry (``-b``: the native C core's
``serial``/``pthreads``/``cpu`` on the host, the tensor backends
``torch``, ``torch-scan``, ``torch-unrolled``, ``cuda`` and ``einsum``);
``-t`` runs the 8-point golden test for p in {1,2,4,8} (the C core's
own, ``pifft_golden_test``, for the native backends; exact, or within
the backend's ``golden_atol``);
``plan`` manages the persistent plan store (``plans.cache``); ``hw
probe`` prints the device inventory (``hw.inventory``); ``faults``
lists the fault-injection sites or runs one transform under an injected
fault and says how the retry and degradation policies carried it
(``resilience``); ``multichip smoke`` drives the collective supervision
-> consensus -> collective-free escape loop on a local job of W ranks
(``parallel``); ``apps`` runs the spectral operation suite's demo or
its smoke (``apps.cli``); ``obs`` summarizes, exports or validates an
event stream, or renders a live telemetry plane (``obs``).  ``--trace
DIR`` writes a ``torch.profiler`` trace of the run.  The tensor backends
run on the card unless ``--device cpu`` is given; a p above a backend's
capacity is refused.
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
    """The golden test at p in {1, 2, 4, 8}: the C core's own for the
    native backends, else one run checked within ``golden_atol``."""
    b = get_backend(backend_name, device)
    ok_all = True
    for p in (1, 2, 4, 8):
        if hasattr(b, "golden_test"):
            ok = b.golden_test(p)
        else:
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
                    help="transform length for warm (int or 2^k; any "
                         "n >= 1: n that is not a power of two warms "
                         "the any-length ladder, natural layout only)")
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
                    help="precision mode to tune for (bf16: bf16 storage "
                         "on rows/rql/fourstep/sixstep, raced beside "
                         "split3)")
    ap.add_argument("--domain", choices=("c2c", "r2c", "c2r"),
                    default="c2c",
                    help="warm: transform domain; the real domains "
                         "(r2c/c2r) need --layout natural, and even n "
                         "rides the c2c plan at n/2")
    ap.add_argument("--force", action="store_true",
                    help="warm/sweep: re-tune even on a cache hit")
    ap.add_argument("--backend", choices=("cuda", "gpu", "cpu-native"),
                    default=None,
                    help="plan backend: cuda (the port's kernels, the "
                         "default for warm/sweep), gpu or cpu-native "
                         "(hw.lowering); show lists every backend unless "
                         "one is given")
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
                             precision=args.precision, domain=args.domain,
                             backend=backend)
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
    except ValueError as e:
        # a key no ladder entry serves: the gpu backend at an n that is
        # not a power of two
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"warmed {key.token()}\n  -> {plan.describe()}")
    return 0


def faults_main(argv) -> int:
    """``faults {list|inject}`` — the fault-injection sites, or one
    pi-layout transform under an injected fault, retried with the fast
    policy, with what the retry and degradation policies did and the
    result against numpy (the reference's ``faults``)."""
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch faults",
        description="list injection sites / inject a fault and watch "
                    "the retry + degradation policies handle it",
    )
    ap.add_argument("action", choices=("list", "inject"))
    ap.add_argument("spec", nargs="?", default=None,
                    help="inject: <site>:<kind>[:<prob>[:<count>]] "
                         "(the PIFFT_FAULT syntax)")
    ap.add_argument("-n", type=_parse_n, default=1 << 10,
                    help="inject: transform length of the run (int or "
                         "2^k; default 2^10)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    from . import resilience

    if args.action == "list":
        print("fault kinds (PIFFT_FAULT=<site>:<kind>[:<prob>[:<count>]],"
              " comma-separated; site is an fnmatch pattern):")
        for kind in resilience.KINDS:
            print(f"  {kind}")
        print("injection sites:")
        for site, where in sorted(resilience.KNOWN_SITES.items()):
            print(f"  {site:<11} {where}")
        print("  anylen      the any-length executors of ops/anylen.py "
              "(bluestein / rader / mixedradix)")
        print("recovery: transient -> with_retry backoff; capacity/"
              "permanent -> plan degradation chain "
              f"({' -> '.join(resilience.DEGRADE_CHAIN)})")
        return 0

    if not args.spec:
        print("error: inject needs a <site>:<kind>[:<prob>[:<count>]] "
              "spec", file=sys.stderr)
        return 2
    try:
        spec = resilience.FaultSpec.parse(args.spec)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from . import plans

    plans.cache.clear(memory=True)  # the run must build its plan afresh
    key = plans.make_key(args.n, layout="pi", device=args.device)
    rng = np.random.default_rng(0)
    xr = rng.standard_normal(args.n).astype(np.float32)
    xi = rng.standard_normal(args.n).astype(np.float32)
    with resilience.inject(spec.site, spec.kind, spec.prob, spec.count,
                           spec.stall_s) as live:
        plan = plans.get_plan(key, args.device)

        def run():
            return plan.execute(xr, xi)

        try:
            yr, yi = resilience.call_with_retry(
                run, policy=resilience.FAST_POLICY, label="faults run")
        except Exception as e:
            kind = resilience.classify(e)
            print(f"run FAILED after policy exhaustion: {kind.value} "
                  f"{type(e).__name__}: {str(e)[:200]}")
            print(f"(fault fired {live.fired} time(s); an uncapped "
                  f"always-on transient spec exhausts the retry budget "
                  f"by design — cap it with :<count>)")
            return 1

    ref = np.fft.fft(xr.astype(np.complex128)
                     + 1j * xi.astype(np.complex128))
    got = verify.pi_layout_to_natural(yr.cpu().numpy()
                                      + 1j * yi.cpu().numpy())
    err = verify.rel_err(got, ref)
    print(f"fault spec {args.spec!r}: fired {live.fired} time(s)")
    d = plan.describe()
    if plan.degraded:
        trail = " -> ".join([plan.variant]
                            + [rec["to"] for rec in plan.demotions])
        print(f"plan DEGRADED: {trail} (run completed on the weakest "
              f"rung that worked)")
    elif live.fired:
        print(f"plan healthy: {d['variant']} {d['params']} (retry "
              f"absorbed the fault)")
    else:
        print(f"plan healthy: {d['variant']} {d['params']} (fault never "
              f"fired)")
    print(f"result vs numpy fft: rel err {err:.3e} "
          f"({'OK' if err < 1e-5 else 'WRONG'})")
    return 0 if err < 1e-5 else 1


def multichip_main(argv) -> int:
    """``multichip smoke`` — the proof that the self-healing multi-rank
    loop works on this machine: a local job of `--world` ranks
    (``parallel.multihost.spawn_local``: gloo, or NCCL where every rank
    has a card of its own) runs the supervised all_to_all 2-D FFT
    healthy, then with a stall injected on every rank; the supervisor
    aborts it, the ranks agree on the fallback epoch, the
    collective-free escape completes the run, and the result must be
    bit-identical to the healthy one and within 1e-5 of numpy.  Checks
    the report and the collective layer's records
    (``resilience.watchdog.recorded_kinds``)."""
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch multichip",
        description="exercise the collective supervision -> consensus -> "
                    "collective-free escape loop on a local job")
    ap.add_argument("action", choices=("smoke",))
    ap.add_argument("-n", type=int, default=64,
                    help="2-D transform side (n x n)")
    ap.add_argument("--deadline", type=float, default=0.5, metavar="S",
                    help="supervision deadline of the stalled run")
    ap.add_argument("--stall", type=float, default=2.0, metavar="S",
                    help="injected stall, on every rank")
    ap.add_argument("--world", type=int, default=8,
                    help="ranks of the local job")
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device: cuda (default; ranks share "
                         "the cards) or cpu")
    args = ap.parse_args(argv)

    from .parallel.escape import drill_rank
    from .parallel.multihost import spawn_local

    if args.n % args.world:
        print(f"error: -n {args.n} must be divisible by --world "
              f"{args.world}", file=sys.stderr)
        return 2
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((args.n, args.n))
         + 1j * rng.standard_normal((args.n, args.n))).astype(np.complex64)
    ranks = spawn_local(drill_rank, args.world, None, args.device, "fft2",
                        x, {"deadline_s": args.deadline,
                            "stall_s": args.stall})
    problems = []
    for i, d in enumerate(ranks):
        rep = d["report"]
        rungs = [t.get("to") for t in rep["trail"]]
        if d["report_ok"]["escaped"]:
            problems.append(f"rank {i}: the healthy run escaped")
        if not (rep["escaped"] and rep["degraded"]):
            problems.append(f"rank {i}: the injected stall did not escape")
        if rungs != ["collective_free"]:
            problems.append(f"rank {i}: degrade trail {rep['trail']}")
        if not np.array_equal(d["healthy"], d["escaped"]):
            problems.append(f"rank {i}: escaped rows differ from the "
                            f"healthy run's")
        if d["collectives"]:
            problems.append(f"rank {i}: {d['collectives']} collectives "
                            f"in the stalled run")
        for wanted in ("collective_heartbeat", "collective_abandoned",
                       "fallback_consensus", "demotion",
                       "collective_escape_completed"):
            if wanted not in d["events"]:
                problems.append(f"rank {i}: no {wanted!r} record")
    y = np.concatenate([d["escaped"] for d in ranks])
    ref = np.fft.fft2(x.astype(np.complex128))
    err = float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    if err > 1e-5:
        problems.append(f"escaped result wrong vs numpy (rel err "
                        f"{err:.2e})")
    for line in problems:
        print(f"error: {line}", file=sys.stderr)
    if problems:
        return 1
    rep = ranks[0]["report"]
    print(f"# healthy supervised all_to_all ok on {args.world} ranks "
          f"(waits={ranks[0]['report_ok']['waits']})")
    print(f"# injected stall ({args.stall:g}s vs {args.deadline:g}s "
          f"deadline) on every rank -> supervised abort after "
          f"{rep['waits']} wait(s) -> consensus epoch {rep['epoch']} -> "
          f"collective_free escape: result bit-identical, rel err vs "
          f"numpy {err:.1e}")
    print(f"# multichip smoke ok: degrade trail "
          f"{[t['from'] + '->' + t['to'] for t in rep['trail']]}, records "
          f"{ranks[0]['events']}")
    return 0


def obs_main(argv) -> int:
    """``obs {summary|export|validate|top}`` — post-process a structured
    event stream, or watch a live telemetry plane."""
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch obs",
        description="summarize / export / validate an observability "
                    "event stream (a JSONL file written by bench "
                    "--events or PIFFT_OBS_EVENTS), or render the live "
                    "/slo + /healthz snapshot of a running telemetry "
                    "plane (obs.http.TelemetryServer) as a refreshing "
                    "terminal table (top)",
    )
    ap.add_argument("action", choices=("summary", "export", "validate",
                                       "top"))
    ap.add_argument("--url", default="http://127.0.0.1:8572",
                    metavar="URL",
                    help="top: base URL of the telemetry plane")
    ap.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="top: refresh period (seconds)")
    ap.add_argument("--once", action="store_true",
                    help="top: print one frame and exit (scripts)")
    ap.add_argument("--events", default="pifft-events.jsonl",
                    metavar="FILE",
                    help="the event-stream JSONL file (default: "
                         "pifft-events.jsonl)")
    ap.add_argument("--format", choices=("chrome", "prom"),
                    default="chrome",
                    help="export format: Chrome trace JSON (Perfetto) "
                         "or Prometheus textfile")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="export: write here instead of stdout")
    ap.add_argument("--json", action="store_true",
                    help="summary: machine-readable output")
    args = ap.parse_args(argv)

    import json as _json
    import os

    from .obs import events as obs_events
    from .obs import export as obs_export

    if args.action == "top":
        return _obs_top(args)

    if not os.path.exists(args.events):
        print(f"error: no event stream at {args.events} (run with "
              f"bench --events or PIFFT_OBS_EVENTS=<path>)",
              file=sys.stderr)
        return 2
    records, dropped = obs_events.load_events(args.events)

    if args.action == "validate":
        problems = obs_export.validate_stream(records)
        for ident, problem in problems:
            print(f"{args.events}: event {ident}: {problem}",
                  file=sys.stderr)
        tail = (f", {dropped} corrupt line(s) skipped" if dropped else "")
        if problems:
            print(f"obs validate: {len(problems)} schema problem(s) in "
                  f"{len(records)} event(s){tail}", file=sys.stderr)
            return 1
        print(f"obs validate: {len(records)} event(s) OK{tail}")
        return 0

    if args.action == "summary":
        summary = obs_export.summarize(records, dropped)
        print(_json.dumps(summary, indent=1, sort_keys=True)
              if args.json else obs_export.format_summary(summary))
        return 0

    # export
    if args.format == "chrome":
        doc = obs_export.chrome_trace(
            obs_export.spans_from_events(records))
        text = _json.dumps(doc, indent=1, sort_keys=True) + "\n"
    else:
        snap = obs_export.last_metrics_snapshot(records)
        if snap is None:
            print("error: the stream has no metrics snapshot (the run "
                  "died before its final flush)", file=sys.stderr)
            return 1
        text = obs_export.prometheus_text(snap)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.format} export to {args.out}")
    else:
        sys.stdout.write(text)
    return 0


def _obs_top(args) -> int:
    """``obs top`` — the live terminal view: poll a running telemetry
    plane's /slo + /healthz and render the refreshing table."""
    import time
    import urllib.error

    from .obs.http import fetch_json, format_top

    base = args.url.rstrip("/")
    interval = max(args.interval, 0.2)
    while True:
        try:
            slo = fetch_json(f"{base}/slo")
            health = fetch_json(f"{base}/healthz")
        except urllib.error.HTTPError as e:
            if e.code != 503:
                print(f"error: {base}: HTTP {e.code}", file=sys.stderr)
                return 1
            # 503 still carries the health body: NOT SERVING is a
            # frame, not a failure of the viewer
            import json as _json

            health = _json.loads(e.read().decode("utf-8"))
            slo = {"rows": {}}
        except (OSError, ValueError) as e:
            print(f"error: no telemetry plane at {base} ({e})",
                  file=sys.stderr)
            return 1
        frame = format_top(slo, health)
        if args.once:
            print(frame)
            return 0
        # clear + home, then the frame (the classic top discipline)
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
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
    if argv and argv[0] == "faults":
        return faults_main(argv[1:])
    if argv and argv[0] == "multichip":
        return multichip_main(argv[1:])
    if argv and argv[0] == "obs":
        return obs_main(argv[1:])
    if argv and argv[0] == "apps":
        from .apps.cli import apps_main

        return apps_main(argv[1:])
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
                    help="timed repetitions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="also check the result against numpy's FFT")
    ap.add_argument("--device", default="cuda",
                    help="the tensor backends' device: cuda (default) or "
                         "cpu (plain versions); the native core runs on "
                         "the host")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to DIR")
    args = ap.parse_args(argv)

    if args.t:
        return run_golden(args.backend, args.device)
    if not args.n or not args.p:
        ap.print_usage(sys.stderr)
        return 2

    b = get_backend(args.backend, args.device)
    cap = b.capacity()
    if cap is not None and args.p > cap:
        print(f"error: p={args.p} exceeds backend '{args.backend}' "
              f"capacity {cap}", file=sys.stderr)
        return 2
    x = make_input(args.n, args.seed)
    try:
        from .obs.profiler import trace

        with trace(args.trace):
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
