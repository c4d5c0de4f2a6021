#!/usr/bin/env python3
"""One traced run of a benchmark cell, with the port's own spans read
beside its result line.

    python3 tools/program_spans.py --workload <cell> --seed <n> [--seconds 10]

Runs ``benchmark/run.py``'s ``main`` with ``--trace 1`` in this process,
keeping the window's trace, so its output is the run's own, result line
last.  Then one more JSON line: the mean ``fft.call`` and
``bench.issue`` spans in us, each transform-path span's count a call,
the host split (``benchlib.program.host_split``) and its sum, the spans
the recorder dropped, and the ten longest idle gaps of the window named
by the innermost program span that covers their middle
(``benchlib.program.idle_gaps``) beside the result line's own names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
    import run as bench_run
    from benchlib import program, trace

    kept = []
    traced = trace.traced

    def keep(fn, port_kernels):
        result, tr = traced(fn, port_kernels)
        kept.append(tr)
        return result, tr

    trace.traced = keep
    rc = bench_run.main(["--workload", args.workload, "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "1"])
    if rc or not kept:
        return rc or 1
    tr = kept[0]
    from cs87project_msolano2_tpu_torch.obs import spans

    run = types.SimpleNamespace(trace=tr)
    ivs = program.intervals(run) or []
    calls = [iv for iv in ivs if iv[0] == "fft.call"]
    if not calls:
        print(json.dumps({"workload": args.workload, "calls": 0}))
        return 1
    counts = {}
    for iv in ivs:
        counts[iv[0]] = counts.get(iv[0], 0) + 1
    split = program.host_split(run)
    issue = tr.span_ns("bench.issue")
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "calls": len(calls),
        "fft_call_us": sum(e - s for *_, s, e in calls) / len(calls) / 1e3,
        "bench_issue_us": sum(issue) / len(issue) / 1e3,
        "spans_per_call": {k: v / len(calls) for k, v in counts.items()},
        "host_split_us": split, "host_split_sum_us": sum(split.values()),
        "lost": getattr(spans._REC, "lost", None),
        "idle_gaps": program.idle_gaps(tr, ivs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
