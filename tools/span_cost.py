#!/usr/bin/env python3
"""What one span site of the port's observability costs on this host,
with observability off and on.

    python3 tools/span_cost.py [--root DIR] [--reps 200000] [--blocks 20]

`--root` is the checkout whose package is timed (default: this one), so
an older checkout is timed by the same script.  Each reading is the
best of 7 rounds of `reps` entries and exits of an empty ``with`` block,
less the same loop with no block, in nanoseconds a site:

* ``span``: ``obs.spans.span("x")``, the general span (every checkout);
* ``path_span``, ``call_span``: the transform path's bare-name sites,
  where the checkout has them;
* on: the same with the event stream armed (``obs.enable``) and, for
  ``path_span``, with a profiler session's recorder in its place;
* on a card, where the checkout records under a profiler, the host time
  of one call (``fft`` of 4096 rows of 4096, ``fft_planes_fast`` of
  2^24 in pi order), each call waited for, inside a CUDA-only
  ``torch.profiler`` session: `blocks` blocks of 50 calls with the
  recording on and as many with it off, in turns, the medians of the
  blocks' means in us.

One JSON line, led by the host's CPU model and the card's name and
power limit where a card is present.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import timeit


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "none"
    except (OSError, subprocess.SubprocessError):
        return "none"


def call_cost(spans, blocks: int) -> dict:
    """{entry: {on_us, off_us, spans_a_call}}: the host time of one call with
    the profiler session's recording on and off (see the docstring)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cs87project_msolano2_tpu_torch.models.fft import fft, fft_planes_fast
    from cs87project_msolano2_tpu_torch.utils.timing import sync

    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, dtype=torch.complex64, device=dev)
    xr, xi = torch.randn(2, 1 << 24, device=dev)
    entries = {"fft 4096x4096": lambda: fft(x),
               "fft_planes_fast 2^24 pi":
                   lambda: fft_planes_fast(xr, xi, natural=False)}

    class NoSession:
        _is_profiler_enabled = False

    session = spans._PROFILER
    out = {}
    for name, call in entries.items():
        for _ in range(20):
            call()
        sync(dev)
        means = {"on": [], "off": []}
        recorded = 0
        with profile(activities=[ProfilerActivity.CUDA]):
            for block in range(2 * blocks):
                mode = ("on", "off")[(block + block // 2) % 2]
                spans._PROFILER = session if mode == "on" else NoSession()
                spans._REC = None  # the block's first call starts afresh
                total = 0.0
                for _ in range(50):
                    t = spans.clock()
                    call()
                    total += spans.clock() - t
                    sync(dev)
                means[mode].append(total / 50 * 1e6)
                recorded += len(spans.intervals())
        spans._PROFILER, spans._REC = session, None
        out[name] = {"on_us": statistics.median(means["on"]),
                     "off_us": statistics.median(means["off"]),
                     "spans_a_call": recorded / (50 * blocks)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=200000)
    ap.add_argument("--blocks", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    from cs87project_msolano2_tpu_torch import obs
    from cs87project_msolano2_tpu_torch.obs import spans

    sites = {"span": "with spans.span('x'): pass"}
    for name in ("path_span", "call_span"):
        if hasattr(spans, name):
            sites[name] = f"with spans.{name}('x'): pass"
    env = {"spans": spans}

    def ns(stmt: str) -> float:
        best = min(timeit.repeat(stmt, globals=env, number=args.reps,
                                 repeat=7))
        return best / args.reps * 1e9

    base = ns("pass")
    out = {"cpu": _cpu_model(), "card": _card(),
           "python": sys.version.split()[0], "root": args.root}
    out["off_ns"] = {k: ns(s) - base for k, s in sites.items()}
    obs.enable(buffer_max=1 << 22)
    on = {k: ns(s) - base for k, s in sites.items()
          if k != "call_span"}
    obs.disable()
    if hasattr(spans, "Recorder"):
        spans._REC = spans.Recorder(1 << 22)
        on["path_span.profiler"] = ns(sites["path_span"]) - base
        spans._REC = None
    out["on_ns"] = on
    import torch

    if torch.cuda.is_available() and hasattr(spans, "call_span"):
        out["call_us"] = call_cost(spans, args.blocks)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
