#!/usr/bin/env python3
"""A/B of the host cost of ``fft`` at N = 2^20 between checkouts of the
PyTorch/CUDA port, on one card.

    python3 tools/ab_fft_2p20.py ROOT_A ROOT_B [--rounds 3]

Each ROOT is a checkout holding ``cs87project_msolano2_tpu_torch``.  The
script runs one child process per root and round, alternating A, B,
B, A, A, B, ... so that drift of the card or the host falls on both.
Each child imports the package from its root only and prints one JSON
line with:

* ``lookup_us``: ``plans.plan_for((2^20,))`` on a memoized key, host
  clock, mean of 20000 calls;
* ``fft_ms``: one natural-order ``models.fft.fft`` of 2^20 complex64
  points, CUDA-event median of 200 calls, L2 flushed before each;
* ``fft_us_back_to_back``: 2000 calls queued without a sync, wall clock
  per call: where the host, not the card, sets the pace, a slower
  lookup shows here first;
* ``fft_planned_us_back_to_back``: the same with the plan passed in
  (``fft(x, plan=...)``), so without the lookup;
* ``fft_device_us``: the card's busy time per call (every kernel of
  200 calls, ``torch.profiler``), which the host does not move;
* ``mf_max_abs``: per precision mode, the max abs error against
  complex128 of ``fft`` through ``Plan(key, "mf", {"R": 128})`` on
  ``chip_smoke.py`` phase 9's input (uniform +-2^-10 planes from
  ``numpy.random.default_rng(0)``), so both roots are held on one input.

The parent prints every child's line, then the median of each metric
per root.  The timing loops are this file's own, the same for both
roots.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

N = 1 << 20
LOOKUPS = 20000
REPS = 200
BACK_TO_BACK = 2000
#: bytes written before each flushed rep: past the card's 50 MB L2
FLUSH_BYTES = 256 << 20


def child(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.models.fft import fft

    pkg = sys.modules["cs87project_msolano2_tpu_torch"].__file__
    if not pkg.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {pkg}, not from {root}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.complex(torch.rand(N, device=dev, generator=g) - 0.5,
                      torch.rand(N, device=dev, generator=g) - 0.5)
    for _ in range(10):
        fft(x)
    torch.cuda.synchronize()

    plans.plan_for((N,), device=dev)
    t0 = time.perf_counter()
    for _ in range(LOOKUPS):
        plans.plan_for((N,), device=dev)
    lookup_us = (time.perf_counter() - t0) / LOOKUPS * 1e6

    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    times = []
    for _ in range(REPS):
        scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fft(x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))

    def back_to_back_us(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BACK_TO_BACK):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / BACK_TO_BACK * 1e6

    pl = plans.plan_for((N,), device=dev)
    b2b_us = back_to_back_us(lambda: fft(x))
    planned_us = back_to_back_us(lambda: fft(x, plan=pl))

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fft(x)
        torch.cuda.synchronize()
    device_us = 0.0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", None)
        device_us += ev.self_cuda_time_total if dt is None else dt
    import numpy as np

    from cs87project_msolano2_tpu_torch.plans.core import Plan

    rng = np.random.default_rng(0)
    amp = 1.0 / np.sqrt(N)
    x9 = (rng.uniform(-amp, amp, N).astype(np.float32)
          + 1j * rng.uniform(-amp, amp, N).astype(np.float32))
    ref9 = torch.from_numpy(np.fft.fft(x9.astype(np.complex128))).to(dev)
    x9 = torch.from_numpy(x9.astype(np.complex64)).to(dev)
    mf_max_abs = {}
    for mode in ("split3", "highest", "fp32", "default"):
        y9 = fft(x9, plan=Plan(plans.make_key(N, precision=mode, device=dev),
                               "mf", {"R": 128}))
        mf_max_abs[mode] = float((y9.to(torch.complex128) - ref9).abs().max())
    print(json.dumps({"root": root, "lookup_us": lookup_us,
                      "fft_ms": statistics.median(times),
                      "fft_us_back_to_back": b2b_us,
                      "fft_planned_us_back_to_back": planned_us,
                      "fft_device_us": device_us / REPS,
                      "mf_max_abs": mf_max_abs}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.roots[0])
        return 0
    a, b = (os.path.abspath(r) for r in args.roots)
    order = []
    for r in range(args.rounds):
        order += [a, b] if r % 2 == 0 else [b, a]
    rows = []
    for root in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, root,
             "--child"], capture_output=True, text=True, cwd=root)
        if out.returncode != 0:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"child for {root} exited {out.returncode}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rows.append(json.loads(line))
    summary = {}
    for root in (a, b):
        mine = [r for r in rows if r["root"] == root]
        summary[root] = {k: statistics.median(r[k] for r in mine)
                         for k in rows[0] if k not in ("root", "mf_max_abs")}
        summary[root]["mf_max_abs"] = mine[0]["mf_max_abs"]
    print(json.dumps({"median_per_root": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
