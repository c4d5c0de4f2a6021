#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (serving on one card) alone, and with
``--bench`` the port's bench at full size after it, each of its cells'
seconds read from the bench's event stream (the ``cell`` spans), longest
first.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 tools/serve_phase.py [--bench]

The plan store is a fresh temporary directory, so phase 19 warms (and
races) its shapes cold and the bench races every key.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv) -> int:
    os.environ["PIFFT_PLAN_CACHE"] = tempfile.mkdtemp()
    sys.path.insert(0, os.getcwd())
    import torch

    from cs87project_msolano2_tpu_torch.utils import buildlib

    t0 = time.perf_counter()
    buildlib.build()
    buildlib.load_kernels()
    print(f"# build {time.perf_counter() - t0:.1f} s", flush=True)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    t0 = time.perf_counter()
    rc = 0
    try:
        smoke.phase_serve(torch.device("cuda"), np.random.default_rng(0))
        print(f"# phase 19 ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    except AssertionError as e:
        print(f"# phase 19 FAILED ({e})", flush=True)
        rc = 1
    if "--bench" in argv:
        from cs87project_msolano2_tpu_torch import bench

        events = tempfile.mktemp(suffix=".jsonl")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc |= bench.main(["--events", events])
        print(f"# bench {time.perf_counter() - t0:.1f} s", flush=True)
        cells = []
        with open(events) as fh:
            for line in fh:
                rec = json.loads(line)
                if rec.get("kind") == "span" \
                        and rec["payload"].get("name") == "cell":
                    cells.append((rec["payload"]["dur_s"], rec.get("cell")))
        for dur, cell in sorted(cells, key=lambda c: -c[0]):
            print(f"# cell {dur:8.2f} s {cell}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
