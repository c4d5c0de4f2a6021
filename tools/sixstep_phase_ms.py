#!/usr/bin/env python3
"""Where the sixstep kernel's time goes: each of its three phases alone,
by phase-B2 cluster width, on one card.

    python3 tools/sixstep_phase_ms.py [--reps 20]

The kernel is one cooperative launch of three phases (A: the outer
long-range levels, B1: the inner ones, B2: the tile rows), so no
profiler sees a phase alone.  ``csrc/sixstep.cu`` runs the phases its
build names in ``PIFFT_SIXSTEP_PHASES`` (all three by default; each
grid.sync() stays); this script builds this checkout's source four
times with the package's own nvcc flags, the nvcc processes started
together, into a temporary directory (all three phases, then A, B1 and
B2 alone), and times each build with CUDA events (median of `reps`
launches after 3 warm-up ones; every phase moves 16 bytes an element,
far past the 50 MB L2 at these sizes) at n = 2^25 and 2^27 with the
automatic blocking, for every phase-B2 cluster width the kernel takes.
A build that skips a phase leaves its data as it was, so the times, not
the values, are what it gives.  One JSON line a reading; the card's
name and power limit lead the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the builds timed (PIFFT_SIXSTEP_PHASES): the whole kernel, then A, B1
#: and B2 alone
MASKS = {"all": 7, "A": 1, "B1": 2, "B2": 4}


def build(tmp: str) -> dict:
    """{phase: the library built with that phase mask}."""
    from cs87project_msolano2_tpu_torch.utils import buildlib

    cu = os.path.join(buildlib.CSRC_DIR, "sixstep.cu")
    procs = {}
    for phase, mask in MASKS.items():
        so = os.path.join(tmp, f"libsixstep_{phase}.so")
        procs[phase] = (so, subprocess.Popen(
            [buildlib.nvcc_path(), *buildlib.NVCC_FLAGS,
             f"-DPIFFT_SIXSTEP_PHASES={mask}", "-I", buildlib.CSRC_DIR,
             "-shared", "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for phase, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc ({phase}) failed:\n{err}")
        lib = ctypes.CDLL(so)
        ptr = ctypes.c_void_p
        lib.pifft_sixstep.restype = ctypes.c_int
        lib.pifft_sixstep.argtypes = [ptr] * 14 + [ctypes.c_int] * 7 + [ptr]
        libs[phase] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops.bits import ilog2
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
        device_factors,
        flat_tables,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for k in (25, 27):
            tile, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << k)
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            xr = torch.randn((R1, R2, tile), generator=gen, device=dev)
            xi = torch.randn((R1, R2, tile), generator=gen, device=dev)
            yr, yi = torch.empty_like(xr), torch.empty_like(xi)
            ops = (*device_factors(R1, R2 * tile, dev),
                   *device_factors(R2, tile, dev), *flat_tables(tile, dev))
            ptrs = [t.data_ptr() for t in (xr, xi, yr, yi, *ops)]
            for cw in (1, 2, 4):
                def launch(lib):
                    err = lib.pifft_sixstep(
                        *ptrs, ilog2(R1), ilog2(R2), ilog2(tile), ilog2(cb1),
                        ilog2(cb2), ilog2(cw), 0,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"sixstep launch: CUDA error {err}")

                for phase, lib in libs.items():
                    for _ in range(3):
                        launch(lib)
                    times = []
                    for _ in range(args.reps):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        launch(lib)
                        end.record()
                        end.synchronize()
                        times.append(start.elapsed_time(end))
                    print(json.dumps({
                        "n": f"2^{k}", "R1": R1, "R2": R2, "cb1": cb1,
                        "cb2": cb2, "cw": cw,
                        "auto_cw": cf.sixstep_cluster_width(tile),
                        "phase": phase, "ms": statistics.median(times),
                        "bytes": 16 << k}), flush=True)
            del xr, xi, yr, yi, ops
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
