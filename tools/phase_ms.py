#!/usr/bin/env python3
"""Where the sixstep and fourstep kernels' time goes: each phase alone,
on one card.

    python3 tools/phase_ms.py [--kernels sixstep fourstep] [--reps 20]

Each kernel is one cooperative launch of several phases, so no profiler
sees a phase alone.  ``csrc/sixstep.cu`` runs the phases its build names
in ``PIFFT_SIXSTEP_PHASES`` (A: the outer long-range levels 1, B1: the
inner ones 2, B2: the tile rows 4), ``csrc/fourstep.cu`` those in
``PIFFT_FOURSTEP_PHASES`` (A: the long-range levels 1, B: the tile rows
2), each grid.sync() kept.  This script builds this checkout's sources
once per mask with the package's own nvcc flags, the nvcc processes
started together, into a temporary directory, and times each build with
CUDA events (median of `reps` launches after 3 warm-up ones; every phase
moves 16 bytes an element, past the 50 MB L2 at these sizes) at the
automatic blocking: sixstep at n = 2^25 and 2^27 for every phase-B2
cluster width the kernel takes, fourstep at n = 2^22 and 2^24 in both
twiddle modes.  A build that skips a phase leaves its data as it
was, so the times, not the values, are what it gives.  One JSON line a
reading, after one a build with ptxas's register and spill lines for its
kernels; the card's name and power limit lead the output.
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
#: sixstep's builds (PIFFT_SIXSTEP_PHASES): the whole kernel, then A, B1
#: and B2 alone
SIXSTEP_MASKS = {"all": 7, "A": 1, "B1": 2, "B2": 4}
#: fourstep's builds (PIFFT_FOURSTEP_PHASES): the whole kernel, then A
#: and B alone
FOURSTEP_MASKS = {"all": 3, "A": 1, "B": 2}


def build(tmp: str, kernels) -> dict:
    """{(kernel, build name): the library of that build}."""
    from cs87project_msolano2_tpu_torch.utils import buildlib

    jobs = {}
    if "sixstep" in kernels:
        for name, mask in SIXSTEP_MASKS.items():
            jobs[("sixstep", name)] = [f"-DPIFFT_SIXSTEP_PHASES={mask}"]
    if "fourstep" in kernels:
        for name, mask in FOURSTEP_MASKS.items():
            jobs[("fourstep", name)] = [f"-DPIFFT_FOURSTEP_PHASES={mask}"]
    procs = {}
    for (kernel, name), defines in jobs.items():
        cu = os.path.join(buildlib.CSRC_DIR, f"{kernel}.cu")
        so = os.path.join(tmp, f"lib{kernel}_{len(procs)}.so")
        procs[(kernel, name)] = (so, subprocess.Popen(
            [buildlib.nvcc_path(), *buildlib.NVCC_FLAGS, *defines, "-I",
             buildlib.CSRC_DIR, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    ptr = ctypes.c_void_p
    for (kernel, name), (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc ({kernel} {name}) failed:\n{err}")
        print(json.dumps({"kernel": kernel, "build": name, "ptxas": [
            line.split(":", 1)[-1].strip() for line in err.splitlines()
            if "registers" in line or "spill" in line]}), flush=True)
        lib = ctypes.CDLL(so)
        for fn, pointers, ints in (("pifft_sixstep", 14, 6),
                                   ("pifft_sixstep_dense", 10, 6),
                                   ("pifft_fourstep", 10, 4),
                                   ("pifft_fourstep_dense", 8, 4)):
            if fn.startswith(f"pifft_{kernel}"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = \
                    [ptr] * pointers + [ctypes.c_int] * (ints + 1) + [ptr]
        libs[(kernel, name)] = lib
    return libs


def median_ms(launch, reps: int) -> float:
    import torch

    for _ in range(3):
        launch()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", nargs="+", choices=("sixstep", "fourstep"),
                    default=["sixstep", "fourstep"])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops.bits import ilog2
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
        dense_long_range_tables,
        device_factors,
        flat_tables,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def planes(shape):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev))

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} launch: CUDA error {err}")

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, args.kernels)
        if "sixstep" in args.kernels:
            for k in (25, 27):
                tile, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << k)
                xr, xi = planes((R1, R2, tile))
                yr, yi = torch.empty_like(xr), torch.empty_like(xi)
                ops = (*device_factors(R1, R2 * tile, dev),
                       *device_factors(R2, tile, dev),
                       *flat_tables(tile, dev))
                ptrs = [t.data_ptr() for t in (xr, xi, yr, yi, *ops)]
                for cw in (1, 2, 4):
                    for name in SIXSTEP_MASKS:
                        lib = libs[("sixstep", name)]
                        ms = median_ms(lambda lib=lib, cw=cw: check(
                            lib.pifft_sixstep(
                                *ptrs, ilog2(R1), ilog2(R2), ilog2(tile),
                                ilog2(cb1), ilog2(cb2), ilog2(cw), 0,
                                stream), "sixstep"), args.reps)
                        print(json.dumps({
                            "kernel": "sixstep", "n": f"2^{k}", "R1": R1,
                            "R2": R2, "cb1": cb1, "cb2": cb2, "cw": cw,
                            "auto_cw": cf.row_cluster_width(tile),
                            "phase": name, "ms": ms, "bytes": 16 << k}),
                            flush=True)
                del xr, xi, yr, yi, ops
                torch.cuda.empty_cache()
        if "fourstep" in args.kernels:
            for k in (22, 24):
                tile, R, cb = cf.fourstep_blocking(1 << k)
                cw = cf.row_cluster_width(tile)
                xr, xi = planes((R, tile))
                yr, yi = torch.empty_like(xr), torch.empty_like(xi)
                for separable in (True, False):
                    lr = device_factors(R, tile, dev) if separable \
                        else dense_long_range_tables(R, tile, dev)
                    ptrs = [t.data_ptr() for t in (
                        xr, xi, yr, yi, *lr, *flat_tables(tile, dev))]
                    fn = "pifft_fourstep" if separable \
                        else "pifft_fourstep_dense"
                    for name in FOURSTEP_MASKS:
                        lib = libs[("fourstep", name)]
                        ms = median_ms(lambda f=getattr(lib, fn): check(
                            f(*ptrs, ilog2(R), ilog2(tile), ilog2(cb),
                              ilog2(cw), 0, stream), "fourstep"),
                            args.reps)
                        print(json.dumps({
                            "kernel": "fourstep", "n": f"2^{k}", "R": R,
                            "cb": cb, "cw": cw, "separable": separable,
                            "phase": name, "ms": ms, "bytes": 16 << k}),
                            flush=True)
                del xr, xi, yr, yi
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
