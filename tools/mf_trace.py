#!/usr/bin/env python3
"""Where one launch of the matmul funnel kernel spends its time, block by
block, on one card.

    python3 tools/mf_trace.py [--R 128] [--log2n 20]

``csrc/mf.cu`` built with ``-DPIFFT_MF_TRACE=1`` has thread 0 of each of
its first 64 blocks note the card's nanosecond clock (``%globaltimer``)
when the block starts, when each of its first 16 steps' data have
arrived (after the step's ``__syncthreads()``), when each step's
products are done (after ``wgmma.wait_group``), around the epilogue of
its first two work units, and when it ends.  This script builds
this checkout's ``mf.cu`` so into a temporary directory with the
package's own nvcc flags, runs it through its C entry on the funnel's
operands (``twiddle.device_funnel_b_tiles`` and ``device_funnel_b2_tiles``)
at R x n / R in the default, split3 and highest modes (three warm-up
launches, then the 50 MB L2 flushed, then the traced launch), and prints
one JSON line a mode: each phase as microseconds after the first block
started, the median, least and greatest over the traced blocks, beside
the CUDA-event median of 20 flushed launches of the same build.  The
card's name and power limit and ptxas's register and spill lines lead
the output.
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

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the trace's shape (mf.cu: kTraceBlocks, kTraceSteps, kTraceSlots)
BLOCKS, STEPS = 64, 16
SLOTS = 2 + 2 * STEPS + 4
MODES = ("default", "split3", "highest")


def build(tmp: str):
    from cs87project_msolano2_tpu_torch.utils import buildlib

    so = os.path.join(tmp, "libmf_trace.so")
    done = subprocess.run(
        [buildlib.nvcc_path(), *buildlib.NVCC_FLAGS, "-DPIFFT_MF_TRACE=1",
         "-I", buildlib.CSRC_DIR, "-shared", "-o", so,
         os.path.join(buildlib.CSRC_DIR, "mf.cu")],
        capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed:\n{done.stderr}")
    print(json.dumps({"ptxas": [
        line.split(":", 1)[-1].strip() for line in done.stderr.splitlines()
        if "registers" in line or "spill" in line]}), flush=True)
    lib = ctypes.CDLL(so)
    ptr = ctypes.c_void_p
    lib.pifft_matmul_funnel.restype = ctypes.c_int
    lib.pifft_matmul_funnel.argtypes = [ptr] * 8 + [ctypes.c_int] * 4 + [ptr]
    lib.pifft_matmul_funnel_trace.restype = ctypes.c_int
    lib.pifft_matmul_funnel_trace.argtypes = [ptr]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--R", type=int, default=128)
    ap.add_argument("--log2n", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops import twiddle
    from cs87project_msolano2_tpu_torch.ops.bits import ilog2
    from cs87project_msolano2_tpu_torch.ops.precision import split_levels
    from cs87project_msolano2_tpu_torch.utils.timing import FLUSH_BYTES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    R, n = args.R, 1 << args.log2n
    R, C, _ = cf.mf_blocking(n, R)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xr = torch.randn((R, C), generator=gen, device=dev)
    xi = torch.randn((R, C), generator=gen, device=dev)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    ar, ai = twiddle.device_funnel_factors(R, n, dev)[:2]
    b2t = twiddle.device_funnel_b2_tiles(R, n, dev)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for mode in MODES:
            levels = split_levels(mode)
            bt = twiddle.device_funnel_b_tiles(R, levels, dev)
            ptrs = [t.data_ptr() for t in (xr, xi, yr, yi, bt, ar, ai, b2t)]

            def launch():
                err = lib.pifft_matmul_funnel(*ptrs, ilog2(R), C, levels,
                                              0, stream)
                if err:
                    raise RuntimeError(f"launch: CUDA error {err}")

            for _ in range(3):
                launch()
            times = []
            for _ in range(20):
                flush.fill_(1)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            flush.fill_(1)
            torch.cuda.synchronize()
            launch()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (BLOCKS * SLOTS))()
            err = lib.pifft_matmul_funnel_trace(buf)
            if err:
                raise RuntimeError(f"trace: CUDA error {err}")
            t = np.array(buf, dtype=np.int64).reshape(BLOCKS, SLOTS)
            # slots this launch did not write keep an earlier launch's
            # readings (or 0): all before its first block started
            t = t[t[:, 0] > 0]
            t0 = t[:, 0].min()

            def phase(slot):
                v = t[:, slot]
                v = (v[v >= t0] - t0) / 1e3
                return None if not len(v) else [
                    round(float(np.median(v)), 3), round(float(v.min()), 3),
                    round(float(v.max()), 3)]

            steps = min(R // 16, STEPS)
            print(json.dumps({
                "mode": mode, "R": R, "C": C, "traced_blocks": len(t),
                "grid": cf.mf_resident_blocks(dev, mode),
                "event_ms": statistics.median(times),
                "us_median_min_max": {
                    "start": phase(0),
                    **{f"step {s} data": phase(1 + 2 * s)
                       for s in range(steps)},
                    **{f"step {s} products": phase(2 + 2 * s)
                       for s in range(steps)},
                    "unit 0 epilogue start": phase(1 + 2 * STEPS),
                    "unit 0 epilogue end": phase(2 + 2 * STEPS),
                    "unit 1 epilogue start": phase(3 + 2 * STEPS),
                    "unit 1 epilogue end": phase(4 + 2 * STEPS),
                    "end": phase(SLOTS - 1)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
