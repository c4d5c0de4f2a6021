#!/usr/bin/env python3
"""Device time per call of the matmul_funnel and long_range_dense
kernels, beside the fourstep, long_range_sep, sixstep, tile_fft,
gpu_rows and fused kernels as the control, on one card, for one or more
checkouts of the PyTorch/CUDA port.

    python3 tools/kernel_device_ms.py [ROOT ...] [--reps 30]

Each ROOT (default: this checkout) holds ``cs87project_msolano2_tpu_torch``;
the script runs one child process per root, in the order given (pass
A B B A to alternate two), and each child imports the package from its
root only.  For every case the child prints one JSON line with:

* ``device_ms``: the kernel's own device time per call, from
  ``torch.profiler``: its mean time a launch over `reps` calls, the 50 MB
  L2 flushed before each (the flush kernel is not counted), times its
  ``launches`` in one call profiled alone (or over the `reps` calls,
  where more), so the host's launch cost does not show.  The session's
  sum is not read; each session opens with one-byte fills that take
  the records the profiler loses at a session's start;
* ``event_ms``: the CUDA-event median over the same kind of calls, as
  ``chip_smoke.py`` phase 7 times kernels: it includes the wrapper's
  host time before the launch when the card is idle.

Cases, each at the root's own automatic blocking: matmul_funnel at
128 x 2^13 (the mf path's first launch at n = 2^20) in the split3,
default and highest modes, and long_range_dense at 1 x 64 x 2^14 (the
two-kernel entry's first pass at n = 2^20), cb 32; the control:
fourstep at n = 2^22 and 2^24 in both twiddle modes, long_range_sep at
1 x 64 x 2^14 (rql's first pass at n = 2^20, config 2), 1 x 256 x 2^14
(rql at 2^22) and 4 x 16 x 2^14 (tube_cuda's segments at n = 2^20, p =
4), cb 32, sixstep at n = 2^25, tile_fft at 4096 x 4096, gpu_rows at
4096 x 4096 and fused at n = 2^20.  A root whose funnel takes B in
float32 and B2 (R, 128) (before the kernel's tiles) is given them so.
Then, in a root that has them (``cuda_fft.BF16_KERNELS``), the bf16
storage instantiations on bf16 planes and tables: tile_fft at 4096 x
4096 and 64 x 2^14, long_range_sep and long_range_dense at 1 x 64 x
2^14, fourstep at 2^22 and 2^24, sixstep at 2^25 and 2^27 and fused at
2^20 (``BF16_CASES``), each case named with "bf16"; a root without them,
or without one of those kernels' bf16 instantiation, prints one line
saying so.

    python3 tools/kernel_device_ms.py --widths [--reps 30]

times instead this checkout's tile_fft kernel at every cluster width
(1, 2, 4, 8) on rows of 2^14 and 2^13 points at row counts around one
wave of the card's SMs, launched through the library's C entry with the
width named, beside the width the wrapper picks (``auto_cw``): the
readings ``cuda_fft.tile_blocking``'s rule is set from.

The card's name and power limit lead the output.  The timing loops are
this file's own, the same for every root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SEED = 0
#: one-byte fills that open each profiler session
PROFILE_PAD = 256
#: log2 n of the fourstep cases
FOURSTEP_LOG2N = (22, 24)
#: (R, n) and precision modes of the matmul_funnel cases
MF_SHAPE = (128, 1 << 20)
MF_MODES = ("split3", "default", "highest")
#: (batch, R, C) of the long_range_sep cases
LONG_RANGE_SHAPES = ((1, 64, 1 << 14), (1, 256, 1 << 14), (4, 16, 1 << 14))
#: (rows, tile) of the width study (--widths)
WIDTH_SHAPES = tuple((rows, 1 << 14) for rows in (8, 16, 32, 64, 96, 128)) \
    + ((64, 1 << 13), (128, 1 << 13))
#: the bf16 cases: (kernel, shape) — tile_fft (rows, tile),
#: long_range_sep and long_range_dense (batch, R, C), fourstep, sixstep
#: and fused log2 n
BF16_CASES = (("tile_fft", (4096, 4096)), ("tile_fft", (64, 1 << 14)),
              ("long_range_sep", (1, 64, 1 << 14)),
              ("long_range_dense", (1, 64, 1 << 14)), ("fourstep", 22),
              ("fourstep", 24), ("sixstep", 25), ("sixstep", 27),
              ("fused", 20))


def child(reps: int, widths: bool) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cs87project_msolano2_tpu_torch.hw import lowering
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops import twiddle
    from cs87project_msolano2_tpu_torch.ops.precision import split_levels
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
        dense_long_range_tables,
        device_factors,
        flat_tables,
    )
    from cs87project_msolano2_tpu_torch.utils.timing import (
        FLUSH_BYTES,
        time_ms,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def planes(shape):
        return tuple(torch.from_numpy(rng.standard_normal(shape)
                                      .astype(np.float32)).to(dev)
                     for _ in range(2))

    def kernel_ms(prof, name):
        # (device ms summed, launches seen) of the profile's kernels whose
        # name holds `name`
        ms, count = 0.0, 0
        for ev in prof.key_averages():
            if name in ev.key:
                dt = getattr(ev, "self_device_time_total", None)
                ms += (ev.self_cuda_time_total if dt is None else dt) / 1e3
                count += ev.count
        return ms, count

    pad = torch.empty(1, dtype=torch.uint8, device=dev)

    def session(fn, args, calls, flush):
        # a profile of `calls` calls, opened by PROFILE_PAD one-byte fills
        # that take the records the profiler loses at a session's start
        # (read again with four times as many where it kept none of them)
        npad = PROFILE_PAD
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(npad):
                    pad.fill_(0)
                torch.cuda.synchronize()
                for _ in range(calls):
                    if flush:
                        scratch.fill_(1)
                    fn(*args)
                torch.cuda.synchronize()
            if kernel_ms(prof, "FillFunctor<unsigned char>")[1] > \
                    calls * flush:
                return prof
            npad *= 4
        return None

    def measure(label, name, fn, *args):
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        one = session(fn, args, 1, False)
        prof = session(fn, args, reps, True)
        ms, count = kernel_ms(prof, name) if prof else (0.0, 0)
        launches = kernel_ms(one, name)[1] if one else 0
        launches = max(launches, round(count / reps))
        event_ms = time_ms(fn, *args, reps=reps, warmup=3, flush_l2=True)[0]
        print(json.dumps({"case": label, "device_ms": ms / count * launches
                          if count and launches else None,
                          "launches": launches, "event_ms": event_ms}),
              flush=True)

    if widths:
        from cs87project_msolano2_tpu_torch.hw.inventory import sm_count
        from cs87project_msolano2_tpu_torch.ops.bits import ilog2

        sms = sm_count(dev)
        for rows, tile in WIDTH_SHAPES:
            x = planes((rows, tile))
            y = (torch.empty_like(x[0]), torch.empty_like(x[1]))
            tw = flat_tables(tile, dev)
            auto = cf.tile_blocking(rows, tile, sms)
            for cw in cf.CLUSTER_WIDTHS:
                block_rows = cf.auto_block_rows(rows, tile) if cw == 1 else 1

                def launch(cw=cw, block_rows=block_rows):
                    cf._launch("tile_fft", "pifft_tile_fft", dev, *x, *y,
                               *tw, rows, ilog2(tile), ilog2(block_rows),
                               ilog2(cw))

                measure(f"tile_fft({rows},{tile}) cw={cw} auto_cw="
                        f"{auto[1]} sms={sms}", "tile_fft", launch)
            del x, y
        return
    R, n = MF_SHAPE
    x = planes((R, n // R))
    for mode in MF_MODES:
        fac = twiddle.device_funnel_factors(R, n, dev)
        if hasattr(twiddle, "device_funnel_b_tiles"):
            ops = (twiddle.device_funnel_b_tiles(R, split_levels(mode), dev),
                   *fac[:2], twiddle.device_funnel_b2_tiles(R, n, dev))
        else:
            ops = (*twiddle.device_funnel_b(R, dev), *fac)
        measure(f"matmul_funnel({R},{n // R}) {mode}", "matmul_funnel",
                lambda *a, m=mode: cf.matmul_funnel(*a, precision=m), *x,
                *ops)
    R, T = 64, 1 << 14
    x = planes((1, R, T))
    measure(f"long_range_dense(1,{R},{T}) cb={cf.DEFAULT_CB}",
            "long_range", cf.long_range_dense, *x,
            *dense_long_range_tables(R, T, dev), cf.DEFAULT_CB)
    del x
    for k in FOURSTEP_LOG2N:
        tile, R, cb = cf.fourstep_blocking(1 << k)
        x = planes((R, tile))
        for separable in (True, False):
            lr = device_factors if separable else dense_long_range_tables
            measure(f"fourstep(2^{k}) cb={cb} separable={separable} "
                    f"(control)", "fourstep",
                    lambda *a, s=separable: cf.fourstep(*a, separable=s),
                    *x, *lr(R, tile, dev), *flat_tables(tile, dev))
        del x
    for batch, R, C in LONG_RANGE_SHAPES:
        x = planes((batch, R, C))
        measure(f"long_range_sep({batch},{R},{C}) cb={cf.DEFAULT_CB} "
                f"(control)", "long_range", cf.long_range_sep, *x,
                *device_factors(R, C, dev), cf.DEFAULT_CB)
        del x
    tile, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << 25)
    x = planes((R1, R2, tile))
    measure(f"sixstep(2^25) (control) auto {(R1, R2, cb1, cb2)}", "sixstep",
            cf.sixstep, *x, *device_factors(R1, R2 * tile, dev),
            *device_factors(R2, tile, dev), *flat_tables(tile, dev))
    x = planes((4096, 4096))
    measure("tile_fft(4096,4096) (control)", "tile_fft", cf.tile_fft, *x,
            *flat_tables(4096, dev))
    measure("gpu_rows(4096,4096) (control)", "gpu_rows", cf.gpu_rows, *x,
            *lowering.device_twiddle_stack(4096, dev))
    R, T = 64, 1 << 14
    x = planes((R, T))
    measure(f"fused({R},{T}) (control) auto {cf.fused_blocking(R * T)}",
            "fused", cf.fused, *x, *device_factors(R, T, dev),
            *flat_tables(T, dev))
    del x
    if not hasattr(cf, "BF16_KERNELS"):
        print(json.dumps({"case": "bf16 instantiations",
                          "device_ms": None,
                          "note": "this root has none"}), flush=True)
        return
    bf = "bfloat16"

    def bf16(shape):
        return tuple(t.to(torch.bfloat16) for t in planes(shape))

    for kernel, shape in BF16_CASES:
        if getattr(cf, kernel) not in cf.BF16_KERNELS:
            print(json.dumps({"case": f"{kernel} bf16", "device_ms": None,
                              "note": "this root has no bf16 instantiation "
                                      "of it"}), flush=True)
            continue
        if kernel == "tile_fft":
            rows, tile = shape
            measure(f"tile_fft({rows},{tile}) bf16", "tile_fft", cf.tile_fft,
                    *bf16(shape), *flat_tables(tile, dev, bf))
        elif kernel == "long_range_sep":
            batch, R, C = shape
            measure(f"long_range_sep({batch},{R},{C}) cb={cf.DEFAULT_CB} "
                    f"bf16", "long_range", cf.long_range_sep, *bf16(shape),
                    *device_factors(R, C, dev, bf), cf.DEFAULT_CB)
        elif kernel == "long_range_dense":
            batch, R, C = shape
            measure(f"long_range_dense({batch},{R},{C}) cb={cf.DEFAULT_CB} "
                    f"bf16", "long_range", cf.long_range_dense, *bf16(shape),
                    *dense_long_range_tables(R, C, dev, bf), cf.DEFAULT_CB)
        elif kernel == "fused":
            tile, R, qb, cw = cf.fused_blocking(1 << shape)
            measure(f"fused(2^{shape}) qb={qb} cw={cw} bf16", "fused",
                    cf.fused, *bf16((R, tile)),
                    *device_factors(R, tile, dev, bf),
                    *flat_tables(tile, dev, bf))
        elif kernel == "fourstep":
            tile, R, cb = cf.fourstep_blocking(1 << shape)
            measure(f"fourstep(2^{shape}) cb={cb} bf16", "fourstep",
                    cf.fourstep, *bf16((R, tile)),
                    *device_factors(R, tile, dev, bf),
                    *flat_tables(tile, dev, bf))
        else:
            tile, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << shape)
            measure(f"sixstep(2^{shape}) auto {(R1, R2, cb1, cb2)} bf16",
                    "sixstep", cf.sixstep, *bf16((R1, R2, tile)),
                    *device_factors(R1, R2 * tile, dev, bf),
                    *device_factors(R2, tile, dev, bf),
                    *flat_tables(tile, dev, bf))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--widths", action="store_true",
                    help="time this checkout's tile_fft at every cluster "
                         "width instead")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps, args.widths)
        return 0
    if args.widths and args.roots:
        ap.error("--widths times this checkout only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for root in args.roots or [here]:
        root = os.path.abspath(root)
        print(json.dumps({"root": root}), flush=True)
        env = dict(os.environ, PYTHONPATH=root)
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--reps", str(args.reps)] + ["--widths"] * args.widths,
            cwd=root, env=env, timeout=900)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
