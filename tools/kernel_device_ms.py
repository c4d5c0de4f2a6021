#!/usr/bin/env python3
"""Device time per call of the gpu_rows and fused kernels (and the
unchanged tile_fft as a control) on one card, for one or more checkouts
of the PyTorch/CUDA port.

    python3 tools/kernel_device_ms.py [ROOT ...] [--reps 30] [--out FILE]

Each ROOT (default: this checkout) holds ``cs87project_msolano2_tpu_torch``;
the script runs one child process per root, in the order given (pass
A B B A to alternate two), and each child imports the package from its
root only.  For every case the child prints one JSON line with:

* ``device_ms``: the kernel's own device time per call, from
  ``torch.profiler`` over `reps` calls, the 50 MB L2 flushed before each
  (the flush kernel is not counted), so the host's launch cost does not
  show;
* ``event_ms``: the CUDA-event median over the same kind of calls, as
  ``chip_smoke.py`` phase 7 times kernels: it includes the wrapper's
  host time before the launch when the card is idle.

Cases: gpu_rows at 4096 x 4096, 2^20 x 16, and 2^24 points of rows of
2^14 .. 2^18 (automatic blocking); fused at n = 2^20 with its automatic
blocking and, where the checkout's ``fused`` takes a cluster width, by
(qb, cw); tile_fft at 4096 x 4096.  The card's name and power limit lead
the output.  The timing loops are this file's own, the same for every
root.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

SEED = 0
GPU_ROWS_SHAPES = ((4096, 4096), (1 << 20, 16), (1024, 1 << 14),
                   (512, 1 << 15), (256, 1 << 16), (128, 1 << 17),
                   (64, 1 << 18))


def child(reps: int) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cs87project_msolano2_tpu_torch.hw import lowering
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
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

    def measure(label, name, fn, *args):
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scratch.fill_(1)
                fn(*args)
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if name in ev.key:
                dt = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if dt is None else dt
        event_ms = time_ms(fn, *args, reps=reps, warmup=3, flush_l2=True)[0]
        print(json.dumps({"case": label, "device_ms": us / 1e3 / reps
                          if us else None, "event_ms": event_ms}),
              flush=True)

    x = planes((4096, 4096))
    measure("tile_fft(4096,4096)", "tile_fft", cf.tile_fft, *x,
            *flat_tables(4096, dev))
    for rows, n in GPU_ROWS_SHAPES:
        x = planes((rows, n))
        measure(f"gpu_rows({rows},{n})", "gpu_rows", cf.gpu_rows, *x,
                *lowering.device_twiddle_stack(n, dev))
        del x
    R, T = 64, 1 << 14
    x = planes((R, T))
    ops = (*device_factors(R, T, dev), *flat_tables(T, dev))
    measure(f"fused({R},{T}) auto {cf.fused_blocking(R * T)}", "fused",
            cf.fused, *x, *ops)
    if "cw" in inspect.signature(cf.fused).parameters:
        for qb in (1, 2):
            for cw in (1, 2, 4, 8):
                measure(f"fused({R},{T}) qb={qb} cw={cw}", "fused",
                        lambda *a, qb=qb, cw=cw: cf.fused(*a, qb=qb, cw=cw),
                        *x, *ops)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps)
        return 0
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
             "--reps", str(args.reps)], cwd=root, env=env, timeout=900)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
