#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cs87project_msolano2_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (nvcc, sm_90a), holds each kernel
against its plain PyTorch version at the main path's shapes, drives the
main path through the user entry points — BASELINE config 2 (one
N=2^20 complex64 fft, the ``rql`` plan), config 3 (4096 rows of 4096
points, the ``rows`` plan) and the paper's funnel/tube ``cuda`` backend
at N=2^20 — checks the results against a complex128 oracle, and times
every kernel and path with CUDA events.  The last line of standard
output is ``{"ok": true, "device": {...}}``; any failed phase raises
and the script exits non-zero without it.  It imports nothing of JAX.

Bounds use NVIDIA's data-sheet peaks for the H100 SXM: 3.35 TB/s of HBM
bandwidth and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
KERNEL_TOL = 1e-6   # kernel vs plain version, rel L2: FMA contraction
PATH_TOL = 1e-5     # whole transform vs complex128, rel L2: split3 budget
MAX_ABS_TOL = 1e-5  # BASELINE's bound on max abs error
REPS = 30
SEED = 0


def log(msg):
    print(msg, flush=True)


def rel_l2(a, b):
    import torch

    a = a.to(torch.complex128)
    b = b.to(torch.complex128)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def max_abs(a, b):
    import torch

    return float((a.to(torch.complex128) - b.to(torch.complex128))
                 .abs().max())


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_complex(rng, shape, device):
    import torch

    n = shape[-1]
    amp = 1.0 / np.sqrt(n)
    xr = rng.uniform(-amp, amp, shape).astype(np.float32)
    xi = rng.uniform(-amp, amp, shape).astype(np.float32)
    return (torch.from_numpy(xr).to(device),
            torch.from_numpy(xi).to(device))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.backends.registry import get_backend
    from cs87project_msolano2_tpu_torch.cli import main as cli_main
    from cs87project_msolano2_tpu_torch.cli import make_input
    from cs87project_msolano2_tpu_torch.models.fft import fft, fft_planes_fast
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
        device_factors,
        flat_tables,
    )
    from cs87project_msolano2_tpu_torch.utils import buildlib, verify
    from cs87project_msolano2_tpu_torch.utils.timing import time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build the kernels from csrc/
    t0 = time.perf_counter()
    buildlib.build()
    buildlib.load_kernels()
    log(f"# phase 2 build: {time.perf_counter() - t0:.1f} s "
        f"({len(buildlib.sources())} sources)")

    # phase 3: each kernel vs its plain version at the main path's shapes
    R, T = 64, 1 << 14
    cases = {}

    def check_kernel(label, kernel, plain, args):
        yk = kernel(*args)
        yp = plain(*args)
        torch.cuda.synchronize()
        k = torch.complex(*yk)
        p = torch.complex(*yp)
        err = rel_l2(k, p)
        mabs = max_abs(k, p)
        log(f"# phase 3 {label}: rel L2 {err:.3e}, max abs {mabs:.3e} "
            f"vs plain")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{label} disagrees with its plain "
                                 f"version: rel L2 {err:.3e}")
        cases[label] = {"rel_l2": err, "max_abs_err": mabs, "args": args}

    twr, twi = flat_tables(4096, dev)
    xr, xi = random_complex(rng, (4096, 4096), dev)
    check_kernel("tile_fft(4096,4096)", cf.tile_fft, cf.tile_fft_plain,
                 (xr, xi, twr, twi))
    twr14, twi14 = flat_tables(T, dev)
    xr, xi = random_complex(rng, (R, T), dev)
    check_kernel("tile_fft(64,16384)", cf.tile_fft, cf.tile_fft_plain,
                 (xr, xi, twr14, twi14))
    fac = device_factors(R, T, dev)
    xr3, xi3 = random_complex(rng, (1, R, T), dev)
    check_kernel("long_range_sep(1,64,16384)",
                 lambda *a: cf.long_range_sep(*a, cf.DEFAULT_CB),
                 cf.long_range_sep_plain, (xr3, xi3, *fac))

    # the main path, counted: config 2, config 3, the paper's backend
    cf.reset_launch_counts()

    # phase 4: config 2 — one N=2^20 complex64 fft through the rql plan
    n2 = 1 << 20
    x2 = torch.complex(*random_complex(rng, (n2,), dev))
    pl2 = plans.plan_for((n2,), device=dev)
    if pl2.variant != "rql":
        raise AssertionError(f"N=2^20 planned {pl2.variant}, not rql")
    before = (cf.tile_fft.launches, cf.long_range_sep.launches)
    y2 = fft(x2)
    torch.cuda.synchronize()
    if cf.tile_fft.launches <= before[0] or \
            cf.long_range_sep.launches <= before[1]:
        raise AssertionError("config 2 did not launch both kernels")
    ref2 = torch.fft.fft(x2.to(torch.complex128))
    e2, m2 = rel_l2(y2, ref2), max_abs(y2, ref2)
    log(f"# phase 4 config 2 fft N=2^20 plan={pl2.variant} "
        f"{pl2.params}: rel L2 {e2:.3e} (budget {PATH_TOL}), max abs "
        f"{m2:.3e} (BASELINE bound {MAX_ABS_TOL}), finite "
        f"{bool(torch.isfinite(y2).all())}")
    if not (e2 <= PATH_TOL and m2 < MAX_ABS_TOL
            and y2.shape == (n2,) and torch.isfinite(y2).all()):
        raise AssertionError("config 2 out of tolerance")

    # phase 5: config 3 — 4096 rows of 4096 points through the rows plan
    x3r, x3i = random_complex(rng, (4096, 4096), dev)
    pl3 = plans.plan_for((4096, 4096), device=dev)
    if pl3.variant != "rows":
        raise AssertionError(f"(4096, 4096) planned {pl3.variant}")
    before = cf.tile_fft.launches
    y3r, y3i = fft_planes_fast(x3r, x3i)
    torch.cuda.synchronize()
    if cf.tile_fft.launches <= before:
        raise AssertionError("config 3 did not launch tile_fft")
    y3 = torch.complex(y3r, y3i)
    ref3 = torch.fft.fft(torch.complex(x3r, x3i).to(torch.complex128))
    e3, m3 = rel_l2(y3, ref3), max_abs(y3, ref3)
    log(f"# phase 5 config 3 fft_planes_fast (4096,4096) "
        f"plan={pl3.variant}: rel L2 {e3:.3e}, max abs {m3:.3e}, finite "
        f"{bool(torch.isfinite(y3).all())}")
    if not (e3 <= PATH_TOL and m3 < MAX_ABS_TOL
            and torch.isfinite(y3).all()):
        raise AssertionError("config 3 out of tolerance")
    del x3r, x3i, y3r, y3i, y3, ref3

    # phase 6: the paper's path — funnel + tube on the kernels, n=2^20
    x = make_input(n2, SEED)
    ref = np.fft.fft(x.astype(np.complex128))
    backend = get_backend("cuda")
    outs = {}
    log("n\tp\ttotal_ms\tfunnel_ms\ttube_ms")
    for p in (1, 4, 16):
        before = (cf.tile_fft.launches, cf.long_range_sep.launches)
        res = backend.run(x, p, reps=5)
        if cf.tile_fft.launches <= before[0] or \
                cf.long_range_sep.launches <= before[1]:
            raise AssertionError(f"cuda backend p={p} missed a kernel")
        err = verify.rel_err(verify.pi_layout_to_natural(res.out), ref)
        if not err <= 1e-5:
            raise AssertionError(f"cuda backend p={p}: --verify rel err "
                                 f"{err:.3e} > 1e-5")
        outs[p] = res.out
        log(f"{n2}\t{p}\t{res.total_ms:.6f}\t{res.funnel_ms:.6f}\t"
            f"{res.tube_ms:.6f}\t# verify rel err {err:.3e}")
    for p in (4, 16):
        d = float(np.linalg.norm(outs[p].astype(np.complex128) - outs[1])
                  / np.linalg.norm(outs[1].astype(np.complex128)))
        log(f"# phase 6 p-invariance p={p} vs p=1: rel L2 {d:.3e}")
        # the funnel's dense table levels and the long-range kernel's
        # separable-factor twiddles round differently: float32 rounding
        if not d <= KERNEL_TOL:
            raise AssertionError(f"cuda backend not p-invariant at p={p}")
    if cli_main(["-n", str(n2), "-p", "4", "-b", "cuda", "--verify",
                 "-o"]) != 0:
        raise AssertionError("CLI run failed")
    launches = {"tile_fft": cf.tile_fft.launches,
                "long_range_sep": cf.long_range_sep.launches}
    log(f"# main path launches: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched: {launches}")

    # phase 7: times (CUDA events, median of REPS, L2 flushed)
    def timed(fn, *args):
        return time_ms(fn, *args, reps=REPS, warmup=3, flush_l2=True)[0]

    timings = {}

    def kernel_row(label, kernel, plain, args, nbytes, flops, fft_flops,
                   lib):
        # flops: the operations the kernel does (its bound); fft_flops:
        # the repo's 5 n log2 n convention for its levels (GFLOP/s)
        ms = timed(kernel, *args)
        plain_ms = timed(plain, *args)
        lib_ms = timed(*lib) if lib is not None else None
        bms, by = bound_ms(nbytes, flops)
        timings[label] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bytes": nbytes,
                          "bound_ms": bms, "bound_by": by,
                          "gflops": fft_flops / (ms * 1e-3) / 1e9}
        log(f"# phase 7 {label}: {ms:.4f} ms "
            f"({timings[label]['gflops']:.1f} GFLOP/s, plain "
            f"{plain_ms:.4f}, torch.fft "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'}, "
            f"bound {bms:.4f} by {by}, {nbytes} bytes)")

    for label, rows, tile in (("tile_fft(4096,4096)", 4096, 4096),
                              ("tile_fft(64,16384)", R, T)):
        a = cases[label]["args"]
        xc = torch.complex(a[0], a[1])
        flops = 5 * rows * tile * int(np.log2(tile))
        kernel_row(label, cf.tile_fft, cf.tile_fft_plain, a,
                   16 * rows * tile + 8 * (tile - 1), flops, flops,
                   (torch.fft.fft, xc))
    a = cases["long_range_sep(1,64,16384)"]["args"]
    lev = int(np.log2(R))
    kernel_row("long_range_sep(1,64,16384)",
               lambda *t: cf.long_range_sep(*t, cf.DEFAULT_CB),
               cf.long_range_sep_plain, a,
               16 * R * T + 8 * (R - 1 + lev * T), 8 * R * T * lev,
               5 * R * T * lev, None)

    paths = {}

    def path_row(label, fn, args, n, count, launches_per_call, lib,
                 plain=None):
        ms = timed(fn, *args)
        plain_ms = timed(plain, *args) if plain is not None else None
        lib_ms = timed(*lib)
        nbytes = 16 * n * count
        flops = 5 * n * int(np.log2(n)) * count
        bms, by = bound_ms(nbytes, flops)
        paths[label] = {"ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bms,
                        "bound_by": by, "bytes": nbytes,
                        "launches_per_call": launches_per_call,
                        "gflops": flops / (ms * 1e-3) / 1e9}
        log(f"# phase 7 path {label}: {ms:.4f} ms, "
            f"{paths[label]['gflops']:.1f} GFLOP/s (5 n log2 n), "
            f"{launches_per_call} launches, plain "
            f"{plain_ms if plain_ms is None else f'{plain_ms:.4f}'} ms, "
            f"torch.fft {lib_ms:.4f} ms, bound {bms:.4f} ms by {by}")

    def rql_plain(xr, xi):
        # the rql composition on the two kernels' plain versions
        yr, yi = cf.long_range_sep_plain(xr.reshape(1, R, T),
                                         xi.reshape(1, R, T), *fac)
        return cf.tile_fft_plain(yr.reshape(R, T), yi.reshape(R, T),
                                 twr14, twi14)

    x2r, x2i = x2.real.contiguous(), x2.imag.contiguous()
    path_row("rql pi N=2^20", cf.fft_pi_layout_cuda_rql, (x2r, x2i),
             n2, 1, 2, (torch.fft.fft, x2), rql_plain)
    path_row("fft natural N=2^20 (plan rql + gather)", fft, (x2,),
             n2, 1, 2, (torch.fft.fft, x2))
    x3r, x3i = random_complex(rng, (4096, 4096), dev)
    x3 = torch.complex(x3r, x3i)
    path_row("rows pi (4096,4096)",
             lambda a, b: cf.fft_rows_cuda(a, b, natural=False),
             (x3r, x3i), 4096, 4096, 1, (torch.fft.fft, x3),
             lambda a, b: cf.tile_fft_plain(a, b, twr, twi))
    path_row("fft_planes_fast natural (4096,4096)", fft_planes_fast,
             (x3r, x3i), 4096, 4096, 1, (torch.fft.fft, x3))

    src = "cs87project_msolano2_tpu_torch/csrc/"
    ref_src = "cs87project_msolano2_tpu/ops/pallas_fft.py:"
    entries = []
    for name, label, source, replaces in (
            ("tile_fft", "tile_fft(4096,4096)", src + "tile_fft.cu",
             ref_src + "299"),
            ("long_range_sep", "long_range_sep(1,64,16384)",
             src + "long_range.cu", ref_src + "519")):
        t = timings[label]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": cases[label]["max_abs_err"],
            "rel_l2": cases[label]["rel_l2"], "shape": label,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    log(json.dumps({"timings": timings, "paths": paths, "card": card}))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
