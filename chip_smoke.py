#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cs87project_msolano2_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (nvcc, sm_90a), holds each kernel
against its plain PyTorch version at the main path's shapes, drives the
main path through the user entry points — BASELINE config 2 (one
N=2^20 complex64 fft, the ``rql`` plan), config 3 (4096 rows of 4096
points, the ``rows`` plan), the paper's funnel/tube ``cuda`` backend
at N=2^20, the large-n 1-D path (``fft`` at n = 2^22 and 2^24 on
the ``fourstep`` plan, 2^25 and 2^27 on ``sixstep``, one launch each)
and the tuned path (phase 8: the autotune race at N=2^20 over ``fused``,
``fused-alias``, ``rql``, ``two-kernel`` and ``fourstep``, the stored
winner serving ``fft``, a second process reading the store, and
``plan sweep`` measuring the fourstep and sixstep crossovers), the matmul
funnel (phase 9: ``Plan(key, "mf")`` at N=2^20 in pi and natural order
in every fp32-storage precision mode, on the tensor cores) and the
``gpu`` plan backend (phase 10: ``plan_for(..., backend="gpu")`` at
4096 x 4096 and 64 x 2^18 on ``gpu-rows``, 2^20 on ``gpu-stages``, a
race whose winner a second process reads back, and ``hw probe``) —
checks the results against a complex128 oracle, and times every kernel
and path with CUDA events.  Phase 3 also holds gpu_rows at every
row regime and cluster size (2..16 blocks) and fused at every phase-B
cluster width in both alias modes against their plain versions, and
phase 7 times both by blocking.  Phase 3 also sets the card's
persisting-L2 set-aside to 0, times rql at N=2^20, and times it again
after the first ``fused`` launch has raised that set-aside; the card's
own value is put back at exit.  Phases 1-7 run with
``PIFFT_PLAN_CACHE`` pointed at a fresh temporary directory, so no plan
stored on the machine changes their paths.  Phase 7 reads each kernel's
time twice: CUDA events around the call (the wrapper's host time
included, as a caller sees it) and the card's busy time per call from
``torch.profiler`` (``device_ms``, the kernels alone).  The last line of standard output is
``{"ok": true, "device": {...}}``; any failed phase raises and the
script exits non-zero without it.  It imports nothing of JAX.

Bounds and carry ceilings come from the port's ``utils/roofline.py``:
NVIDIA's data-sheet peaks for the card by name (3.35 TB/s of HBM
bandwidth, 67 TFLOP/s of float32 outside the tensor cores and 989
TFLOP/s of dense bf16 on them for the H100 SXM).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_TOL = 1e-6   # kernel vs plain version, rel L2: FMA contraction
PATH_TOL = 1e-5     # whole transform vs complex128, rel L2: split3 budget
MAX_ABS_TOL = 1e-5  # BASELINE's bound on max abs error
REPS = 30
#: reps of the plain versions at n = 2^27, a few hundred ms per call
PLAIN_REPS_2_27 = 5
SEED = 0
#: (log2 n, plan) of the large-n 1-D path
LARGE = ((22, "fourstep"), (24, "fourstep"), (25, "sixstep"),
         (27, "sixstep"))
#: plan lookups timed on the host clock in phase 7
LOOKUPS = 10000
#: log2 of the transform lengths phase 8's ``plan sweep`` races
SWEEP = (20, 22, 24, 25)
#: the matmul funnel's precision modes and each one's whole-path budget
#: against complex128 (ops/precision.py)
MF_BUDGETS = {"split3": 1e-5, "highest": 5e-6, "fp32": 5e-6,
              "default": 1e-2}
#: (rows, n) of phase 3's gpu_rows checks: 2^24 points each, the
#: configs' shapes 4096 x 4096 and 64 x 2^18 among them, and every
#: cluster size of the long rows (2, 4, 8, 16 blocks at 2^15 .. 2^18)
GPU_ROWS_CHECKS = ((1 << 20, 16), (4096, 4096), (1024, 1 << 14),
                   (512, 1 << 15), (256, 1 << 16), (128, 1 << 17),
                   (64, 1 << 18))
#: the fused kernel's phase-B cluster widths held against the plain
#: version in phase 3 and timed in phase 7 (with qb 1 and 2)
FUSED_CWS = (1, 2, 4, 8)
#: kernel launches of one call of each 1-D plan variant
VARIANT_LAUNCHES = {
    "fused": {"fused": 1}, "fused-alias": {"fused": 1},
    "rql": {"long_range_sep": 1, "tile_fft": 1},
    "two-kernel": {"long_range_dense": 1, "tile_fft": 1},
    "fourstep": {"fourstep": 1}, "sixstep": {"sixstep": 1}}


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


def random_complex(rng, shape, device, n=None):
    """Seeded uniform planes in +-1/sqrt(n); n defaults to the trailing
    axis (one transform per row)."""
    import torch

    amp = 1.0 / np.sqrt(n or shape[-1])
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
    # a fresh plan store: no plan stored on this machine may change the
    # static paths of phases 4-7, and phase 8 writes its winners here
    store = tempfile.mkdtemp(prefix="pifft-plans-")
    os.environ["PIFFT_PLAN_CACHE"] = store
    os.environ.pop("PIFFT_PLAN_AUTOTUNE", None)
    try:
        return run(store)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def run(store) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.backends.registry import get_backend
    from cs87project_msolano2_tpu_torch.cli import main as cli_main
    from cs87project_msolano2_tpu_torch.cli import make_input
    from cs87project_msolano2_tpu_torch.models.fft import (
        fft,
        fft_planes_fast,
        ifft,
    )
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.hw import lowering
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
        dense_long_range_tables,
        device_factors,
        device_funnel_b,
        device_funnel_factors,
        flat_tables,
    )
    from cs87project_msolano2_tpu_torch.plans.core import Plan
    from cs87project_msolano2_tpu_torch.utils import buildlib, roofline, verify
    from cs87project_msolano2_tpu_torch.utils.timing import FLUSH_BYTES, time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    kind = torch.cuda.get_device_name(0)

    def bound_ms(nbytes, flops, bf16_flops=0):
        return roofline.bound_ms(nbytes, flops, kind, bf16_flops)

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
        f"({len(buildlib.sources())} sources, "
        f"{len(buildlib.headers())} headers)")
    with open(buildlib.build_log_path()) as f:
        for line in f:
            if line.startswith("==") or "registers" in line \
                    or "spill" in line:
                log(f"# ptxas {line.strip()}")

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
    # the large-n path's kernels at its blocking: fourstep at n = 2^24,
    # sixstep at n = 2^27 (work items outnumber the persistent grid)
    t4, R4, cb4 = cf.fourstep_blocking(1 << 24)
    xr4, xi4 = random_complex(rng, (R4, t4), dev, R4 * t4)
    label4 = f"fourstep({R4},{t4})"
    check_kernel(label4, lambda *a: cf.fourstep(*a, cb=cb4), cf.fourstep_plain,
                 (xr4, xi4, *device_factors(R4, t4, dev), twr14, twi14))
    t6, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << 27)
    xr6, xi6 = random_complex(rng, (R1, R2, t6), dev, R1 * R2 * t6)
    label6 = f"sixstep({R1},{R2},{t6})"
    check_kernel(label6, lambda *a: cf.sixstep(*a, cb1=cb1, cb2=cb2),
                 cf.sixstep_plain,
                 (xr6, xi6, *device_factors(R1, R2 * t6, dev),
                  *device_factors(R2, t6, dev), twr14, twi14))
    log(f"# phase 3 blocking: fourstep R={R4} cb={cb4}; sixstep "
        f"R1={R1} R2={R2} cb1={cb1} cb2={cb2}")
    # the tuned path's kernels: the dense long-range pass and the
    # two-kernel composition at n = 2^20, fused in both alias modes at
    # n = 2^20, and the dense modes of fourstep and sixstep at n = 2^22
    dense = dense_long_range_tables(R, T, dev)
    check_kernel("long_range_dense(1,64,16384)",
                 lambda *a: cf.long_range_dense(*a, cf.DEFAULT_CB),
                 cf.long_range_dense_plain, (xr3, xi3, *dense))
    x2r, x2i = random_complex(rng, (R * T,), dev)

    def two_kernel_plain(xr, xi):
        yr, yi = cf.long_range_dense_plain(xr.reshape(1, R, T),
                                           xi.reshape(1, R, T), *dense)
        yr, yi = cf.tile_fft_plain(yr.reshape(R, T), yi.reshape(R, T),
                                   twr14, twi14)
        return yr.reshape(-1), yi.reshape(-1)

    check_kernel("fft_pi_layout_cuda2(2^20)", cf.fft_pi_layout_cuda2,
                 two_kernel_plain, (x2r, x2i))

    # the first fused launch raises the card's persisting-L2 set-aside
    # until process exit: rql at 2^20, read with no set-aside and after
    # that launch, L2 flushed (cold, as phase 7 times) and not (the
    # planes stay in L2 across reps, where a smaller usable L2 would
    # show).  The reading is the kernels' device time per call from
    # torch.profiler, which host launch gaps do not move.  The card's
    # own value is put back at exit, after the fused wrapper's restore
    # (atexit runs last what it registered first).
    from torch.profiler import ProfilerActivity, profile

    def rql_device_ms(flush):
        scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev) \
            if flush else None
        for _ in range(3):
            cf.fft_pi_layout_cuda_rql(x2r, x2i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                if scratch is not None:
                    scratch.fill_(1)
                cf.fft_pi_layout_cuda_rql(x2r, x2i)
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if "long_range" in ev.key or "tile_fft" in ev.key:
                dt = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if dt is None else dt
        if not us:
            raise AssertionError("the profiler saw no rql kernel")
        return us / 1e3 / REPS

    def rql_reading():
        reading = {"set_aside_bytes": cf.persisting_l2_set_aside(dev)}
        for flush in (True, False):
            reading[f"rql_device_ms_flush_{flush}"] = rql_device_ms(flush)
        return reading

    set_aside = {"at_start_bytes": cf.persisting_l2_set_aside(dev)}
    atexit.register(cf.set_persisting_l2_set_aside, dev,
                    set_aside["at_start_bytes"])
    cf.set_persisting_l2_set_aside(dev, 0)
    set_aside["before"] = rql_reading()
    tf, Rf, qbf, cwf = cf.fused_blocking(R * T)
    labelf = f"fused({Rf},{tf})"
    fused_args = (x2r.reshape(Rf, tf), x2i.reshape(Rf, tf),
                  *device_factors(Rf, tf, dev), twr14, twi14)
    check_kernel(labelf, cf.fused, cf.fused_plain, fused_args)
    check_kernel(f"fused-alias({Rf},{tf})",
                 lambda xr, xi, *a: cf.fused(xr.clone(), xi.clone(), *a,
                                             alias_io=True),
                 cf.fused_plain, fused_args)
    # every phase-B cluster width, in both alias modes
    for cw in FUSED_CWS:
        for alias in (False, True):
            check_kernel(f"fused({Rf},{tf}) cw={cw} alias={alias}",
                         lambda xr, xi, *a, cw=cw, al=alias: cf.fused(
                             xr.clone(), xi.clone(), *a, alias_io=al,
                             cw=cw),
                         cf.fused_plain, fused_args)
    set_aside["after"] = rql_reading()
    log(f"# phase 3 persisting-L2 set-aside at start "
        f"{set_aside['at_start_bytes']} bytes; set-aside and rql N=2^20 "
        f"device ms per call (profiler; flushed, warm L2) with it set to "
        f"0: {set_aside['before']}; "
        f"after the first fused launch: {set_aside['after']}")
    if set_aside["before"]["set_aside_bytes"] != 0 or \
            set_aside["after"]["set_aside_bytes"] < 8 * Rf * tf:
        raise AssertionError(f"fused left the set-aside at {set_aside}")
    t22, R22, cb22 = cf.fourstep_blocking(1 << 22)
    xr22, xi22 = random_complex(rng, (R22, t22), dev, R22 * t22)
    check_kernel(f"fourstep-dense({R22},{t22})",
                 lambda *a: cf.fourstep(*a, cb=cb22, separable=False),
                 lambda *a: cf.fourstep_plain(*a, separable=False),
                 (xr22, xi22, *dense_long_range_tables(R22, t22, dev),
                  twr14, twi14))
    _, s1, s2, _, _ = cf.sixstep_blocking(1 << 22)
    check_kernel(f"sixstep-dense({s1},{s2},{t22})",
                 lambda *a: cf.sixstep(*a, separable=False),
                 lambda *a: cf.sixstep_plain(*a, separable=False),
                 (xr22.reshape(s1, s2, t22), xi22.reshape(s1, s2, t22),
                  *dense_long_range_tables(s1, s2 * t22, dev),
                  *dense_long_range_tables(s2, t22, dev), twr14, twi14))
    log(f"# phase 3 blocking: fused R={Rf} qb={qbf} cw={cwf}; dense fourstep "
        f"R={R22} cb={cb22}; dense sixstep R1={s1} R2={s2}; fused carry "
        f"limit {cf.fused_carry_limit(dev)} bytes of persisting L2")
    # the matmul funnel at the mf path's shape (R = 128, n = 2^20) in each
    # tensor-core mode: the same bf16 planes and products as the plain
    # version, summed in another order
    Rm, Cm, cbm = cf.mf_blocking(R * T)
    xrm, xim = random_complex(rng, (Rm, Cm), dev, Rm * Cm)
    mf_args = (xrm, xim, *device_funnel_b(Rm, dev),
               *device_funnel_factors(Rm, Rm * Cm, dev))
    for mode in ("split3", "default", "highest"):
        check_kernel(f"matmul_funnel({Rm},{Cm}) {mode}",
                     lambda *a, m=mode: cf.matmul_funnel(*a, precision=m),
                     lambda *a, m=mode: cf.matmul_funnel_plain(
                         *a, precision=m), mf_args)
    # gpu_rows at every row regime: short rows many to a block, 2^14 in
    # one block, 2^15 .. 2^18 on clusters of 2 .. 16 blocks; automatic
    # blocks and 8 rows a block (or a cluster) where shared memory
    # holds them
    clusters = {n: cf.gpu_rows_max_clusters(dev, n)
                for _, n in GPU_ROWS_CHECKS if n > cf.GPU_ROWS_SEGMENT}
    log(f"# phase 3 gpu_rows clusters the card holds at once, by n: "
        f"{clusters}")
    for rows, n in GPU_ROWS_CHECKS:
        xg = random_complex(rng, (rows, n), dev)
        stack = lowering.device_twiddle_stack(n, dev)
        for br in (None, 8):
            try:
                cf.gpu_rows_blocking(rows, n, br)
            except ValueError:
                continue
            check_kernel(f"gpu_rows({rows},{n}) block_rows={br}",
                         lambda a, b, *t, br=br: cf.gpu_rows(
                             a, b, *t, block_rows=br),
                         cf.gpu_rows_plain, (*xg, *stack))
        del xg
    log(f"# phase 3 blocking: mf R={Rm} C={Cm} cb={cbm}; gpu_rows "
        f"automatic block_rows "
        f"{[cf.gpu_rows_blocking(r, n) for r, n in GPU_ROWS_CHECKS]}")

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

    # phase 6b: the large-n 1-D path, counted — fft in natural order on
    # the fourstep and sixstep plans, one launch of one kernel each
    def counts():
        return {"tile_fft": cf.tile_fft.launches,
                "long_range_sep": cf.long_range_sep.launches,
                "fourstep": cf.fourstep.launches,
                "sixstep": cf.sixstep.launches}

    def counts_all():
        return {k.__name__: k.launches for k in cf.KERNELS}

    cf.reset_launch_counts()
    large = {}
    for k, want in LARGE:
        n = 1 << k
        x = torch.complex(*random_complex(rng, (n,), dev))
        pl = plans.plan_for((n,), device=dev)
        if pl.variant != want:
            raise AssertionError(f"n=2^{k} planned {pl.variant}, not {want}")
        before = counts()
        y = fft(x)
        torch.cuda.synchronize()
        delta = {name: c - before[name] for name, c in counts().items()}
        expect = {name: int(name == want) for name in delta}
        if delta != expect:
            raise AssertionError(f"n=2^{k} fft launched {delta}, expected "
                                 f"{expect}")
        ref = torch.fft.fft(x.to(torch.complex128))
        e, m = rel_l2(y, ref), max_abs(y, ref)
        finite = bool(torch.isfinite(y).all())
        log(f"# phase 6b fft n=2^{k} plan={pl.variant} {pl.params}: rel L2 "
            f"{e:.3e} (budget {PATH_TOL}), max abs {m:.3e} (bound "
            f"{MAX_ABS_TOL}), finite {finite}, launches {delta}")
        if not (e <= PATH_TOL and m < MAX_ABS_TOL and y.shape == (n,)
                and finite):
            raise AssertionError(f"n=2^{k} fft out of tolerance")
        large[k] = {"plan": pl.variant, "rel_l2": e, "max_abs": m,
                    "x": x}
        del y, ref
    x24 = large[24]["x"]
    before = counts()
    back = ifft(fft(x24))
    torch.cuda.synchronize()
    e_rt = rel_l2(back, x24)
    log(f"# phase 6b ifft(fft(x)) n=2^24: rel L2 {e_rt:.3e}, fourstep "
        f"launches {cf.fourstep.launches - before['fourstep']}")
    if not (e_rt <= PATH_TOL
            and cf.fourstep.launches - before["fourstep"] == 2):
        raise AssertionError("ifft(fft(x)) at 2^24 failed")
    del back
    large_launches = counts()
    log(f"# large-n path launches: {large_launches}")
    if large_launches["fourstep"] < 1 or large_launches["sixstep"] < 1:
        raise AssertionError(f"a kernel never launched: {large_launches}")
    launches.update(fourstep=large_launches["fourstep"],
                    sixstep=large_launches["sixstep"])

    # phase 7: times (CUDA events, median of REPS, L2 flushed)
    def timed(fn, *args, before=None):
        return time_ms(fn, *args, reps=REPS, warmup=3, flush_l2=True,
                       before=before)[0]

    timings = {}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def device_ms(fn, *args):
        # the card's busy time per call from torch.profiler, L2 flushed
        # before each call (the flush's fill kernel is not counted): the
        # kernels alone, which the host's launch gaps do not move
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                flush.fill_(1)
                fn(*args)
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    "Fill" not in ev.key:
                dt = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if dt is None else dt
        return us / 1e3 / REPS if us else None

    def kernel_row(label, kernel, plain, args, nbytes, flops, fft_flops,
                   lib, plain_reps=REPS, bf16_flops=0):
        # flops: the fp32 operations the kernel does and bf16_flops its
        # tensor-core ones (its bound); fft_flops: the repo's 5 n log2 n
        # convention for its levels (GFLOP/s)
        ms = timed(kernel, *args)
        dev_ms = device_ms(kernel, *args)
        plain_ms = time_ms(plain, *args, reps=plain_reps, warmup=1,
                           flush_l2=True)[0]
        lib_ms = timed(*lib) if lib is not None else None
        bms, by = bound_ms(nbytes, flops, bf16_flops)
        timings[label] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                          "plain_reps": plain_reps,
                          "library_ms": lib_ms, "bytes": nbytes,
                          "bound_ms": bms, "bound_by": by,
                          "gflops": fft_flops / (ms * 1e-3) / 1e9}
        log(f"# phase 7 {label}: {ms:.4f} ms (device "
            f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms, "
            f"{timings[label]['gflops']:.1f} GFLOP/s, plain "
            f"{plain_ms:.4f}, library "
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

    def fac_bytes(rows, cols):
        # separable factors: A (rows - 1) and B (levels x cols), re + im
        return 8 * (rows - 1 + int(np.log2(rows)) * cols)

    # long_range_dense: 5 flop per element per level, the planes once
    # each way plus the (R - 1) x T dense tables
    kernel_row("long_range_dense(1,64,16384)",
               lambda *t: cf.long_range_dense(*t, cf.DEFAULT_CB),
               cf.long_range_dense_plain,
               cases["long_range_dense(1,64,16384)"]["args"],
               16 * R * T + 8 * (R - 1) * T, 5 * R * T * lev,
               5 * R * T * lev, None)
    # fused at 2^20: 8 flop per element per long-range level (6 of them
    # rebuilding the twiddle) and 5 per tile level; the planes once each
    # way plus factors and tables (the carry stays in L2)
    lev_f = int(np.log2(Rf))
    nf = Rf * tf
    xcf = torch.complex(x2r, x2i)
    kernel_row(labelf, cf.fused, cf.fused_plain, fused_args,
               16 * nf + fac_bytes(Rf, tf) + 8 * (tf - 1),
               nf * (8 * lev_f + 5 * int(np.log2(tf))),
               5 * nf * int(np.log2(nf)), (torch.fft.fft, xcf))
    # fused by phase-A block (qb) and phase-B cluster width (cw)
    fused_by = {}
    for qb in (1, 2):
        for cw in FUSED_CWS:
            run_f = (lambda *a, qb=qb, cw=cw: cf.fused(*a, qb=qb, cw=cw))
            fused_by[f"qb={qb} cw={cw}"] = {
                "ms": timed(run_f, *fused_args),
                "device_ms": device_ms(run_f, *fused_args)}
    timings["fused blocking"] = {"auto": {"qb": qbf, "cw": cwf},
                                 "ms": fused_by}
    log(f"# phase 7 fused({Rf},{tf}) by blocking (automatic qb={qbf} "
        f"cw={cwf}), CUDA events / device: "
        + ", ".join(f"{k}: {v['ms']:.4f} / {v['device_ms']:.4f} ms"
                    for k, v in fused_by.items()))

    # fourstep at 2^24 and sixstep at 2^27: each element passes 8 flop
    # per long-range level (6 of them rebuilding the twiddle) and 5 per
    # tile level; bytes are the planes once each way, factors, tables
    for label, rows, lib_tile, args, fn, plain, nbytes, lr_levels, reps in (
            (label4, [R4], t4, cases[label4]["args"],
             lambda *a: cf.fourstep(*a, cb=cb4), cf.fourstep_plain,
             16 * R4 * t4 + fac_bytes(R4, t4) + 8 * (t4 - 1),
             int(np.log2(R4)), REPS),
            (label6, [R1, R2], t6, cases[label6]["args"],
             lambda *a: cf.sixstep(*a, cb1=cb1, cb2=cb2), cf.sixstep_plain,
             16 * R1 * R2 * t6 + fac_bytes(R1, R2 * t6)
             + fac_bytes(R2, t6) + 8 * (t6 - 1),
             int(np.log2(R1 * R2)), PLAIN_REPS_2_27)):
        n = int(np.prod(rows)) * lib_tile
        xc = torch.complex(args[0], args[1]).reshape(n)
        kernel_row(label, fn, plain, args, nbytes,
                   n * (8 * lr_levels + 5 * int(np.log2(lib_tile))),
                   5 * n * int(np.log2(n)), (torch.fft.fft, xc), reps)
        del xc

    paths = {}

    def path_row(label, fn, args, n, count, launches_per_call, lib,
                 plain=None, variant=None, plain_reps=REPS, before=None):
        ms = timed(fn, *args, before=before)
        plain_ms = time_ms(plain, *args, reps=plain_reps, warmup=1,
                           flush_l2=True)[0] if plain is not None else None
        lib_ms = timed(*lib)
        nbytes = roofline.fft_min_hbm_bytes(n) * count
        flops = 5 * n * int(np.log2(n)) * count
        bms, by = bound_ms(nbytes, flops)
        ceiling = roofline.roofline_ceiling(
            roofline.plan_carry_passes(variant))
        paths[label] = {"ms": ms, "plain_ms": plain_ms,
                        "plain_reps": plain_reps if plain else None,
                        "library_ms": lib_ms, "bound_ms": bms,
                        "bound_by": by, "bytes": nbytes,
                        "launches_per_call": launches_per_call,
                        "carry_ceiling": ceiling,
                        "util": bms / ms,
                        "gflops": flops / (ms * 1e-3) / 1e9}
        log(f"# phase 7 path {label}: {ms:.4f} ms, "
            f"{paths[label]['gflops']:.1f} GFLOP/s (5 n log2 n), "
            f"{launches_per_call} launches, plain "
            f"{plain_ms if plain_ms is None else f'{plain_ms:.4f}'} ms, "
            f"torch.fft {lib_ms:.4f} ms, bound {bms:.4f} ms by {by}, "
            f"{bms / ms:.3f} of bound (carry ceiling {ceiling})")

    def rql_plain(xr, xi):
        # the rql composition on the two kernels' plain versions
        yr, yi = cf.long_range_sep_plain(xr.reshape(1, R, T),
                                         xi.reshape(1, R, T), *fac)
        return cf.tile_fft_plain(yr.reshape(R, T), yi.reshape(R, T),
                                 twr14, twi14)

    x2r, x2i = x2.real.contiguous(), x2.imag.contiguous()
    path_row("rql pi N=2^20", cf.fft_pi_layout_cuda_rql, (x2r, x2i),
             n2, 1, 2, (torch.fft.fft, x2), rql_plain, "rql")
    path_row("fft natural N=2^20 (plan rql + gather)", fft, (x2,),
             n2, 1, 2, (torch.fft.fft, x2), variant="rql")
    # the tuned path's candidates at N=2^20, pi layout, each through the
    # ladder's executor as the race times it (fused-alias writes over
    # its planes: each rep gets them back, untimed, as in the race)
    from cs87project_msolano2_tpu_torch.plans import ladder

    key_pi = plans.make_key(n2, layout="pi", device=dev)
    for variant, params, launches_per_call, plain in (
            ("fused", {"tile": T, "qb": qbf, "cw": cwf}, 1,
             lambda a, b: cf.fused_plain(a.reshape(R, T), b.reshape(R, T),
                                         *fac, twr14, twi14)),
            ("fused-alias", {"tile": T, "qb": qbf, "cw": cwf}, 1, None),
            ("two-kernel", {"tile": T, "cb": cf.DEFAULT_CB}, 2,
             two_kernel_plain)):
        run = ladder.build_executor(key_pi, variant, params)
        args, before = (x2r, x2i), None
        if run.consumes_input:
            args = (x2r.clone(), x2i.clone())

            def before(a=args):
                a[0].copy_(x2r)
                a[1].copy_(x2i)
        path_row(f"{variant} pi N=2^20 {params}", run, args, n2, 1,
                 launches_per_call, (torch.fft.fft, x2), plain, variant,
                 before=before)

    # the plan lookup every fft call makes, on the host clock
    t0 = time.perf_counter()
    for _ in range(LOOKUPS):
        plans.plan_for((n2,), device=dev)
    lookup_us = (time.perf_counter() - t0) / LOOKUPS * 1e6
    log(f"# phase 7 plan_for((2^20,)) lookup: {lookup_us:.3f} us per call "
        f"(host clock, {LOOKUPS} calls)")
    x3r, x3i = random_complex(rng, (4096, 4096), dev)
    x3 = torch.complex(x3r, x3i)
    path_row("rows pi (4096,4096)",
             lambda a, b: cf.fft_rows_cuda(a, b, natural=False),
             (x3r, x3i), 4096, 4096, 1, (torch.fft.fft, x3),
             lambda a, b: cf.tile_fft_plain(a, b, twr, twi), "rows")
    path_row("fft_planes_fast natural (4096,4096)", fft_planes_fast,
             (x3r, x3i), 4096, 4096, 1, (torch.fft.fft, x3), variant="rows")
    del x3r, x3i, x3

    def large_plain(variant):
        # the fourstep/sixstep composition on the kernels' plain versions
        def run(xr, xi):
            n = xr.shape[0]
            if variant == "fourstep":
                tile, R_, _ = cf.fourstep_blocking(n)
                return cf.fourstep_plain(
                    xr.reshape(R_, tile), xi.reshape(R_, tile),
                    *device_factors(R_, tile, dev), *flat_tables(tile, dev))
            tile, r1, r2, _, _ = cf.sixstep_blocking(n)
            return cf.sixstep_plain(
                xr.reshape(r1, r2, tile), xi.reshape(r1, r2, tile),
                *device_factors(r1, r2 * tile, dev),
                *device_factors(r2, tile, dev), *flat_tables(tile, dev))
        return run

    for k, variant in LARGE:
        n = 1 << k
        xl = large[k]["x"]
        xlr, xli = xl.real.contiguous(), xl.imag.contiguous()
        compose = (cf.fft_pi_layout_cuda_fourstep if variant == "fourstep"
                   else cf.fft_pi_layout_cuda_sixstep)
        path_row(f"{variant} pi N=2^{k}", compose, (xlr, xli), n, 1, 1,
                 (torch.fft.fft, xl), large_plain(variant), variant,
                 PLAIN_REPS_2_27 if k == 27 else REPS)
        path_row(f"fft natural N=2^{k} (plan {variant} + gather)", fft,
                 (xl,), n, 1, 1, (torch.fft.fft, xl), variant=variant)
        del xl, xlr, xli

    # the matmul funnel alone in each mode, beside the nearest library
    # pair: torch.matmul of the complex64 DFT matrix and X, times the
    # dense complex64 twiddle grid.  Bytes: the planes once each way, B,
    # A and B2; operations: 8 R bf16 flop per element per pass on the
    # tensor cores, 14 fp32 flop per element in the epilogue
    from cs87project_msolano2_tpu_torch.ops.precision import dot_passes

    nm = Rm * Cm
    bm = torch.complex(*mf_args[2:4]).to(torch.complex64)
    fa = [a.double() for a in mf_args[4:]]
    tm = (torch.complex(fa[0], fa[1]).reshape(Rm, -1, 1)
          * torch.complex(fa[2], fa[3]).reshape(Rm, 1, 128)) \
        .reshape(Rm, Cm).to(torch.complex64)
    xm = torch.complex(xrm, xim)
    mf_bytes = 16 * nm + 8 * (Rm * Rm + Rm * (Cm // 128) + Rm * 128)
    for mode in ("split3", "default", "highest"):
        label = f"matmul_funnel({Rm},{Cm}) {mode}"
        kernel_row(label,
                   lambda *a, m=mode: cf.matmul_funnel(*a, precision=m),
                   lambda *a, m=mode: cf.matmul_funnel_plain(*a,
                                                             precision=m),
                   mf_args, mf_bytes, 14 * nm, 5 * nm * int(np.log2(Rm)),
                   (lambda b, x, t: torch.matmul(b, x) * t, bm, xm, tm),
                   bf16_flops=dot_passes(mode) * 8 * Rm * nm)
    del bm, tm, xm

    def mf_plain(xr, xi, mode="split3"):
        # the mf composition on the two kernels' plain versions
        yr, yi = cf.matmul_funnel_plain(xr.reshape(Rm, Cm),
                                        xi.reshape(Rm, Cm), *mf_args[2:],
                                        precision=mode)
        return cf.tile_fft_plain(yr, yi, *flat_tables(Cm, dev))

    for mode in ("split3", "highest"):
        path_row(f"mf pi N=2^20 {mode}",
                 lambda a, b, m=mode: cf.fft_pi_layout_cuda_mf(
                     a, b, precision=m), (x2r, x2i), n2, 1, 2,
                 (torch.fft.fft, x2),
                 lambda a, b, m=mode: mf_plain(a, b, m), "mf")
    mf_nat = Plan(plans.make_key(n2, device=dev), "mf", {"R": Rm})
    path_row("fft natural N=2^20 (Plan mf split3 + gather)",
             lambda x: fft(x, plan=mf_nat), (x2,), n2, 1, 2,
             (torch.fft.fft, x2), variant="mf")

    # gpu_rows at the gpu backend's two shapes, beside the cuda family's
    # rows kernel (4096 x 4096) and torch.fft.fft on the same rows; bytes
    # count the stack's n - 1 distinct entries once (row s of the
    # zero-padded stack is read only below (n >> s) / 2)
    for rows, n in ((4096, 4096), (64, 1 << 18)):
        label = f"gpu_rows({rows},{n}) block_rows=None"
        a = cases[label]["args"]
        xc = torch.complex(a[0], a[1])
        flops = 5 * rows * n * int(np.log2(n))
        kernel_row(label, cf.gpu_rows, cf.gpu_rows_plain, a,
                   16 * rows * n + 8 * (n - 1), flops,
                   flops, (torch.fft.fft, xc))
        if n <= cf.MAX_ROW_TILE:
            timings[label]["rows_ms"] = timed(
                lambda p, q: cf.fft_rows_cuda(p, q, natural=False),
                a[0], a[1])
            log(f"# phase 7 {label}: the cuda family's rows (tile_fft) on "
                f"the same rows {timings[label]['rows_ms']:.4f} ms")
        del xc

    # gpu_rows' automatic blocking (block_rows None) against 1 row a
    # block, a block of 1024 threads and the most rows a block's shared
    # memory holds, at 2^20 rows of 16 points and at 4096 x 4096
    blocking = {}
    for rows, n in ((1 << 20, 16), (4096, 4096)):
        a = cases[f"gpu_rows({rows},{n}) block_rows=None"]["args"]
        row = {}
        for br in sorted({1, cf.gpu_rows_blocking(rows, n),
                          min(2048 // n, rows) or 1,
                          cf.MAX_SMEM_TILE // n}):
            run_g = (lambda *t, br=br: cf.gpu_rows(*t, block_rows=br))
            row[br] = {"ms": timed(run_g, *a),
                       "device_ms": device_ms(run_g, *a)}
        blocking[f"{rows}x{n}"] = {"auto": cf.gpu_rows_blocking(rows, n),
                                   "ms_by_block_rows": row}
        log(f"# phase 7 gpu_rows({rows},{n}) by block_rows (automatic "
            f"{cf.gpu_rows_blocking(rows, n)}), CUDA events / device: "
            + ", ".join(f"{br}: {v['ms']:.4f} / {v['device_ms']:.4f} ms"
                        for br, v in row.items()))
    timings["gpu_rows blocking"] = blocking

    # phase 7b: device time of one natural-order large-n fft by kernel,
    # from torch.profiler, and the card's idle share of that call
    profiles = {}
    for k, variant in LARGE:
        xl = large[k].pop("x")
        fft(xl)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fft(xl)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            by_kernel[ev.key[:60]] = by_kernel.get(ev.key[:60], 0) + us / 1e3
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
        profiles[f"2^{k}"] = {"wall_ms": wall_ms, "device_ms": busy,
                              "idle_share": (1 - busy / wall_ms) if busy
                              else None, "kernels_ms": dict(top)}
        log(f"# phase 7b fft natural N=2^{k} ({variant}): device "
            f"{busy:.4f} ms of {wall_ms:.4f} ms wall (profiled), "
            + (f"idle share {1 - busy / wall_ms:.3f}; " if busy else
               "no device time seen: not measured; ")
            + "; ".join(f"{name} {ms:.4f}" for name, ms in top))
        del xl

    # phase 8: the tuned path, counted — the race at N=2^20 (pi layout),
    # the opted-in race of the natural-order key that fft's plan lookup
    # runs on a miss, then fft served by the stored winner
    n8 = 1 << 20
    cf.reset_launch_counts()
    tuned_pi = plans.tune(plans.make_key(n8, layout="pi", device=dev),
                          force=True)
    race = {r.variant + " " + json.dumps(r.params, sort_keys=True):
            {"status": r.status, "ms": r.ms, "reason": r.reason}
            for r in tuned_pi.tuning}
    for r in tuned_pi.tuning:
        log(f"# phase 8 race N=2^20 pi: {r.variant} {r.params}: "
            f"{r.status}" + (f" {r.ms:.4f} ms" if r.ms is not None else "")
            + (f" ({r.reason})" if r.status == "rejected" else ""))
    for variant in ("fused", "fused-alias", "two-kernel"):
        if not any(r.variant == variant and r.status in ("won", "lost")
                   for r in tuned_pi.tuning):
            raise AssertionError(f"the race did not time {variant}")
    os.environ["PIFFT_PLAN_AUTOTUNE"] = "1"
    try:
        tuned_nat = plans.plan_for((n8,), device=dev)
    finally:
        del os.environ["PIFFT_PLAN_AUTOTUNE"]
    if tuned_nat.source != "tuned":
        raise AssertionError(f"opted-in plan_for gave a {tuned_nat.source} "
                             f"plan, not a tuned one")
    log(f"# phase 8 winners N=2^20: pi {tuned_pi.variant} "
        f"{tuned_pi.params} ({tuned_pi.ms:.4f} ms); natural "
        f"{tuned_nat.variant} {tuned_nat.params} ({tuned_nat.ms:.4f} ms)")
    x8 = torch.complex(*random_complex(rng, (n8,), dev))
    before = counts_all()
    y8 = fft(x8)
    torch.cuda.synchronize()
    delta8 = {k: c - before[k] for k, c in counts_all().items()}
    want8 = {k: VARIANT_LAUNCHES[tuned_nat.variant].get(k, 0)
             for k in delta8}
    if delta8 != want8 or plans.plan_for((n8,), device=dev) is not tuned_nat:
        raise AssertionError(f"the tuned fft launched {delta8}, expected "
                             f"{want8} for {tuned_nat.variant}")
    ref8 = torch.fft.fft(x8.to(torch.complex128))
    e8, m8 = rel_l2(y8, ref8), max_abs(y8, ref8)
    log(f"# phase 8 tuned fft N=2^20 plan={tuned_nat.variant} "
        f"{tuned_nat.params} [{tuned_nat.source}]: rel L2 {e8:.3e} (budget "
        f"{PATH_TOL}), max abs {m8:.3e} (bound {MAX_ABS_TOL}), launches "
        f"{delta8}")
    if not (e8 <= PATH_TOL and m8 < MAX_ABS_TOL and y8.shape == (n8,)
            and torch.isfinite(y8).all()):
        raise AssertionError("the tuned fft is out of tolerance")
    tuned_launches = counts_all()
    log(f"# tuned path launches (race, opted-in race, fft): "
        f"{tuned_launches}")
    for name in ("fused", "long_range_dense"):
        if tuned_launches[name] < 1:
            raise AssertionError(f"the tuned path never launched {name}")
    launches.update(fused=tuned_launches["fused"],
                    long_range_dense=tuned_launches["long_range_dense"])

    # a second process finds both winners on disk
    shown = subprocess.run(
        [sys.executable, "-m", "cs87project_msolano2_tpu_torch", "plan",
         "show"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ), cwd=os.path.dirname(os.path.abspath(__file__)))
    log("\n".join(f"# phase 8 plan show: {line}"
                   for line in shown.stdout.splitlines()))
    for pl in (tuned_pi, tuned_nat):
        if shown.returncode != 0 or not any(
                f"n={n8} " in line and f" {pl.key.layout} " in line
                and f": {pl.variant} " in line
                for line in shown.stdout.splitlines()):
            raise AssertionError(f"plan show in a second process did not "
                                 f"list the {pl.key.layout} winner: "
                                 f"{shown.stderr[-2000:]}")

    # the sweep: races at each n, the crossovers this card measures
    cf.reset_launch_counts()
    if cli_main(["plan", "sweep", "--ns", *(f"2^{k}" for k in SWEEP)]) != 0:
        raise AssertionError("plan sweep failed")
    sweep_launches = counts_all()
    swept, cross4 = plans.tune_sweep([1 << k for k in SWEEP], verbose=False)
    cross6 = plans.sixstep_crossover(swept)
    sweep = {p.key.n: {"variant": p.variant, "params": p.params,
                       "ms": p.ms,
                       "race": [r.to_record() for r in p.tuning]}
             for p in swept}
    log(f"# phase 8 sweep: fourstep crossover {cross4}, sixstep crossover "
        f"{cross6} (the static ladder's, from the TPU: 2^21 and 2^25); "
        f"launches {sweep_launches}")
    if sweep_launches["sixstep"] < 1 or sweep_launches["fourstep"] < 1:
        raise AssertionError(f"the sweep raced no carry kernel: "
                             f"{sweep_launches}")

    # phase 9: the matmul funnel, counted — fft through Plan(key, "mf")
    # at N=2^20 in pi and natural order, in every fp32-storage mode, each
    # call one launch of matmul_funnel and one of tile_fft
    cf.reset_launch_counts()
    x9 = torch.complex(*random_complex(rng, (n2,), dev))
    ref9 = torch.fft.fft(x9.to(torch.complex128))
    ref9_pi = ref9[torch.from_numpy(verify.bit_reverse_indices(n2))
                   .to(dev)]
    mf_path = {}
    for mode, budget in MF_BUDGETS.items():
        for layout in ("pi", "natural"):
            pl9 = Plan(plans.make_key(n2, layout=layout, precision=mode,
                                      device=dev), "mf", {"R": 128})
            before = counts_all()
            if layout == "natural":
                y9 = fft(x9, plan=pl9)
                ref = ref9
            else:
                y9 = torch.complex(*pl9.execute(x9.real.contiguous(),
                                                x9.imag.contiguous()))
                ref = ref9_pi
            torch.cuda.synchronize()
            delta = {k: c - before[k] for k, c in counts_all().items()
                     if c != before[k]}
            e, m = rel_l2(y9, ref), max_abs(y9, ref)
            finite = bool(torch.isfinite(y9).all())
            mf_path[f"{mode} {layout}"] = {"rel_l2": e, "max_abs": m,
                                           "launches": delta}
            log(f"# phase 9 mf N=2^20 {layout} {mode}: rel L2 {e:.3e} "
                f"(budget {budget}), max abs {m:.3e}, finite {finite}, "
                f"launches {delta}")
            if not (e <= budget and finite and y9.shape == (n2,)
                    and delta == {"matmul_funnel": 1, "tile_fft": 1}):
                raise AssertionError(f"mf {layout} {mode} failed")
    del x9, ref9, ref9_pi, y9
    mf_launches = counts_all()
    log(f"# mf path launches: {mf_launches}")
    launches.update(matmul_funnel=mf_launches["matmul_funnel"])

    # phase 10: the gpu backend, counted — plan_for(..., backend="gpu")
    # at config 3 and at 64 rows of 2^18 (gpu-rows), 2^20 (gpu-stages),
    # the refused pi-layout 2^20 key, then a race of the 4096 x 4096 key
    # whose winner a second process reads back with `hw probe --json`
    cf.reset_launch_counts()
    gpu_backend = {}
    for shape, want in (((4096, 4096), "gpu-rows"),
                        ((64, 1 << 18), "gpu-rows"),
                        ((1 << 20,), "gpu-stages")):
        pl10 = plans.plan_for(shape, device=dev, backend="gpu")
        xgr, xgi = random_complex(rng, shape, dev)
        before = counts_all()
        ygr, ygi = fft_planes_fast(xgr, xgi, plan=pl10)
        torch.cuda.synchronize()
        delta = {k: c - before[k] for k, c in counts_all().items()
                 if c != before[k]}
        yg = torch.complex(ygr, ygi)
        ref = torch.fft.fft(torch.complex(xgr, xgi).to(torch.complex128))
        e, m = rel_l2(yg, ref), max_abs(yg, ref)
        finite = bool(torch.isfinite(yg).all())
        gpu_backend[str(shape)] = {"variant": pl10.variant,
                                   "params": pl10.params, "rel_l2": e,
                                   "max_abs": m, "launches": delta}
        log(f"# phase 10 gpu backend {shape}: plan {pl10.variant} "
            f"{pl10.params}, rel L2 {e:.3e} (budget {PATH_TOL}), max abs "
            f"{m:.3e}, finite {finite}, launches {delta}")
        want_launches = {"gpu_rows": 1} if want == "gpu-rows" else {}
        if not (pl10.variant == want and pl10.key.backend == "gpu"
                and e <= PATH_TOL and finite and delta == want_launches):
            raise AssertionError(f"gpu backend {shape} failed")
        del xgr, xgi, ygr, ygi, yg, ref
    try:
        plans.plan_for((n2,), layout="pi", device=dev, backend="gpu")
    except ValueError as err:
        log(f"# phase 10 gpu backend pi N=2^20 refused: {err}")
    else:
        raise AssertionError("the pi-layout 2^20 gpu key was served")
    gpu_launches = counts_all()
    log(f"# gpu backend launches (plans): {gpu_launches}")
    if gpu_launches["gpu_rows"] < 1:
        raise AssertionError("the gpu backend never launched gpu_rows")
    launches.update(gpu_rows=gpu_launches["gpu_rows"])
    cf.reset_launch_counts()
    key_gpu = plans.make_key(4096, (4096,), device=dev, backend="gpu")
    key_cuda = plans.make_key(4096, (4096,), device=dev)
    tuned_gpu = plans.tune(key_gpu, force=True)
    tuned_cuda = plans.tune(key_cuda, force=True)
    for r in tuned_gpu.tuning:
        log(f"# phase 10 race (4096,4096) gpu: {r.variant} {r.params}: "
            f"{r.status}" + (f" {r.ms:.4f} ms" if r.ms is not None else "")
            + (f" ({r.reason[:120]})" if r.status == "rejected" else ""))
    if key_gpu.token() == key_cuda.token() or \
            tuned_cuda.variant != "rows":
        raise AssertionError("the gpu and cuda keys share a winner")
    probe_code = (
        "from cs87project_msolano2_tpu_torch.cli import main\n"
        "main(['plan', 'show', '--backend', 'gpu'])\n"
        "print('--- hw probe')\n"
        "main(['hw', 'probe', '--json'])\n")
    second = subprocess.run(
        [sys.executable, "-c", probe_code], capture_output=True, text=True,
        timeout=300, env=dict(os.environ),
        cwd=os.path.dirname(os.path.abspath(__file__)))
    shown, _, probed = second.stdout.partition("--- hw probe\n")
    log("\n".join(f"# phase 10 plan show --backend gpu: {line}"
                   for line in shown.splitlines()))
    if second.returncode != 0 or not any(
            "n=4096 " in line and "backend=gpu" in line
            and f": {tuned_gpu.variant} " in line
            for line in shown.splitlines()):
        raise AssertionError(f"a second process did not read the gpu "
                             f"winner back: {second.stderr[-2000:]}")
    hw = json.loads(probed)
    log(f"# phase 10 hw probe --json: {json.dumps(hw, sort_keys=True)}")
    if hw["platform"] != "cuda" or hw["device_kind"] != kind or \
            not hw["sm_count"] or not hw["l2_bytes"]:
        raise AssertionError(f"hw probe on the card: {hw}")
    race_launches = counts_all()
    log(f"# gpu backend race launches (not counted in the kernels "
        f"line): {race_launches}")
    gpu_backend["race"] = {"winner": tuned_gpu.describe(),
                           "cuda_winner": tuned_cuda.describe(),
                           "launches": race_launches,
                           "entries": [r.to_record()
                                       for r in tuned_gpu.tuning]}

    src = "cs87project_msolano2_tpu_torch/csrc/"
    ref_src = "cs87project_msolano2_tpu/ops/pallas_fft.py:"
    entries = []
    log(f"# phase 7 gpu_rows(64,{1 << 18}) block_rows=None (the second "
        f"gpu_rows shape): "
        f"{timings[f'gpu_rows(64,{1 << 18}) block_rows=None']}")
    for name, label, source, replaces in (
            ("tile_fft", "tile_fft(4096,4096)", src + "tile_fft.cu",
             ref_src + "299"),
            ("long_range_sep", "long_range_sep(1,64,16384)",
             src + "long_range.cu", ref_src + "519"),
            ("long_range_dense", "long_range_dense(1,64,16384)",
             src + "long_range.cu", ref_src + "483"),
            ("fourstep", label4, src + "fourstep.cu", ref_src + "1046"),
            ("sixstep", label6, src + "sixstep.cu", ref_src + "1354"),
            ("fused", labelf, src + "fused.cu", ref_src + "832"),
            ("matmul_funnel", f"matmul_funnel({Rm},{Cm}) split3",
             src + "mf.cu", ref_src + "1915"),
            ("gpu_rows", "gpu_rows(4096,4096) block_rows=None",
             src + "gpu_rows.cu",
             "cs87project_msolano2_tpu/hw/lowering.py:82")):
        t = timings[label]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": cases[label]["max_abs_err"],
            "rel_l2": cases[label]["rel_l2"], "shape": label,
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    checks = {label: {"rel_l2": c["rel_l2"], "max_abs_err": c["max_abs_err"]}
              for label, c in cases.items()}
    log(json.dumps({"timings": timings, "paths": paths, "card": card,
                    "large_n": large, "profiles": profiles,
                    "set_aside": set_aside, "lookup_us": lookup_us,
                    "kernel_checks": checks, "mf_path": mf_path,
                    "gpu_backend": gpu_backend, "hw_probe": hw,
                    "tuned": {"race_2^20_pi": race,
                              "winner_pi": tuned_pi.describe(),
                              "winner_natural": tuned_nat.describe(),
                              "fft": {"rel_l2": e8, "max_abs": m8,
                                      "launches": delta8},
                              "sweep": sweep, "fourstep_crossover": cross4,
                              "sixstep_crossover": cross6}}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
