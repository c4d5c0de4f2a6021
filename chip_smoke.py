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
race whose winner a second process reads back, and ``hw probe``) and
the bf16 storage mode (phase 11: ``precision="bf16"`` through the plan
layer in natural and pi order at config 2 on ``rql``, config 3 on
``rows``, 2^24 on ``fourstep``, 2^27 on ``sixstep``, and 2^20 through
``Plan(key, "fused")``, ``"fused-alias"`` and ``"two-kernel"``, each
kernel's bf16 device time beside its float32 one, and the precision
race at 2^20 with its bf16 and split3 entries, none of them rejected)
and the real and any-length domains (phase 12: ``rfft``/``irfft`` at
n = 2^21, on 4096 x 4096 real rows and at 2^25, riding the c2c plans
at n/2 (rql, rows, fourstep); ``fft``/``ifft`` at the prime 1048573
(rader, padded to 2^21 on fourstep), at 3^13 (bluestein, padded to
2^22) and at 5 * 2^16 in a batch of 16 (mixedradix over rows of 2^16);
``rfft`` at n = 1000; each case's plan, Hopper launches a call with
torch.fft and numpy.fft refused during the counted calls, accuracy
against numpy in complex128 forward and round trip, and its time
beside torch.fft's and, for r2c, its c2c twin's) — checks the results
against a complex128 oracle, and times every kernel and path: phase 7
by the loop slope (``utils.timing.loop_slope_ms``, k calls in one CUDA
graph over copies of the operands the L2 cannot serve), the
CUDA-event median of 30 calls with the L2 flushed beside it.  Phase 3 holds the bf16 instantiations of
tile_fft, long_range_sep, long_range_dense (on the float32 check's 13
long-range shapes), fourstep, sixstep and fused (2^20 at every cluster
width, qb 1 and 2, both alias modes, and R = 2; the persisting-L2
set-aside read before and after its first launch) against their plain
bf16 versions at the main path's shapes (rel L2 <= 1e-3: both round at
the same points).  Phase 3 also holds gpu_rows at every
row regime and cluster size (2..16 blocks), fused at every phase-B
cluster width in both alias modes, tile_fft at every tile (2..2^14) and
at every cluster width of the rql and mf row passes, long_range_sep
and long_range_dense across R (2 .. 8192) and cb (2 .. 32) with batches
above 1, the matmul funnel in each tensor-core mode on its persistent
grid (wgmma, B's bf16 planes cut once per card), fourstep at
every automatic blocking from n = 2^21 to 2^25 and at the race's half
tile (2^13) from 2^21 to 2^24, and sixstep at n = 2^25 and 2^27, both in
both twiddle modes, against their plain versions
(with fourstep's persistent grid as the occupancy API gives it), and
phase 7 times gpu_rows and fused by blocking.  The race of phase 8
times each candidate by the loop slope over a CUDA graph
(``utils.timing.loop_slope_ms``); the phase prints each entry's slope
time beside its CUDA-event time.  Phase 3 also sets the card's
persisting-L2 set-aside to 0, times rql at N=2^20, and times it again
after the first ``fused`` launch has raised that set-aside; the card's
own value is put back at exit.  The whole script runs with
``PIFFT_PLAN_CACHE`` pointed at a fresh temporary directory, so no plan
stored on the machine changes the static paths.  Phase 7 reads each
kernel's time three ways: the loop slope (device time per call, the
``ms`` of the kernels line), CUDA events around the call (the wrapper's
host time included, as a caller sees it) and the card's time per call
from ``torch.profiler`` (``device_ms``, the kernels alone: each
kernel's mean time a launch times its launches in one call).  After
phase 12 it checks that no plan of phases 4-12 demoted (the demotion
counter empty, no memoized plan ``degraded``), then drives the
resilience layer (phase 13, no CUDA graph in any case: one injected
capacity fault at the ``tube`` site takes the 2^24 fourstep plan to
``rql`` and the 2^25 sixstep plan to ``fourstep``, each within 1e-5 of
numpy, the counter showing the rung's kernels and not the dead one's; a
transient fault at ``plan`` retried by ``call_with_retry``, not
demoted; ``promote_precision`` moving a bf16 plan at 2^20 to
``default``; the bench's chaos run, ``PIFFT_FAULT=tube:capacity:1.0:1``
``bench --smoke`` in a subprocess, exit 0, degraded, the flagship on
``rql``: on the card the chain ends at rql and never serves a library
call) and the measurement entries (phase 14: ``bench.main([])`` at full
size on phase 8's plan store, each key the store lacks raced first as
the reference races the keys its cache lacks, its record printed on its
own line, every
row present and none degraded, the 2^26 rows' plans checked once
against torch.fft in complex128; then the harness's (n, p) sweep on the
``cuda`` backend over n in {2^16, 2^20, 2^24} and p in {1, 4, 16, 64,
256}, 3 reps, and its verify pass, the TSV printed, no row DEGRADED;
the record's ``c_ms``, ``vs_baseline`` and ``cpun2^K`` rows present
and positive) and the rest of the algorithm and its backends (phase
15: ``tube_planned`` on the plan store phases 8 and 14 wrote, as the
sharded path runs it — each processor's ``funnel_single`` chain then
its 1-D segment at n = 2^27, p = 2 (sixstep) and p = 8 (the store's
winner at 2^24, else fourstep); the funnel's (p, s) planes at n = 2^20,
p = 64 (rows) and n = 2^24, p = 4 (the stage tube) — each case's
variant, its launches counted with torch.fft and numpy.fft refused,
its result against torch.fft in complex128 and against ``tube_cuda`` on
the same funnel output, both tubes' slopes; one
``PIFFT_FAULT=resolve:capacity:1.0:1`` firing sending the rows case to
the stage tube with one warning; the C core's golden test (``-t``) on
serial and pthreads beside its capacity and this process's affinity
mask; the harness on serial, pthreads, torch-scan and einsum, -T 3
--verify, every cell verified and none DEGRADED; BASELINE config 1)
and the parallel configs on torch.distributed (phase 16,
``phase_parallel``: BASELINE configs 3, 4 and 5 at full size through
the sharded entry points on a world-1 NCCL job, each counted —
``COLLECTIVE_CALLS`` 0, 4, 4 a call — and timed beside its unsharded
twin; the same configs, ``pi_fft_sharded`` at n = 2^27 and
``pi_fft_sharded_batched`` on a 2 x 2 mesh on four gloo ranks sharing
the card, every output assembled here and held to ``torch.fft`` in
complex128 or to u_true; the collective-free escape bit for bit
against the primary, an unhealthy report that skips the dispatch, a
stall on every rank aborted, agreed and escaped; the sharded harness,
-T 3 --verify) and the spectral apps (phase 17, ``phase_apps``:
``fftconv``/``fftcorr`` of a 2^24 - 128-sample signal with 129 taps in
every mode, the kernel-spectrum cache saving one forward transform,
conv_np's length 3 x 2^18 with the bytes meter under its pow2
control's, the metered fusion gate at 2^24, overlap-save of 2^26
samples at ``tune_block``'s raced block, overlap-add and the stream fed
uneven chunks, the journaled kill and resume byte-identical,
``solve_spectral_1d`` at 2^22 and ``apps.pde.poisson_solve`` at 512^3
charging its bytes, the fused conv's and the solve's slopes beside the
library pair ``torch.fft.irfft(torch.fft.rfft(x) * K)``, and the
``apps {conv,corr,solve} --smoke --json`` subprocesses; each counted
call with torch.fft and numpy.fft refused, each output within 1e-5 of
torch.fft in float64) and the telemetry layer (phase 18, ``phase_obs``:
the 2^20 fft unarmed, its slope within 5% of phase 7's on the same plan,
then armed with a JSONL sink and the bare telemetry server up, output
bit-identical and the armed cost of a call read from alternated turns;
the funnel/tube, sixstep, autotune and spectral_op spans, the race's
fates, the plan cache's hit and miss, the kernel-spectrum cache and the
bytes counter, a retry and a demotion counted, a ``torch.profiler``
trace holding the funnel/tube ranges and the csrc kernels; the stream
read back by ``obs validate/summary/export``, and ``bench --smoke
--events --trace-out`` and the harness with ``--events``, all in
subprocesses).  Phase 14's bench record carries the conv2^K
and conv_np rows, its os2^K rows skipped past MAX_BLOCK.  Phase 11's
pi-layout oracle gathers on the card and its slopes take the fitted
window (``slope_ms``), the cut that pays for phase 17.
Each phase's seconds are printed as it ends.  The last line of
standard output is
``{"ok": true, "device": {...}}``; any failed phase raises and the
script exits non-zero without it.  It imports nothing of JAX.
The loop slopes (``slope_ms``) read a call of more than about a
millisecond over the window that takes about 200 ms a run, not the
reference's 256 or 1024 calls, as the race's timer does.

Bounds and carry ceilings come from the port's ``utils/roofline.py``:
NVIDIA's data-sheet peaks for the card by name (3.35 TB/s of HBM
bandwidth, 67 TFLOP/s of float32 outside the tensor cores and 989
TFLOP/s of dense bf16 on them for the H100 SXM).
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

KERNEL_TOL = 1e-6   # kernel vs plain version, rel L2: FMA contraction
#: a bf16 instantiation vs its plain bf16 version, rel L2: both compute
#: in float32 and round at the same points, so they differ only where a
#: float32 difference of about 1e-7 crosses a bf16 rounding boundary
BF16_KERNEL_TOL = 1e-3
#: the bf16 mode's budget against complex128 (ops/precision.py)
BF16_BUDGET = 3e-2
PATH_TOL = 1e-5     # whole transform vs complex128, rel L2: split3 budget
MAX_ABS_TOL = 1e-5  # BASELINE's bound on max abs error
REPS = 30
#: one-byte fills that open each torch.profiler session (chip_smoke's
#: ``profiled``): they take the records the profiler loses at a
#: session's start; PAD_KEY names their kernel (and the L2 flush's)
PROFILE_PAD = 256
PAD_KEY = "FillFunctor<unsigned char>"
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
#: against complex128 (ops/precision.py: the contract is rel L2)
MF_BUDGETS = {"split3": 1e-5, "highest": 5e-6, "fp32": 5e-6,
              "default": 1e-2}
#: the modes of the full-precision path, also held to MAX_ABS_TOL; the
#: bf16 splits of split3 and default keep 16 and 8 bits of each operand
#: and are held to their budgets (split3's max abs on phase 9's input is
#: 1.11e-5 on an H100, the same under the earlier tile kernel:
#: tools/ab_fft_2p20.py)
MF_MAX_ABS_HELD = ("highest", "fp32")
#: (rows, n) of phase 3's gpu_rows checks: 2^24 points each, the
#: configs' shapes 4096 x 4096 and 64 x 2^18 among them, and every
#: cluster size of the long rows (2, 4, 8, 16 blocks at 2^15 .. 2^18)
GPU_ROWS_CHECKS = ((1 << 20, 16), (4096, 4096), (1024, 1 << 14),
                   (512, 1 << 15), (256, 1 << 16), (128, 1 << 17),
                   (64, 1 << 18))
#: the fused kernel's phase-B cluster widths held against the plain
#: version in phase 3 and timed in phase 7 (with qb 1 and 2)
FUSED_CWS = (1, 2, 4, 8)
#: points of each phase-3 tile_fft check at tiles 2 .. 2^14
TILE_CHECK_POINTS = 1 << 22
#: row counts of the tile_fft checks at tiles 2^13 and 2^14, where the
#: automatic blocking picks the cluster width by rows and SMs: one check
#: for each blocking these give (rql's row pass at 2^20 is 64 x 2^14,
#: mf's 128 x 2^13)
TILE_CLUSTER_ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
#: (log2 n, tile) of phase 3's fourstep checks: every automatic
#: blocking (tile 2^14: phase-B rows on clusters of 4), and the race's
#: half-tile entries (tile 2^13: clusters of 2)
FOURSTEP_CHECKS = tuple((k, 1 << 14) for k in range(21, 26)) \
    + tuple((k, 1 << 13) for k in range(21, 25))
#: (batch, R, C, cb) of phase 3's long_range_sep checks beside config
#: 2's (1, 64, 2^14, 32): every first-pass split of R = 2 .. 8192, cb 2
#: .. 32, batches above 1 (up to 16; tube_cuda's segments at n = 2^20,
#: p = 4), rql's first pass at n = 2^22 and 2^24
LONG_RANGE_CHECKS = ((1, 2, 4096, 32), (2, 4, 256, 2), (16, 8, 8192, 32),
                     (4, 16, 1 << 14, 32), (2, 32, 2048, 4),
                     (1, 128, 1 << 14, 32), (1, 256, 1 << 14, 32),
                     (3, 512, 1024, 8), (1, 1024, 1 << 14, 16),
                     (1, 2048, 4096, 8), (1, 4096, 4096, 4),
                     (1, 8192, 2048, 2))
#: (batch, R, C) of the long_range_sep shapes phase 7 also times
LONG_RANGE_TIMED = ((1, 256, 1 << 14), (4, 16, 1 << 14))
#: kernel launches of one call of each 1-D plan variant
VARIANT_LAUNCHES = {
    "fused": {"fused": 1}, "fused-alias": {"fused": 1},
    "rql": {"long_range_sep": 1, "tile_fft": 1},
    "two-kernel": {"long_range_dense": 1, "tile_fft": 1},
    "fourstep": {"fourstep": 1}, "sixstep": {"sixstep": 1},
    "rows": {"tile_fft": 1}}
#: (label, shape, plan variant, params) of phase 11's bf16 storage runs:
#: params None is the static plan (plan_for), a dict a Plan built with
#: the variant, as a tuned store would serve it
BF16_PATHS = (("config 2 N=2^20", (1 << 20,), "rql", None),
              ("config 3 (4096,4096)", (4096, 4096), "rows", None),
              ("N=2^24", (1 << 24,), "fourstep", None),
              ("N=2^27", (1 << 27,), "sixstep", None),
              ("N=2^20 fused", (1 << 20,), "fused", {"tile": 1 << 14}),
              ("N=2^20 fused-alias", (1 << 20,), "fused-alias",
               {"tile": 1 << 14}),
              ("N=2^20 two-kernel", (1 << 20,), "two-kernel",
               {"tile": 1 << 14, "cb": 32}))
#: profiled calls of each phase-11 device-time reading
BF16_PROFILE_REPS = 10
#: phase 12, the domains: (label, domain, shape, variant the plan
#: resolves to, Hopper kernel launches a forward call).  The r2c cases
#: ride the c2c plan at n/2 (config 2's transform as a real signal: rql
#: at 2^20; config 3's rows as real rows: rows of 2048; the reference
#: bench's 2^25: fourstep at 2^24); fft at the largest prime below 2^20
#: (rader, its convolution of 1048572 padded to 2^21), at 3^13 (an odd
#: part past MIXEDRADIX_MAX_ODD: bluestein, padded to 2^22) and at
#: 5 * 2^16 in a batch of 16 (mixedradix: 80 rows of 2^16); rfft at the
#: reference's own test length 1000 (mixedradix at 500, whose rows of 4
#: no Hopper kernel serves)
DOMAIN_CASES = (
    ("rfft n=2^21", "r2c", (1 << 21,), "rql",
     {"long_range_sep": 1, "tile_fft": 1}),
    ("rfft (4096,4096)", "r2c", (4096, 4096), "rows", {"tile_fft": 1}),
    ("rfft n=2^25", "r2c", (1 << 25,), "fourstep", {"fourstep": 1}),
    ("fft n=1048573", "c2c", (1048573,), "rader", {"fourstep": 2}),
    ("fft n=3^13", "c2c", (3 ** 13,), "bluestein", {"fourstep": 2}),
    ("fft n=5*2^16 batch 16", "c2c", (16, 5 << 16), "mixedradix",
     {"long_range_sep": 1, "tile_fft": 1}),
    ("rfft n=1000", "r2c", (1000,), "mixedradix", {}))
#: phase 12's bounds against numpy in complex128, max |got - ref| /
#: max |ref| (the reference's tests/test_anylen.py measure)
DOMAIN_TOL = 1e-5
DOMAIN_RT_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


class PhaseClock:
    """Seconds of each phase on the host clock: ``start(name)`` closes
    the running phase, logs its seconds, and opens `name` (None closes
    the last)."""

    def __init__(self):
        self.name, self.t0, self.seconds = None, time.perf_counter(), {}

    def start(self, name):
        now = time.perf_counter()
        if self.name is not None:
            self.seconds[self.name] = round(now - self.t0, 1)
            log(f"# {self.name} took {now - self.t0:.1f} s")
        self.name, self.t0 = name, now


def rel_l2(a, b):
    import torch

    a = a.to(torch.complex128)
    b = b.to(torch.complex128)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def ms_text(ms):
    """A time for the log: 4 decimals, or "not measured" where the
    profiler saw no device time for the run."""
    return "not measured" if ms is None else f"{ms:.4f}"


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


def slope_ms(fn, *args, consumes=False):
    """Per-call ms of ``fn(*args)`` by the loop slope
    (``utils.timing.fitted_slope_ms``: k calls in one CUDA graph, device
    time per call with no host work between calls), the calls rotating
    over copies of the tensor arguments, as many as keep the L2 from
    serving a call (``window_copies``), as the race times a candidate.
    The window is the reference's for the operands' size, narrowed for
    a call of more than about a millisecond to what takes FITTED_RUN_MS
    a run (``fitted_window``, as the backends time a phase): the slope
    of a 16 ms call is read over a dozen calls, not hundreds.
    `consumes`: fn writes over its tensor arguments, so every copy gets
    them back before each timed run."""
    from cs87project_msolano2_tpu_torch.utils.timing import fitted_slope_ms

    return fitted_slope_ms(fn, *args, consumes=consumes)


def domain_subplan(plan):
    """(label, plan) of the power-of-two subplan that carries a domain
    plan's transform: the c2c plan at n/2 of an even r2c key, the pad's
    of rader and bluestein, mixedradix's batched rows."""
    import dataclasses

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.ops import anylen

    key = plan.key
    if key.domain != "c2c" and key.n % 2 == 0:
        key = dataclasses.replace(key, n=key.n // 2, domain="c2c")
        plan = plans.get_plan(key)
    if plan.variant in ("rader", "bluestein"):
        sub = dataclasses.replace(key, n=plan.params["pad"], domain="c2c")
    elif plan.variant == "mixedradix":
        a, m = anylen.odd_split(key.n)
        sub = dataclasses.replace(key, n=1 << a, batch=key.batch + (m,),
                                  domain="c2c")
    else:
        return f"c2c {key.batch + (key.n,)}", plan
    return f"c2c {sub.batch + (sub.n,)}", plans.get_plan(sub)


def phase_domains(dev, rng, timed):
    """Phase 12: the real and any-length domains at full size through
    the user entry points (``rfft``/``irfft``, ``fft``/``ifft``), each
    case of DOMAIN_CASES checked for its plan, its Hopper launches per
    call (counted), no fallback (torch.fft and numpy.fft raise during
    the counted calls), its accuracy against numpy in complex128 forward
    and round trip, and timed by the loop slope beside the CUDA-event
    median, with torch.fft on the same data and, for r2c, the c2c twin
    (fft at the same n).  The plans are the static ladder's: the phase
    runs with the plan store off and the in-process plans dropped, so no
    winner of phase 8's races serves it.  Returns the rows by case;
    raises on any failure."""
    from cs87project_msolano2_tpu_torch import plans

    store = os.environ.get("PIFFT_PLAN_CACHE")
    os.environ["PIFFT_PLAN_CACHE"] = "off"
    plans.cache.clear(memory=True)
    try:
        return {case[0]: domain_case(dev, rng, timed, *case)
                for case in DOMAIN_CASES}
    finally:
        plans.cache.clear(memory=True)
        if store is None:
            os.environ.pop("PIFFT_PLAN_CACHE")
        else:
            os.environ["PIFFT_PLAN_CACHE"] = store


def counted(fn, *args):
    """(``fn(*args)``, {kernel: launches}) of one call with torch.fft's
    and numpy.fft's transforms refused: a path that reaches either
    raises."""
    import torch

    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf

    def refused(*_a, **_k):
        raise AssertionError("a domain path reached torch.fft or numpy.fft")

    fallbacks = [(mod, name) for mod in (torch.fft, np.fft)
                 for name in ("fft", "ifft", "rfft", "irfft")]
    saved = [getattr(mod, name) for mod, name in fallbacks]
    for mod, name in fallbacks:
        setattr(mod, name, refused)
    cf.reset_launch_counts()
    try:
        out = fn(*args)
        torch.cuda.synchronize()
    finally:
        for (mod, name), f in zip(fallbacks, saved):
            setattr(mod, name, f)
    return out, {k: v for k, v in cf.launch_counts().items() if v}


def domain_case(dev, rng, timed, label, domain, shape, want, want_launches):
    """One case of phase 12 (``phase_domains``): its row."""
    import torch

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.models.fft import fft, ifft
    from cs87project_msolano2_tpu_torch.models.real import irfft, rfft

    n = shape[-1]
    xr, xi = random_complex(rng, shape, dev)
    if domain == "r2c":
        x, fwd, inv, lib = xr, rfft, irfft, torch.fft.rfft
        twin_x = torch.complex(xr, torch.zeros_like(xr))
    else:
        x, fwd, inv, lib = torch.complex(xr, xi), fft, ifft, torch.fft.fft
        twin_x = None
    lib_name = f"torch.fft.{'rfft' if domain == 'r2c' else 'fft'}"
    del xr, xi
    plan = plans.plan_for(shape, domain=domain, device=dev)
    sub_label, sub = domain_subplan(plan)
    log(f"# phase 12 {label}: plan {plan.variant} {plan.params} "
        f"[{plan.source}], subplan {sub_label} {sub.variant} {sub.params}")
    # the first call builds the tables and subplans, uncounted
    inv(fwd(x))
    y, fwd_launches = counted(fwd, x)
    back, inv_launches = counted(inv, y)
    xh = x.cpu().numpy().astype(np.complex128 if domain == "c2c"
                                else np.float64)
    yh = y.cpu().numpy().astype(np.complex128)
    ref = (np.fft.rfft if domain == "r2c" else np.fft.fft)(xh, axis=-1)
    err = float(np.max(np.abs(yh - ref)) / np.max(np.abs(ref)))
    bh = back.cpu().numpy().astype(xh.dtype)
    rt = float(np.max(np.abs(bh - xh)) / np.max(np.abs(xh)))
    bins = n // 2 + 1 if domain == "r2c" else n
    ok = (plan.variant == want and fwd_launches == want_launches
          and inv_launches == want_launches and err <= DOMAIN_TOL
          and rt <= DOMAIN_RT_TOL
          and y.device.type == back.device.type == dev.type
          and bool(torch.isfinite(y).all())
          and y.shape == shape[:-1] + (bins,) and back.shape == shape)
    log(f"# phase 12 {label}: forward {err:.3e} (bound {DOMAIN_TOL}), "
        f"round trip {rt:.3e} (bound {DOMAIN_RT_TOL}) vs numpy complex128; "
        f"Hopper launches a call: forward {fwd_launches}, inverse "
        f"{inv_launches} (expected {want_launches})")
    if not ok:
        raise AssertionError(f"phase 12 {label} failed")
    del y, back, xh, yh, bh, ref
    row = {"plan": plan.variant, "params": plan.params,
           "subplan": [sub_label, sub.variant, sub.params],
           "forward_err": err, "round_trip_err": rt,
           "launches_forward": fwd_launches,
           "launches_inverse": inv_launches,
           "slope_ms": slope_ms(fwd, x), "event_ms": timed(fwd, x),
           "torch_fft_slope_ms": slope_ms(lib, x),
           "torch_fft_event_ms": timed(lib, x)}
    text = (f"slope {row['slope_ms']:.4f} ms (events "
            f"{row['event_ms']:.4f}); {lib_name} slope "
            f"{row['torch_fft_slope_ms']:.4f} (events "
            f"{row['torch_fft_event_ms']:.4f})")
    if twin_x is not None:
        del x
        twin = plans.plan_for(shape, device=dev)
        row["c2c_twin"] = {"plan": twin.variant, "params": twin.params,
                           "slope_ms": slope_ms(fft, twin_x),
                           "event_ms": timed(fft, twin_x)}
        text += (f"; c2c twin fft at n={n} ({twin.variant}) slope "
                 f"{row['c2c_twin']['slope_ms']:.4f} (events "
                 f"{row['c2c_twin']['event_ms']:.4f}), r2c / c2c "
                 f"{row['slope_ms'] / row['c2c_twin']['slope_ms']:.3f}")
    log(f"# phase 12 {label}: {text}")
    return row


#: plans memoized with a demotion since ``watch_demotions()``: token ->
#: trail
DEMOTED = {}


def watch_demotions():
    """From here on, record in DEMOTED every plan the plan cache
    memoizes with a demotion.  Every demotion memoizes its plan with
    ``degraded`` set and the trail in ``demotions``, whether or not obs
    is armed, so the record outlives the cache's clears (phase 12 clears
    it on entry and on exit) and its LRU eviction.  Returns the cache's
    own ``memoize``, which ``no_demotions`` puts back."""
    from cs87project_msolano2_tpu_torch.plans import cache

    memoize = cache.memoize

    def watched(plan):
        if plan.degraded or plan.demotions:
            DEMOTED[plan.key.token()] = list(plan.demotions)
        return memoize(plan)

    cache.memoize = watched
    return memoize


def no_demotions(where, memoize=None):
    """Raise unless no plan of this process has demoted: none memoized
    with a demotion since ``watch_demotions()`` (whose returned
    `memoize` is put back here, ending the watch) and none in the
    in-process cache reporting ``degraded`` or a trail."""
    from cs87project_msolano2_tpu_torch.plans import cache

    if memoize is not None:
        cache.memoize = memoize
    degraded = dict(DEMOTED)
    degraded.update({p.key.token(): p.demotions
                     for p in list(cache._MEM.values())
                     if p.degraded or p.demotions})
    log(f"# {where}: degraded plans {degraded}")
    if degraded:
        raise AssertionError(f"{where}: a plan demoted: {degraded}")


def numpy_rel_l2(yr, yi, x):
    """rel L2 of planes (yr, yi) against numpy's FFT of the complex
    tensor x in complex128."""
    ref = np.fft.fft(x.cpu().numpy().astype(np.complex128))
    got = yr.cpu().numpy().astype(np.float64) \
        + 1j * yi.cpu().numpy().astype(np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def demoted_case(dev, rng, k, was, to, absent):
    """Phase 13, cases 1 and 2: the static natural-order plan at n = 2^k
    (`was`) under one injected CAPACITY fault at the ``tube`` site
    lands on `to`: its record reads ``was -> to``, the kernels of `to`
    launch and `absent` does not, the result stays within PATH_TOL of
    numpy."""
    import torch

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.resilience import inject

    n = 1 << k
    xr, xi = random_complex(rng, (n,), dev)
    plan = plans.plan_for((n,), device=dev)
    if plan.variant != was:
        raise AssertionError(f"n=2^{k} planned {plan.variant}, not {was}")
    cf.reset_launch_counts()
    with inject("tube", "capacity", count=1) as spec:
        yr, yi = plan.execute(xr, xi)
        torch.cuda.synchronize()
    launched = {k2: v for k2, v in cf.launch_counts().items() if v}
    err = numpy_rel_l2(yr, yi, torch.complex(xr, xi))
    trail = [(d["from"], d["to"]) for d in plan.demotions]
    log(f"# phase 13 tube capacity fault n=2^{k} natural: fired "
        f"{spec.fired}, degraded {plan.degraded}, demotions "
        f"{json.dumps(plan.demotions)}, launches {launched}, rel L2 "
        f"{err:.3e} vs numpy (bound {PATH_TOL})")
    want = {"rql": ("long_range_sep", "tile_fft"),
            "fourstep": ("fourstep",)}[to]
    if not (spec.fired == 1 and plan.degraded and trail == [(was, to)]
            and all(launched.get(w) for w in want)
            and not launched.get(absent) and err <= PATH_TOL
            and yr.shape == (n,) and bool(torch.isfinite(yr).all())):
        raise AssertionError(f"phase 13 n=2^{k} {was} -> {to} failed")
    return {"demotions": plan.demotions, "launches": launched,
            "rel_l2": err}


def phase_resilience(dev, rng):
    """Phase 13: the resilience layer on the card, no CUDA graph in any
    case, the plans the static ladder's (store off).  (1) 2^24 natural,
    one capacity fault at ``tube``: fourstep -> rql; (2) 2^25: sixstep
    -> fourstep; (3) one transient fault at ``plan`` under
    ``call_with_retry(FAST_POLICY)``: retried, not demoted; (4)
    ``promote_precision`` on a bf16 plan at 2^20 (pi), its budget set to
    0 by ``PIFFT_PRECISION_BUDGET``: promoted to ``default``, the next
    call launches tile_fft and not tile_fft_bf16; (5) the bench's chaos
    run, ``PIFFT_FAULT=tube:capacity:1.0:1 python -m
    cs87project_msolano2_tpu_torch.bench --smoke`` in a subprocess:
    exit 0, ``degraded: true``, the flagship's plan demoted onto
    ``rql`` and no library rung anywhere.  The fault fires once: on the
    card the chain ends at rql, so a fault at every kernel entry would
    leave nothing to serve.
    Returns the cases' records; raises on any failure."""
    import torch

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops.bits import to_natural
    from cs87project_msolano2_tpu_torch.ops.precision import (
        BUDGET_ENV,
        error_budget,
    )
    from cs87project_msolano2_tpu_torch.resilience import (
        FAST_POLICY,
        call_with_retry,
        inject,
        promote_precision,
    )
    from cs87project_msolano2_tpu_torch.resilience.degrade import (
        LIBRARY_RUNGS,
    )

    store = os.environ.get("PIFFT_PLAN_CACHE")
    os.environ["PIFFT_PLAN_CACHE"] = "off"
    plans.cache.clear(memory=True)
    rows = {}
    try:
        rows["fourstep_to_rql_2^24"] = demoted_case(
            dev, rng, 24, "fourstep", "rql", "fourstep")
        rows["sixstep_to_fourstep_2^25"] = demoted_case(
            dev, rng, 25, "sixstep", "fourstep", "sixstep")

        n = 1 << 20
        xr, xi = random_complex(rng, (n,), dev)
        plan = plans.plan_for((n,), device=dev)
        with inject("plan", "transient", count=1) as spec:
            yr, yi = call_with_retry(plan.execute, xr, xi,
                                     policy=FAST_POLICY,
                                     label="phase 13 transient")
        err = numpy_rel_l2(yr, yi, torch.complex(xr, xi))
        log(f"# phase 13 transient fault at plan, N=2^20 {plan.variant}: "
            f"fired {spec.fired}, degraded {plan.degraded}, rel L2 "
            f"{err:.3e}")
        if not (spec.fired == 1 and not plan.degraded and err <= PATH_TOL):
            raise AssertionError("phase 13 transient retry failed")
        rows["transient_retried_2^20"] = {"fired": spec.fired,
                                          "plan": plan.variant,
                                          "rel_l2": err}

        pl16 = plans.plan_for((n,), layout="pi", precision="bf16",
                              device=dev)
        cf.reset_launch_counts()
        yr, yi = pl16.execute(xr, xi)
        before = {k: v for k, v in cf.launch_counts().items() if v}
        x = torch.complex(xr, xi)
        err16 = numpy_rel_l2(*to_natural(yr, yi), x)
        os.environ[BUDGET_ENV] = "0"
        try:
            budget = error_budget(pl16.effective_precision())
        finally:
            os.environ.pop(BUDGET_ENV)
        mode = promote_precision(pl16, err16, budget) \
            if err16 > budget else None
        cf.reset_launch_counts()
        yr, yi = pl16.execute(xr, xi)
        torch.cuda.synchronize()
        after = {k: v for k, v in cf.launch_counts().items() if v}
        err_up = numpy_rel_l2(*to_natural(yr, yi), x)
        log(f"# phase 13 promote_precision bf16 N=2^20 pi "
            f"({pl16.variant}): rel L2 {err16:.3e} > budget {budget} "
            f"(PIFFT_PRECISION_BUDGET=0) -> {mode}; demotions "
            f"{json.dumps(pl16.demotions)}; launches before {before}, "
            f"after {after}; rel L2 after {err_up:.3e}")
        if not (mode == "default" and pl16.degraded
                and before.get("tile_fft_bf16")
                and after.get("tile_fft") and not after.get("tile_fft_bf16")
                and err_up <= PATH_TOL):
            raise AssertionError("phase 13 promote_precision failed")
        rows["promote_bf16_2^20"] = {"demotions": pl16.demotions,
                                     "launches_before": before,
                                     "launches_after": after,
                                     "rel_l2_before": err16,
                                     "rel_l2_after": err_up}
        del xr, xi, x, yr, yi

        env = dict(os.environ, PIFFT_FAULT="tube:capacity:1.0:1",
                   PIFFT_PLAN_CACHE="off")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cs87project_msolano2_tpu_torch.bench",
             "--smoke"], capture_output=True, text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
        chaos_s = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        rec = json.loads(lines[-1]) if proc.returncode == 0 and lines \
            else {}
        demotions = rec.get("plan", {}).get("demotions")
        rungs = [d["to"] for d in demotions or []] + [
            d["to"] for k, v in rec.items() if k.endswith("_plan")
            for d in v.get("demotions", [])]
        log(f"# phase 13 chaos bench (PIFFT_FAULT=tube:capacity:1.0:1 "
            f"--smoke): exit {proc.returncode} in {chaos_s:.1f} s, "
            f"degraded {rec.get('degraded')}, flagship demotions "
            f"{json.dumps(demotions)}, rungs served {rungs}")
        if not (proc.returncode == 0 and rec.get("degraded") is True
                and rec["plan"].get("degraded") is True and demotions
                and demotions[-1]["to"] == "rql"
                and not set(rungs) & set(LIBRARY_RUNGS)):
            log(proc.stderr[-4000:])
            raise AssertionError("phase 13 chaos bench failed")
        rows["chaos_bench"] = {"exit": proc.returncode,
                               "degraded": rec.get("degraded"),
                               "demotions": demotions, "s": chaos_s}
    finally:
        plans.cache.clear(memory=True)
        if store is None:
            os.environ.pop("PIFFT_PLAN_CACHE")
        else:
            os.environ["PIFFT_PLAN_CACHE"] = store
    return rows


#: the bench rows phase 14 requires (the reference's LARGE_LOGNS and
#: its gpu backend rows), each by its ms field
BENCH_LOGNS = (22, 24, 25, 26, 27)
#: phase 14's harness sweep: the cuda backend, T replications
HARNESS_NS = (1 << 16, 1 << 20, 1 << 24)
HARNESS_PS = (1, 4, 16, 64, 256)
HARNESS_REPS = 3


def phase_measurement(dev):
    """Phase 14: the bench at full size (``bench.main([])`` in this
    process, reading the plan store phase 8 wrote: each key the store
    holds serves its winner, every other key is raced first, as the
    reference races the keys its cache lacks),
    its record printed on its own line; every row present, none
    degraded, the 2^26 rows' plans checked once against torch.fft.fft
    in complex128 (c2c and rfft within PATH_TOL, bf16 within its
    budget); then the paper's (n, p) sweep through the harness on the
    cuda backend (HARNESS_NS x HARNESS_PS, HARNESS_REPS reps) and its
    verify pass, as ``python -m
    cs87project_msolano2_tpu_torch.harness.run_experiments`` in a
    subprocess.  Returns (bench record, TSV rows); raises on any
    failure."""
    import contextlib
    import io

    import torch

    from cs87project_msolano2_tpu_torch import bench, plans
    from cs87project_msolano2_tpu_torch.harness import run_experiments
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.ops.bits import to_natural

    plans.cache.clear(memory=True)
    torch.cuda.empty_cache()
    cf.reset_launch_counts()
    t0 = time.perf_counter()
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = bench.main([])
    bench_s = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    launched = {k: v for k, v in cf.launch_counts().items() if v}
    line = buf.getvalue().strip().splitlines()[-1]
    log(line)
    rec = json.loads(line)
    want = ["ms", "library_fft_ms", "c_ms", "vs_baseline"] + [
        f"{p}2^{k}_ms" for k in BENCH_LOGNS
        for p in ("n", "rfft", "bf16_", "conv")
    ] + [f"{p}2^{k}_ms" for k in bench.BACKEND_ROW_LOGNS
         for p in ("gpu", "cpun")] + [f"conv_np{APPS_NP}_ms"]
    missing = [w for w in want if w not in rec]
    not_positive = [w for w in want if w in rec and not rec[w] > 0]
    degraded = [k for k, v in rec.items()
                if k.endswith("degraded") and v]
    # every os2^K row of the full bench is past MAX_BLOCK: skipped, with
    # the diagnostic
    os_rows = [k for k in rec if k.startswith("os2^")]
    os_unsaid = [k for k in BENCH_LOGNS
                 if f"overlap-save 2^{k} skipped" not in err.getvalue()]
    log(f"# phase 14 bench: exit {rc} in {bench_s:.1f} s, missing "
        f"{missing}, not positive {not_positive}, degraded {degraded}, "
        f"os rows {os_rows} (skips not announced: {os_unsaid}), "
        f"launches (captured included) {launched}")
    for tag in [f"conv2^{k}" for k in BENCH_LOGNS] + [f"conv_np{APPS_NP}"]:
        log(f"# phase 14 bench row {tag}: slope {rec.get(tag + '_ms')} ms, "
            f"events {rec.get(tag + '_event_ms')} ms, "
            f"{rec.get(tag + '_gflops')} GFLOP/s, share of the fused floor "
            f"{rec.get(tag + '_roofline_util')}, metered "
            f"{rec.get(tag + '_hbm_bytes')} B, plan "
            f"{json.dumps(rec.get(tag + '_plan'))}")
    log(f"# phase 14 C baseline: c_ms {rec.get('c_ms')} (pthreads, N=2^20, "
        f"best of 3 on the host: {host_cpu()}, {len(os.sched_getaffinity(0))}"
        f" cores this process may use), flagship {rec.get('ms')} ms, "
        f"vs_baseline {rec.get('vs_baseline')}; cpun2^8 "
        f"{rec.get('cpun2^8_ms')} ms, cpun2^10 {rec.get('cpun2^10_ms')} ms "
        f"({rec.get('cpun2^10_plan')})")
    if rc != 0 or missing or not_positive or degraded or os_rows \
            or os_unsaid or not launched.get("gpu_rows"):
        raise AssertionError("phase 14 bench failed")

    n = 1 << 26
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    xr = torch.randn(n, generator=gen, device=dev)
    xi = torch.randn(n, generator=gen, device=dev)
    checks = {}
    for tag, key, tol in (
            ("n2^26", plans.make_key(n, layout="pi", device=dev), PATH_TOL),
            ("bf16_2^26", plans.make_key(n, layout="pi", precision="bf16",
                                         device=dev), BF16_BUDGET),
            ("rfft2^26", plans.make_key(n, domain="r2c", device=dev),
             PATH_TOL)):
        plan = plans.get_plan(key, str(dev))
        if key.domain == "r2c":
            got = torch.complex(*plan.execute(xr, xr))
            ref = torch.fft.rfft(xr.to(torch.float64))
        else:
            yr, yi = plan.execute(xr, xi)
            got = torch.complex(*to_natural(yr, yi))
            ref = torch.fft.fft(torch.complex(xr, xi).to(torch.complex128))
        e = rel_l2(got, ref)
        checks[tag] = {"plan": plan.describe(), "rel_l2": e}
        log(f"# phase 14 bench row {tag}: plan {plan.variant} "
            f"{plan.params}, rel L2 {e:.3e} vs torch.fft in complex128 "
            f"(bound {tol})")
        if not (e <= tol and not plan.degraded):
            raise AssertionError(f"phase 14 {tag} out of tolerance")
        del got, ref
    del xr, xi
    plans.cache.clear(memory=True)
    torch.cuda.empty_cache()

    # the harness in a process of its own: the 2^24 x 256 funnel needs
    # about 56 GB of the card, more than this process leaves free
    log(f"# phase 14 this process holds {torch.cuda.memory_allocated()} "
        f"bytes of the card before the harness")
    out = tempfile.mkdtemp(prefix="pifft-harness-")
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "cs87project_msolano2_tpu_torch.harness.run_experiments",
             "--backends", "cuda", "--n-grid",
             ",".join(map(str, HARNESS_NS)), "--p-grid",
             ",".join(map(str, HARNESS_PS)), "-T", str(HARNESS_REPS),
             "--verify", "--seed", str(SEED), "--out", out],
            capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        harness_s = time.perf_counter() - t0
        path = run_experiments.result_path(out, "cuda")
        tsv = []
        if os.path.exists(path):
            with open(path) as f:
                tsv = [line.rstrip("\n") for line in f]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    for row in tsv:
        log(f"# phase 14 harness tsv\t{row}")
    cells = len(HARNESS_NS) * len(HARNESS_PS)
    marked = [row for row in tsv if row.endswith("DEGRADED")]
    verified = [line for line in proc.stderr.splitlines()
                if line.startswith("# cuda: verified")]
    log(f"# phase 14 harness cuda: exit {proc.returncode} in "
        f"{harness_s:.1f} s, {len(tsv)} rows, DEGRADED rows "
        f"{len(marked)}, {verified}")
    if (proc.returncode != 0 or len(tsv) != cells * HARNESS_REPS or marked
            or verified != [f"# cuda: verified {cells}/{cells} cells vs "
                            f"numpy fft (0 skipped)"]):
        log(proc.stderr[-4000:])
        raise AssertionError("phase 14 harness failed")
    return {"record": rec, "s": bench_s, "harness_s": harness_s,
            "checks_2^26": checks}, tsv


def host_cpu():
    """The host CPU: its model name from ``/proc/cpuinfo`` (else, where
    a sandbox reports none or "unknown", its vendor, family and model
    numbers there, else ``lscpu``'s model name), its architecture and
    the vector extension PyTorch's CPU kernels use."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name")
    if name in (None, "", "unknown") and "vendor_id" in fields:
        name = (f"{fields['vendor_id']} family {fields.get('cpu family')} "
                f"model {fields.get('model')}")
    if name is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((line.split(":", 1)[1].strip()
                         for line in out.splitlines()
                         if line.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    import torch

    return (f"{name or 'unknown model'} ({platform.machine()}, "
            f"{torch.backends.cpu.get_cpu_capability()})")


#: phase 15's planned-tube cases: (label, log2 n, p, how the tube is
#: driven — "segments": each processor's funnel_single chain, then
#: tube_planned on its 1-D segment, as the sharded path runs it;
#: "planes": the funnel's (p, s) planes, then tube_planned on them —
#: and the static ladder's variant for that shape (a batch of segments
#: longer than 2^16 takes rql over the batch, where the reference's plan
#: layer refuses it and takes its stage tube)
PLANNED_CASES = (("n=2^27 p=2", 27, 2, "segments", "sixstep"),
                 ("n=2^27 p=8", 27, 8, "segments", "fourstep"),
                 ("n=2^20 p=64", 20, 64, "planes", "rows"),
                 ("n=2^24 p=4", 24, 4, "planes", "rql"))
#: the planned tube vs tube_cuda on the same funnel output, rel L2: two
#: float32 kernel paths (tube_cuda runs rql at every s)
TUBE_TOL = 1e-6
#: phase 15's harness sweeps: backend -> (n grid, p grid), -T 3
#: --verify; pthreads' p-grid is clipped at the core's capacity; the
#: pthreads and torch-scan grids stop at 2^22 and the einsum grid at
#: 2^15 (tube segments up to 2^15) to keep the run inside its time: the
#: 2^24 runs (1.2 s a pthreads run at p = 1, the torch-scan funnels at
#: p = 64) and the einsum tube at s = 2^16 took most of the phase
BACKEND_SWEEPS = (("serial", (1 << 16, 1 << 20), (1, 4, 16, 64)),
                  ("pthreads", (1 << 16, 1 << 20, 1 << 22), (1, 4, 16, 64)),
                  ("torch-scan", (1 << 16, 1 << 20, 1 << 22),
                   (1, 4, 16, 64)),
                  ("einsum", (1 << 12, 1 << 14, 1 << 15), (1, 4, 16, 64)))
#: the pthreads run whose worker threads phase 15 reads the affinity of
PINNING_N = 1 << 22
#: BASELINE config 1 (the float64 direct DFT) vs numpy, rel L2
CONFIG1_TOL = 1e-12


def planned_case(dev, rng, ref_cache, label, k, p, drive, static):
    """One planned-tube case of phase 15: the funnel, then
    ``tube_planned`` (counted, torch.fft and numpy.fft refused), the
    variant checked against the store's winner or the static ladder's,
    the result against torch.fft in complex128 on the card (natural
    order) and against ``tube_cuda`` on the same funnel output, and both
    tubes timed by the
    loop slope on one call's operands.  Returns (row, launches)."""
    import contextlib
    import io

    import torch

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.models.pi_fft import (
        funnel,
        funnel_single,
        resolve_tube_plan,
        tube_planned,
    )
    from cs87project_msolano2_tpu_torch.ops.bits import to_natural
    from cs87project_msolano2_tpu_torch.ops.cuda_fft import tube_cuda

    n = 1 << k
    s = n // p
    if k not in ref_cache:
        ref_cache.clear()
        xr, xi = random_complex(rng, (n,), dev)
        # the complex128 oracle on the card (numpy's host FFT of 2^27
        # points took 20 s of the phase); torch.fft is refused only in
        # the counted calls below
        ref = torch.fft.fft(torch.complex(xr, xi).to(torch.complex128))
        ref_cache[k] = (xr, xi, ref.cpu().numpy())
        del ref
    xr, xi, ref = ref_cache[k]
    shape = (s,) if drive == "segments" else (p, s)
    key = plans.make_key(s, shape[:-1], layout="pi", device=dev)
    stored = plans.cache.lookup(key)
    want = stored.variant if stored is not None and stored.source != \
        "static" else static
    plan = resolve_tube_plan(shape, device=dev)
    got_variant = None if plan is None else plan.variant

    def funnel_out():
        if drive == "segments":
            return [funnel_single(xr, xi, pi, p) for pi in range(p)]
        return [funnel(xr, xi, p)]

    def planned(parts):
        return [tube_planned(fr, fi, n, p) for fr, fi in parts]

    parts = funnel_out()
    torch.cuda.synchronize()
    outs, launched = counted(planned, parts)
    yr = torch.cat([o[0].reshape(-1) for o in outs])
    yi = torch.cat([o[1].reshape(-1) for o in outs])
    del outs
    nr, ni = to_natural(yr, yi)
    got = nr.cpu().numpy().astype(np.complex128)
    got.imag = ni.cpu().numpy()
    del nr, ni
    err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    del got
    outs = [tube_cuda(fr, fi, n, p) for fr, fi in parts]
    cr = torch.cat([o[0].reshape(-1) for o in outs])
    ci = torch.cat([o[1].reshape(-1) for o in outs])
    del outs
    err_cuda = rel_l2(torch.complex(yr, yi), torch.complex(cr, ci))
    del yr, yi, cr, ci
    fr, fi = (t.contiguous() for t in parts[0])
    del parts
    torch.cuda.empty_cache()
    planned_ms = slope_ms(lambda a, b: tube_planned(a, b, n, p),
                                 fr, fi)
    cuda_ms = slope_ms(lambda a, b: tube_cuda(a, b, n, p), fr, fi)
    calls = p if drive == "segments" else 1
    want_launches = {} if want is None else {
        name: c * calls for name, c in VARIANT_LAUNCHES[want].items()}
    row = {"variant": got_variant, "expected": want,
           "stored": None if stored is None else stored.variant,
           "launches": launched, "rel_l2_numpy": err,
           "rel_l2_tube_cuda": err_cuda,
           "tube_planned_ms": planned_ms, "tube_cuda_ms": cuda_ms,
           "drive": drive}
    log(f"# phase 15 planned tube {label} ({drive}, s=2^"
        f"{s.bit_length() - 1}): resolved {got_variant} (expected {want}; stored "
        f"{row['stored']}), launches {launched} (expected "
        f"{want_launches}), rel L2 {err:.3e} vs torch.fft complex128 (bound "
        f"{PATH_TOL}), {err_cuda:.3e} vs tube_cuda (bound {TUBE_TOL}); "
        f"slope ms of one {'segment' if calls > 1 else 'call'}: "
        f"tube_planned {planned_ms:.4f}, tube_cuda (rql) {cuda_ms:.4f}")
    if not (got_variant == want and launched == want_launches
            and err <= PATH_TOL and err_cuda <= TUBE_TOL):
        raise AssertionError(f"phase 15 planned tube {label} failed")
    if label == "n=2^20 p=64":
        # the resolve fault on card planes: it re-raises, with no warning
        # and nothing launched (the stage tube is a plain version, which
        # card planes never fall back to); one firing, so the next call
        # resolves its kernel again
        from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
        from cs87project_msolano2_tpu_torch.resilience import (
            InjectedFault,
            classify,
        )

        os.environ["PIFFT_FAULT"] = "resolve:capacity:1.0:1"
        buf = io.StringIO()
        raised = None
        try:
            with contextlib.redirect_stderr(buf):
                counted(planned, [(fr, fi)])
        except InjectedFault as e:
            raised = classify(e).value
        finally:
            os.environ.pop("PIFFT_FAULT")
        faulted = {k: v for k, v in cf.launch_counts().items() if v}
        warned = buf.getvalue().count("DEGRADED to the stage tube")
        (fy,), after = counted(planned, [(fr, fi)])
        nr, ni = to_natural(fy[0].reshape(-1), fy[1].reshape(-1))
        got = nr.cpu().numpy().astype(np.complex128)
        got.imag = ni.cpu().numpy()
        e_after = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        log(f"# phase 15 PIFFT_FAULT=resolve:capacity:1.0:1 on {label}: "
            f"raised {raised}, {warned} warning(s), launches {faulted}; "
            f"the next call: launches {after}, rel L2 {e_after:.3e} vs "
            f"torch.fft complex128")
        row["resolve_fault"] = {"raised": raised, "warnings": warned,
                                "launches": faulted,
                                "next_launches": after,
                                "next_rel_l2_numpy": e_after}
        if not (raised == "capacity" and warned == 0 and faulted == {}
                and after == want_launches and e_after <= PATH_TOL):
            raise AssertionError("phase 15 resolve fault failed")
    return row, launched


def observed_pinning(x, p):
    """{thread id: allowed cores} of the C core's pthreads workers, read
    while they run: a pthreads run of `x` at `p` (a warm-up and three
    timed runs, each starting its own workers) in a second thread, this
    one polling ``/proc/self/task`` for threads that were not there
    before and reading each one's affinity until it ends (the last read
    is the one after the core set the thread's mask)."""
    import threading

    from cs87project_msolano2_tpu_torch.backends.cpu import NativeBackend

    before = set(os.listdir("/proc/self/task"))
    runner = []
    done = threading.Event()

    def run():
        runner.append(str(threading.get_native_id()))
        try:
            NativeBackend("pthreads").run(x, p, reps=3, timers=False)
        finally:
            done.set()

    thread = threading.Thread(target=run)
    thread.start()
    seen = {}
    while not done.is_set():
        for tid in os.listdir("/proc/self/task"):
            if tid in before:
                continue
            try:
                seen[tid] = sorted(os.sched_getaffinity(int(tid)))
            except OSError:
                pass  # the worker ended between the listing and the read
    thread.join()
    for tid in runner:
        seen.pop(tid, None)
    return seen


def phase_backends(dev, rng):
    """Phase 15: the rest of the algorithm and its backends on the card.
    (a) the planned tube (``models.pi_fft.tube_planned``) as the sharded
    path runs it, on the plan store phases 8 and 14 wrote
    (PLANNED_CASES), and the ``resolve`` fault; (b) the C core on the
    card's host: ``-t`` on serial and pthreads, its capacity beside this
    process's affinity and what its pinning does; (c) the harness on
    serial, pthreads, torch-scan and einsum (BACKEND_SWEEPS, -T 3
    --verify), every cell verified, none DEGRADED; (d) BASELINE config
    1.  Returns (rows, the planned tube's launches); raises on any
    failure."""
    import contextlib
    import io

    import torch

    from cs87project_msolano2_tpu_torch.backends.cpu import (
        NativeBackend,
        num_cores,
    )
    from cs87project_msolano2_tpu_torch.cli import main as cli_main
    from cs87project_msolano2_tpu_torch.harness import run_experiments
    from cs87project_msolano2_tpu_torch.models.direct_dft import dft_direct

    rows = {}
    launches = {}
    ref_cache = {}
    for case in PLANNED_CASES:
        t0 = time.perf_counter()
        row, launched = planned_case(dev, rng, ref_cache, *case)
        row["s"] = time.perf_counter() - t0
        log(f"# phase 15 planned tube {case[0]}: {row['s']:.1f} s")
        rows[f"planned {case[0]}"] = row
        for name, c in launched.items():
            launches[name] = launches.get(name, 0) + c
        torch.cuda.empty_cache()
    ref_cache.clear()
    log(f"# phase 15 planned tube launches (counted, torch.fft refused): "
        f"{launches}")

    # (b) the C core on this host
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rcs = [cli_main(["-t", "-b", b]) for b in ("serial", "pthreads")]
    golden = buf.getvalue().strip().splitlines()
    for line in golden:
        log(f"# phase 15 {line}")
    allowed = sorted(os.sched_getaffinity(0))
    cap = NativeBackend("pthreads").capacity()
    cores = num_cores()
    xp = rng.standard_normal(PINNING_N) + 1j * rng.standard_normal(PINNING_N)
    workers = observed_pinning(xp, cap or 1)
    masks = sorted({tuple(m) for m in workers.values()})
    pinned = sum(len(m) == 1 for m in workers.values())
    if not workers:
        how = "no worker thread observed"
    elif pinned == len(workers):
        how = (f"every worker pinned to one core (cores "
               f"{sorted({m[0] for m in workers.values()})})")
    else:
        how = (f"{len(workers) - pinned} of {len(workers)} workers "
               f"unpinned (the core's fallback), masks {masks}")
    log(f"# phase 15 C core on {host_cpu()}: pifft_capacity(pthreads) "
        f"{cap}, pifft_num_cores {cores}, os.sched_getaffinity "
        f"{len(allowed)} cores {allowed}; observed at p={cap}, n=2^"
        f"{PINNING_N.bit_length() - 1}: {len(workers)} worker threads, "
        f"{how}; golden exits {rcs} in {time.perf_counter() - t0:.1f} s")
    rows["c_core"] = {"capacity": cap, "num_cores": cores,
                      "affinity": allowed, "workers_seen": len(workers),
                      "workers_pinned": pinned,
                      "worker_masks": [list(m) for m in masks],
                      "golden": golden}
    if rcs != [0, 0] or len(golden) != 8 or \
            any(not line.endswith("PASSED") for line in golden):
        raise AssertionError("phase 15 C core golden test failed")

    # (c) the harness on the new backends, in this process
    out = tempfile.mkdtemp(prefix="pifft-harness15-")
    sweeps = {}
    try:
        for backend, ns, ps in BACKEND_SWEEPS:
            t0 = time.perf_counter()
            err = io.StringIO()
            with contextlib.redirect_stderr(err), \
                    contextlib.redirect_stdout(io.StringIO()):
                rc = run_experiments.main(
                    ["--backends", backend, "--n-grid",
                     ",".join(map(str, ns)), "--p-grid",
                     ",".join(map(str, ps)), "-T", "3", "--verify",
                     "--seed", str(SEED), "--out", out])
            took = time.perf_counter() - t0
            path = run_experiments.result_path(out, backend)
            with open(path) as f:
                tsv = [line.rstrip("\n") for line in f]
            for line in tsv:
                log(f"# phase 15 harness tsv {backend}\t{line}")
            cap_b = NativeBackend(backend).capacity() \
                if backend in ("serial", "pthreads") else None
            cells = [(n, p) for n in ns for p in ps
                     if p <= n and (cap_b is None or p <= cap_b)]
            verified = [line for line in err.getvalue().splitlines()
                        if line.startswith(f"# {backend}: verified")]
            marked = [line for line in tsv if line.endswith("DEGRADED")]
            log(f"# phase 15 harness {backend}: exit {rc} in {took:.1f} s, "
                f"{len(tsv)} rows, {len(cells)} cells, DEGRADED rows "
                f"{len(marked)}, {verified}")
            sweeps[backend] = {"s": took, "tsv": tsv, "cells": cells}
            if (rc != 0 or len(tsv) != 3 * len(cells) or marked
                    or verified != [f"# {backend}: verified {len(cells)}/"
                                    f"{len(cells)} cells vs numpy fft "
                                    f"(0 skipped)"]):
                log(err.getvalue()[-4000:])
                raise AssertionError(f"phase 15 harness {backend} failed")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    rows["harness"] = sweeps

    # (d) BASELINE config 1: the float64 direct DFT at N = 1024
    x1 = rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
    y1 = dft_direct(x1, np.complex128)
    ref1 = np.fft.fft(x1)
    e1 = float(np.linalg.norm(y1 - ref1) / np.linalg.norm(ref1))
    log(f"# phase 15 BASELINE config 1 dft_direct N=1024 complex128: rel "
        f"L2 {e1:.3e} vs numpy.fft (bound {CONFIG1_TOL}), dtype "
        f"{y1.dtype}")
    rows["config1"] = {"rel_l2": e1}
    if not (e1 <= CONFIG1_TOL and y1.dtype == np.complex128):
        raise AssertionError("phase 15 config 1 failed")
    return rows, launches


#: phase 16, the parallel configs: the ranks of the job that share the
#: card (gloo: NCCL refuses two ranks on one GPU)
PARALLEL_WORLD = 4
#: BASELINE configs 3 (a batch of 4096 rows of 4096), 4 (the 4096^2 2-D
#: FFT) and 5 (the 512^3 slab Poisson solve) at full size
P16_ROWS = (4096, 4096)
P16_FFT2 = (4096, 4096)
P16_POISSON = (512, 512, 512)
#: pi_fft_sharded at n = 2^27 (segments of 2^25 at world 4) and
#: pi_fft_sharded_batched on the 2 x 2 mesh
P16_PI_LOGN = 27
P16_PI_BATCH = (8, 1 << 20)
#: the stall drill on every rank (the 4096^2 fft2): a deadline over the
#: healthy call's time, a stall past two deadlines
P16_DRILL = {"deadline_s": 2.0, "abort_waits": 2, "stall_s": 5.0}
#: the seeds of phase 16's inputs (made on the card, the same in every
#: process: ``p16_planes``)
P16_SEEDS = {"rows": 31, "fft2": 41, "poisson": 51, "pi": 61,
             "pi_batch": 71}
#: phase 16's sharded harness: n grid, p grid, reps
P16_HARNESS = ((1 << 20, 1 << 24), (1, 4, 16, 64), 3)
#: the slab Poisson solve vs u_true, max |u - u_true| / max |u_true|
#: (the reference test's bound)
POISSON_TOL = 1e-3


def p16_planes(dev, shape, seed):
    """Uniform planes in +-1/sqrt(n) from the card's generator: every
    process of the job makes the same ones from the seed."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + seed)
    amp = 1.0 / np.sqrt(shape[-1])
    return tuple((torch.rand(shape, generator=g, device=dev) * 2 - 1) * amp
                 for _ in range(2))


def p16_poisson_problem(dev):
    """(f, u_true) of the 512^3 solve: u_true seeded and mean-free, f =
    lap(u_true) by the torch.fft oracle in complex128 (the reference
    test's construction)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + P16_SEEDS["poisson"])
    u = torch.randn(P16_POISSON, generator=g, device=dev)
    u -= u.mean()
    ksq = None
    for ax, m in enumerate(P16_POISSON):
        k = torch.fft.fftfreq(m, 1.0 / m, dtype=torch.float64, device=dev)
        shape = [1, 1, 1]
        shape[ax] = m
        k = (k ** 2).reshape(shape)
        ksq = k if ksq is None else ksq + k
    f = torch.fft.ifftn(-ksq * torch.fft.fftn(u.to(torch.float64)))
    return f.real.to(torch.float32).contiguous(), u


def p16_counted(fn, *args):
    """(result, Hopper launches, collectives, axis copies) of one call,
    torch.fft and numpy.fft refused (``counted``)."""
    from cs87project_msolano2_tpu_torch.apps import pde
    from cs87project_msolano2_tpu_torch.parallel import collectives

    calls0, copies0 = collectives.COLLECTIVE_CALLS, pde.AXIS_COPIES
    out, launched = counted(fn, *args)
    return (out, launched, collectives.COLLECTIVE_CALLS - calls0,
            pde.AXIS_COPIES - copies0)


def p16_world1(poisson_path):
    """The world-1 NCCL job's rank (a spawned process on the card):
    configs 3, 4 and 5 through the sharded entries and their unsharded
    twins, each counted (Hopper launches, collectives, axis copies) and
    timed — the loop slope, CUDA events beside it — and each output,
    the twins' too, returned for the parent's oracles."""
    import torch

    from cs87project_msolano2_tpu_torch import plans
    from cs87project_msolano2_tpu_torch.apps.pde import poisson_solve
    from cs87project_msolano2_tpu_torch.models.fft import (
        fft2,
        fft_planes_fast,
    )
    from cs87project_msolano2_tpu_torch.parallel.batched import (
        fft_batched_planes,
    )
    from cs87project_msolano2_tpu_torch.parallel.fft2d import (
        fft2_sharded_planes,
    )
    from cs87project_msolano2_tpu_torch.parallel.mesh import make_mesh
    from cs87project_msolano2_tpu_torch.parallel.multihost import to_host
    from cs87project_msolano2_tpu_torch.parallel.poisson3d import (
        poisson_solve_sharded,
    )
    from cs87project_msolano2_tpu_torch.utils.timing import time_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(axis="p")
    mesh_d = make_mesh(axis="data")
    dev = mesh.device

    def events(fn, *args):
        return time_ms(fn, *args, reps=10, warmup=2, flush_l2=True)[0]

    def case(run, twin, args, twin_args, plan_shapes):
        run(*args)
        twin(*twin_args)
        torch.cuda.synchronize()
        out, launched, colls, copies = p16_counted(run, *args)
        twin_out, twin_launched, twin_colls, twin_copies = p16_counted(
            twin, *twin_args)
        row = {"launches": launched, "collectives": colls,
               "axis_copies": copies, "twin_launches": twin_launched,
               "twin_collectives": twin_colls, "twin_axis_copies":
               twin_copies,
               "plans": {str(s): plans.plan_for(s, device=dev).variant
                         for s in plan_shapes},
               "slope_ms": slope_ms(run, *args),
               "event_ms": events(run, *args),
               "twin_slope_ms": slope_ms(twin, *twin_args),
               "twin_event_ms": events(twin, *twin_args)}
        return row, to_host(out), to_host(twin_out)

    rows, outs = {}, {}
    xr, xi = p16_planes(dev, P16_ROWS, P16_SEEDS["rows"])
    rows["config 3"], outs["config 3"], outs["config 3 twin"] = case(
        lambda a, b: fft_batched_planes(a, b, mesh_d),
        lambda a, b: fft_planes_fast(a, b), (xr, xi), (xr, xi), [P16_ROWS])
    R, C = P16_FFT2
    xr, xi = p16_planes(dev, P16_FFT2, P16_SEEDS["fft2"])
    x = torch.complex(xr, xi)
    rows["config 4"], outs["config 4"], outs["config 4 twin"] = case(
        lambda a, b: fft2_sharded_planes(a, b, mesh),
        lambda v: fft2(v), (xr, xi), (x,), [(R, C), (C, R)])
    del xr, xi, x
    f = torch.from_numpy(np.load(poisson_path)).to(dev)
    rows["config 5"], outs["config 5"], outs["config 5 twin"] = case(
        lambda v: poisson_solve_sharded(v, mesh),
        lambda v: poisson_solve(v), (f,), (f,), [P16_POISSON])
    rows["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return rows, outs


def p16_rank(poisson_path):
    """A rank of the world-4 gloo job on the shared card: configs 3, 4
    and 5 through the sharded entries on the rank's blocks, the pi-FFT
    at 2^27 and its batched form on the 2 x 2 mesh (blocks returned for
    the parent's oracles, collectives counted); the escape of configs 4
    and 5 against the primary, bit for bit; the stall drill; the
    unhealthy report."""
    import torch

    from cs87project_msolano2_tpu_torch.parallel import collectives
    from cs87project_msolano2_tpu_torch.parallel.batched import (
        fft_batched_planes,
    )
    from cs87project_msolano2_tpu_torch.parallel.escape import (
        clear_unhealthy,
        fft2_collective_free_planes,
        poisson_solve_collective_free,
        report_unhealthy,
        stall_drill,
    )
    from cs87project_msolano2_tpu_torch.parallel.fft2d import (
        fft2_sharded_planes,
        fft2_sharded_resilient,
    )
    from cs87project_msolano2_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh2d,
    )
    from cs87project_msolano2_tpu_torch.parallel.pi_shard import (
        PLAN_SEGMENT_MIN,
        pi_fft_sharded,
        pi_fft_sharded_batched,
    )
    from cs87project_msolano2_tpu_torch.models.pi_fft import (
        resolve_tube_plan,
    )
    from cs87project_msolano2_tpu_torch import obs
    from cs87project_msolano2_tpu_torch.resilience import watchdog

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(axis="p")
    mesh_d = make_mesh(axis="data")
    mesh2 = make_mesh2d(2, 2)
    dev = mesh.device
    p, i = mesh.shape["p"], mesh.axis_index("p")
    out, rec = {}, {}

    def timed_call(label, fn, *args):
        # torch.fft and numpy.fft refused, as at world 1 (``counted``)
        torch.cuda.synchronize(dev)
        calls0 = collectives.COLLECTIVE_CALLS
        t0 = time.perf_counter()
        y, launched = counted(fn, *args)
        rec[label] = {"s": time.perf_counter() - t0,
                      "collectives": collectives.COLLECTIVE_CALLS - calls0,
                      "launches": launched}
        return y

    def rows_of(t, n_rows):
        b = n_rows // p
        return t[i * b:(i + 1) * b]

    xr, xi = p16_planes(dev, P16_ROWS, P16_SEEDS["rows"])
    y = timed_call("config 3", fft_batched_planes, rows_of(xr, P16_ROWS[0]),
                   rows_of(xi, P16_ROWS[0]), mesh_d)
    out["config 3"] = tuple(t.cpu().numpy() for t in y)
    del xr, xi, y
    xr, xi = p16_planes(dev, P16_FFT2, P16_SEEDS["fft2"])
    R = P16_FFT2[0]
    # the first call builds the plans and tables, and gloo's pairs
    fft2_sharded_planes(rows_of(xr, R), rows_of(xi, R), mesh)
    y = timed_call("config 4", fft2_sharded_planes, rows_of(xr, R),
                   rows_of(xi, R), mesh)
    e = timed_call("config 4 escape", fft2_collective_free_planes, xr, xi,
                   mesh)
    rec["config 4 escape"]["bit_identical"] = bool(
        torch.equal(y[0], e[0]) and torch.equal(y[1], e[1]))
    out["config 4"] = tuple(t.cpu().numpy() for t in y)
    x = torch.complex(xr, xi)
    del xr, xi, e
    # the unhealthy report: the doomed dispatch is skipped
    report_unhealthy(dev, "phase 16: reported by the operator")
    try:
        yu, rep = timed_call("config 4 unhealthy", fft2_sharded_resilient,
                             x, mesh)
    finally:
        clear_unhealthy()
    rec["config 4 unhealthy"].update(
        report=rep.to_record(),
        bit_identical=bool(torch.equal(yu.real, y[0])
                           and torch.equal(yu.imag, y[1])))
    del yu, y
    # the stall on every rank
    t0 = time.perf_counter()
    with obs.armed(), watchdog.recorded_kinds() as all_events:
        d, _ = counted(lambda: stall_drill("fft2", x, mesh, **P16_DRILL))
    rec["drill"] = {"s": time.perf_counter() - t0,
                    "report_ok": d["report_ok"], "report": d["report"],
                    "collectives": d["collectives"], "events": d["events"],
                    "bit_identical": bool(torch.equal(d["healthy"],
                                                      d["escaped"])),
                    "all_events": all_events}
    del d, x
    f = torch.from_numpy(np.load(poisson_path)).to(dev)
    s1 = P16_POISSON[0] // p
    from cs87project_msolano2_tpu_torch.parallel.poisson3d import (
        poisson_solve_sharded,
    )

    poisson_solve_sharded(f[i * s1:(i + 1) * s1], mesh)
    u = timed_call("config 5", poisson_solve_sharded,
                   f[i * s1:(i + 1) * s1], mesh)
    ue = timed_call("config 5 escape", poisson_solve_collective_free, f,
                    mesh)
    rec["config 5 escape"]["bit_identical"] = bool(torch.equal(u, ue))
    out["config 5"] = u.cpu().numpy()
    del f, u, ue
    torch.cuda.empty_cache()
    n = 1 << P16_PI_LOGN
    xr, xi = p16_planes(dev, (n,), P16_SEEDS["pi"])
    seg = resolve_tube_plan((n // p,), None, min_segment=PLAN_SEGMENT_MIN,
                            device=dev)
    pi_fft_sharded(xr, xi, mesh)
    y = timed_call("pi", pi_fft_sharded, xr, xi, mesh)
    rec["pi"]["plan"] = None if seg is None else [seg.variant, seg.params]
    out["pi"] = tuple(t.cpu().numpy() for t in y)
    del xr, xi, y
    torch.cuda.empty_cache()
    xr, xi = p16_planes(dev, P16_PI_BATCH, P16_SEEDS["pi_batch"])
    b = P16_PI_BATCH[0] // mesh2.shape["data"]
    d_i = mesh2.axis_index("data")
    blk = slice(d_i * b, (d_i + 1) * b)
    pi_fft_sharded_batched(xr[blk], xi[blk], mesh2)
    y = timed_call("pi batched", pi_fft_sharded_batched, xr[blk], xi[blk],
                   mesh2)
    out["pi batched"] = tuple(t.cpu().numpy() for t in y)
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    rec["coords"] = {"p": i, "data2": d_i, "seq2": mesh2.axis_index("p")}
    return rec, out


def p16_check(label, got, oracle):
    """(errors, ok) of an assembled output against its oracle (natural
    order; the pi-FFT's pi layout is gathered to natural order first):
    the transforms max |got - ref| / max |ref| <= 1e-5 and rel L2 within
    the split3 budget; the Poisson solve max |u - u_true| / max |u_true|
    (mean-free) <= POISSON_TOL."""
    import torch

    from cs87project_msolano2_tpu_torch.ops.bits import to_natural

    dev = oracle.device
    if label == "config 5":
        u = torch.from_numpy(got).to(dev)
        u = u - u.mean()
        err = float((u - oracle).abs().max() / oracle.abs().max())
        return {"rel_max": err}, err <= POISSON_TOL
    if isinstance(got, tuple):
        gr, gi = (torch.from_numpy(t).to(dev) for t in got)
        if label.startswith("pi"):
            # the pi layout to natural order on the card (the host's
            # bit-reversal table of 2^27 entries takes most of a minute)
            gr, gi = to_natural(gr, gi)
        g = torch.complex(gr, gi)
        del gr, gi
    else:
        g = torch.from_numpy(got).to(dev)
    g = g.to(torch.complex128)
    rel_max = float((g - oracle).abs().max() / oracle.abs().max())
    l2 = float(torch.linalg.vector_norm(g - oracle)
               / torch.linalg.vector_norm(oracle))
    return ({"rel_max": rel_max, "rel_l2": l2},
            rel_max <= DOMAIN_TOL and l2 <= PATH_TOL)


def phase_parallel(dev, rng):
    """Phase 16: the parallel configs on the card.  (a) A world-1 NCCL
    job (``p16_world1``): BASELINE configs 3, 4 and 5 at full size
    through ``fft_batched_planes``, ``fft2_sharded_planes`` and
    ``poisson_solve_sharded``, collectives counted (0, 4, 4 a call),
    each timed (slope and events) beside its unsharded twin
    (``fft_planes_fast``, ``models.fft.fft2``, ``apps.pde.poisson_solve``)
    with its per-shard plans and launches.  (b) A job of PARALLEL_WORLD
    gloo ranks sharing the card (``p16_rank``): the same configs, the
    pi-FFT at 2^27 and batched on the 2 x 2 mesh (no collective), the
    escape bit for bit, the unhealthy report, the stall drill.  Every
    output is assembled here and held to its oracle (``torch.fft`` in
    complex128 on the card, or u_true).  (c) The sharded harness, -T 3
    --verify, into a temporary directory.  Runs alone after
    ``buildlib.build()``.  Returns the rows; raises on any failure."""
    import torch

    from cs87project_msolano2_tpu_torch.harness import (
        run_sharded_experiments as rse,
    )
    from cs87project_msolano2_tpu_torch.parallel.multihost import spawn_local

    rows = {}
    tmp = tempfile.mkdtemp(prefix="pifft-p16-")
    try:
        t0 = time.perf_counter()
        f, u_true = p16_poisson_problem(dev)
        poisson_path = os.path.join(tmp, "poisson_f.npy")
        np.save(poisson_path, f.cpu().numpy())
        del f
        torch.cuda.empty_cache()
        log(f"# phase 16 the 512^3 problem made and saved: "
            f"{time.perf_counter() - t0:.1f} s")

        def oracle(label):
            if label == "config 5":
                return u_true
            if label == "config 3":
                xr, xi = p16_planes(dev, P16_ROWS, P16_SEEDS["rows"])
                return torch.fft.fft(torch.complex(xr, xi).to(
                    torch.complex128), dim=-1)
            if label == "config 4":
                xr, xi = p16_planes(dev, P16_FFT2, P16_SEEDS["fft2"])
                return torch.fft.fft2(torch.complex(xr, xi).to(
                    torch.complex128))
            if label == "pi":
                xr, xi = p16_planes(dev, (1 << P16_PI_LOGN,),
                                    P16_SEEDS["pi"])
                return torch.fft.fft(torch.complex(xr, xi).to(
                    torch.complex128))
            xr, xi = p16_planes(dev, P16_PI_BATCH, P16_SEEDS["pi_batch"])
            return torch.fft.fft(torch.complex(xr, xi).to(torch.complex128),
                                 dim=-1)

        def check(world, label, got, what=""):
            errs, ok = p16_check(label, got, oracle(label))
            torch.cuda.empty_cache()
            log(f"# phase 16 world {world} {label}{what}: {errs} vs the "
                f"oracle "
                f"({'u_true, bound ' + str(POISSON_TOL) if label == 'config 5' else f'torch.fft complex128, bounds {DOMAIN_TOL} max, {PATH_TOL} rel L2'})")
            if not ok:
                raise AssertionError(f"phase 16 world {world} {label}"
                                     f"{what} failed: {errs}")
            return errs

        # (a) world 1, NCCL
        t0 = time.perf_counter()
        (w1,) = spawn_local(p16_world1, 1, "nccl", "cuda", poisson_path)
        w1_rows, w1_outs = w1
        log(f"# phase 16 world 1 (nccl) job: {time.perf_counter() - t0:.1f}"
            f" s, max_memory_allocated "
            f"{w1_rows.pop('max_memory_allocated') / 2**30:.2f} GiB")
        want_colls = {"config 3": 0, "config 4": 4, "config 5": 4}
        t0 = time.perf_counter()
        for label, row in w1_rows.items():
            row["errors"] = check(1, label, w1_outs[label])
            # the unsharded twin's output is held to the same oracle
            row["twin_errors"] = check(1, label, w1_outs[label + " twin"],
                                       " (its unsharded twin)")
            log(f"# phase 16 world 1 {label}: plans {row['plans']}, "
                f"launches a call {row['launches']} (twin "
                f"{row['twin_launches']}), axis copies "
                f"{row['axis_copies']} (twin {row['twin_axis_copies']}), "
                f"COLLECTIVE_CALLS {row['collectives']} (expected "
                f"{want_colls[label]}); slope {row['slope_ms']:.4f} ms "
                f"(events {row['event_ms']:.4f}), unsharded twin slope "
                f"{row['twin_slope_ms']:.4f} (events "
                f"{row['twin_event_ms']:.4f})")
            if row["collectives"] != want_colls[label] \
                    or row["twin_collectives"] or not row["launches"]:
                raise AssertionError(f"phase 16 world 1 {label}: "
                                     f"collectives or launches wrong")
        rows["world 1"] = w1_rows
        del w1, w1_outs
        log(f"# phase 16 world 1 checks: {time.perf_counter() - t0:.1f} s")

        # (b) world PARALLEL_WORLD, gloo on the shared card
        t0 = time.perf_counter()
        ranks = spawn_local(p16_rank, PARALLEL_WORLD, "gloo", "cuda",
                            poisson_path)
        took = time.perf_counter() - t0
        recs = [r[0] for r in ranks]
        t0 = time.perf_counter()
        log(f"# phase 16 world {PARALLEL_WORLD} (gloo, one card) job: "
            f"{took:.1f} s, max_memory_allocated by rank "
            f"{[round(r['max_memory_allocated'] / 2**30, 2) for r in recs]}"
            f" GiB")
        w4 = {}
        for label in ("config 3", "config 4", "config 5", "pi"):
            parts = [r[1][label] for r in ranks]
            got = (tuple(np.concatenate([q[k] for q in parts])
                         for k in range(2))
                   if isinstance(parts[0], tuple) else np.concatenate(parts))
            w4[label] = {"errors": check(PARALLEL_WORLD, label, got),
                         "ranks": [r[label] for r in recs]}
            del got, parts
        # the 2 x 2 mesh: rank r = (d, q) holds rows block d, segment q
        blocks = [r[1]["pi batched"] for r in ranks]
        got = tuple(np.concatenate([np.concatenate(
            [blocks[d * 2 + q][k] for q in range(2)], axis=1)
            for d in range(2)]) for k in range(2))
        w4["pi batched"] = {"errors": check(PARALLEL_WORLD, "pi batched",
                                            got),
                            "ranks": [r["pi batched"] for r in recs]}
        del ranks, blocks, got
        log(f"# phase 16 world {PARALLEL_WORLD} assembly and checks: "
            f"{time.perf_counter() - t0:.1f} s")
        for label in ("config 3", "config 4", "config 5", "pi",
                      "pi batched", "config 4 escape", "config 5 escape",
                      "config 4 unhealthy"):
            rr = [r[label] for r in recs]
            log(f"# phase 16 world {PARALLEL_WORLD} {label}: seconds by "
                f"rank {[round(x['s'], 3) for x in rr]}, COLLECTIVE_CALLS "
                f"{[x['collectives'] for x in rr]}, launches (rank 0) "
                f"{rr[0]['launches']}"
                + (f", bit-identical {[x['bit_identical'] for x in rr]}"
                   if "bit_identical" in rr[0] else "")
                + (f", segment plan {rr[0]['plan']}" if "plan" in rr[0]
                   else ""))
        want = {"config 3": 0, "config 4": 4, "config 5": 4, "pi": 0,
                "pi batched": 0, "config 4 escape": 0,
                "config 5 escape": 0, "config 4 unhealthy": 0}
        for label, c in want.items():
            if [r[label]["collectives"] for r in recs] != \
                    [c] * PARALLEL_WORLD:
                raise AssertionError(f"phase 16 {label}: collectives")
        for label in ("config 4 escape", "config 5 escape",
                      "config 4 unhealthy"):
            if not all(r[label]["bit_identical"] for r in recs):
                raise AssertionError(f"phase 16 {label}: not bit-identical")
        for label in ("config 3", "config 4", "config 5", "pi",
                      "pi batched"):
            if not all(r[label]["launches"] for r in recs):
                raise AssertionError(f"phase 16 {label}: a rank launched "
                                     f"no kernel")
        # the escapes replay every block's passes: p row and p column
        # passes for the primary's one of each (fft2), 2p + 2p + 2 for
        # the solve's 2 + 2 + 2 (every pass here one plan call of the
        # same launches: 4096- and 512-point rows)
        p = PARALLEL_WORLD
        for label, primary, factor in (
                ("config 4 escape", "config 4", (p, 1)),
                ("config 4 unhealthy", "config 4", (p, 1)),
                ("config 5 escape", "config 5", (4 * p + 2, 6))):
            for r in recs:
                want = {k: v * factor[0] // factor[1]
                        for k, v in r[primary]["launches"].items()}
                if r[label]["launches"] != want:
                    raise AssertionError(
                        f"phase 16 {label}: launches {r[label]['launches']}"
                        f", expected {want} from the primary's "
                        f"{r[primary]['launches']}")
        for r in recs:
            rep = r["config 4 unhealthy"]["report"]
            if not (rep["escaped"] and rep["waits"] == 0 and
                    [t["to"] for t in rep["trail"]] == ["collective_free"]):
                raise AssertionError(f"phase 16 unhealthy report: {rep}")
        drills = [r["drill"] for r in recs]
        epochs = {d["report"]["epoch"] for d in drills}
        log(f"# phase 16 stall drill ({P16_DRILL}, every rank): seconds "
            f"{[round(d['s'], 2) for d in drills]}, healthy waits "
            f"{[d['report_ok']['waits'] for d in drills]}, aborted after "
            f"{[d['report']['waits'] for d in drills]} waits, consensus "
            f"epochs {sorted(epochs)}, trail "
            f"{drills[0]['report']['trail']}, bit-identical "
            f"{[d['bit_identical'] for d in drills]}, collectives in the "
            f"stalled run {[d['collectives'] for d in drills]}, records "
            f"{drills[0]['events']}")
        for d in drills:
            rep = d["report"]
            if (d["report_ok"]["escaped"] or not rep["escaped"]
                    or [t["to"] for t in rep["trail"]] != ["collective_free"]
                    or not d["bit_identical"] or d["collectives"]
                    or len(epochs) != 1
                    or any(k not in d["events"] for k in (
                        "collective_heartbeat", "collective_abandoned",
                        "fallback_consensus", "demotion",
                        "collective_escape_completed"))):
                raise AssertionError(f"phase 16 stall drill failed: {d}")
        w4["drill"] = drills
        rows[f"world {PARALLEL_WORLD}"] = w4
        del recs, u_true
        torch.cuda.empty_cache()

        # (c) the sharded harness
        ns, ps, reps = P16_HARNESS
        out = os.path.join(tmp, "harness")
        t0 = time.perf_counter()
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            rc = rse.main(["--n-grid", ",".join(map(str, ns)), "--p-grid",
                           ",".join(map(str, ps)), "-T", str(reps),
                           "--verify", "--world", str(PARALLEL_WORLD),
                           "--seed", str(SEED), "--out", out])
        took = time.perf_counter() - t0
        with open(rse.result_path(out)) as fh:
            tsv = [line.rstrip("\n") for line in fh]
        for line in tsv:
            log(f"# phase 16 sharded harness tsv\t{line}")
        cells = len(ns) * len(ps)
        notes = [line for line in err.getvalue().splitlines()
                 if "cross-check" in line or "verified" in line]
        marked = [line for line in tsv if line.endswith("DEGRADED")]
        log(f"# phase 16 sharded harness: exit {rc} in {took:.1f} s, "
            f"{len(tsv)} rows, {cells} cells, DEGRADED rows {len(marked)}; "
            f"{notes}")
        if (rc != 0 or len(tsv) != reps * cells or marked
                or f"# sharded: verified {cells}/{cells} cells vs numpy fft"
                not in notes):
            log(err.getvalue()[-4000:])
            raise AssertionError("phase 16 sharded harness failed")
        rows["harness"] = {"s": took, "tsv": tsv, "notes": notes}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


#: phase 17, the spectral apps: the conv/corr signal's samples (its
#: linear convolution with APPS_TAPS taps is exactly 2^24 long) and taps
APPS_N = 1 << 24
APPS_TAPS = 129
#: conv_np's linear length: 3 x 2^18 (cheapest_length keeps it: mixed
#: radix at 3 x 2^17), next_pow2 2^20
APPS_NP = 3 << 18
#: the overlap-save/add signal, and the journaled case's signal and block
APPS_OS_N = 1 << 26
APPS_JOURNAL_N, APPS_JOURNAL_BLOCK = 1 << 20, 1 << 14
#: the 1-D solve's length and pde's 512^3 grid
APPS_SOLVE_N = 1 << 22
APPS_GRID = (512, 512, 512)
#: each output against its oracle, max |got - ref| / max |ref|
APPS_TOL = 1e-5
#: the chunk sizes overlap_save_stream is fed, in turn (uneven)
APPS_CHUNKS = (1_000_003, 777_777, 3_333_331, 65_537)


def apps_oracle_conv(x, k, mode, op):
    """numpy.convolve / numpy.correlate(x, k, mode) for len(x) >=
    len(k) by torch.fft in float64 on the card (correlate is convolve
    with the kernel reversed)."""
    import torch

    la, lv = x.shape[0], k.shape[0]
    kk = k.flip(0) if op == "corr" else k
    n = la + lv - 1
    nfft = 1 << (n - 1).bit_length()
    full = torch.fft.irfft(torch.fft.rfft(x.double(), nfft)
                           * torch.fft.rfft(kk.double(), nfft), nfft)[:n]
    if mode == "same":
        return full[(lv - 1) // 2:(lv - 1) // 2 + la]
    if mode == "valid":
        return full[lv - 1:la]
    return full


def apps_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


def phase_apps(dev, rng):
    """Phase 17: the spectral apps on the card at full size (``apps``).
    conv and corr of a 2^24 - 128-sample signal with a 129-tap kernel in
    every mode; the kernel-spectrum cache (a second ``circular_conv``
    with the same kernel launches one forward transform fewer); conv_np's
    length 3 x 2^18 (mixed radix) with the meter's charge under its pow2
    control's; the metered fusion gate at 2^24; overlap-save of 2^26
    samples at ``tune_block``'s raced block (every candidate logged),
    overlap-add and the stream fed uneven chunks; the journaled kill and
    resume; ``solve_spectral_1d`` at 2^22 and ``apps.pde.poisson_solve``
    at 512^3 with its meter charge; the slope of the fused conv and of
    the solve beside the library pair; the ``apps`` CLI's smokes in
    subprocesses.  Every counted call has torch.fft and numpy.fft refused
    and its launches summed by kernel; the oracles are torch.fft in
    float64 on the card, outside the counted calls.  Returns (rows,
    launches by kernel); raises on any failure."""
    import torch

    from cs87project_msolano2_tpu_torch import obs, plans
    from cs87project_msolano2_tpu_torch.apps import cli as apps_cli
    from cs87project_msolano2_tpu_torch.apps import pde, spectral, stream
    from cs87project_msolano2_tpu_torch.utils import roofline
    from cs87project_msolano2_tpu_torch.utils.timing import time_ms

    spectral.fused_cache_clear()
    spectral.kernel_spectrum_cache_clear()
    kind = torch.cuda.get_device_name(dev)
    rows, launched, problems = {}, {}, []

    def run(label, fn, *args):
        out, got = counted(fn, *args)
        for name, c in got.items():
            launched[name] = launched.get(name, 0) + c
        rows.setdefault(label, {})["launches"] = got
        return out

    def check(label, err, bound=APPS_TOL):
        rows.setdefault(label, {})["err"] = err
        log(f"# phase 17 {label}: max |got - ref| / max |ref| {err:.3e} "
            f"(bound {bound:g}), launches {rows[label].get('launches')}")
        if not err <= bound:
            problems.append(f"{label}: {err:.3e} > {bound:g}")

    def signal(n, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + seed)
        return torch.randn(n, generator=g, device=dev)

    def metered(fn, *args):
        with obs.armed():
            before = obs.metrics.counter_value("pifft_hbm_bytes_total")
            out = fn(*args)
            return out, int(obs.metrics.counter_value(
                "pifft_hbm_bytes_total") - before)

    # conv and corr at a power-of-two length, every mode
    x = signal(APPS_N - (APPS_TAPS - 1), 1)
    k = signal(APPS_TAPS, 2)
    for op, fn in (("conv", spectral.fftconv), ("corr", spectral.fftcorr)):
        for mode in ("full", "same", "valid"):
            label = f"{op} 2^24 {mode}"
            y = run(label, fn, x, k, mode)
            check(label, apps_err(y, apps_oracle_conv(x, k, mode, op)))
            del y
    # the kernel-spectrum cache: a fresh kernel, twice, beside one
    # forward transform alone
    k2, k3 = signal(APPS_TAPS, 3), signal(APPS_TAPS, 4)
    xn = torch.nn.functional.pad(x, (0, APPS_TAPS - 1))
    with obs.armed():
        hits = obs.metrics.counter_value("pifft_apps_kspec_cache_total",
                                         result="hit")
        run("circular_conv miss", spectral.circular_conv, xn, k2)
        run("circular_conv hit", spectral.circular_conv, xn, k2)
        run("one forward transform", spectral.kernel_spectrum, k3, APPS_N)
        hits = obs.metrics.counter_value("pifft_apps_kspec_cache_total",
                                         result="hit") - hits
    miss_l, hit_l = (rows[f"circular_conv {w}"]["launches"]
                     for w in ("miss", "hit"))
    fwd_l = rows["one forward transform"]["launches"]
    saved = {name: miss_l.get(name, 0) - hit_l.get(name, 0)
             for name in set(miss_l) | set(hit_l)}
    saved = {name: c for name, c in saved.items() if c}
    log(f"# phase 17 kernel-spectrum cache: launches of a miss {miss_l}, "
        f"of a hit {hit_l}, the difference {saved}, one forward transform "
        f"{fwd_l}; cache hits {hits:g}")
    if saved != fwd_l or hits != 1:
        problems.append("the kernel-spectrum cache did not save one forward "
                        "transform")
    rows["kernel-spectrum cache"] = {"saved": saved, "forward": fwd_l}

    # conv_np: the any-length fused conv and its pow2 control, from the
    # meter
    xnp = signal(APPS_NP - (APPS_TAPS - 1), 5)
    n_np = spectral.cheapest_length(APPS_NP)
    p2 = spectral.next_pow2(APPS_NP)
    y, np_bytes = metered(run, "conv_np", spectral.fftconv, xnp, k)
    check("conv_np", apps_err(y, apps_oracle_conv(xnp, k, "full", "conv")))
    _, p2_bytes = metered(run, "conv_np pow2 control",
                          spectral.circular_conv, xnp, k, "conv", None, p2)
    plan_np = plans.plan_for((n_np,), domain="r2c", device=dev)
    rows["conv_np"].update({"n": n_np, "plan": plan_np.describe(),
                            "hbm_bytes": np_bytes, "pow2_n": p2,
                            "pow2_hbm_bytes": p2_bytes})
    log(f"# phase 17 conv_np: n {n_np} ({plan_np.variant}), metered "
        f"{np_bytes} B against the pow2 control's {p2_bytes} B at {p2}")
    if not (n_np == APPS_NP and plan_np.variant == "mixedradix"
            and np_bytes == roofline.spectral_hbm_bytes("conv", n_np)
            and 0 < np_bytes < p2_bytes):
        problems.append("conv_np's bytes gate")
    del y, xnp

    # the metered fusion gate at 2^24
    (y_f, fused_bytes) = metered(spectral.fftconv, x, k)
    (y_u, unfused_bytes) = metered(spectral.fftconv_unfused, x, k)
    floor = roofline.spectral_min_hbm_bytes("conv", APPS_N)
    agree = apps_err(y_u, y_f.double())
    rows["fusion gate"] = {"fused": fused_bytes, "unfused": unfused_bytes,
                           "floor": floor, "agree": agree}
    log(f"# phase 17 fusion gate 2^24: fused {fused_bytes} B, unfused "
        f"{unfused_bytes} B, floor {floor} B x {apps_cli.FUSED_TOL}; the "
        f"outputs agree to {agree:.3e}")
    if not (0 < fused_bytes <= floor * apps_cli.FUSED_TOL < unfused_bytes
            and agree <= APPS_TOL):
        problems.append("the fusion gate")
    del y_f, y_u

    # the fused conv at 2^24 and the 1-D solve at 2^22, beside the
    # library pair on the same data
    kr, ki = spectral.kernel_spectrum(k, APPS_N)
    fused = spectral._fused_circular("conv", APPS_N, None, dev)
    kspec = torch.complex(kr, ki)
    f = signal(APPS_SOLVE_N, 6)
    mult = torch.from_numpy(spectral.poisson_multiplier_1d(APPS_SOLVE_N)
                            ).to(dev)

    def lib_conv(v):
        return torch.fft.irfft(torch.fft.rfft(v) * kspec, APPS_N)

    def lib_solve(v):
        return torch.fft.irfft(torch.fft.rfft(v) * mult, APPS_SOLVE_N)

    timing = {}
    for label, fn, args, lib, n, op in (
            ("fused conv 2^24", fused, (xn, kr, ki), lib_conv, APPS_N,
             "conv"),
            ("solve_spectral_1d 2^22", spectral.solve_spectral_1d, (f,),
             lib_solve, APPS_SOLVE_N, "solve")):
        row = {"ms": slope_ms(fn, *args),
               "event_ms": time_ms(fn, *args, reps=REPS)[0],
               "library_ms": slope_ms(lib, args[0]),
               "library_event_ms": time_ms(lib, args[0], reps=REPS)[0]}
        row["util_of_floor"] = roofline.spectral_roofline_utilization(
            op, n, row["ms"], kind)
        row["floor_ms"] = roofline.spectral_min_hbm_bytes(op, n) \
            / roofline.peak_bytes_per_s(kind) * 1e3
        timing[label] = row
        log(f"# phase 17 time {label}: slope {row['ms']:.4f} ms (events "
            f"{row['event_ms']:.4f}), the library pair torch.fft.irfft("
            f"torch.fft.rfft(x) * K) slope {row['library_ms']:.4f} (events "
            f"{row['library_event_ms']:.4f}); fused floor "
            f"{row['floor_ms']:.4f} ms, share {row['util_of_floor']:.3f}")
    rows["timing"] = timing
    del kspec

    # the apps CLI's smokes on the card, in processes of their own while
    # the checks below run
    here = os.path.dirname(os.path.abspath(__file__))
    cli_procs = {op: subprocess.Popen(
        [sys.executable, "-m", "cs87project_msolano2_tpu_torch", "apps", op,
         "--smoke", "--json"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=here)
        for op in ("conv", "corr", "solve")}
    try:
        # overlap-save at the raced block, overlap-add, the stream
        xo = signal(APPS_OS_N, 7)
        ref_o = apps_oracle_conv(xo, k, "full", "conv")
        buf = io.StringIO()
        # the race is timed, so obs stays disarmed: each candidate's fate
        # is read from its verbose line ("block race: block=B <ms>
        # ms/chunk ..." or "... rejected ...")
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(buf):
            block = stream.tune_block(APPS_TAPS, APPS_OS_N, verbose=True)
        race_s = time.perf_counter() - t0
        fates = {}
        for line in buf.getvalue().splitlines():
            log(f"# phase 17 {line.lstrip('# ')}")
            got = re.search(r"block race: block=(\d+) (rejected|[\d.]+ "
                            r"ms/chunk)", line)
            if got:
                fate = "rejected" if got[2] == "rejected" else "timed"
                label = f"{got[1]} {fate}"
                fates[label] = fates.get(label, 0) + 1
        log(f"# phase 17 block race ({race_s:.1f} s): block {block}, fates "
            f"{fates}")
        raced = sorted(int(label.split()[0]) for label in fates)
        if raced != sorted(stream.block_candidates(APPS_TAPS, APPS_OS_N)) \
                or set(fates.values()) != {1}:
            problems.append("the block race left a candidate without a fate")
        rows["block race"] = {"block": block, "fates": fates, "s": race_s}
        for label, fn in (("overlap_save", stream.overlap_save),
                          ("overlap_add", stream.overlap_add)):
            t0 = time.perf_counter()
            y = run(label, fn, xo, k, block)
            rows[label] = {**rows[label], "block": block,
                           "chunks": stream.chunk_count(APPS_OS_N, APPS_TAPS,
                                                        block),
                           "s": time.perf_counter() - t0}
            check(label, apps_err(y, ref_o))
            del y

        def streamed():
            chunks, start, i = [], 0, 0
            while start < APPS_OS_N:
                step = APPS_CHUNKS[i % len(APPS_CHUNKS)]
                chunks.append(xo[start:start + step])
                start, i = start + step, i + 1
            pieces = list(stream.overlap_save_stream(chunks, k,
                                                     block=block))
            return torch.cat(pieces), len(chunks), len(pieces)

        (y, fed, drained) = run("overlap_save_stream", streamed)
        rows["overlap_save_stream"].update({"fed": fed, "drained": drained})
        check("overlap_save_stream", apps_err(y, ref_o))
        del y, xo, ref_o

        # the journaled kill and resume
        xj = signal(APPS_JOURNAL_N, 8)
        jdir = tempfile.mkdtemp(prefix="pifft-os-journal-")
        try:
            jp = os.path.join(jdir, "os.jsonl")
            total = stream.chunk_count(APPS_JOURNAL_N, APPS_TAPS,
                                       APPS_JOURNAL_BLOCK)
            y1, c1 = run("journaled", stream.overlap_save_journaled, xj, k,
                         jp, APPS_JOURNAL_BLOCK)
            check("journaled", apps_err(
                y1, apps_oracle_conv(xj, k, "full", "conv")))
            with open(jp, encoding="utf-8") as fh:
                lines = fh.readlines()
            kept = [ln for ln in lines
                    if f'"cell": "os:{total - 1}"' not in ln
                    and f'"cell": "os:{total - 2}"' not in ln]
            with open(jp, "w", encoding="utf-8") as fh:
                fh.writelines(kept)
                fh.write('{"cell": "os:torn')
            y2, c2 = run("journaled resume", stream.overlap_save_journaled,
                         xj, k, jp, APPS_JOURNAL_BLOCK)
            y3, c3 = stream.overlap_save_journaled(xj, k, jp,
                                                   APPS_JOURNAL_BLOCK)
            same = bool(torch.equal(y1, y2) and torch.equal(y1, y3))
        finally:
            shutil.rmtree(jdir, ignore_errors=True)
        rows["journaled"].update({"chunks": total, "computed": c1,
                                  "resumed": c2, "finished": c3,
                                  "byte_identical": same})
        log(f"# phase 17 journaled overlap-save 2^20 at block 2^14: {c1} of "
            f"{total} chunks; after dropping the last two records and a "
            f"torn line, the resume computed {c2}; a finished journal "
            f"{c3}; byte-identical {same}")
        if not (c1 == total and c2 == 2 and c3 == 0 and same):
            problems.append("the journaled resume")
        del y1, y2, y3, xj

        # the 1-D solve and pde's charge
        u = run("solve_spectral_1d 2^22", spectral.solve_spectral_1d, f)
        check("solve_spectral_1d 2^22", apps_err(u, lib_solve(f.double())))
        fg = signal(APPS_GRID[0] ** 3, 9).reshape(APPS_GRID)
        fg -= fg.mean()
        ug, solve_bytes = metered(run, "poisson_solve 512^3",
                                  pde.poisson_solve, fg)
        want = roofline.spectral_hbm_bytes("solve", fg.numel())
        finite = bool(torch.isfinite(ug).all())
        rows["poisson_solve 512^3"].update({"hbm_bytes": solve_bytes,
                                            "want": want,
                                            "finite": finite})
        log(f"# phase 17 poisson_solve 512^3: metered {solve_bytes} B, "
            f"spectral_hbm_bytes('solve', 2^27) {want} B, finite {finite}, "
            f"launches {rows['poisson_solve 512^3']['launches']}")
        if not (solve_bytes == want and finite):
            problems.append("pde's charge")
        del u, fg, ug, f
    finally:
        cli = {}
        for op, proc in cli_procs.items():
            out, err = proc.communicate(timeout=600)
            rep = json.loads(out) if proc.returncode == 0 and out else {}
            cli[op] = {"exit": proc.returncode, "checks": rep.get("checks"),
                       "device": rep.get("device")}
            log(f"# phase 17 apps {op} --smoke --json: exit "
                f"{proc.returncode}, device {rep.get('device')}, checks "
                f"{rep.get('checks')}, problems {rep.get('problems')}")
            if proc.returncode != 0 or not rep.get("ok"):
                log(err[-3000:])
                problems.append(f"apps {op} --smoke")
    rows["cli"] = cli
    log(f"# phase 17 launches (counted calls): {launched}")
    if problems:
        raise AssertionError(f"phase 17 failed: {problems}")
    return rows, launched


#: phase 18: n of the armed fft and the race, the pi-FFT's n and p, the
#: sixstep's n, the traced pi-FFT's n, and the event median's calls
OBS_N = 1 << 20
OBS_PI = (1 << 24, 8)
OBS_SIX_N = 1 << 27
OBS_TRACE = (1 << 20, 8)
OBS_REPS = 30
#: rounds of (unarmed, armed, armed, unarmed) behind the armed cost, and
#: the plan lookups a host-clock reading averages
OBS_COST_ROUNDS = 3
OBS_LOOKUPS = 2000
#: the unarmed slope against phase 7's row of the same call and plan
OBS_SLOPE_TOL = 0.05
#: the csrc kernels the traced pi-FFT's tube launches (rql over the
#: funnel's rows)
OBS_TRACE_KERNELS = ("long_range_sep_kernel", "tile_fft_rows",
                     "tile_fft_cluster")


def phase_obs(dev, rng, ref_row=None):
    """Phase 18: the telemetry layer (``obs``) on the card at full width.
    Unarmed, ``fft`` in natural order at 2^20 on the store's plan: its
    output, its loop slope (within OBS_SLOPE_TOL of phase 7's row of the
    same call and plan, `ref_row` = (slope ms, plan description), in a
    whole run) and its CUDA-event median of OBS_REPS calls.  Armed, with
    a JSONL sink and the bare telemetry server up: the same fft (output
    bit-identical, event median beside the unarmed one: the armed cost
    of a call), the pi-FFT on the cuda backend at n = 2^24, p = 8 (one
    funnel and one tube span), the static sixstep at 2^27 (one sixstep
    span with ``sixstep_blocking``'s geometry), the race of the 2^20 pi
    key (``tune(force=True, persist=False)``: one autotune span, one
    plan_tuned event, every candidate's fate; then a memory hit and a
    miss of exactly one each), the fused conv at 2^24 twice with one
    kernel (kernel-spectrum miss then hit, two spectral_op spans, the
    apps byte counter at twice the op's bytes, the roofline gauge), one
    transient fault at ``plan`` (retried, counted) and one capacity
    fault at ``tube`` (fourstep -> rql at 2^24, as phase 13), and a
    ``torch.profiler`` trace of the pi-FFT at 2^20 whose funnel/tube
    ranges hold launches of the csrc kernels.  Disarmed, the stream is
    read by ``obs validate``/``summary``/``export`` in subprocesses and
    the Chrome trace nests funnel/tube under their cell; ``bench
    --smoke --events --trace-out`` and the harness sweep with
    ``--events`` run as two more subprocesses meanwhile.  No time is
    read from the profiler.  Returns (rows, launches by kernel of the
    counted armed calls); raises on any failure."""
    import torch

    from cs87project_msolano2_tpu_torch import obs, plans
    from cs87project_msolano2_tpu_torch.apps import spectral
    from cs87project_msolano2_tpu_torch.models.fft import fft
    from cs87project_msolano2_tpu_torch.obs import export, metrics
    from cs87project_msolano2_tpu_torch.obs.http import (
        TelemetryServer,
        fetch_json,
        fetch_text,
    )
    from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
    from cs87project_msolano2_tpu_torch.plans import autotune, ladder
    from cs87project_msolano2_tpu_torch.plans.core import Plan
    from cs87project_msolano2_tpu_torch.resilience import (
        FAST_POLICY,
        call_with_retry,
        inject,
    )
    from cs87project_msolano2_tpu_torch.utils import roofline
    from cs87project_msolano2_tpu_torch.utils.timing import time_ms

    t_phase = time.perf_counter()
    rows, launched, problems = {}, {}, []
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="pifft-obs-")
    kind = torch.cuda.get_device_name(dev)

    def check(label, ok, detail):
        rows.setdefault("checks", {})[label] = bool(ok)
        log(f"# phase 18 {label}: {'ok' if ok else 'FAILED'} ({detail})")
        if not ok:
            problems.append(label)

    def run(label, fn, *args):
        out, got = counted(fn, *args)
        for name, c in got.items():
            launched[name] = launched.get(name, 0) + c
        rows.setdefault(label, {})["launches"] = got
        return out

    def events_ms(fn, *args):
        return time_ms(fn, *args, reps=OBS_REPS, warmup=3)[0]

    def lookup_us():
        # the host clock of the plan lookup every fft call makes: the one
        # thing on the call's path that obs touches (the cache counter)
        t0 = time.perf_counter()
        for _ in range(OBS_LOOKUPS):
            plans.plan_for((OBS_N,), device=dev)
        return (time.perf_counter() - t0) / OBS_LOOKUPS * 1e6

    # 1. unarmed: fft natural at 2^20 on the store's plan
    if obs.enabled():
        raise AssertionError("phase 18: obs armed before the phase")
    x = torch.complex(*random_complex(rng, (OBS_N,), dev))
    plan = plans.plan_for((OBS_N,), device=dev)
    y0 = fft(x).clone()
    unarmed = {"plan": plan.describe(), "slope_ms": slope_ms(fft, x),
               "event_ms": events_ms(fft, x)}
    rows["unarmed"] = unarmed
    log(f"# phase 18 unarmed fft natural n={OBS_N} ({plan.variant} "
        f"{plan.params}): slope {unarmed['slope_ms']:.4f} ms, CUDA-event "
        f"median of {OBS_REPS} {unarmed['event_ms']:.4f} ms")
    if ref_row is not None:
        ref_ms, ref_plan = ref_row
        if ref_plan == plan.describe():
            same = unarmed["slope_ms"]
        else:
            # phase 7 served another plan (the store had no winner then):
            # hold that plan's call, unarmed now, to its phase 7 slope
            key = plans.make_key(OBS_N, layout="natural", device=dev)
            p7 = Plan(key, ref_plan["variant"], dict(ref_plan["params"]))
            same = slope_ms(lambda z: fft(z, plan=p7), x)
        rows["vs_phase7"] = {"phase7_slope_ms": ref_ms, "slope_ms": same,
                             "plan": ref_plan}
        check("unarmed slope vs phase 7",
              abs(same - ref_ms) <= OBS_SLOPE_TOL * ref_ms,
              f"{same:.4f} ms now, {ref_ms:.4f} ms in phase 7 on "
              f"{ref_plan['variant']} {ref_plan['params']}, tolerance "
              f"{OBS_SLOPE_TOL:.0%}")

    # the armed cost of a call: unarmed and armed (the in-process
    # buffer) in turns, off on on off, OBS_COST_ROUNDS times; a call's
    # event median is host-paced and moves by tens of us between reads,
    # so one pair would measure the drift
    turns = {False: {"event_ms": [], "lookup_us": []},
             True: {"event_ms": [], "lookup_us": []}}
    for _ in range(OBS_COST_ROUNDS):
        for on in (False, True, True, False):
            if on:
                obs.enable()
            turns[on]["event_ms"].append(events_ms(fft, x))
            turns[on]["lookup_us"].append(lookup_us())
            if on:
                obs.disable()
    med = {on: {k: float(np.median(v)) for k, v in t.items()}
           for on, t in turns.items()}

    def spread(k):
        v = turns[True][k] + turns[False][k]
        return max(v) - min(v)

    cost = med[True]["lookup_us"] - med[False]["lookup_us"]
    rows["armed"] = {
        "turns": {("armed" if on else "unarmed"): t
                  for on, t in turns.items()},
        "event_ms": med[True]["event_ms"],
        "unarmed_event_ms": med[False]["event_ms"],
        # the armed cost: what obs adds to the one thing on the call's
        # path it touches, the plan lookup, on the host clock; resolved
        # only where it exceeds the spread of the turns
        "cost_us": cost,
        "lookup_spread_us": spread("lookup_us"),
        "cost_resolved": abs(cost) > spread("lookup_us"),
        # not a cost: the call's event medians are host-paced and spread
        # by far more than the lookup's cost
        "event_median_diff_us":
            (med[True]["event_ms"] - med[False]["event_ms"]) * 1e3,
        "event_median_spread_us": spread("event_ms") * 1e3}
    armed_row = rows["armed"]
    log(f"# phase 18 armed cost of a fft call at n={OBS_N}, "
        f"{OBS_COST_ROUNDS} x (off, on, on, off): the plan lookup on the "
        f"host clock armed "
        f"{sorted(round(v, 2) for v in turns[True]['lookup_us'])}, unarmed "
        f"{sorted(round(v, 2) for v in turns[False]['lookup_us'])} us: "
        f"{cost:.2f} us a call, "
        f"{'resolved' if armed_row['cost_resolved'] else 'unresolved'} "
        f"(the turns spread {armed_row['lookup_spread_us']:.2f} us); "
        f"CUDA-event medians of {OBS_REPS} calls armed "
        f"{sorted(turns[True]['event_ms'])}, unarmed "
        f"{sorted(turns[False]['event_ms'])} ms differ by "
        f"{armed_row['event_median_diff_us']:.2f} us, unresolved: they "
        f"spread {armed_row['event_median_spread_us']:.2f} us")

    # 2. armed: the sink, the live plane, and each call once
    epath = os.path.join(tmp, "events.jsonl")
    rid = obs.enable(events_path=epath)
    server = TelemetryServer(None, host="127.0.0.1", port=0).start()
    procs = {}
    try:
        y1 = fft(x)
        check("armed fft bit-identical", torch.equal(y0, y1),
              f"max |armed - unarmed| "
              f"{float((y1 - y0).abs().max()):.3e}")
        del y0, y1
        # 4. the bench and the harness with --events, meanwhile (after
        # the timed reads above: the card is shared)
        bench_e = os.path.join(tmp, "bench.jsonl")
        bench_t = os.path.join(tmp, "bench-trace.json")
        sweep_e = os.path.join(tmp, "sweep.jsonl")
        procs["bench"] = subprocess.Popen(
            [sys.executable, "-m", "cs87project_msolano2_tpu_torch.bench",
             "--smoke", "--events", bench_e, "--trace-out", bench_t],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=here)
        procs["sweep"] = subprocess.Popen(
            [sys.executable, "-m",
             "cs87project_msolano2_tpu_torch.harness.run_experiments",
             "--backends", "cuda", "--n-grid", str(OBS_N), "--p-grid",
             "1,8", "-T", "1", "--verify", "--events", sweep_e, "--out",
             os.path.join(tmp, "sweep")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=here)

        def spans_named(name, since):
            return [s for s in obs.events.span_snapshot()[since:]
                    if s["name"] == name]

        # the pi-FFT on the cuda backend at 2^24, p = 8
        n, p = OBS_PI
        xr, xi = random_complex(rng, (n,), dev)
        mark = len(obs.events.span_snapshot())
        with obs.span("cell", cell={"name": "pi_fft", "n": n}):
            run("pi_fft cuda", cf.pi_fft_pi_layout_cuda, xr, xi, p)
        got = {name: [s.get("cell") for s in spans_named(name, mark)]
               for name in ("funnel", "tube")}
        check("pi_fft spans", got == {"funnel": [{"n": n, "p": p}],
                                      "tube": [{"n": n, "p": p}]},
              f"{got}, launches {rows['pi_fft cuda']['launches']}")
        del xr, xi

        # the static sixstep at 2^27, pi layout
        xr, xi = random_complex(rng, (OBS_SIX_N,), dev)
        mark = len(obs.events.span_snapshot())
        with obs.span("cell", cell={"name": "sixstep", "n": OBS_SIX_N}):
            run("sixstep 2^27", cf.fft_pi_layout_cuda_sixstep, xr, xi)
        six = spans_named("sixstep", mark)
        tile, r1, r2, cb1, cb2 = cf.sixstep_blocking(OBS_SIX_N, None, None,
                                                     None, None)
        want = {"cell": {"n": OBS_SIX_N, "r1": r1, "r2": r2},
                "args": {"tile": tile, "cb1": cb1, "cb2": cb2}}
        check("sixstep span", len(six) == 1 and all(
            six[0].get(k) == v for k, v in want.items()),
            f"{[{k: s.get(k) for k in want} for s in six]} vs "
            f"sixstep_blocking {want}")
        del xr, xi

        # the race of the 2^20 pi key, then the cache's hit and miss
        key = plans.make_key(OBS_N, layout="pi", device=dev)
        cands = ladder.candidates(key)
        mark = len(obs.events.span_snapshot())
        seq0 = obs.events._STATE.seq
        with obs.span("cell", cell={"name": "race", "n": OBS_N}):
            tuned = autotune.tune(key, force=True, persist=False,
                                  verbose=False, device=dev)
        fates = {k: int(v) for k, v in metrics.snapshot()["counters"].items()
                 if k.startswith("pifft_autotune_candidates_total{")}
        tuned_ev = [e for e in obs.snapshot() if e["seq"] >= seq0
                    and e["kind"] == "plan_tuned"]
        rows["race"] = {"winner": tuned.describe(), "fates": fates}
        check("race span, event and fates",
              len(spans_named("autotune", mark)) == 1
              and len(tuned_ev) == 1
              and sum(fates.values()) == len(cands),
              f"{len(spans_named('autotune', mark))} autotune span(s), "
              f"{len(tuned_ev)} plan_tuned event(s), fates {fates} over "
              f"{len(cands)} candidates, winner {tuned.variant} "
              f"{tuned.params}")

        def cache_counts():
            return (metrics.counter_value("pifft_plan_cache_hits_total",
                                          level="memory"),
                    metrics.counter_value("pifft_plan_cache_misses_total"))

        hits0, misses0 = cache_counts()
        plans.plan_for((OBS_N,), layout="pi", device=dev)
        hits1, misses1 = cache_counts()
        plans.plan_for((3, 1 << 11), layout="pi", device=dev)
        hits2, misses2 = cache_counts()
        check("plan cache hit and miss",
              (hits1 - hits0, misses1 - misses0, hits2 - hits1,
               misses2 - misses1) == (1, 0, 0, 1),
              f"memory hits +{hits1 - hits0:g} then +{hits2 - hits1:g}, "
              f"misses +{misses1 - misses0:g} then +{misses2 - misses1:g}")
        text = fetch_text(server.url("/metrics"))
        health = fetch_json(server.url("/healthz"))
        check("telemetry server",
              "pifft_plan_cache_hits_total" in text
              and "pifft_plan_cache_misses_total" in text
              and health.get("ok") and health.get("run") == rid,
              f"/metrics {len(text.splitlines())} lines, /healthz {health}")

        # the fused conv at 2^24, twice with one kernel
        spectral.kernel_spectrum_cache_clear()
        xc = torch.randn(APPS_N - (APPS_TAPS - 1), device=dev)
        kc = torch.randn(APPS_TAPS, device=dev)
        mark = len(obs.events.span_snapshot())
        kspec = {r: metrics.counter_value("pifft_apps_kspec_cache_total",
                                          result=r) for r in ("miss", "hit")}
        conv0 = metrics.counter_value("pifft_apps_hbm_bytes_total",
                                      op="conv")
        with obs.span("cell", cell={"name": "conv", "n": APPS_N}):
            run("conv 2^24 miss", spectral.fftconv, xc, kc)
            kspec_miss = {r: metrics.counter_value(
                "pifft_apps_kspec_cache_total", result=r) - kspec[r]
                for r in ("miss", "hit")}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run("conv 2^24 hit", spectral.fftconv, xc, kc)
            end.record()
            end.synchronize()
        conv_ms = start.elapsed_time(end)
        kspec_hit = {r: metrics.counter_value(
            "pifft_apps_kspec_cache_total", result=r) - kspec[r]
            - kspec_miss[r] for r in ("miss", "hit")}
        conv_bytes = metrics.counter_value("pifft_apps_hbm_bytes_total",
                                           op="conv") - conv0
        util = roofline.spectral_roofline_utilization("conv", APPS_N,
                                                      conv_ms, kind)
        gauges = {k: v for k, v in metrics.snapshot()["gauges"].items()
                  if k.startswith("pifft_roofline_util{")
                  and 'op="conv"' in k}
        rows["conv"] = {"kspec_first": kspec_miss, "kspec_second": kspec_hit,
                        "bytes": conv_bytes, "ms": conv_ms, "util": util,
                        "gauges": gauges}
        check("conv spans, cache and bytes",
              kspec_miss == {"miss": 1, "hit": 0}
              and kspec_hit == {"miss": 0, "hit": 1}
              and len(spans_named("spectral_op", mark)) == 2
              and conv_bytes == 2 * roofline.spectral_hbm_bytes(
                  "conv", APPS_N)
              and util is not None and util in gauges.values(),
              f"kernel spectra {kspec_miss} then {kspec_hit}, "
              f"{len(spans_named('spectral_op', mark))} spectral_op spans, "
              f"{conv_bytes:g} B vs 2 x {roofline.spectral_hbm_bytes('conv', APPS_N)}"
              f" B, roofline util {util} (CUDA events {conv_ms:.3f} ms), "
              f"gauge {gauges}")
        del xc, kc

        # one transient fault at plan, one capacity fault at tube
        xr, xi = random_complex(rng, (OBS_N,), dev)
        pl = plans.plan_for((OBS_N,), device=dev)
        with inject("plan", "transient", count=1) as spec:
            call_with_retry(pl.execute, xr, xi, policy=FAST_POLICY,
                            label="phase 18 transient")
        retries = metrics.counter_value("pifft_retries_total",
                                        kind="transient")
        retry_ev = [e for e in obs.snapshot() if e["kind"] == "retry"]
        check("transient retry", spec.fired == 1 and retries == 1
              and len(retry_ev) == 1,
              f"fired {spec.fired}, pifft_retries_total{{kind=transient}} "
              f"{retries:g}, retry events {len(retry_ev)}")
        del xr, xi
        n4 = 1 << 24
        k4 = plans.make_key(n4, layout="natural", device=dev)
        p4 = Plan(k4, *ladder.static_default(k4), source="static",
                  device=str(dev))
        xr, xi = random_complex(rng, (n4,), dev)
        with inject("tube", "capacity", count=1) as spec:
            p4.execute(xr, xi)
            torch.cuda.synchronize()
        demoted = {k: int(v) for k, v in
                   metrics.snapshot()["counters"].items()
                   if k.startswith("pifft_demotions_total{")}
        demo_ev = [e["payload"] for e in obs.snapshot()
                   if e["kind"] == "demotion"]
        check("capacity demotion",
              spec.fired == 1 and p4.variant == "fourstep"
              and demoted == {'pifft_demotions_total{to="rql"}': 1}
              and [(d["from"], d["to"]) for d in demo_ev]
              == [("fourstep", "rql")],
              f"fired {spec.fired}, {p4.variant} -> "
              f"{[d['to'] for d in p4.demotions]}, counters {demoted}, "
              f"events {[(d['from'], d['to']) for d in demo_ev]}")
        del xr, xi, p4

        # the torch.profiler trace of the pi-FFT at 2^20, p = 8
        n, p = OBS_TRACE
        xr, xi = random_complex(rng, (n,), dev)
        tdir = os.path.join(tmp, "profile")
        with obs.span("cell", cell={"name": "profile", "n": n}):
            cf.pi_fft_pi_layout_cuda(xr, xi, p)  # warm: tables, launch
            torch.cuda.synchronize()
            with obs.profiler.trace(tdir):
                # a session's first records can go missing in a long
                # process: one-byte fills open it
                for _ in range(3):
                    torch.zeros(1, device=dev).fill_(1)
                torch.cuda.synchronize()
                cf.pi_fft_pi_layout_cuda(xr, xi, p)
                torch.cuda.synchronize()
        rows["profile"] = obs_trace_check(tdir, check)
        del xr, xi
        # the stream's last word, then the Chrome trace of its spans
        obs.emit("metrics", snapshot=metrics.snapshot())
        obs.flush()
        chrome = os.path.join(tmp, "trace.json")
        export.write_chrome_trace(chrome)
    finally:
        server.stop()
        obs.disable()
        plans.cache.clear(memory=True)
    check("telemetry server stopped", server._thread is None,
          f"port {server.port} released")

    # 3. disarmed: the stream read back in subprocesses
    cli = [sys.executable, "-m", "cs87project_msolano2_tpu_torch", "obs"]
    readers = {
        "validate": subprocess.Popen(cli + ["validate", "--events", epath],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     cwd=here),
        "summary": subprocess.Popen(cli + ["summary", "--events", epath,
                                           "--json"],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    cwd=here),
        "prom": subprocess.Popen(cli + ["export", "--format", "prom",
                                        "--events", epath],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 cwd=here)}
    outs = {name: (proc.communicate(timeout=300), proc.returncode)
            for name, proc in readers.items()}
    (vout, verr), vrc = outs["validate"]
    check("obs validate", vrc == 0, f"exit {vrc}: {vout.strip()} "
          f"{verr.strip()[-500:]}")
    (sout, serr), src = outs["summary"]
    summary = json.loads(sout) if src == 0 else {}
    want_spans = {"cell", "funnel", "tube", "sixstep", "autotune",
                  "spectral_op"}
    counters = summary.get("metrics", {}).get("counters", {})
    want_series = ('pifft_plan_cache_hits_total{level="memory"}',
                   "pifft_plan_cache_misses_total",
                   'pifft_apps_kspec_cache_total{result="hit"}',
                   'pifft_apps_kspec_cache_total{result="miss"}',
                   'pifft_apps_ops_total{op="conv"}',
                   'pifft_apps_hbm_bytes_total{op="conv"}',
                   "pifft_hbm_bytes_total", "pifft_hbm_min_bytes_total",
                   'pifft_retries_total{kind="transient"}',
                   'pifft_demotions_total{to="rql"}')
    rows["summary"] = {"kinds": summary.get("kinds"),
                       "spans": sorted(summary.get("spans", {})),
                       "runs": summary.get("runs")}
    check("obs summary",
          src == 0 and want_spans <= set(summary.get("spans", {}))
          and all(s in counters for s in want_series)
          and any(k.startswith("pifft_autotune_candidates_total{")
                  for k in counters)
          and summary.get("runs") == [rid],
          f"exit {src}, spans {sorted(summary.get('spans', {}))}, kinds "
          f"{summary.get('kinds')}, missing counters "
          f"{[s for s in want_series if s not in counters]}")
    (pout, perr), prc = outs["prom"]
    bad = []
    for line in pout.splitlines():
        if line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
            float(value)
        except ValueError:
            bad.append(line)
    check("obs export --format prom", prc == 0 and pout and not bad,
          f"exit {prc}, {len(pout.splitlines())} lines, unparsed {bad[:3]}")
    with open(chrome) as fh:
        evs = json.load(fh)["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    cells = [e for e in xs if e["name"] == "cell"]
    phases = [e for e in xs if e["name"] in ("funnel", "tube")]
    nested = [ph for ph in phases if ph["args"].get("parent") == "cell"
              and any(c["tid"] == ph["tid"] and c["ts"] <= ph["ts"]
                      and ph["ts"] + ph["dur"] <= c["ts"] + c["dur"] + 1e-3
                      for c in cells)]
    check("chrome trace nests funnel/tube under their cell",
          phases and len(nested) == len(phases),
          f"{len(nested)} of {len(phases)} funnel/tube spans inside a cell")

    # 4. the two subprocesses started in step 2
    outs = {}
    for name, proc in procs.items():
        outs[name], err = proc.communicate(timeout=600)
        rows.setdefault(name, {})["exit"] = proc.returncode
        if proc.returncode != 0:
            log(err[-3000:])
    bench_ok = procs["bench"].returncode == 0
    rec = json.loads(outs["bench"].strip().splitlines()[-1]) \
        if bench_ok else {}
    brecs, bdropped = obs.events.load_events(bench_e) \
        if os.path.exists(bench_e) else ([], 0)
    bspans = export.spans_from_events(brecs)

    def probed(cell):
        # the cell's funnel and tube probe: inside it on its thread
        return {s["name"] for s in bspans
                if s["name"] in ("funnel", "tube")
                and s["tid"] == cell["tid"] and s.get("parent") == "cell"
                and cell["ts_s"] <= s["ts_s"]
                and s["ts_s"] + s["dur_s"] <= cell["ts_s"] + cell["dur_s"]
                + 1e-6}

    bcells = [s for s in bspans if s["name"] == "cell"
              and s["cell"]["name"] != "library"]
    unprobed = [c["cell"]["name"] for c in bcells
                if probed(c) != {"funnel", "tube"}]
    rows["bench"].update({"events": len(brecs), "cells": len(bcells),
                          "run": rec.get("run"), "unprobed": unprobed})
    check("bench --smoke --events --trace-out",
          bench_ok and brecs and not bdropped
          and export.validate_stream(brecs) == []
          and all(e["run"] == rec.get("run") for e in brecs)
          and brecs[-1]["kind"] == "metrics"
          and os.path.exists(bench_t) and bcells and not unprobed,
          f"exit {procs['bench'].returncode}, {len(brecs)} events, run "
          f"{rec.get('run')}, last {brecs[-1]['kind'] if brecs else None}, "
          f"{len(bcells)} transform cell spans, without the funnel/tube "
          f"probe {unprobed}")
    srecs, _ = obs.events.load_events(sweep_e) \
        if os.path.exists(sweep_e) else ([], 0)
    cells_ev = [e for e in srecs if e["kind"] == "sweep_cell"]
    prog = [e["payload"] for e in srecs if e["kind"] == "sweep_progress"]
    check("harness --events",
          procs["sweep"].returncode == 0 and len(cells_ev) == 2
          and prog and prog[-1]["eta_s"] == 0
          and export.validate_stream(srecs) == [],
          f"exit {procs['sweep'].returncode}, {len(cells_ev)} sweep_cell "
          f"events, last sweep_progress {prog[-1] if prog else None}")
    shutil.rmtree(tmp, ignore_errors=True)
    rows["seconds"] = time.perf_counter() - t_phase
    log(f"# phase 18 launches (counted armed calls): {launched}; armed "
        f"cost of a call {rows['armed']['cost_us']:.2f} us on the plan "
        f"lookup's host clock ("
        f"{'' if rows['armed']['cost_resolved'] else 'un'}resolved, the "
        f"turns spread {rows['armed']['lookup_spread_us']:.2f} us; "
        f"CUDA-event medians "
        f"{rows['armed']['event_ms']:.4f} armed, "
        f"{rows['armed']['unarmed_event_ms']:.4f} ms unarmed, spreading "
        f"{rows['armed']['event_median_spread_us']:.2f} us); the phase "
        f"{rows['seconds']:.1f} s")
    for name in ("tile_fft", "long_range_sep", "sixstep"):
        if not launched.get(name):
            problems.append(f"phase 18 never launched {name}")
    if problems:
        raise AssertionError(f"phase 18 failed: {problems}")
    return rows, launched


def obs_trace_check(tdir, check) -> dict:
    """Phase 18's reading of its ``torch.profiler`` trace (no time read):
    the funnel/tube ``record_function`` ranges, the csrc kernels' device
    events, and a kernel launch inside the tube range on the host
    timeline."""
    files = [f for f in os.listdir(tdir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(tdir, files[0])) as fh:
        evs = json.load(fh)["traceEvents"]
    ranges = [e for e in evs if e.get("cat") == "user_annotation"
              and e.get("name") in ("funnel", "tube")]
    kernels = sorted({k for e in evs if e.get("cat") == "kernel"
                      for k in OBS_TRACE_KERNELS if k in e.get("name", "")})
    launches = [e for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "aunch" in e.get("name", "")]
    tubes = [e for e in ranges if e["name"] == "tube"]
    inside = [e for e in launches for t in tubes
              if t["ts"] <= e["ts"] <= t["ts"] + t.get("dur", 0)]
    names = sorted({e["name"] for e in ranges})
    check("profiler trace",
          len(files) == 1 and names == ["funnel", "tube"]
          and "long_range_sep_kernel" in kernels
          and ({"tile_fft_rows", "tile_fft_cluster"} & set(kernels))
          and inside,
          f"{files}: ranges {names}, csrc kernels {kernels}, "
          f"{len(launches)} launches, {len(inside)} inside the tube range")
    return {"ranges": names, "kernels": kernels,
            "launches_in_tube": len(inside)}


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
    from cs87project_msolano2_tpu_torch.ops.bits import to_natural
    from cs87project_msolano2_tpu_torch.hw import lowering
    from cs87project_msolano2_tpu_torch.ops.twiddle import (
        dense_long_range_tables,
        device_factors,
        device_funnel_b,
        device_funnel_b2_tiles,
        device_funnel_b_tiles,
        device_funnel_factors,
        flat_tables,
    )
    from cs87project_msolano2_tpu_torch.plans.core import Plan
    from cs87project_msolano2_tpu_torch.utils import buildlib, roofline, verify
    from cs87project_msolano2_tpu_torch.utils.timing import FLUSH_BYTES, time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    kind = torch.cuda.get_device_name(0)
    clock = PhaseClock()
    # no plan of phases 1-12 may demote: watched until phase 13
    memoize = watch_demotions()

    def bound_ms(nbytes, flops, bf16_flops=0):
        return roofline.bound_ms(nbytes, flops, kind, bf16_flops)

    clock.start("phase 1")
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    clock.start("phase 2")
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
                    or "spill" in line or "Compiling entry" in line:
                log(f"# ptxas {line.strip()}")

    clock.start("phase 3")
    # phase 3: each kernel vs its plain version at the main path's shapes
    R, T = 64, 1 << 14
    cases = {}

    def check_kernel(label, kernel, plain, args, tol=KERNEL_TOL):
        yk = kernel(*args)
        yp = plain(*args)
        torch.cuda.synchronize()
        if yk[0].dtype != args[0].dtype:
            raise AssertionError(f"{label} returned {yk[0].dtype} for "
                                 f"{args[0].dtype} planes")
        # bf16 planes are compared in float32 (exact upcasts)
        k = torch.complex(yk[0].float(), yk[1].float())
        p = torch.complex(yp[0].float(), yp[1].float())
        err = rel_l2(k, p)
        mabs = max_abs(k, p)
        log(f"# phase 3 {label}: rel L2 {err:.3e} (limit {tol:g}), max abs "
            f"{mabs:.3e} vs plain")
        if not err <= tol:
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
    xr, xi = random_complex(rng, (128, T // 2), dev)
    check_kernel("tile_fft(128,8192)", cf.tile_fft, cf.tile_fft_plain,
                 (xr, xi, *flat_tables(T // 2, dev)))
    # tile_fft at every tile (every first-pass radix, blocks of several
    # short rows) with its automatic blocking, and the long rows at each
    # cluster width the row count picks
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile_blocks = {}
    for k in range(1, 15):
        tile = 1 << k
        rows = TILE_CHECK_POINTS // tile
        tile_blocks[tile] = cf.tile_blocking(rows, tile, sms)
        xt = random_complex(rng, (rows, tile), dev)
        label = f"tile_fft({rows},{tile}) auto {tile_blocks[tile]}"
        check_kernel(label, cf.tile_fft, cf.tile_fft_plain,
                     (*xt, *flat_tables(tile, dev)))
        cases[label].pop("args")
    # the row counts at 2^13 and 2^14 that give a blocking not checked
    # yet (the main path's 64 x 2^14 and 128 x 2^13 above, the
    # 2^22-point checks just run): one check for each blocking
    checked = {(T, cf.tile_blocking(R, T, sms)),
               (T // 2, cf.tile_blocking(128, T // 2, sms)),
               (T, tile_blocks[T]), (T // 2, tile_blocks[T // 2])}
    for tile in (1 << 13, 1 << 14):
        by_blocking = {}
        for rows in TILE_CLUSTER_ROWS:
            auto = cf.tile_blocking(rows, tile, sms)
            if (tile, auto) not in checked:
                by_blocking.setdefault(auto, rows)
        for auto, rows in by_blocking.items():
            tile_blocks[f"{rows}x{tile}"] = auto
            xt = random_complex(rng, (rows, tile), dev)
            label = f"tile_fft({rows},{tile}) auto {auto}"
            check_kernel(label, cf.tile_fft, cf.tile_fft_plain,
                         (*xt, *flat_tables(tile, dev)))
            cases[label].pop("args")
    del xt
    log(f"# phase 3 tile_fft automatic (block_rows, cw) by tile on "
        f"{sms} SMs: {tile_blocks}")
    fac = device_factors(R, T, dev)
    xr3, xi3 = random_complex(rng, (1, R, T), dev)
    check_kernel("long_range_sep(1,64,16384)",
                 lambda *a: cf.long_range_sep(*a, cf.DEFAULT_CB),
                 cf.long_range_sep_plain, (xr3, xi3, *fac))
    # long_range_sep across R (every pass split, 2 .. 8192) and cb (2 ..
    # 32), batches above 1: rql at 2^22 and 2^24, tube_cuda's segments
    # at p = 4
    for batch, rr, cc, cb in LONG_RANGE_CHECKS:
        xl = random_complex(rng, (batch, rr, cc), dev, rr * cc)
        label = f"long_range_sep({batch},{rr},{cc}) cb={cb}"
        check_kernel(label, lambda *a, cb=cb: cf.long_range_sep(*a, cb),
                     cf.long_range_sep_plain,
                     (*xl, *device_factors(rr, cc, dev)))
        if (batch, rr, cc) not in LONG_RANGE_TIMED:
            cases[label].pop("args")
    del xl
    # the large-n path's kernels at its blocking: fourstep at every
    # automatic blocking from n = 2^21 to 2^25 and at the race's half
    # tile from 2^21 to 2^24, in both twiddle modes, its persistent grid
    # from the occupancy API; sixstep at n = 2^27 (work items outnumber
    # the persistent grid)
    four_grid = {}
    for k, tile_k in FOURSTEP_CHECKS:
        tk, Rk, cbk = cf.fourstep_blocking(1 << k, tile_k)
        xk = random_complex(rng, (Rk, tk), dev, Rk * tk)
        for separable in (True, False):
            lr = device_factors if separable else dense_long_range_tables
            label = f"fourstep({Rk},{tk})" + ("" if separable else "-dense")
            check_kernel(label,
                         lambda *a, s=separable: cf.fourstep(*a,
                                                             separable=s),
                         lambda *a, s=separable: cf.fourstep_plain(
                             *a, separable=s),
                         (*xk, *lr(Rk, tk, dev), *flat_tables(tk, dev)))
            if k not in (22, 24) or tk != 1 << 14 or not separable:
                cases[label].pop("args")
        resident = cf.fourstep_resident_blocks(dev, 1 << k, tk)
        four_grid[f"2^{k} tile {tk}"] = {
            "cb": cbk, "cw": cf.row_cluster_width(tk),
            "smem_bytes": cf.fourstep_smem_bytes(Rk, cbk, tk),
            "resident_blocks": resident, "per_sm": resident / sms}
        del xk
    t4, R4, cb4 = cf.fourstep_blocking(1 << 24)
    label4 = f"fourstep({R4},{t4})"
    log(f"# phase 3 fourstep blocking and persistent grid (occupancy API) "
        f"by n: {four_grid}")
    # sixstep at n = 2^25 and 2^27 (its automatic blocking), separable
    # and dense twiddles
    six = {}
    for k in (25, 27):
        t6, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << k)
        xr6, xi6 = random_complex(rng, (R1, R2, t6), dev, R1 * R2 * t6)
        label6 = f"sixstep({R1},{R2},{t6})"
        six[k] = {"label": label6, "blocking": (R1, R2, cb1, cb2),
                  "cw": cf.row_cluster_width(t6)}
        check_kernel(label6, lambda *a, c1=cb1, c2=cb2: cf.sixstep(
                         *a, cb1=c1, cb2=c2),
                     cf.sixstep_plain,
                     (xr6, xi6, *device_factors(R1, R2 * t6, dev),
                      *device_factors(R2, t6, dev), twr14, twi14))
        check_kernel(f"sixstep-dense({R1},{R2},{t6})",
                     lambda *a: cf.sixstep(*a, separable=False),
                     lambda *a: cf.sixstep_plain(*a, separable=False),
                     (xr6, xi6, *dense_long_range_tables(R1, R2 * t6, dev),
                      *dense_long_range_tables(R2, t6, dev), twr14, twi14))
        cases[f"sixstep-dense({R1},{R2},{t6})"].pop("args")
        del xr6, xi6
    label6 = six[27]["label"]
    log(f"# phase 3 blocking: fourstep R={R4} cb={cb4}; sixstep "
        + "; ".join(f"2^{k} R1, R2, cb1, cb2 = {v['blocking']}, phase-B2 "
                    f"cluster {v['cw']}" for k, v in six.items()))
    # the tuned path's kernels: the dense long-range pass and the
    # two-kernel composition at n = 2^20, fused in both alias modes at
    # n = 2^20, and the dense modes of fourstep and sixstep at n = 2^22
    dense = dense_long_range_tables(R, T, dev)
    check_kernel("long_range_dense(1,64,16384)",
                 lambda *a: cf.long_range_dense(*a, cf.DEFAULT_CB),
                 cf.long_range_dense_plain, (xr3, xi3, *dense))
    # the dense kernel on long_range_sep's shapes: the same passes (both
    # KMAX, every first-pass split, cb 2 .. 32) with the dense tables
    for batch, rr, cc, cb in LONG_RANGE_CHECKS:
        xl = random_complex(rng, (batch, rr, cc), dev, rr * cc)
        label = f"long_range_dense({batch},{rr},{cc}) cb={cb}"
        check_kernel(label, lambda *a, cb=cb: cf.long_range_dense(*a, cb),
                     cf.long_range_dense_plain,
                     (*xl, *dense_long_range_tables(rr, cc, dev)))
        cases[label].pop("args")
    del xl
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

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def kernel_name(key):
        # a profiler kernel name without namespace, template arguments
        # and parameters; " bf16" for a bf16 storage instantiation
        k = key.replace("(anonymous namespace)::", "").replace("void ", "")
        return k.split("<")[0].split("(")[0].strip() + (
            " bf16" if "bfloat16" in key else "")

    def kernel_ms(prof):
        # {profiler kernel key: (device ms summed, launches seen)} of a
        # profile's CUDA kernels, the one-byte fills (pad, flush) left out
        seen = {}
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA or \
                    PAD_KEY in ev.key:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            ms, count = seen.get(ev.key, (0.0, 0))
            seen[ev.key] = (ms + us / 1e3, count + ev.count)
        return seen

    pad = torch.empty(1, dtype=torch.uint8, device=dev)

    def profiled(fn, *args, reps=1, flush_l2=False, cpu=False):
        # ({kernel key: (ms, launches)}, wall ms) of `reps` calls in one
        # torch.profiler session, or (None, None).  The profiler loses the
        # first records of a session, more of them the longer the process
        # has launched kernels (on the H100: a one-call session saw no
        # kernel from phase 7 on), so the session opens with PROFILE_PAD
        # one-byte fills that take the loss; a session that kept none of
        # them is read again with four times as many
        npad = PROFILE_PAD
        acts = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * cpu
        for _ in range(3):
            with profile(activities=acts) as prof:
                for _ in range(npad):
                    pad.fill_(0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    if flush_l2:
                        flush.fill_(1)
                    fn(*args)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            fills = sum(ev.count for ev in prof.key_averages()
                        if ev.device_type == torch.autograd.DeviceType.CUDA
                        and PAD_KEY in ev.key)
            if fills > reps * flush_l2:
                return kernel_ms(prof), wall_ms
            npad *= 4
        return None, None

    def device_ms(fn, *args, reps=REPS, by_kernel=False, flush_l2=True):
        # the card's time per call from torch.profiler, the kernels alone
        # (the host's launch gaps do not move it): each kernel's mean time
        # a launch over `reps` calls, the L2 flushed before each (unless
        # flush_l2 is False), times its launches a call (those of one call
        # profiled alone, or of the `reps` calls over reps where that is
        # more).  A session's sum over calls is not read, so a record the
        # profiler loses moves neither.  None where it kept none (not
        # measured).  With by_kernel, (ms, {kernel: [ms a launch, launches
        # a call]})
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        one = profiled(fn, *args)[0]
        many = profiled(fn, *args, reps=reps, flush_l2=flush_l2)[0]
        if one is None or many is None:
            one = {}
        kernels = {}
        for key, (ms, c) in one.items():
            ms_r, c_r = many.get(key, (ms * reps, c * reps))
            launches = max(c, round(c_r / reps))
            t, n = kernels.get(kernel_name(key), (0.0, 0))
            kernels[kernel_name(key)] = (t + ms_r / c_r * launches,
                                         n + launches)
        total = sum(t for t, _ in kernels.values()) or None
        if not by_kernel:
            return total
        return total, {k: [t / n, n] for k, (t, n) in kernels.items()}

    def rql_device_ms(flush_l2):
        _, by_kernel = device_ms(cf.fft_pi_layout_cuda_rql, x2r, x2i,
                                 flush_l2=flush_l2, by_kernel=True)
        ms = sum(t * c for k, (t, c) in by_kernel.items()
                 if "long_range" in k or "tile_fft" in k)
        if not ms:
            raise AssertionError("the profiler saw no rql kernel")
        return ms

    def rql_reading():
        reading = {"set_aside_bytes": cf.persisting_l2_set_aside(dev)}
        for cold in (True, False):
            reading[f"rql_device_ms_flush_{cold}"] = rql_device_ms(cold)
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
    # version, summed in another order; B's planes cut and tiled once per
    # mode
    from cs87project_msolano2_tpu_torch.ops.precision import split_levels

    Rm, Cm, cbm = cf.mf_blocking(R * T)
    xrm, xim = random_complex(rng, (Rm, Cm), dev, Rm * Cm)
    mf_args = {mode: (xrm, xim,
                      device_funnel_b_tiles(Rm, split_levels(mode), dev),
                      *device_funnel_factors(Rm, Rm * Cm, dev)[:2],
                      device_funnel_b2_tiles(Rm, Rm * Cm, dev))
               for mode in ("split3", "default", "highest")}
    mf_grid = {}
    for mode, margs in mf_args.items():
        mf_grid[mode] = cf.mf_resident_blocks(dev, mode)
        check_kernel(f"matmul_funnel({Rm},{Cm}) {mode}",
                     lambda *a, m=mode: cf.matmul_funnel(*a, precision=m),
                     lambda *a, m=mode: cf.matmul_funnel_plain(
                         *a, precision=m), margs)
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
    log(f"# phase 3 blocking: mf R={Rm} C={Cm} cb={cbm}, "
        f"{(Cm // cbm) * -(-Rm // 64)} units on a persistent grid of "
        f"{mf_grid} blocks; gpu_rows "
        f"automatic block_rows "
        f"{[cf.gpu_rows_blocking(r, n) for r, n in GPU_ROWS_CHECKS]}")

    # the bf16 storage instantiations at the main path's shapes, each
    # against its plain bf16 version on the same bf16 planes and tables:
    # tile_fft at config 3's 4096 x 4096 and rql's 64 x 2^14,
    # long_range_sep at rql's 1 x 64 x 2^14, fourstep at 2^22 and 2^24,
    # sixstep at 2^25 and 2^27 (their automatic blocking)
    bf = "bfloat16"

    def bf16_planes(shape, n):
        return tuple(t.to(torch.bfloat16)
                     for t in random_complex(rng, shape, dev, n))

    bf16_labels = {}
    for rows, tile in ((4096, 4096), (R, T)):
        label = f"tile_fft_bf16({rows},{tile})"
        check_kernel(label, cf.tile_fft, cf.tile_fft_plain,
                     (*bf16_planes((rows, tile), tile),
                      *flat_tables(tile, dev, bf)), BF16_KERNEL_TOL)
    bf16_labels["tile_fft_bf16"] = "tile_fft_bf16(4096,4096)"
    label = f"long_range_sep_bf16(1,{R},{T})"
    check_kernel(label, lambda *a: cf.long_range_sep(*a, cf.DEFAULT_CB),
                 cf.long_range_sep_plain,
                 (*bf16_planes((1, R, T), R * T),
                  *device_factors(R, T, dev, bf)), BF16_KERNEL_TOL)
    bf16_labels["long_range_sep_bf16"] = label
    for k in (22, 24):
        tk, Rk, _ = cf.fourstep_blocking(1 << k)
        label = f"fourstep_bf16({Rk},{tk})"
        check_kernel(label, cf.fourstep, cf.fourstep_plain,
                     (*bf16_planes((Rk, tk), Rk * tk),
                      *device_factors(Rk, tk, dev, bf),
                      *flat_tables(tk, dev, bf)), BF16_KERNEL_TOL)
        bf16_labels["fourstep_bf16"] = label
    for k in (25, 27):
        t6, R1, R2, cb1, cb2 = cf.sixstep_blocking(1 << k)
        label = f"sixstep_bf16({R1},{R2},{t6})"
        check_kernel(label, lambda *a, c1=cb1, c2=cb2: cf.sixstep(
                         *a, cb1=c1, cb2=c2), cf.sixstep_plain,
                     (*bf16_planes((R1, R2, t6), R1 * R2 * t6),
                      *device_factors(R1, R2 * t6, dev, bf),
                      *device_factors(R2, t6, dev, bf),
                      *flat_tables(t6, dev, bf)), BF16_KERNEL_TOL)
        bf16_labels["sixstep_bf16"] = label
    # long_range_dense_bf16 on the float32 check's 13 long-range shapes
    # (R = 2 .. 8192, cb 2 .. 32, both KMAX)
    for batch, rr, cc, cb in ((1, R, T, cf.DEFAULT_CB),) + LONG_RANGE_CHECKS:
        label = f"long_range_dense_bf16({batch},{rr},{cc}) cb={cb}"
        check_kernel(label, lambda *a, cb=cb: cf.long_range_dense(*a, cb),
                     cf.long_range_dense_plain,
                     (*bf16_planes((batch, rr, cc), rr * cc),
                      *dense_long_range_tables(rr, cc, dev, bf)),
                     BF16_KERNEL_TOL)
        if (batch, rr, cc) != (1, R, T):
            cases[label].pop("args")
    bf16_labels["long_range_dense_bf16"] = \
        f"long_range_dense_bf16(1,{R},{T}) cb={cf.DEFAULT_CB}"
    # fused_bf16 at n = 2^20 (R = 64, tile 2^14) at every cluster width,
    # qb 1 and 2, both alias modes, and at the smallest R (2); the
    # set-aside, set to 0, read before and after its first launch: the
    # launch raises it to its 2n-value bf16 carry (4 MB), not 2n floats
    fused16_args = (*bf16_planes((Rf, tf), Rf * tf),
                    *device_factors(Rf, tf, dev, bf), *flat_tables(tf, dev, bf))
    cf.set_persisting_l2_set_aside(dev, 0)
    set_aside["bf16_before"] = cf.persisting_l2_set_aside(dev)
    labelf16 = f"fused_bf16({Rf},{tf})"
    check_kernel(labelf16, cf.fused, cf.fused_plain, fused16_args,
                 BF16_KERNEL_TOL)
    torch.cuda.synchronize()
    set_aside["bf16_after"] = cf.persisting_l2_set_aside(dev)
    carry16 = 2 * Rf * tf * 2
    log(f"# phase 3 persisting-L2 set-aside around the first fused_bf16 "
        f"launch: {set_aside['bf16_before']} bytes before, "
        f"{set_aside['bf16_after']} after (its carry {carry16} bytes)")
    if set_aside["bf16_before"] != 0 or \
            not carry16 <= set_aside["bf16_after"] < 2 * carry16:
        raise AssertionError(f"fused_bf16 sized the set-aside to "
                             f"{set_aside['bf16_after']} bytes for a "
                             f"{carry16}-byte carry")
    bf16_labels["fused_bf16"] = labelf16
    for qb in (1, 2):
        for cw in FUSED_CWS:
            for alias in (False, True):
                label = f"fused_bf16({Rf},{tf}) qb={qb} cw={cw} alias={alias}"
                check_kernel(label,
                             lambda xr, xi, *a, qb=qb, cw=cw, al=alias:
                             cf.fused(xr.clone(), xi.clone(), *a, qb=qb,
                                      alias_io=al, cw=cw),
                             cf.fused_plain, fused16_args, BF16_KERNEL_TOL)
                cases[label].pop("args")
    tr2 = cf.fused_blocking(2 * T)[0]
    for alias in (False, True):
        label = f"fused_bf16(2,{tr2}) alias={alias}"
        check_kernel(label,
                     lambda xr, xi, *a, al=alias: cf.fused(
                         xr.clone(), xi.clone(), *a, alias_io=al),
                     cf.fused_plain,
                     (*bf16_planes((2, tr2), 2 * tr2),
                      *device_factors(2, tr2, dev, bf),
                      *flat_tables(tr2, dev, bf)), BF16_KERNEL_TOL)
        cases[label].pop("args")

    # the main path, counted: config 2, config 3, the paper's backend
    cf.reset_launch_counts()

    clock.start("phase 4")
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

    clock.start("phase 5")
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

    clock.start("phase 6")
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

    clock.start("phase 6b")
    # phase 6b: the large-n 1-D path, counted — fft in natural order on
    # the fourstep and sixstep plans, one launch of one kernel each
    def counts():
        return {"tile_fft": cf.tile_fft.launches,
                "long_range_sep": cf.long_range_sep.launches,
                "fourstep": cf.fourstep.launches,
                "sixstep": cf.sixstep.launches}

    def counts_all():
        # every instantiation: float32 under the wrapper's name, bf16
        # storage as <name>_bf16
        return cf.launch_counts()

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

    clock.start("phase 7")
    # phase 7: times per call — the loop slope (device time per call,
    # no host work between calls, operands cold), and beside it the
    # CUDA-event median of REPS calls with the L2 flushed (what a caller
    # feels, the wrapper's host time in)
    def timed(fn, *args, before=None):
        return time_ms(fn, *args, reps=REPS, warmup=3, flush_l2=True,
                       before=before)[0]

    timings = {}
    library_seen = {}

    def library_times(lib):
        """(slope ms, event ms) of the library call ``lib[0](*lib[1:])``,
        read once for each function and operand shapes: torch.fft's time
        does not depend on the values, so rows that share a shape share
        the reading"""
        fn, *args = lib
        key = (fn, tuple((tuple(a.shape), a.dtype) for a in args))
        if key not in library_seen:
            library_seen[key] = (slope_ms(*lib), timed(*lib))
        return library_seen[key]

    def kernel_row(label, kernel, plain, args, nbytes, flops, lib,
                   plain_reps=REPS, bf16_flops=0, bound_flops=None):
        # flops: the float32 operations of the transform's levels, the
        # repo's 5 per element a level (GFLOP/s, and the bound's: a
        # kernel that rebuilds its twiddles does more than the transform
        # needs); bound_flops, where given, the float32 operations of the
        # bound instead, and bf16_flops its tensor-core ones.  ms and the
        # library's are loop slopes; the plain version's, the CUDA-event
        # median of plain_reps calls (its slope would take minutes)
        ms = slope_ms(kernel, *args)
        event_ms = timed(kernel, *args)
        dev_ms = device_ms(kernel, *args)
        plain_ms = time_ms(plain, *args, reps=plain_reps, warmup=1,
                           flush_l2=True)[0]
        lib_ms, lib_event_ms = library_times(lib) if lib is not None \
            else (None, None)
        bms, by = bound_ms(nbytes, flops if bound_flops is None
                           else bound_flops, bf16_flops)
        timings[label] = {"ms": ms, "event_ms": event_ms,
                          "device_ms": dev_ms, "plain_ms": plain_ms,
                          "plain_reps": plain_reps,
                          "library_ms": lib_ms,
                          "library_event_ms": lib_event_ms, "bytes": nbytes,
                          "bound_ms": bms, "bound_by": by,
                          "gflops": flops / (ms * 1e-3) / 1e9}
        log(f"# phase 7 {label}: slope {ms:.4f} ms (events "
            f"{event_ms:.4f}, device {ms_text(dev_ms)} ms, "
            f"{timings[label]['gflops']:.1f} GFLOP/s, plain "
            f"{plain_ms:.4f} (events), library slope "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} (events "
            f"{lib_event_ms if lib_ms is None else f'{lib_event_ms:.4f}'}), "
            f"bound {bms:.4f} by {by}, {nbytes} bytes)")

    for label, rows, tile in (("tile_fft(4096,4096)", 4096, 4096),
                              ("tile_fft(64,16384)", R, T),
                              ("tile_fft(128,8192)", 128, T // 2)):
        a = cases[label]["args"]
        xc = torch.complex(a[0], a[1])
        flops = 5 * rows * tile * int(np.log2(tile))
        kernel_row(label, cf.tile_fft, cf.tile_fft_plain, a,
                   16 * rows * tile + 8 * (tile - 1), flops,
                   (torch.fft.fft, xc))
    a = cases["long_range_sep(1,64,16384)"]["args"]
    lev = int(np.log2(R))
    kernel_row("long_range_sep(1,64,16384)",
               lambda *t: cf.long_range_sep(*t, cf.DEFAULT_CB),
               cf.long_range_sep_plain, a,
               16 * R * T + 8 * (R - 1 + lev * T), 5 * R * T * lev, None)
    for batch, rr, cc in LONG_RANGE_TIMED:
        label = f"long_range_sep({batch},{rr},{cc}) cb={cf.DEFAULT_CB}"
        lv = int(np.log2(rr))
        kernel_row(label, lambda *t: cf.long_range_sep(*t, cf.DEFAULT_CB),
                   cf.long_range_sep_plain, cases[label]["args"],
                   16 * batch * rr * cc + 8 * (rr - 1 + lv * cc),
                   5 * batch * rr * cc * lv, None)

    def fac_bytes(rows, cols):
        # separable factors: A (rows - 1) and B (levels x cols), re + im
        return 8 * (rows - 1 + int(np.log2(rows)) * cols)

    # long_range_dense: 5 flop per element per level, the planes once
    # each way plus the (R - 1) x T dense tables
    kernel_row("long_range_dense(1,64,16384)",
               lambda *t: cf.long_range_dense(*t, cf.DEFAULT_CB),
               cf.long_range_dense_plain,
               cases["long_range_dense(1,64,16384)"]["args"],
               16 * R * T + 8 * (R - 1) * T, 5 * R * T * lev, None)
    # fused at 2^20: the planes once each way plus factors and tables
    # (the carry stays in L2)
    nf = Rf * tf
    xcf = torch.complex(x2r, x2i)
    kernel_row(labelf, cf.fused, cf.fused_plain, fused_args,
               16 * nf + fac_bytes(Rf, tf) + 8 * (tf - 1),
               5 * nf * int(np.log2(nf)), (torch.fft.fft, xcf))
    # fused by phase-A block (qb) and phase-B cluster width (cw), float32
    # and bf16 storage
    for name, f_args in (("fused", fused_args), ("fused_bf16", fused16_args)):
        fused_by = {}
        for qb in (1, 2):
            for cw in FUSED_CWS:
                run_f = (lambda *a, qb=qb, cw=cw: cf.fused(*a, qb=qb, cw=cw))
                fused_by[f"qb={qb} cw={cw}"] = {"ms": timed(run_f, *f_args)}
        timings[f"{name} blocking"] = {"auto": {"qb": qbf, "cw": cwf},
                                       "ms": fused_by}
        log(f"# phase 7 {name}({Rf},{tf}) by blocking (automatic qb={qbf} "
            f"cw={cwf}), CUDA events: "
            + ", ".join(f"{k}: {v['ms']:.4f} ms"
                        for k, v in fused_by.items()))

    # fourstep at 2^22 and 2^24 and sixstep at 2^25 and 2^27: bytes are
    # the planes once each way, factors, tables
    def six_row(k):
        r1, r2, c1, c2 = six[k]["blocking"]
        lab = six[k]["label"]
        return (lab, [r1, r2], T, cases[lab]["args"],
                lambda *a: cf.sixstep(*a, cb1=c1, cb2=c2), cf.sixstep_plain,
                16 * r1 * r2 * T + fac_bytes(r1, r2 * T) + fac_bytes(r2, T)
                + 8 * (T - 1), PLAIN_REPS_2_27 if k == 27 else REPS)

    def four_row(k):
        tk, rk, _ = cf.fourstep_blocking(1 << k)
        lab = f"fourstep({rk},{tk})"
        return (lab, [rk], tk, cases[lab]["args"], cf.fourstep,
                cf.fourstep_plain,
                16 * rk * tk + fac_bytes(rk, tk) + 8 * (tk - 1), REPS)

    for label, rows, lib_tile, args, fn, plain, nbytes, reps in (
            four_row(22), four_row(24), six_row(25), six_row(27)):
        n = int(np.prod(rows)) * lib_tile
        xc = torch.complex(args[0], args[1]).reshape(n)
        kernel_row(label, fn, plain, args, nbytes, 5 * n * int(np.log2(n)),
                   (torch.fft.fft, xc), reps)
        del xc

    paths = {}

    def path_row(label, fn, args, n, count, launches_per_call, lib,
                 plain=None, variant=None, plain_reps=REPS, consumes=False):
        # consumes: fn writes over its planes; every timed call gets them
        # back, untimed, as a Plan hands it fresh planes per call
        before = None
        if consumes:
            src, args = args, tuple(a.clone() for a in args)

            def before():
                for a, b in zip(args, src):
                    a.copy_(b)
        ms = slope_ms(fn, *args, consumes=consumes)
        event_ms = timed(fn, *args, before=before)
        plain_ms = time_ms(plain, *args, reps=plain_reps, warmup=1,
                           flush_l2=True)[0] if plain is not None else None
        lib_ms, lib_event_ms = library_times(lib)
        nbytes = roofline.fft_min_hbm_bytes(n) * count
        flops = 5 * n * int(np.log2(n)) * count
        bms, by = bound_ms(nbytes, flops)
        ceiling = roofline.roofline_ceiling(
            roofline.plan_carry_passes(variant))
        paths[label] = {"ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
                        "plain_reps": plain_reps if plain else None,
                        "library_ms": lib_ms,
                        "library_event_ms": lib_event_ms, "bound_ms": bms,
                        "bound_by": by, "bytes": nbytes,
                        "launches_per_call": launches_per_call,
                        "carry_ceiling": ceiling,
                        "util": bms / ms,
                        "gflops": flops / (ms * 1e-3) / 1e9}
        log(f"# phase 7 path {label}: slope {ms:.4f} ms (events "
            f"{event_ms:.4f}), {paths[label]['gflops']:.1f} GFLOP/s "
            f"(5 n log2 n), {launches_per_call} launches, plain "
            f"{plain_ms if plain_ms is None else f'{plain_ms:.4f}'} ms "
            f"(events), torch.fft slope {lib_ms:.4f} ms (events "
            f"{lib_event_ms:.4f}), bound {bms:.4f} ms by {by}, "
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
    # phase 18 holds its unarmed fft to this row on this plan
    p7_row = (paths["fft natural N=2^20 (plan rql + gather)"]["ms"],
              plans.plan_for((n2,), device=dev).describe())
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
        path_row(f"{variant} pi N=2^20 {params}", run, (x2r, x2i), n2, 1,
                 launches_per_call, (torch.fft.fft, x2), plain, variant,
                 consumes=run.consumes_input)

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
    bm = torch.complex(*device_funnel_b(Rm, dev)).to(torch.complex64)
    fa = [a.double() for a in device_funnel_factors(Rm, Rm * Cm, dev)]
    tm = (torch.complex(fa[0], fa[1]).reshape(Rm, -1, 1)
          * torch.complex(fa[2], fa[3]).reshape(Rm, 1, 128)) \
        .reshape(Rm, Cm).to(torch.complex64)
    xm = torch.complex(xrm, xim)
    for mode in ("split3", "default", "highest"):
        label = f"matmul_funnel({Rm},{Cm}) {mode}"
        # B's split_levels(mode) bf16 planes, re + im
        mf_bytes = 16 * nm + 4 * split_levels(mode) * Rm * Rm \
            + 8 * (Rm * (Cm // 128) + Rm * 128)
        kernel_row(label,
                   lambda *a, m=mode: cf.matmul_funnel(*a, precision=m),
                   lambda *a, m=mode: cf.matmul_funnel_plain(*a,
                                                             precision=m),
                   mf_args[mode], mf_bytes, 5 * nm * int(np.log2(Rm)),
                   (lambda b, x, t: torch.matmul(b, x) * t, bm, xm, tm),
                   bf16_flops=dot_passes(mode) * 8 * Rm * nm,
                   bound_flops=14 * nm)
    del bm, tm, xm

    def mf_plain(xr, xi, mode="split3"):
        # the mf composition on the two kernels' plain versions
        yr, yi = cf.matmul_funnel_plain(xr.reshape(Rm, Cm),
                                        xi.reshape(Rm, Cm),
                                        *mf_args[mode][2:],
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
                   16 * rows * n + 8 * (n - 1), flops, (torch.fft.fft, xc))
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
            row[br] = {"ms": timed(run_g, *a)}
        blocking[f"{rows}x{n}"] = {"auto": cf.gpu_rows_blocking(rows, n),
                                   "ms_by_block_rows": row}
        log(f"# phase 7 gpu_rows({rows},{n}) by block_rows (automatic "
            f"{cf.gpu_rows_blocking(rows, n)}), CUDA events: "
            + ", ".join(f"{br}: {v['ms']:.4f} ms" for br, v in row.items()))
    timings["gpu_rows blocking"] = blocking

    # the bf16 storage instantiations at the shapes phase 3 checked them,
    # beside the float32 rows above.  Bytes: the planes once each way at 2
    # bytes a value (8 an element, in and out) and the tables at 2 bytes;
    # operations: the transform's own, on float32 units.  No
    # PyTorch call computes a bf16-storage FFT (library null); torch.fft's
    # complex64 time on the same values stands beside it
    def bf16_row(label, kernel, plain, nbytes, flops, n_rows, n,
                 reps=REPS, twin=None):
        # twin: the float32 instantiation's phase-7 label, printed beside
        args = cases[label]["args"]
        kernel_row(label, kernel, plain, args, nbytes, flops, None, reps)
        xc = torch.complex(args[0].float(), args[1].float()).reshape(
            n_rows, n)
        timings[label]["torch_fft_fp32_ms"] = timed(torch.fft.fft, xc)
        log(f"# phase 7 {label}: library null (no torch call computes a "
            f"bf16-storage FFT); torch.fft.fft complex64 on the same values "
            f"{timings[label]['torch_fft_fp32_ms']:.4f} ms")
        if twin is not None:
            t32 = timings[twin]
            log(f"# phase 7 {label} beside its float32 twin {twin}: event "
                f"ms {timings[label]['ms']:.4f} / {t32['ms']:.4f}, device "
                f"ms {ms_text(timings[label]['device_ms'])} / "
                f"{ms_text(t32['device_ms'])}, bound "
                f"{timings[label]['bound_ms']:.4f} / {t32['bound_ms']:.4f}")
        del xc

    for rows, tile in ((4096, 4096), (R, T)):
        bf16_row(f"tile_fft_bf16({rows},{tile})", cf.tile_fft,
                 cf.tile_fft_plain, 8 * rows * tile + 4 * (tile - 1),
                 5 * rows * tile * int(np.log2(tile)), rows, tile)
    bf16_row(f"long_range_sep_bf16(1,{R},{T})",
             lambda *t: cf.long_range_sep(*t, cf.DEFAULT_CB),
             cf.long_range_sep_plain,
             8 * R * T + 4 * (R - 1 + lev * T), 5 * R * T * lev, 1, R * T)
    for k in (22, 24):
        tk, rk, _ = cf.fourstep_blocking(1 << k)
        bf16_row(f"fourstep_bf16({rk},{tk})", cf.fourstep,
                 cf.fourstep_plain,
                 8 * rk * tk + fac_bytes(rk, tk) // 2 + 4 * (tk - 1),
                 5 * k << k, 1, 1 << k)
    # long_range_dense_bf16: the planes once each way at 2 bytes a value
    # and the (R - 1) x T bf16 tables, 12 bytes an element in all
    bf16_row(bf16_labels["long_range_dense_bf16"],
             lambda *t: cf.long_range_dense(*t, cf.DEFAULT_CB),
             cf.long_range_dense_plain, 8 * R * T + 4 * (R - 1) * T,
             5 * R * T * lev, 1, R * T, twin="long_range_dense(1,64,16384)")
    # fused_bf16 at 2^20: the planes once each way, bf16 factors and
    # tables (the bf16 carry stays in L2), about 8 bytes an element
    bf16_row(labelf16, cf.fused, cf.fused_plain,
             8 * nf + fac_bytes(Rf, tf) // 2 + 4 * (tf - 1),
             5 * nf * int(np.log2(nf)), 1, nf, twin=labelf)
    for k in (25, 27):
        r1, r2, c1, c2 = six[k]["blocking"]
        bf16_row(f"sixstep_bf16({r1},{r2},{T})",
                 lambda *a, c1=c1, c2=c2: cf.sixstep(*a, cb1=c1, cb2=c2),
                 cf.sixstep_plain,
                 8 * r1 * r2 * T + (fac_bytes(r1, r2 * T)
                                    + fac_bytes(r2, T)) // 2 + 4 * (T - 1),
                 5 * k << k, 1, 1 << k,
                 PLAIN_REPS_2_27 if k == 27 else REPS)

    clock.start("phase 7b")
    # phase 7b: device time of one natural-order large-n fft by kernel,
    # from torch.profiler, and the card's idle share of that call
    profiles = {}
    for k, variant in LARGE:
        xl = large[k].pop("x")
        fft(xl)
        torch.cuda.synchronize()
        seen, wall_ms = profiled(fft, xl, cpu=True)
        by_kernel = {}
        for key, (ms, _) in (seen or {}).items():
            by_kernel[key[:60]] = by_kernel.get(key[:60], 0) + ms
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
        profiles[f"2^{k}"] = {"wall_ms": wall_ms, "device_ms": busy,
                              "idle_share": (1 - busy / wall_ms) if busy
                              else None, "kernels_ms": dict(top)}
        log(f"# phase 7b fft natural N=2^{k} ({variant}): device "
            f"{busy:.4f} ms of {ms_text(wall_ms)} ms wall (profiled), "
            + (f"idle share {1 - busy / wall_ms:.3f}; " if busy else
               "no device time seen: not measured; ")
            + "; ".join(f"{name} {ms:.4f}" for name, ms in top))
        del xl

    clock.start("phase 8")
    # phase 8: the tuned path, counted — the race at N=2^20 (pi layout),
    # the opted-in race of the natural-order key that fft's plan lookup
    # runs on a miss, then fft served by the stored winner
    n8 = 1 << 20
    cf.reset_launch_counts()
    tuned_pi = plans.tune(plans.make_key(n8, layout="pi", device=dev),
                          force=True)
    # each timed entry's slope time (the race's: device time per call,
    # no host work between calls) beside its CUDA-event time around one
    # call with the L2 flushed (phase 7's, the wrapper's host time in)
    def event_times(plan):
        # {entry: CUDA-event ms} of a tuned plan's timed race entries
        xr_, xi_ = random_complex(rng, plan.key.input_shape(), dev,
                                  plan.key.n)
        out = {}
        for r in plan.tuning:
            if r.ms is None:
                continue
            run_ = ladder.build_executor(plan.key, r.variant, r.params)
            args_, before_ = (xr_, xi_), None
            if run_.consumes_input:
                args_ = (xr_.clone(), xi_.clone())

                def before_(a=args_):
                    a[0].copy_(xr_)
                    a[1].copy_(xi_)
            out[id(r)] = timed(run_, *args_, before=before_)
        return out

    race = {}
    events8 = event_times(tuned_pi)
    for r in tuned_pi.tuning:
        event_ms = events8.get(id(r))
        race[r.variant + " " + json.dumps(r.params, sort_keys=True)] = {
            "status": r.status, "slope_ms": r.ms, "event_ms": event_ms,
            "reason": r.reason}
        log(f"# phase 8 race N=2^20 pi: {r.variant} {r.params}: "
            f"{r.status}"
            + (f" slope {r.ms:.4f} ms, CUDA events {event_ms:.4f} ms"
               if r.ms is not None else "")
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
    # the races captured their candidates' calls into CUDA graphs: a
    # wrapper counts a launch when it is captured, not when it replays,
    # so these are logged apart and the kernels line reads the counted
    # run below
    race_launches8 = counts_all()
    log(f"# phase 8 race launches captured (not counted in the kernels "
        f"line): {race_launches8}")
    x8 = torch.complex(*random_complex(rng, (n8,), dev))
    cf.reset_launch_counts()
    y8 = fft(x8)
    torch.cuda.synchronize()
    delta8 = counts_all()
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
    # one call of the race's best entry of each raced kernel the served
    # plan did not launch, through the ladder's executor, held to the
    # same budget on the same input
    ref8_pi = ref8[torch.from_numpy(verify.bit_reverse_indices(n8))
                   .to(dev)]
    for name, variants in (("fused", ("fused", "fused-alias")),
                           ("long_range_dense", ("two-kernel",))):
        if delta8[name]:
            continue
        entry = min((r for r in tuned_pi.tuning
                     if r.variant in variants and r.ms is not None),
                    key=lambda r: r.ms)
        run8 = ladder.build_executor(tuned_pi.key, entry.variant,
                                     entry.params)
        yr8, yi8 = run8(x8.real.contiguous(), x8.imag.contiguous())
        e, m = rel_l2(torch.complex(yr8, yi8), ref8_pi), max_abs(
            torch.complex(yr8, yi8), ref8_pi)
        log(f"# phase 8 {entry.variant} {entry.params} N=2^20 pi: rel L2 "
            f"{e:.3e}, max abs {m:.3e}")
        if not (e <= PATH_TOL and m < MAX_ABS_TOL):
            raise AssertionError(f"{entry.variant} is out of tolerance")
    torch.cuda.synchronize()
    tuned_launches = counts_all()
    log(f"# tuned path launches (the tuned fft, then one call of each "
        f"raced kernel it did not take): {tuned_launches}")
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
    sweep_events = {}
    for p in swept:
        ev = event_times(p)
        sweep_events[p.key.n] = [
            {"variant": r.variant, "params": r.params, "status": r.status,
             "slope_ms": r.ms, "event_ms": ev[id(r)]}
            for r in p.tuning if r.ms is not None]
        log(f"# phase 8 sweep n={p.key.n}: winner {p.variant} {p.params}; "
            "slope / CUDA events ms: "
            + ", ".join(f"{r.variant} {r.params} {r.ms:.4f} / "
                        f"{ev[id(r)]:.4f}"
                        for r in p.tuning if r.ms is not None))
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

    clock.start("phase 9")
    # phase 9: the matmul funnel, counted — fft through Plan(key, "mf")
    # at N=2^20 in pi and natural order, in every fp32-storage mode, each
    # call one launch of matmul_funnel and one of tile_fft
    # (its input from a generator of its own, seeded with SEED, so it
    # does not move with earlier phases' draws; tools/ab_fft_2p20.py
    # makes the same input)
    cf.reset_launch_counts()
    x9 = torch.complex(*random_complex(np.random.default_rng(SEED), (n2,),
                                       dev))
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
            held = mode in MF_MAX_ABS_HELD
            log(f"# phase 9 mf N=2^20 {layout} {mode}: rel L2 {e:.3e} "
                f"(budget {budget}), max abs {m:.3e}"
                + (f" (bound {MAX_ABS_TOL})" if held else "")
                + f", finite {finite}, launches {delta}")
            if not (e <= budget and finite and y9.shape == (n2,)
                    and (m < MAX_ABS_TOL or not held)
                    and delta == {"matmul_funnel": 1, "tile_fft": 1}):
                raise AssertionError(f"mf {layout} {mode} failed")
    del x9, ref9, ref9_pi, y9
    mf_launches = counts_all()
    log(f"# mf path launches: {mf_launches}")
    launches.update(matmul_funnel=mf_launches["matmul_funnel"])

    clock.start("phase 10")
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

    clock.start("phase 11")
    # phase 11: the bf16 storage mode at full size, counted — each shape
    # of BF16_PATHS through the plan layer (its static plan, or a Plan
    # built with its variant) in natural order (fft, or fft_planes_fast
    # for config 3's rows) and pi order (Plan.execute),
    # held to the bf16 budget against complex128, float32 out, each call
    # one launch of each of its kernels' bf16 instantiations; then, after
    # the counted run, each kernel's device time (profiler) and the
    # call's (loop slope) in bf16 beside float32, and the precision race
    # at 2^20 for a bf16 key
    cf.reset_launch_counts()
    bf16_path = {}

    def bf16_plan(shape, variant, params, layout="natural", mode="bf16"):
        # the static plan of a bf16 key, or a Plan built with `variant`
        if params is None and mode == "bf16":
            return plans.plan_for(shape, layout=layout, precision=mode,
                                  device=dev)
        key = plans.make_key(shape[-1], shape[:-1], layout=layout,
                             precision=mode, device=dev)
        return Plan(key, variant, dict(params or {}))

    for label, shape, want, params in BF16_PATHS:
        n = shape[-1]
        x11r, x11i = random_complex(rng, shape, dev)
        ref = torch.fft.fft(torch.complex(x11r, x11i).to(torch.complex128))
        # the pi-layout oracle: the bit-reversal gather on the card (the
        # host's table of 2^27 entries took tens of seconds)
        ref_pi = torch.complex(*to_natural(ref.real, ref.imag))
        want_launches = {f"{k}_bf16": v
                         for k, v in VARIANT_LAUNCHES[want].items()}
        row = {}
        for layout in ("natural", "pi"):
            pl11 = bf16_plan(shape, want, params, layout)
            before = counts_all()
            if layout == "pi":
                y11 = torch.complex(*pl11.execute(x11r, x11i))
            elif params is not None:
                y11 = fft(torch.complex(x11r, x11i), plan=pl11)
            elif len(shape) == 1:
                y11 = fft(torch.complex(x11r, x11i), precision="bf16")
            else:
                y11 = torch.complex(*fft_planes_fast(x11r, x11i,
                                                     precision="bf16"))
            torch.cuda.synchronize()
            delta = {k: c - before[k] for k, c in counts_all().items()
                     if c != before[k]}
            e = rel_l2(y11, ref if layout == "natural" else ref_pi)
            finite = bool(torch.isfinite(y11).all())
            row[layout] = {"plan": pl11.variant, "rel_l2": e,
                           "dtype": str(y11.real.dtype),
                           "storage_bytes": pl11.storage_bytes(),
                           "launches_per_call": delta}
            log(f"# phase 11 bf16 {label} {layout}: plan {pl11.variant} "
                f"{pl11.params} ({pl11.storage_bytes()} bytes a value), rel "
                f"L2 {e:.3e} vs complex128 (budget {BF16_BUDGET}), output "
                f"{y11.real.dtype}, finite {finite}, launches per call "
                f"{delta}")
            if not (pl11.variant == want and pl11.storage_bytes() == 2
                    and e <= BF16_BUDGET and finite
                    and y11.real.dtype == torch.float32
                    and y11.shape == shape and delta == want_launches):
                raise AssertionError(f"bf16 {label} {layout} failed")
            del y11
        bf16_path[label] = row
        del x11r, x11i, ref, ref_pi
    torch.cuda.synchronize()
    bf16_launches = counts_all()
    log(f"# bf16 path launches (phase 11): {bf16_launches}")
    for name in ("tile_fft_bf16", "long_range_sep_bf16", "fourstep_bf16",
                 "sixstep_bf16", "long_range_dense_bf16", "fused_bf16"):
        if bf16_launches[name] < 1:
            raise AssertionError(f"the bf16 path never launched {name}")
        launches[name] = bf16_launches[name]
    # the natural-order call's device time, bf16 beside the same variant
    # and parameters in float32 on the same planes: each kernel's by the
    # profiler, the call's by the loop slope (device time per call, no
    # host work between calls, over rotation copies of the planes and
    # the window fitted to the call, ``slope_ms``).  Both capture or
    # repeat calls, so they come after the counted run
    for label, shape, variant, params in BF16_PATHS:
        x11r, x11i = random_complex(rng, shape, dev)
        pl16 = bf16_plan(shape, variant, params)
        pl32 = bf16_plan(shape, pl16.variant, pl16.params, mode="split3")
        row = bf16_path[label]
        for mode, pl in (("bf16", pl16), ("fp32", pl32)):
            row[f"device_ms_{mode}"], row[f"kernels_{mode}"] = device_ms(
                pl.execute, x11r, x11i, reps=BF16_PROFILE_REPS,
                by_kernel=True)
            row[f"slope_ms_{mode}"] = slope_ms(pl.execute, x11r, x11i)
        log(f"# phase 11 bf16 {label} natural, plan {pl16.variant} "
            f"{pl16.params}: call device ms (loop slope) bf16 "
            f"{row['slope_ms_bf16']:.4f}, fp32 {row['slope_ms_fp32']:.4f}; "
            f"profiler (device_ms, {BF16_PROFILE_REPS} calls, L2 flushed) "
            f"bf16 {ms_text(row['device_ms_bf16'])}, fp32 "
            f"{ms_text(row['device_ms_fp32'])}: ms a launch x launches a "
            f"call, bf16 "
            + ", ".join(f"{k} {v[0]:.4f} x {v[1]:g}"
                        for k, v in row["kernels_bf16"].items())
            + "; fp32 " + ", ".join(f"{k} {v[0]:.4f} x {v[1]:g}"
                                    for k, v in row["kernels_fp32"].items()))
        del x11r, x11i
    # the precision race at 2^20 for a bf16 key: every entry once per
    # mode (bf16, then split3), each timed (no entry rejected: every
    # ladder variant has its bf16 instantiation); mf is never raced, and
    # refuses bf16 with the reference's message
    cf.reset_launch_counts()
    key16 = plans.make_key(n8, layout="pi", precision="bf16", device=dev)
    tuned16 = plans.tune(key16, force=True)
    race16 = []
    for r in tuned16.tuning:
        race16.append(r.to_record())
        log(f"# phase 11 race N=2^20 pi bf16 key: {r.variant} {r.params}: "
            f"{r.status}" + (f" slope {r.ms:.4f} ms" if r.ms is not None
                             else "")
            + (f" ({r.reason})" if r.status == "rejected" else ""))
    try:
        ladder.build_executor(key16, "mf", {"R": 128, "precision": "bf16"})
    except ValueError as err:
        log(f"# phase 11 race N=2^20 pi bf16 key: mf {{'precision': "
            f"'bf16'}}: rejected (never raced; {err})")
    else:
        raise AssertionError("mf served bf16 storage")
    rejected16 = {r.variant for r in tuned16.tuning
                  if r.status == "rejected"
                  and r.params.get("precision") == "bf16"}
    timed16 = {(r.variant, r.params.get("precision")) for r in tuned16.tuning
               if r.ms is not None}
    log(f"# phase 11 race winner: {tuned16.variant} {tuned16.params} "
        f"({tuned16.ms:.4f} ms), effective precision "
        f"{tuned16.effective_precision()}, storage_bytes() "
        f"{tuned16.storage_bytes()}; race launches captured (not counted "
        f"in the kernels line): {counts_all()}")
    raced16 = {(v, m) for v in ("fused", "fused-alias", "two-kernel", "rql",
                                "fourstep") for m in ("bf16", "split3")}
    not_ported = [r.reason for r in tuned16.tuning
                  if r.reason and "not ported yet" in r.reason]
    if rejected16 or not_ported or not raced16 <= timed16:
        raise AssertionError(f"the bf16 race: rejected {rejected16} "
                             f"{not_ported}, timed {timed16}")
    bf16_path["race_2^20_pi"] = {"winner": tuned16.describe(),
                                 "storage_bytes": tuned16.storage_bytes(),
                                 "entries": race16}

    clock.start("phase 12")
    # phase 12: the real and any-length domains
    domains = phase_domains(dev, rng, timed)

    # no plan of phases 1-12 demoted, then phase 13: the resilience
    # layer; phase 14: the bench and the harness sweep
    no_demotions("before phase 13", memoize)
    clock.start("phase 13")
    resilience = phase_resilience(dev, rng)
    clock.start("phase 14")
    measurement, harness_tsv = phase_measurement(dev)
    # phase 15: the planned tube, the C core, the new backends' sweeps
    # and config 1
    clock.start("phase 15")
    backends15, planned_launches = phase_backends(dev, rng)
    # phase 16: the parallel configs on torch.distributed
    clock.start("phase 16")
    torch.cuda.empty_cache()
    parallel16 = phase_parallel(dev, rng)
    # phase 17: the spectral apps
    clock.start("phase 17")
    torch.cuda.empty_cache()
    apps17, apps_launches = phase_apps(dev, rng)
    # phase 18: telemetry
    clock.start("phase 18")
    torch.cuda.empty_cache()
    obs18, obs_launches = phase_obs(dev, rng, p7_row)
    clock.start(None)
    log(f"# seconds by phase: {clock.seconds}; all phases "
        f"{sum(clock.seconds.values()):.1f} s")
    for name in ("sixstep", "tile_fft"):
        if not planned_launches.get(name):
            raise AssertionError(f"the planned tube never launched {name}: "
                                 f"{planned_launches}")
    # phase 16's counted calls: the world-1 job's sharded entries, and
    # rank 0's calls of the world-4 job
    parallel_launches = {}
    counted16 = [row["launches"] for row in parallel16["world 1"].values()]
    counted16 += [row["ranks"][0]["launches"] for label, row in
                  parallel16[f"world {PARALLEL_WORLD}"].items()
                  if label != "drill"]
    for launched in counted16:
        for name, c in launched.items():
            parallel_launches[name] = parallel_launches.get(name, 0) + c
    log(f"# phase 16 launches (world 1 counted calls, world "
        f"{PARALLEL_WORLD} rank 0): {parallel_launches}")
    for name in ("tile_fft", "long_range_sep"):
        if not parallel_launches.get(name):
            raise AssertionError(f"the parallel configs never launched "
                                 f"{name}: {parallel_launches}")
        if not apps_launches.get(name):
            raise AssertionError(f"the spectral apps never launched {name}: "
                                 f"{apps_launches}")

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
             "cs87project_msolano2_tpu/hw/lowering.py:82"),
            # the bf16 storage instantiations: the same TPU kernels'
            # storage="bfloat16" (pallas_fft.py:382, :745, :1232, :1670,
            # :604 and :906)
            ("tile_fft_bf16", bf16_labels["tile_fft_bf16"],
             src + "tile_fft.cu", ref_src + "299"),
            ("long_range_sep_bf16", bf16_labels["long_range_sep_bf16"],
             src + "long_range.cu", ref_src + "519"),
            ("fourstep_bf16", bf16_labels["fourstep_bf16"],
             src + "fourstep.cu", ref_src + "1046"),
            ("sixstep_bf16", bf16_labels["sixstep_bf16"],
             src + "sixstep.cu", ref_src + "1354"),
            ("long_range_dense_bf16", bf16_labels["long_range_dense_bf16"],
             src + "long_range.cu", ref_src + "483"),
            ("fused_bf16", bf16_labels["fused_bf16"], src + "fused.cu",
             ref_src + "832")):
        t = timings[label]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": cases[label]["max_abs_err"],
            "rel_l2": cases[label]["rel_l2"], "shape": label,
            "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "planned_tube_launches": planned_launches.get(name, 0),
            "parallel_launches": parallel_launches.get(name, 0),
            "apps_launches": apps_launches.get(name, 0),
            "obs_launches": obs_launches.get(name, 0)})
    checks = {label: {"rel_l2": c["rel_l2"], "max_abs_err": c["max_abs_err"]}
              for label, c in cases.items()}
    log(json.dumps({"timings": timings, "paths": paths, "card": card,
                    "large_n": large, "profiles": profiles,
                    "set_aside": set_aside, "lookup_us": lookup_us,
                    "kernel_checks": checks, "mf_path": mf_path,
                    "gpu_backend": gpu_backend, "hw_probe": hw,
                    "bf16": bf16_path, "domains": domains,
                    "resilience": resilience, "bench": measurement,
                    "harness_tsv": harness_tsv, "backends": backends15,
                    "parallel": parallel16, "apps": apps17,
                    "obs": obs18,
                    "seconds_by_phase": clock.seconds,
                    "tuned": {"race_2^20_pi": race,
                              "winner_pi": tuned_pi.describe(),
                              "winner_natural": tuned_nat.describe(),
                              "fft": {"rel_l2": e8, "max_abs": m8,
                                      "launches": delta8},
                              "race_launches": race_launches8,
                              "sweep": sweep,
                              "sweep_slope_vs_events": sweep_events,
                              "fourstep_crossover": cross4,
                              "sixstep_crossover": cross6}}))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
