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
kernel's mean time a launch times its launches in one call).  The last line of
standard output is
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
    (``utils.timing.loop_slope_ms``: k calls in one CUDA graph, device
    time per call with no host work between calls) over the reference's
    windows, the calls rotating over copies of the tensor arguments, as
    many as keep the L2 from serving a call (``rotation_copies``), as
    the race times a candidate.  `consumes`: fn writes over its tensor
    arguments, so every copy gets them back before each timed run."""
    import torch

    from cs87project_msolano2_tpu_torch.hw.inventory import l2_bytes
    from cs87project_msolano2_tpu_torch.utils.timing import (
        loop_slope_ms,
        rotation_copies,
        slope_window,
    )

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = rotation_copies(nbytes, l2_bytes(tensors[0].device))

    def copy():
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    sets = [copy() for _ in range(copies)] if consumes \
        else [args] + [copy() for _ in range(copies - 1)]
    before = None
    if consumes:
        def before():
            for s in sets:
                for a, b in zip(s, args):
                    if isinstance(a, torch.Tensor):
                        a.copy_(b)
    elements = max(t.numel() for t in tensors)
    return loop_slope_ms(fn, sets, *slope_window(elements), before=before)


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
                    or "spill" in line or "Compiling entry" in line:
                log(f"# ptxas {line.strip()}")

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
    for tile in (1 << 13, 1 << 14):
        by_blocking = {}
        for rows in TILE_CLUSTER_ROWS:
            by_blocking.setdefault(cf.tile_blocking(rows, tile, sms), rows)
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

    # phase 7: times per call — the loop slope (device time per call,
    # no host work between calls, operands cold), and beside it the
    # CUDA-event median of REPS calls with the L2 flushed (what a caller
    # feels, the wrapper's host time in)
    def timed(fn, *args, before=None):
        return time_ms(fn, *args, reps=REPS, warmup=3, flush_l2=True,
                       before=before)[0]

    timings = {}

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
        lib_ms = slope_ms(*lib) if lib is not None else None
        lib_event_ms = timed(*lib) if lib is not None else None
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
                fused_by[f"qb={qb} cw={cw}"] = {
                    "ms": timed(run_f, *f_args),
                    "device_ms": device_ms(run_f, *f_args)}
        timings[f"{name} blocking"] = {"auto": {"qb": qbf, "cw": cwf},
                                       "ms": fused_by}
        log(f"# phase 7 {name}({Rf},{tf}) by blocking (automatic qb={qbf} "
            f"cw={cwf}), CUDA events / device: "
            + ", ".join(f"{k}: {v['ms']:.4f} / {ms_text(v['device_ms'])} ms"
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
        lib_ms = slope_ms(*lib)
        lib_event_ms = timed(*lib)
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
            row[br] = {"ms": timed(run_g, *a),
                       "device_ms": device_ms(run_g, *a)}
        blocking[f"{rows}x{n}"] = {"auto": cf.gpu_rows_blocking(rows, n),
                                   "ms_by_block_rows": row}
        log(f"# phase 7 gpu_rows({rows},{n}) by block_rows (automatic "
            f"{cf.gpu_rows_blocking(rows, n)}), CUDA events / device: "
            + ", ".join(f"{br}: {v['ms']:.4f} / "
                        f"{ms_text(v['device_ms'])} ms"
                        for br, v in row.items()))
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
        rev = torch.from_numpy(verify.bit_reverse_indices(n)).to(dev)
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
            e = rel_l2(y11, ref if layout == "natural" else ref[..., rev])
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
        del x11r, x11i, ref
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
    # profiler, the call's by the race's loop slope (device time per
    # call, no host work between calls).  Both capture or repeat calls,
    # so they come after the counted run
    from cs87project_msolano2_tpu_torch.hw.inventory import l2_bytes
    from cs87project_msolano2_tpu_torch.utils.timing import (
        loop_slope_ms,
        rotation_copies,
        slope_window,
    )

    for label, shape, variant, params in BF16_PATHS:
        x11r, x11i = random_complex(rng, shape, dev)
        # the race's rotation: enough copies that each call reads its
        # planes cold
        copies = [(x11r.clone(), x11i.clone()) for _ in range(
            rotation_copies(8 * x11r.numel(), l2_bytes(dev)))]
        pl16 = bf16_plan(shape, variant, params)
        pl32 = bf16_plan(shape, pl16.variant, pl16.params, mode="split3")
        row = bf16_path[label]
        for mode, pl in (("bf16", pl16), ("fp32", pl32)):
            row[f"device_ms_{mode}"], row[f"kernels_{mode}"] = device_ms(
                pl.execute, x11r, x11i, reps=BF16_PROFILE_REPS,
                by_kernel=True)
            row[f"slope_ms_{mode}"] = loop_slope_ms(
                pl.execute, copies, *slope_window(x11r.numel()))
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
        del x11r, x11i, copies
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

    # phase 12: the real and any-length domains
    domains = phase_domains(dev, rng, timed)

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
            "library_ms": t["library_ms"]})
    checks = {label: {"rel_l2": c["rel_l2"], "max_abs_err": c["max_abs_err"]}
              for label, c in cases.items()}
    log(json.dumps({"timings": timings, "paths": paths, "card": card,
                    "large_n": large, "profiles": profiles,
                    "set_aside": set_aside, "lookup_us": lookup_us,
                    "kernel_checks": checks, "mf_path": mf_path,
                    "gpu_backend": gpu_backend, "hw_probe": hw,
                    "bf16": bf16_path, "domains": domains,
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
