"""Headline benchmark of the port: 1-D complex FFT, N = 2^20, one card.

    python -m cs87project_msolano2_tpu_torch.bench [--smoke] [--device cpu]
        [--journal PATH] [--resume]

Measures the flagship path (pi-layout output, the bit-reversal gather
excluded as the reference excludes it) against ``torch.fft.fft`` on the
same card at the same n and prints ONE JSON line in the reference
bench's record format (``bench.py`` at the repository root):

    {"metric": "fft1d_n2^20_complex64_gflops", "value": GFLOP/s,
     "unit": "GFLOP/s", "ms": ..., "plan": {...}, "env": {...},
     "library": "torch.fft.fft", "library_fft_ms": ...,
     "vs_library_fft": ..., "roofline_util": ..., ...,
     "n2^22_ms": ..., "n2^22_vs_library": ..., "rfft2^22_ms": ...,
     "bf16_2^22_ms": ..., ..., "gpu2^8_ms": ..., "cpun2^8_ms": ..., ...,
     "c_ms": ..., "vs_baseline": ...}

* vs_library_fft / n2^K_vs_library — library time over the port's:
  above 1 the port is faster than ``torch.fft.fft`` on the same card.
* For each K in LARGE_LOGNS three rows: ``n2^K_*`` (c2c, pi layout),
  ``rfft2^K_*`` (the half-spectrum real transform, natural order, GFLOP/s
  on 2.5 n log2 n) and ``bf16_2^K_*`` (bf16 storage).  Each row carries
  ms, GFLOP/s, the plan that served (its demotion trail where it
  degraded), the carry passes of the variant or rung that served and
  their ceiling 1/(1+p), the share of the card's data-sheet bandwidth
  at the domain's and storage's minimum traffic (``roofline_util``),
  its share of the ceiling, and the bytes the plan declares
  (``utils.roofline.fft_hbm_bytes``; no counter meters them yet).
* ``gpu2^K_*`` and ``cpun2^K_*`` — the same pi-layout shape under the
  ``gpu`` and ``cpu-native`` plan backends (``hw.lowering``) at
  BACKEND_ROW_LOGNS, tagged with their backend; a cpun row's share of
  the bound is against the host's DRAM ceiling
  (``hw.inventory.peak_bytes_per_s("cpu-native")``).
* c_ms / vs_baseline — the native C core's time at the flagship N
  (``measure_c_baseline_ms``: pthreads, p the largest power of two not
  above the core's ``pifft_num_cores``, best of 3 by total_ms, on the
  host) and that time over the flagship's: above 1 the card is faster
  than the C baseline.  Left out of ``--smoke`` runs, whose toy-n
  flagship makes the ratio meaningless, as the reference leaves it.

Timing is the race's: ``plans.measured_ms`` — a freshly raced winner's
loop slope, else the stored or static plan timed by
``plans.autotune.default_timer`` (the loop slope over a CUDA graph,
rotating over copies of the planes), a plan that demoted while timed
re-raced once.  Keys the plan store lacks are raced first, as the
reference races the keys its cache lacks.  The library rows take
``utils.timing.slope_ms``.  The cpun rows run on the host, so their race
and time are the host clock's (``plans.autotune.default_timer``).

Resilience: every measurement runs under ``resilience.call_with_retry``
(TRANSIENT faults retried, the rest straight through) after a
``maybe_fault("bench")`` probe; CAPACITY and PERMANENT kernel faults
ride the plan's degradation chain and surface as ``<tag>_degraded``
rows and a top-level ``degraded: true``.  A row that fails outright
drops its fields with a warning.  ``--journal``/``--resume`` checkpoint
each cell in an atomic JSONL journal, so a killed run re-run with
``--resume`` measures only the cells the kill took.

``--smoke`` runs the whole pipeline at toy sizes with single-shot timing
(numbers meaningless, shape and plumbing real); with
``PIFFT_FAULT=tube:capacity:1.0`` it is the chaos run: it must exit 0
with ``degraded: true`` and a demotion on the flagship's plan.  That
holds on the CPU, where the chain ends on the library rungs.  On the
card the chain ends at rql, so every kernel refusing leaves nothing to
serve; the card's chaos run caps the fault at one firing
(``PIFFT_FAULT=tube:capacity:1.0:1``) and the flagship lands on rql.  The
reference's conv / overlap-save rows, the serving suites and the event
and trace outputs come with the apps and serving; its smoke-only forced
sixstep cell is left out (the card's 2^25-2^27 rows run sixstep).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

N = 1 << 20
#: the reference bench's large n (its bench.py:96)
LARGE_LOGNS = (22, 24, 25, 26, 27)

SMOKE_N = 1 << 12
SMOKE_LARGE_LOGNS = (13,)

#: the gpu and cpu-native backends' rows, at bounded n in every tier, as
#: the reference
BACKEND_ROW_LOGNS = (8, 10)
BACKEND_ROW_BACKENDS = ("gpu", "cpu-native")
BACKEND_ROW_PREFIX = {"gpu": "gpu", "cpu-native": "cpun"}

#: the library transform every c2c row is compared with
LIBRARY = "torch.fft.fft"

#: seeds of each row kind's input planes
SEED_FFT, SEED_LIBRARY, SEED_RFFT, SEED_BF16, SEED_BACKEND = 0, 2, 5, 7, 13


def _retry(fn, *args, smoke: bool = False, label: str = ""):
    """TRANSIENT faults retried (the fast policy in smoke runs); CAPACITY
    and PERMANENT ones pass straight through."""
    from .resilience import FAST_POLICY, call_with_retry

    return call_with_retry(fn, *args, policy=FAST_POLICY if smoke else None,
                           label=label)


def _planes(n: int, seed: int, device):
    """Two float32 (n,) planes from a seeded generator on `device`."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return (torch.randn(n, generator=gen, device=device),
            torch.randn(n, generator=gen, device=device))


def _smoke_ms(fn, *args) -> float:
    """One-shot time for --smoke: the callable the real run measures,
    none of the loop slope's cost."""
    from .utils.timing import time_ms

    ms, _ = time_ms(fn, *args, reps=2, warmup=1)
    return ms


def _measure(key, device, smoke: bool, seed: int, label: str):
    """(ms, plan) of `key`: in a smoke run the served plan timed once on
    seeded planes, else ``plans.measured_ms``."""
    from . import plans
    from .resilience import maybe_fault

    if smoke:
        plan = plans.get_plan(key, str(device))
        xr, xi = _planes(key.n, seed, device)

        def run_smoke():
            maybe_fault("bench")  # resilience injection site
            return _smoke_ms(plan.execute, xr, xi)

        return _retry(run_smoke, smoke=True, label=f"{label} smoke"), plan

    def run():
        maybe_fault("bench")  # resilience injection site
        return plans.measured_ms(key, device=device)

    return _retry(run, label=label)


def measure_fft_ms(n: int, device, smoke: bool = False) -> tuple:
    """(ms, plan) of the n-point pi-layout c2c key."""
    from . import plans

    key = plans.make_key(n, layout="pi", device=device)
    return _measure(key, device, smoke, SEED_FFT, f"fft n={n}")


def measure_library_ms(n: int, device, smoke: bool = False):
    """ms of ``torch.fft.fft`` on complex64 input at n on `device`, by
    the loop slope (one-shot in smoke runs); None, with a warning, where
    it cannot be measured."""
    import torch

    from .plans import warn
    from .resilience import classify, maybe_fault
    from .utils.timing import slope_ms

    xr, xi = _planes(n, SEED_LIBRARY, device)
    x = torch.complex(xr, xi)
    del xr, xi

    def library(z):
        return torch.fft.fft(z)

    def run():
        maybe_fault("bench")  # resilience injection site
        return _smoke_ms(library, x) if smoke else slope_ms(library, x)

    try:
        return _retry(run, smoke=smoke, label=f"{LIBRARY} n={n}")
    except Exception as e:
        warn(f"{LIBRARY} n={n} not measured ({classify(e).value} "
             f"{type(e).__name__}: {str(e)[:200]}); omitting the "
             f"library comparison")
        return None


def _row_fields(tag: str, nn: int, ms: float, plan, domain: str = "c2c",
                flops_per: float = 5.0) -> dict:
    """The fields every row kind shares: ms, GFLOP/s on the given flop
    count, the plan, the degraded flag, and the roofline figures of the
    variant or rung that served (a demoted row is judged by its rung's
    carries), at the served plan's storage width, against the ceiling of
    the plan's backend (``hw.inventory.peak_bytes_per_s``)."""
    from .hw.inventory import peak_bytes_per_s
    from .utils.roofline import (
        fft_hbm_bytes,
        plan_carry_passes,
        roofline_ceiling,
        roofline_utilization,
    )

    out = {f"{tag}_ms": round(ms, 4),
           f"{tag}_gflops": round(
               flops_per * nn * np.log2(nn) / (ms * 1e-3) / 1e9, 1),
           f"{tag}_plan": plan.describe()}
    if plan.degraded:
        out[f"{tag}_degraded"] = True
    passes = plan_carry_passes(plan.served_variant(), nn)
    ceil = roofline_ceiling(passes)
    if ceil is not None:
        out[f"{tag}_carry_passes"] = passes
        out[f"{tag}_roofline_ceiling"] = round(ceil, 3)
    storage = plan.storage_bytes()
    out[f"{tag}_hbm_bytes"] = fft_hbm_bytes(nn, passes or 0, domain,
                                            storage)
    util = roofline_utilization(
        nn, ms, plan.key.device_kind, domain, storage,
        peak=peak_bytes_per_s(plan.key.backend, plan.key.device_kind))
    if util is not None:
        out[f"{tag}_roofline_util"] = round(util, 3)
        if ceil:
            out[f"{tag}_util_of_ceiling"] = round(util / ceil, 3)
    return out


def _warn_row(what: str, e: BaseException) -> dict:
    from .plans import warn
    from .resilience import classify

    warn(f"{what} not measured ({classify(e).value} {type(e).__name__}: "
         f"{str(e)[:200]})")
    return {}


def _free(device) -> None:
    """Hand the rows' planes and graph pools back to the card."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _pi_parity(plan, n: int, seed: int, device) -> float:
    """max |got - ref| / max |ref| of one call of a pi-layout c2c plan
    against numpy in complex128 (smoke rows)."""
    from .utils.verify import pi_layout_to_natural

    xr, xi = _planes(n, seed, device)
    yr, yi = plan.execute(xr, xi)
    got = pi_layout_to_natural(yr.cpu().numpy() + 1j * yi.cpu().numpy())
    x = xr.cpu().numpy().astype(np.float64) \
        + 1j * xi.cpu().numpy().astype(np.float64)
    ref = np.fft.fft(x)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def measure_large_n_row(logn: int, device, smoke: bool = False) -> dict:
    """The c2c row at n = 2^logn, with the library comparison."""
    nn = 1 << logn
    tag = f"n2^{logn}"
    try:
        ms, plan = measure_fft_ms(nn, device, smoke=smoke)
    except Exception as e:
        return _warn_row(f"large-n 2^{logn}", e)
    out = _row_fields(tag, nn, ms, plan)
    lib = measure_library_ms(nn, device, smoke=smoke)
    if lib is not None:
        out[f"{tag}_library_ms"] = round(lib, 4)
        out[f"{tag}_vs_library"] = round(lib / ms, 2)
    _free(device)
    return out


def measure_rfft_row(logn: int, device, smoke: bool = False) -> dict:
    """The half-spectrum r2c row at n = 2^logn (natural order: the
    Hermitian merge is the r2c contract, there is no gather to
    exclude), GFLOP/s on 2.5 n log2 n."""
    from . import plans

    nn = 1 << logn
    tag = f"rfft2^{logn}"
    key = plans.make_key(nn, layout="natural", domain="r2c", device=device)
    try:
        ms, plan = _measure(key, device, smoke, SEED_RFFT,
                            f"rfft n={nn}")
    except Exception as e:
        return _warn_row(f"rfft 2^{logn}", e)
    out = _row_fields(tag, nn, ms, plan, domain="r2c", flops_per=2.5)
    out[f"{tag}_domain"] = "r2c"
    if smoke:
        from .models.real import rfft

        x, _ = _planes(nn, SEED_RFFT, device)
        ref = np.fft.rfft(x.cpu().numpy().astype(np.float64))
        got = rfft(x, plan=plan).cpu().numpy()
        out[f"{tag}_parity_relerr"] = float(
            np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    _free(device)
    return out


def measure_precision_row(logn: int, mode: str, device,
                          smoke: bool = False) -> dict:
    """The c2c row at n = 2^logn in precision `mode` (bf16: bf16
    storage, the minimum traffic half of float32's)."""
    from . import plans

    nn = 1 << logn
    tag = f"{mode}_2^{logn}"
    key = plans.make_key(nn, layout="pi", precision=mode, device=device)
    try:
        ms, plan = _measure(key, device, smoke, SEED_BF16,
                            f"{mode} n={nn}")
    except Exception as e:
        return _warn_row(f"{mode} 2^{logn}", e)
    out = _row_fields(tag, nn, ms, plan)
    out[f"{tag}_precision"] = plan.effective_precision()
    if smoke:
        out[f"{tag}_parity_relerr"] = _pi_parity(plan, nn, SEED_BF16,
                                                 device)
    _free(device)
    return out


def measure_backend_row(logn: int, backend: str, device,
                        smoke: bool = False) -> dict:
    """The pi-layout c2c row at n = 2^logn under the plan backend
    `backend` (``hw.lowering``: "gpu" or "cpu-native"), tagged with
    it."""
    from . import plans

    nn = 1 << logn
    tag = f"{BACKEND_ROW_PREFIX[backend]}2^{logn}"
    key = plans.make_key(nn, layout="pi", backend=backend, device=device)
    try:
        ms, plan = _measure(key, device, smoke, SEED_BACKEND,
                            f"{backend} n={nn}")
    except Exception as e:
        return _warn_row(f"{backend} 2^{logn}", e)
    out = _row_fields(tag, nn, ms, plan)
    out[f"{tag}_backend"] = backend
    if smoke:
        out[f"{tag}_parity_relerr"] = _pi_parity(plan, nn, SEED_BACKEND,
                                                 device)
    return out


def measure_c_baseline_ms() -> float:
    """The C baseline (the reference's ``measure_c_baseline_ms``): the
    native core's pthreads variant at N, p the largest power of two not
    above ``pifft_num_cores``, best of 3 by total_ms, on the host."""
    from .backends.cpu import NativeBackend, num_cores
    from .cli import make_input

    p = 1
    while p * 2 <= num_cores():
        p *= 2
    return NativeBackend("pthreads").run(make_input(N, seed=0), p,
                                         reps=3).total_ms


def main(argv=None) -> int:
    from . import plans
    from .analyze.records import emit_record, env_fingerprint
    from .utils.device import resolve_device
    from .utils.roofline import (
        plan_carry_passes,
        roofline_ceiling,
        roofline_utilization,
    )

    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="toy sizes and one-shot timing: the whole "
                         "pipeline, numbers meaningless")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="checkpoint each cell to an atomic JSONL journal")
    ap.add_argument("--resume", action="store_true",
                    help="skip the cells the journal holds (default "
                         "journal: bench-journal.jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    n = SMOKE_N if args.smoke else N
    logns = SMOKE_LARGE_LOGNS if args.smoke else LARGE_LOGNS

    journal = None
    if args.journal or args.resume:
        from .resilience import Journal

        journal = Journal(args.journal or "bench-journal.jsonl")
        if args.resume:
            journal.load()
        else:
            journal.reset()
        # cells are keyed by name, so the journal carries its run's
        # configuration and a resume under another one is refused
        try:
            journal.guard_config(
                {"n": n, "logns": list(logns), "smoke": bool(args.smoke),
                 "device": device.type}, label="bench")
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    def cell(name, compute):
        """compute() -> a JSON-safe payload, checkpointed per cell.  An
        empty payload (a row that failed outright) is never journaled,
        so --resume measures it again."""
        if journal is not None and journal.has(name):
            rec = dict(journal.get(name))
            rec.pop("cell", None)
            plans.warn(f"bench --resume: cell {name} loaded from journal "
                       f"(not re-measured)")
            return rec
        out = compute()
        if journal is not None and out:
            journal.record(name, out)
        return out

    def flagship_cell():
        ms, plan = measure_fft_ms(n, device, smoke=args.smoke)
        out = {"ms": ms, "plan": plan.describe(),
               "device_kind": plan.key.device_kind,
               "served": plan.served_variant()}
        if plan.degraded:
            out["degraded"] = True
        return out

    def library_cell():
        ms = measure_library_ms(n, device, smoke=args.smoke)
        return {} if ms is None else {"library_ms": ms}

    flagship = cell("flagship", flagship_cell)
    library = cell("library", library_cell)
    rows = {}
    for logn in logns:
        for prefix, measure in (
                ("n", measure_large_n_row), ("rfft", measure_rfft_row),
                ("bf16_", lambda logn, *a, **k: measure_precision_row(
                    logn, "bf16", *a, **k))):
            rows.update(cell(f"{prefix}2^{logn}",
                             lambda logn=logn, measure=measure: measure(
                                 logn, device, smoke=args.smoke)))
    for backend in BACKEND_ROW_BACKENDS:
        for logn in BACKEND_ROW_LOGNS:
            rows.update(cell(
                f"{BACKEND_ROW_PREFIX[backend]}2^{logn}",
                lambda logn=logn, backend=backend: measure_backend_row(
                    logn, backend, device, smoke=args.smoke)))
    # the C baseline runs at the full flagship N: against a smoke run's
    # toy-n flagship the ratio would mean nothing, so smoke omits it
    c_ms = None if args.smoke else cell(
        "c_baseline", lambda: {"c_ms": measure_c_baseline_ms()})["c_ms"]

    ms = flagship["ms"]
    lib_ms = library.get("library_ms")
    record = {
        "metric": f"fft1d_n2^{n.bit_length() - 1}_complex64_gflops",
        "value": round(5.0 * n * np.log2(n) / (ms * 1e-3) / 1e9, 1),
        "unit": "GFLOP/s",
        "ms": round(ms, 4),
        "plan": flagship["plan"],
        "env": env_fingerprint(smoke=bool(args.smoke),
                               device_kind=flagship.get("device_kind"),
                               device=device),
        "library": LIBRARY,
    }
    if args.smoke:
        record["smoke"] = True
    if flagship.get("degraded") or any(
            k.endswith("_degraded") and v for k, v in rows.items()):
        # a demoted plan anywhere taints the whole line
        record["degraded"] = True
    passes = plan_carry_passes(flagship["served"], n)
    ceil = roofline_ceiling(passes)
    if ceil is not None:
        record["roofline_ceiling"] = round(ceil, 3)
    util = roofline_utilization(n, ms, flagship["device_kind"])
    if util is not None:
        record["roofline_util"] = round(util, 3)
        if ceil:
            record["util_of_ceiling"] = round(util / ceil, 3)
    if lib_ms is not None:
        record["library_fft_ms"] = round(lib_ms, 4)
        record["vs_library_fft"] = round(lib_ms / ms, 2)
    if c_ms is not None:
        record["c_ms"] = round(c_ms, 4)
        record["vs_baseline"] = round(c_ms / ms, 1)
    record.update(rows)
    emit_record(record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
