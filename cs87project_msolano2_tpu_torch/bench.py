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
* For each K in LARGE_LOGNS two spectral-op rows (``apps``):
  ``conv2^K_*``, the fused circular convolution at n = 2^K against a
  cached 129-tap kernel spectrum (ms by the loop slope, ``event_ms``
  beside it, GFLOP/s on the two real transforms it runs, 2 x 2.5 n log2
  n, the share of the bound on the op's fused floor, and
  ``hbm_bytes``, the bytes-meter delta of one execution), and
  ``os2^K_*``, overlap-save of a 4 x 2^K-sample signal at block 2^K,
  skipped with a diagnostic past ``apps.stream.MAX_BLOCK``; then one
  ``conv_np<n>_*`` row at the length ``cheapest_length`` picks for a
  3 x 2^18-sample linear convolution (mixed radix), with the meter's
  charge of the same op at next_pow2 beside it (``_pow2_hbm_bytes``).
  The reference times a conv row by the wall median of 5; the port by
  the loop slope, its time per transform.
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
reference's serving suites and the event and trace outputs come with
serving; its smoke-only forced sixstep cell is left out (the card's
2^25-2^27 rows run sixstep).
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
#: seeds of the spectral-op rows (the reference's)
SEED_CONV, SEED_OS, SEED_CONV_NP = 9, 10, 11
#: taps of the op rows' kernels
OP_TAPS = 129


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


def _metered_hbm_delta(fn) -> tuple:
    """(result, bytes) of calling `fn`: the ``pifft_hbm_bytes_total``
    delta it charged on the bytes meter."""
    from .utils.roofline import meter_value

    before = meter_value("pifft_hbm_bytes_total")
    out = fn()
    return out, int(meter_value("pifft_hbm_bytes_total") - before)


def _op_ms(fn, *args, smoke: bool = False) -> tuple:
    """(ms, event_ms) of one fused-op call: the loop slope fitted to the
    call (``utils.timing.fitted_slope_ms``), the port's time per
    transform, beside the CUDA-event median; one-shot for --smoke."""
    from .utils.timing import fitted_slope_ms, time_ms

    if smoke:
        ms = _smoke_ms(fn, *args)
        return ms, ms
    return fitted_slope_ms(fn, *args), time_ms(fn, *args, reps=10)[0]


def _conv_row(tag: str, nn: int, x, k, device, smoke: bool,
              label: str) -> dict:
    """The fields of one fused circular-conv row at length nn: the
    pipeline against the cached spectrum of `k`, timed, metered, its
    share of the bound on the op's fused floor, and (smoke) its parity
    with the numpy oracle."""
    import torch

    from . import plans
    from .apps.spectral import _fused_circular, kernel_spectrum, numpy_oracle
    from .hw.inventory import peak_bytes_per_s
    from .resilience import maybe_fault
    from .utils.roofline import (
        charge_spectral_traffic,
        spectral_roofline_utilization,
    )

    try:
        kr, ki = kernel_spectrum(k, nn, device=device)
        fused = _fused_circular("conv", nn, None, device)
        xp = torch.from_numpy(x).to(device)

        def run_cell():
            maybe_fault("bench")  # resilience injection site
            return _op_ms(fused, xp, kr, ki, smoke=smoke)

        ms, event_ms = _retry(run_cell, smoke=smoke, label=label)
    except Exception as e:
        return _warn_row(label, e)
    plan = plans.plan_for((nn,), layout="natural", domain="r2c",
                          device=device)
    # the timed pipeline runs two transforms (the kernel spectrum is
    # cached): one rfft of the signal and one irfft
    out = {f"{tag}_ms": round(ms, 4), f"{tag}_event_ms": round(event_ms, 4),
           f"{tag}_gflops": round(
               2 * 2.5 * nn * np.log2(nn) / (ms * 1e-3) / 1e9, 1),
           f"{tag}_op": "conv", f"{tag}_plan": plan.describe()}
    if plan.degraded:
        out[f"{tag}_degraded"] = True
    _, hbm = _metered_hbm_delta(lambda: charge_spectral_traffic("conv", nn))
    out[f"{tag}_hbm_bytes"] = hbm
    util = spectral_roofline_utilization(
        "conv", nn, ms, plan.key.device_kind,
        peak=peak_bytes_per_s(plan.key.backend, plan.key.device_kind))
    if util is not None:
        out[f"{tag}_roofline_util"] = round(util, 3)
    if smoke:
        y = fused(xp, kr, ki).cpu().numpy()
        ref = numpy_oracle("conv", x, np.pad(k, (0, nn - k.shape[0])), nn)
        out[f"{tag}_parity_relerr"] = float(
            np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
    _free(device)
    return out


def measure_conv_row(logn: int, device, smoke: bool = False) -> dict:
    """The fused spectral-convolution row at n = 2^logn, beside the
    transform rows at the same n: the circular conv primitive, rfft(x)
    times a cached kernel spectrum, irfft, all on the device."""
    nn = 1 << logn
    rng = np.random.default_rng(SEED_CONV)
    x = rng.standard_normal(nn).astype(np.float32)
    k = rng.standard_normal(OP_TAPS).astype(np.float32)
    return _conv_row(f"conv2^{logn}", nn, x, k, device, smoke,
                     f"conv 2^{logn}")


def measure_conv_np_row(device, smoke: bool = False) -> dict:
    """The any-length fftconv row: the fused circular conv at the length
    ``cheapest_length`` picks for a 3·2^18-sample linear convolution
    (3·2^8 in smoke; mixed radix), with the meter's charge of the same
    op at next_pow2 beside it, so the pad-to-pow2 tax the row shows gone
    is read from the meter."""
    from .apps.spectral import cheapest_length, next_pow2
    from .utils.roofline import charge_spectral_traffic

    # the linear length la + lv - 1 lands on 3·2^k exactly
    lv = OP_TAPS
    la = (3 * (1 << 8) if smoke else 3 * (1 << 18)) - (lv - 1)
    nn = cheapest_length(la + lv - 1)
    tag = f"conv_np{nn}"
    rng = np.random.default_rng(SEED_CONV_NP)
    x = rng.standard_normal(nn).astype(np.float32)
    k = rng.standard_normal(lv).astype(np.float32)
    out = _conv_row(tag, nn, x, k, device, smoke, f"conv_np {nn}")
    if out:
        _, out[f"{tag}_pow2_hbm_bytes"] = _metered_hbm_delta(
            lambda: charge_spectral_traffic("conv", next_pow2(la + lv - 1)))
    return out


def measure_os_row(logn: int, device, smoke: bool = False) -> dict:
    """The overlap-save row at block 2^logn: a signal of 4 blocks through
    ONE cached plan pair, with the chunk count and overlap waste (the
    two sides of the block-size trade), the host-clock time of the whole
    stream and the metered traffic.  Past ``apps.stream.MAX_BLOCK`` the
    row is skipped with a diagnostic, never measured at a capped block
    its tag would misname."""
    import time

    from .apps.stream import MAX_BLOCK, chunk_count, overlap_save, \
        overlap_waste
    from .plans import warn
    from .resilience import maybe_fault

    if (1 << logn) > MAX_BLOCK:
        warn(f"overlap-save 2^{logn} skipped: block past the "
             f"raced-candidate ceiling MAX_BLOCK="
             f"2^{MAX_BLOCK.bit_length() - 1} (apps/stream.py block-size "
             f"tuning)")
        return {}
    block = 1 << logn
    n_signal = 4 * block
    tag = f"os2^{logn}"
    rng = np.random.default_rng(SEED_OS)
    x = rng.standard_normal(n_signal).astype(np.float32)
    k = rng.standard_normal(OP_TAPS).astype(np.float32)
    try:
        def run_cell():
            maybe_fault("bench")  # resilience injection site
            t0 = time.perf_counter()
            y = overlap_save(x, k, block=block, device=device)
            return (time.perf_counter() - t0) * 1e3, y

        (ms, y), hbm = _metered_hbm_delta(
            lambda: _retry(run_cell, smoke=smoke,
                           label=f"overlap-save block={block}"))
    except Exception as e:
        return _warn_row(f"overlap-save 2^{logn}", e)
    out = {f"{tag}_ms": round(ms, 4), f"{tag}_block": block,
           f"{tag}_signal_n": n_signal,
           f"{tag}_chunks": chunk_count(n_signal, OP_TAPS, block),
           f"{tag}_overlap_waste": round(overlap_waste(block, OP_TAPS), 4),
           f"{tag}_op": "conv", f"{tag}_hbm_bytes": hbm}
    if smoke:
        ref = np.convolve(x.astype(np.float64), k.astype(np.float64),
                          "full")
        out[f"{tag}_parity_relerr"] = float(
            np.max(np.abs(y - ref)) / np.max(np.abs(ref)))
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
                    logn, "bf16", *a, **k)),
                ("conv", measure_conv_row), ("os", measure_os_row)):
            rows.update(cell(f"{prefix}2^{logn}",
                             lambda logn=logn, measure=measure: measure(
                                 logn, device, smoke=args.smoke)))
    rows.update(cell("conv_np", lambda: measure_conv_np_row(
        device, smoke=args.smoke)))
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
