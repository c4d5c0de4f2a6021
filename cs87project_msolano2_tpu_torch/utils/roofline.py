"""Device-memory roofline accounting for the FFT paths on an NVIDIA card
(the FFT half of the reference's ``utils/roofline.py``).

An FFT that leaves one shared-memory tile is memory-bound: its 5 n log2 n
flops ride far under the card's float32 peak.  The bound charged here is
the MINIMUM traffic any implementation must move — read the re+im
float32 planes once, write them once (16 bytes per element) — and each
materialized intermediate (a carry pass: the fourstep carry, either of
sixstep's two, the rql intermediate) moves one more full round trip, so
a path with ``p`` plan-declared carry passes can reach at most
``1/(1+p)`` of the bound:

    carry-free (rows, fused, gpu-rows      ceiling 1.0
                to 2^18: long rows on a
                cluster never leave the chip)
    one carry  (fourstep, rql, mf)         ceiling 0.5
    two carries (sixstep, n >= 2^25)       ceiling 1/3

Peaks are keyed on the CUDA device name (``torch.cuda.get_device_name``)
and come from NVIDIA's data sheets; an unknown card gives None, never a
figure of another device.

The spectral half (the reference's roofline.py:169-263) models what a
spectral OPERATION must move when its half-spectrum never leaves the
card between the paired transforms (``spectral_min_hbm_bytes``), what
an unfused one moves on top (``spectral_hbm_bytes``), and meters each
op execution (``charge_spectral_traffic``) on :data:`HBM_METER`, the
stand-in for the reference's obs counters under their series names.
"""

from __future__ import annotations

import threading
from typing import Optional

#: peak device-memory bandwidth, bytes/s, by a substring of the CUDA
#: device name (NVIDIA data sheets; "H100 80GB HBM3" is how the SXM part
#: names itself)
GPU_PEAK_BYTES_PER_S = {
    "H100 SXM": 3.35e12,
    "H100 80GB HBM3": 3.35e12,
    "H100 PCIe": 2.0e12,
    "H200": 4.8e12,
}

#: peak dense bf16 rate of the tensor cores, flop/s (NVIDIA data
#: sheets), the matmul funnel's products
GPU_PEAK_BF16_FLOPS = {
    "H100 SXM": 989e12,
    "H100 80GB HBM3": 989e12,
    "H100 PCIe": 756e12,
    "H200": 989e12,
}

#: peak float32 rate outside the tensor cores, flop/s (NVIDIA data
#: sheets; the H200 keeps the H100 SXM's SMs and clocks)
GPU_PEAK_FP32_FLOPS = {
    "H100 SXM": 67e12,
    "H100 80GB HBM3": 67e12,
    "H100 PCIe": 51e12,
    "H200": 67e12,
}

# Materialized-intermediate round trips per plan variant (the
# reference's PLAN_CARRY_PASSES, its roofline.py:55).
PLAN_CARRY_PASSES = {
    "rows": 0,
    "fused": 0,
    "fused-alias": 0,
    "fourstep": 1,
    "rql": 1,
    "two-kernel": 1,
    "mf": 1,
    "sixstep": 2,
    "bluestein": 2,
    "rader": 2,
    "mixedradix": 1,
}

def _lookup(table: dict, device_name: str) -> Optional[float]:
    """Longest-substring match of `device_name` against `table`'s keys
    (case-insensitive), or None."""
    name = (device_name or "").lower()
    best = None
    for sub, value in table.items():
        if sub.lower() in name and (best is None or len(sub) > best[0]):
            best = (len(sub), value)
    return best[1] if best else None


def peak_bytes_per_s(device_name: str) -> Optional[float]:
    """Peak device-memory bytes/s of the card named `device_name`, or
    None for a card not in the table."""
    return _lookup(GPU_PEAK_BYTES_PER_S, device_name)


def peak_fp32_flops(device_name: str) -> Optional[float]:
    """Peak float32 flop/s (no tensor cores) of the card, or None."""
    return _lookup(GPU_PEAK_FP32_FLOPS, device_name)


def peak_bf16_flops(device_name: str) -> Optional[float]:
    """Peak dense bf16 tensor-core flop/s of the card, or None."""
    return _lookup(GPU_PEAK_BF16_FLOPS, device_name)


def plan_carry_passes(variant: str, n: Optional[int] = None) -> Optional[int]:
    """Plan-declared carry passes for a ladder variant, or None for
    paths this model does not cover (the stage paths).  ``gpu-rows``
    charges 0 for every row it serves (up to GPU_ROWS_MAX_N points): a
    row one block cannot hold runs on a thread-block cluster that keeps
    it in distributed shared memory, so it moves through device memory
    once each way; None without n, or past GPU_ROWS_MAX_N.  The
    reference leaves its gpu rows out of PLAN_CARRY_PASSES."""
    if variant == "gpu-rows":
        from ..ops.cuda_fft import GPU_ROWS_MAX_N

        if n is None or n > GPU_ROWS_MAX_N:
            return None
        return 0
    return PLAN_CARRY_PASSES.get(variant)


def fft_min_hbm_bytes(n: int, domain: str = "c2c",
                      storage_bytes: int = 4) -> int:
    """The floor any n-point plane FFT must move through device memory:
    c2c reads and writes the re+im planes once (4 * storage_bytes bytes
    per element, 16 at float32); the real domains move half that.
    Twiddle tables are excluded: they are an implementation's choice."""
    if domain in ("r2c", "c2r"):
        return 2 * storage_bytes * n
    return 4 * storage_bytes * n


def fft_hbm_bytes(n: int, carry_passes: int = 0, domain: str = "c2c",
                  storage_bytes: int = 4, pad_n: Optional[int] = None) -> int:
    """The traffic of an n-point transform with `carry_passes`
    materialized intermediates: the floor plus one full write+read round
    trip of the planes per carry pass.  An any-length plan's carries
    live at its padded length: pass its ``params["pad"]`` as `pad_n` and
    each carry is charged at the pad, the floor always at n."""
    carry_unit = fft_min_hbm_bytes(pad_n or n, domain, storage_bytes)
    return fft_min_hbm_bytes(n, domain, storage_bytes) \
        + carry_passes * carry_unit


def roofline_utilization(n: int, ms: float, device_name: str,
                         domain: str = "c2c",
                         storage_bytes: int = 4,
                         peak: Optional[float] = None) -> Optional[float]:
    """The achieved share of the card's data-sheet bandwidth (or of
    `peak` bytes/s where given: another backend's ceiling) of an n-point
    transform taking `ms` a call, charging the minimum traffic of its
    domain and storage (``fft_min_hbm_bytes``), so the figure reads
    against the 1/(1+p) ceiling of the path's carry passes (the
    reference's ``roofline_utilization``, without its metered counter).
    None for a card the table does not know or a time that is not
    positive."""
    peak = peak or peak_bytes_per_s(device_name)
    if peak is None or ms is None or ms <= 0.0:
        return None
    return fft_min_hbm_bytes(n, domain, storage_bytes) / (ms * 1e-3) / peak


def roofline_ceiling(carry_passes: Optional[int]) -> Optional[float]:
    """The share of the minimum-traffic bound a perfectly overlapped path
    with `carry_passes` intermediates can reach: 1/(1+p).  None passes
    through (unmodeled paths)."""
    if carry_passes is None:
        return None
    return 1.0 / (1 + carry_passes)


def bound_ms(nbytes: int, flops: int, device_name: str,
             bf16_flops: int = 0):
    """(ms, "bytes" or "operations"): the least time the card named
    `device_name` could take to move `nbytes`, do `flops` float32
    operations and `bf16_flops` bf16 tensor-core operations — the larger
    of the bytes' time and the operations' (each type at its own
    data-sheet peak, the two summed).  Raises ValueError for a card the
    tables do not know."""
    bw = peak_bytes_per_s(device_name)
    fl = peak_fp32_flops(device_name)
    tc = peak_bf16_flops(device_name)
    if bw is None or fl is None or tc is None:
        raise ValueError(f"no data-sheet peaks for the card "
                         f"{device_name!r}; add it to utils/roofline.py")
    t_bytes, t_ops = nbytes / bw, flops / fl + bf16_flops / tc
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------- spectral ops
#
# Fused-op minimum-traffic models: what a spectral OPERATION —
# convolution, correlation, a spectral solve — must move through device
# memory when its half-spectrum intermediate never leaves the pipeline.
# The floor is the op's own I/O plus the kernel spectrum it reads
# (conv/corr); the internal transforms' extra traffic is the
# implementation's choice, as twiddle tables are in fft_min_hbm_bytes.
# An UNFUSED implementation — one that takes the half-spectrum to the
# host between the rfft and the irfft — moves the spectrum out and back
# in on top of the floor: ``spectral_hbm_bytes(..., host_round_trips=1)``.

#: the spectral operations; "fft" is the bare transform every other op
#: composes
SPECTRAL_OPS = ("fft", "conv", "corr", "solve")

#: the bytes meter, series name -> {sorted label items: value}: the
#: stand-in for the reference's obs counters ``pifft_hbm_bytes_total``,
#: ``pifft_hbm_min_bytes_total`` and ``pifft_apps_hbm_bytes_total{op}``
#: (obs: not ported), always on
HBM_METER: dict = {}
_METER_LOCK = threading.Lock()


def meter_inc(name: str, value: float, **labels) -> None:
    """Add `value` to the series `name` with `labels`."""
    series = tuple(sorted(labels.items()))
    with _METER_LOCK:
        by_labels = HBM_METER.setdefault(name, {})
        by_labels[series] = by_labels.get(series, 0.0) + float(value)


def meter_value(name: str, **labels) -> float:
    """The value of one series (0 when absent), as the reference's
    ``metrics.counter_value``: the labels select exactly one series."""
    with _METER_LOCK:
        return HBM_METER.get(name, {}).get(tuple(sorted(labels.items())),
                                           0.0)


def meter_reset() -> None:
    """Drop every series (tests)."""
    with _METER_LOCK:
        HBM_METER.clear()


def spectral_min_hbm_bytes(op: str, n: int, storage_bytes: int = 4) -> int:
    """The fused floor of one n-point spectral op on real input:
    conv/corr read the signal (n), read the cached kernel half-spectrum
    (2·(n/2+1) plane values) and write the real output (n); solve reads
    the field and writes the solution (its multiplier is a table,
    excluded like twiddles).  "fft" is the r2c transform's own floor."""
    if op == "fft":
        return fft_min_hbm_bytes(n, "r2c", storage_bytes)
    if op in ("conv", "corr"):
        return storage_bytes * (2 * n + 2 * (n // 2 + 1))
    if op == "solve":
        return storage_bytes * 2 * n
    raise ValueError(f"op={op!r} not in {SPECTRAL_OPS}")


def spectral_hbm_bytes(op: str, n: int, host_round_trips: int = 0,
                       storage_bytes: int = 4) -> int:
    """The traffic an n-point spectral op moves: the fused floor plus
    one full write and read of the half-spectrum planes (2 × 2·(n/2+1)
    values) per host round trip between the paired transforms."""
    trip = 2 * 2 * storage_bytes * (n // 2 + 1)
    return spectral_min_hbm_bytes(op, n, storage_bytes) \
        + host_round_trips * trip


def charge_spectral_traffic(op: str, n: int, host_round_trips: int = 0,
                            storage_bytes: int = 4, count: int = 1) -> int:
    """Meter `count` spectral-op executions on :data:`HBM_METER`: the
    op's traffic on ``pifft_hbm_bytes_total`` and, labelled by op, on
    ``pifft_apps_hbm_bytes_total``, its floor on
    ``pifft_hbm_min_bytes_total``.  Returns the charged bytes."""
    charged = count * spectral_hbm_bytes(op, n, host_round_trips,
                                         storage_bytes)
    meter_inc("pifft_hbm_min_bytes_total",
              count * spectral_min_hbm_bytes(op, n, storage_bytes))
    meter_inc("pifft_hbm_bytes_total", charged)
    meter_inc("pifft_apps_hbm_bytes_total", charged, op=op)
    return charged


def spectral_roofline_utilization(op: str, n: int, ms: float,
                                  device_name: str,
                                  storage_bytes: int = 4,
                                  peak: Optional[float] = None
                                  ) -> Optional[float]:
    """The share of the card's data-sheet bandwidth (or of `peak`) that
    one fused spectral op taking `ms` a call reaches on its fused floor
    (the bench conv rows' figure).  Meters nothing: the op's execution
    already charged its traffic.  None for a card the table does not
    know or a time that is not positive."""
    peak = peak or peak_bytes_per_s(device_name)
    if peak is None or ms is None or ms <= 0.0:
        return None
    return spectral_min_hbm_bytes(op, n, storage_bytes) / (ms * 1e-3) / peak
