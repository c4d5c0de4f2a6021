"""The ``gpu`` and ``cpu-native`` plan backends: the reference's
``hw/lowering.py`` families, the gpu one on the port's own kernel.

``plans.ladder`` dispatches here for keys whose ``backend`` is "gpu";
the variant names are disjoint from the ``cuda`` family's, so a stored
winner of one backend can never hand the other a foreign variant.
The reference's names map so:

    reference   port          executor
    ----------  ------------  ---------------------------------------------
    gpu-rows    gpu-rows      ``fft_rows_gpu``: ``ops.cuda_fft.gpu_rows``
                              (csrc/gpu_rows.cu), one launch per call
    gpu-jnp     gpu-stages    ``models.fft.fft_planes``, the all-float32
                              stage path (the ``cuda`` family's
                              ``stages``); natural order only

The rules are the reference's: ``gpu-rows`` serves power-of-two rows of
2..GPU_ROWS_MAX_N points in pi or natural order (the bit-reversal gather
follows the kernel for natural order); the static default takes it up to
GPU_ROWS_STATIC_MAX_N on any device, and up to GPU_ROWS_MAX_N for a key
that names a card, and ``gpu-stages`` for a larger natural-order key
(or a longer one offline).  A pi-layout key that no ``gpu-rows`` serves
raises.  An even-n r2c or c2r key rides its half-length c2c subkey
(``plans.ladder.c2c_subkey``), the executor wrapped in the pack and
Hermitian passes of ``models.real``, as the reference's
(hw/lowering.py:242-311); a key whose n (or whose half-length subkey's
n) is not a power of two raises, as the reference's static default
does (its any-length variants are the ``cuda`` family's).  A key in
bf16 mode gets what the reference's gpu family gives it: the same candidates and default, run in float32 (the gpu
family has no narrow storage, so ``Plan.storage_bytes`` charges 4
bytes).

``plans.ladder`` dispatches "cpu-native" keys here too: the reference's
cpu-native family (hw/lowering.py:158-359), the native C core as a
ladder rung.  Its one variant, ``cpu-native``, runs each row of the
planes through the core's pthreads variant on the host
(``backends.cpu.NativeBackend``) with `p` virtual processors, the raced
parameter (the paper's p sweep as a plan axis): capacity first
(``native_capacity_p``), then one halving, then 1.  The planes go to
the host and the result comes back to their device.  Where the core
cannot be built the rung raises the build error
(``resilience.KernelBuildError``, which the degradation chain never
demotes): unlike the reference's rung it has no numpy stand-in.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops.bits import is_power_of_two, to_natural
from ..ops.cuda_fft import (
    GPU_ROWS_MAX_N,
    gpu_rows,
    gpu_rows_blocking,
    gpu_rows_plain,
)
from ..plans.core import PlanKey, offline_kind
from ..utils.device import as_planes

#: above this n the static default serves ``gpu-rows`` only to a key
#: that names a card (the reference's bound, hw/lowering.py:42)
GPU_ROWS_STATIC_MAX_N = 1 << 14


def twiddle_stack(n: int) -> tuple:
    """(stages, n//2) float32 twiddle planes: row s holds W_m^j for
    m = n >> s, j < m//2 (zero-padded past it) — the whole DIF
    schedule's tables as two dense arrays, bit-identical to the
    reference's ``_twiddle_stack``."""
    stages = n.bit_length() - 1
    twr = np.zeros((stages, max(n // 2, 1)), dtype=np.float32)
    twi = np.zeros((stages, max(n // 2, 1)), dtype=np.float32)
    for s in range(stages):
        m = n >> s
        half = m // 2
        j = np.arange(half)
        w = np.exp(-2j * np.pi * j / m)
        twr[s, :half] = w.real.astype(np.float32)
        twi[s, :half] = w.imag.astype(np.float32)
    return twr, twi


@lru_cache(maxsize=16)
def device_twiddle_stack(n: int, device) -> tuple:
    """``twiddle_stack(n)`` as float32 tensors on `device`."""
    return tuple(torch.from_numpy(t).to(device) for t in twiddle_stack(n))


def _rows_view(xr, xi, name: str):
    if xr.shape != xi.shape or xr.dim() < 1:
        raise ValueError(f"{name}: re/im planes must share one shape, got "
                         f"{tuple(xr.shape)} / {tuple(xi.shape)}")
    n = xr.shape[-1]
    return (xr.contiguous().reshape(-1, n), xi.contiguous().reshape(-1, n),
            n)


def fft_rows_gpu_plain(xr, xi):
    """Plain version of ``fft_rows_gpu``: ``ops.cuda_fft.gpu_rows_plain``
    (the reference's stage loop) on every trailing-axis row."""
    shape = xr.shape
    xr2, xi2, n = _rows_view(xr, xi, "fft_rows_gpu_plain")
    gpu_rows_blocking(xr2.shape[0] or 1, n)
    yr, yi = gpu_rows_plain(xr2, xi2, *device_twiddle_stack(n, xr.device))
    return yr.reshape(shape), yi.reshape(shape)


def fft_rows_gpu(xr, xi, block_rows=None):
    """pi-layout (bit-reversed) FFT of each trailing-axis row of float32
    planes through the gpu-rows kernel, ONE launch per call (the
    reference's fft_rows_gpu, hw/lowering.py:116).  ``block_rows`` rows
    share a block (None: ``ops.cuda_fft.gpu_rows_blocking`` picks);
    CPU tensors take the kernel's plain version."""
    shape = xr.shape
    xr2, xi2, n = _rows_view(xr, xi, "fft_rows_gpu")
    yr, yi = gpu_rows(xr2, xi2, *device_twiddle_stack(n, xr.device),
                      block_rows=block_rows)
    return yr.reshape(shape), yi.reshape(shape)


def _nrows(key: PlanKey) -> int:
    return math.prod(key.batch) or 1


def _check_key(key: PlanKey) -> None:
    # the precision mode is not checked: the gpu and cpu-native families
    # serve every mode in float32, as the reference's do
    if key.domain != "c2c" or not is_power_of_two(key.n):
        raise ValueError(
            f"backend={key.backend!r} serves power-of-two c2c (and the "
            f"even real domains riding it) only; n={key.n} "
            f"domain={key.domain!r} rides the cuda family's any-length "
            f"variants")


def _real_subkey(key: PlanKey):
    """The half-length c2c subkey of an even-n real-domain key, else
    None."""
    if key.domain != "c2c" and key.n % 2 == 0:
        from ..plans.ladder import c2c_subkey

        return c2c_subkey(key)
    return None


def candidates(key: PlanKey) -> list:
    """The ordered (variant, params) race for a gpu key: gpu-rows with
    automatic blocking, then 8 rows a block where 8 divides the rows,
    then the stage path for natural order; an even-n real-domain key
    races its half-length c2c subkey's entries."""
    sub = _real_subkey(key)
    if sub is not None:
        return candidates(sub)
    _check_key(key)
    if key.backend == "cpu-native":
        cap = native_capacity_p(key.n)
        return [("cpu-native", {"p": p})
                for p in sorted({cap, max(cap // 2, 1), 1}, reverse=True)]
    cands = []
    if 2 <= key.n <= GPU_ROWS_MAX_N:
        cands.append(("gpu-rows", {"block_rows": None}))
        if _nrows(key) % 8 == 0:
            cands.append(("gpu-rows", {"block_rows": 8}))
    if key.layout == "natural":
        cands.append(("gpu-stages", {}))
    return cands


def static_default(key: PlanKey):
    """(variant, params) for a gpu key when nothing is tuned or stored:
    gpu-rows for n up to GPU_ROWS_STATIC_MAX_N, up to GPU_ROWS_MAX_N for
    a key naming a card, and for every pi-layout key (which raises past
    GPU_ROWS_MAX_N: no gpu rung serves it); gpu-stages otherwise.  An
    even-n real-domain key takes its half-length c2c subkey's."""
    sub = _real_subkey(key)
    if sub is not None:
        return static_default(sub)
    _check_key(key)
    if key.backend == "cpu-native":
        return "cpu-native", {"p": native_capacity_p(key.n)}
    small = 2 <= key.n <= GPU_ROWS_STATIC_MAX_N
    large_ok = (2 <= key.n <= GPU_ROWS_MAX_N
                and not offline_kind(key.device_kind))
    if small or large_ok or key.layout == "pi":
        if not 2 <= key.n <= GPU_ROWS_MAX_N:
            raise ValueError(
                f"gpu-rows bound exceeded for pi layout (n={key.n} not in "
                f"[2, {GPU_ROWS_MAX_N}]); no gpu rung serves it")
        return "gpu-rows", {"block_rows": None}
    return "gpu-stages", {}


def build_executor(key: PlanKey, variant: str, params: dict):
    """The (xr, xi) -> (yr, yi) executor for one gpu ladder entry.
    Raises ValueError for an unknown variant and for a block_rows the
    kernel cannot take, before anything launches (the tuner records
    those as rejections).  An even-n real-domain key wraps the
    half-length c2c executor of the same entry."""
    sub = _real_subkey(key)
    if sub is not None:
        from ..models import real

        return real.real_executor(build_executor(sub, variant, params),
                                  key.domain, key.n)
    _check_key(key)
    natural = key.layout == "natural"
    if key.backend == "cpu-native":
        if variant != "cpu-native":
            raise ValueError(f"unknown {key.backend} plan variant "
                             f"{variant!r}")
        return _native_executor(key.n, int(params.get("p") or 1), natural)
    if variant == "gpu-stages":
        if not natural:
            raise ValueError("the stage path only produces natural order")
        from ..models.fft import fft_planes

        return fft_planes
    if variant != "gpu-rows":
        raise ValueError(f"unknown {key.backend} plan variant {variant!r}")
    block_rows = params.get("block_rows")
    gpu_rows_blocking(_nrows(key), key.n, block_rows)

    def gpu_run(xr, xi):
        yr, yi = fft_rows_gpu(xr, xi, block_rows=block_rows)
        return to_natural(yr, yi) if natural else (yr, yi)

    return gpu_run


# --------------------------------------------------------- cpu-native

def native_capacity_p(n: int) -> int:
    """The largest sensible virtual-processor count for an n-point
    native run: the cores this process may use, clipped by the core's
    own capacity probe, rounded down to a power of two and clipped by n
    (the reference's probe-and-clip rule as a plan bound).  Raises the
    build error where the core cannot be built."""
    from ..backends.cpu import NativeBackend
    from .inventory import cpu_cores

    cores = max(cpu_cores(), 1)
    cap = NativeBackend("pthreads").capacity()
    if cap:
        cores = min(cores, cap)
    p = 1 << (cores.bit_length() - 1)
    return max(min(p, n), 1)


def _native_executor(n: int, p: int, natural: bool):
    """The cpu-native rung's executor: every trailing-axis row of the
    planes through the core's pthreads variant at `p` (one warm-up run,
    then one timed, as ``NativeBackend.run``), pi layout or, for a
    natural key, the bit-reversal gather after it; the planes go to the
    host and the result comes back as float32 planes on their device.
    Each row's native timer is observed on ``pifft_hw_native_ms``."""
    from ..backends.cpu import NativeBackend
    from ..obs import metrics

    if p & (p - 1) or not 1 <= p <= n:
        raise ValueError(f"cpu-native p={p} must be a power of two in "
                         f"[1, n={n}]")
    native = NativeBackend("pthreads")
    native.capacity()  # builds the core now: a missing one raises here

    def native_run(xr, xi):
        shape = xr.shape
        x = (xr.detach().to("cpu", torch.float32).numpy()
             + 1j * xi.detach().to("cpu", torch.float32).numpy())
        flat = np.ascontiguousarray(x.reshape(-1, n), dtype=np.complex64)
        out = np.empty_like(flat)
        for i in range(flat.shape[0]):
            res = native.run(flat[i], p, reps=1)
            out[i] = res.out
            metrics.observe("pifft_hw_native_ms", res.total_ms,
                            backend="cpu-native")
        yr, yi = as_planes(out.real.reshape(shape), out.imag.reshape(shape),
                           xr.device)
        return to_natural(yr, yi) if natural else (yr, yi)

    return native_run
