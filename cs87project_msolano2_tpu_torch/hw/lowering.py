"""The ``gpu`` plan backend: the reference's ``hw/lowering.py`` gpu
family, on the port's own kernel.

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
raises.  Real domains, non-power-of-two n and bf16 storage raise as the
``cuda`` family does; the reference's ``cpu-native`` family is not
ported (``plans.core`` refuses the backend).
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
from ..ops.precision import ported_storage
from ..plans.core import PlanKey, offline_kind

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
    ported_storage(key.precision)
    if key.domain != "c2c":
        raise ValueError(f"domain {key.domain!r} is not ported yet")
    if not is_power_of_two(key.n):
        raise ValueError(f"backend={key.backend!r} serves power-of-two n "
                         f"only; any-length n={key.n} is not ported yet")


def candidates(key: PlanKey) -> list:
    """The ordered (variant, params) race for a gpu key: gpu-rows with
    automatic blocking, then 8 rows a block where 8 divides the rows,
    then the stage path for natural order."""
    _check_key(key)
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
    GPU_ROWS_MAX_N: no gpu rung serves it); gpu-stages otherwise."""
    _check_key(key)
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
    those as rejections)."""
    _check_key(key)
    natural = key.layout == "natural"
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
