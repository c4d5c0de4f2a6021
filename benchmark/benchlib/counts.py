"""Operations and bytes of one call, and the card's data-sheet peaks.

The flop count is the benchFFT convention (http://www.fftw.org/speed/):
5 n log2 n for a complex transform of n points, 2.5 n log2 n for a real
one, times the rows.  The least bytes read each input byte once and
write each output byte once, at the entry's own dtypes: 16 B a complex64
point, 12 B a real float32 point with its half spectrum.  The arithmetic
of the port's ``utils/roofline.py`` (``fft_min_hbm_bytes``, the peak
table), copied so that no change to the program moves the yardstick.
"""

from __future__ import annotations

import math

#: peak device-memory bandwidth, bytes/s, by a substring of the CUDA
#: device name (NVIDIA data sheets, at the full power limit; "H100 80GB
#: HBM3" is how the SXM part names itself)
PEAK_BYTES_PER_S = {
    "H100 SXM": 3.35e12,
    "H100 80GB HBM3": 3.35e12,
    "H100 PCIe": 2.0e12,
    "H200": 4.8e12,
}


def peak_bytes_per_s(device_name: str):
    """The longest key of PEAK_BYTES_PER_S found in `device_name`
    (case-insensitive), or None for a card not in the table."""
    name = (device_name or "").lower()
    hits = [k for k in PEAK_BYTES_PER_S if k.lower() in name]
    return PEAK_BYTES_PER_S[max(hits, key=len)] if hits else None


def transform_flops(shape, domain: str) -> float:
    """benchFFT flops of one call over `shape` (rows x n, the trailing
    axis transformed) in `domain` ("c2c" or "r2c")."""
    n = shape[-1]
    rows = math.prod(shape[:-1])
    per_point = 5.0 if domain == "c2c" else 2.5
    return per_point * n * math.log2(n) * rows


def least_bytes(inputs, outputs) -> int:
    """Bytes of every input tensor read once and every output tensor
    written once."""
    return sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
