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

    carry-free (rows, gpu-rows n <= 2^14)  ceiling 1.0
    one carry  (fourstep, rql, mf,         ceiling 0.5
                gpu-rows n > 2^14)
    two carries (sixstep, n >= 2^25)       ceiling 1/3

Peaks are keyed on the CUDA device name (``torch.cuda.get_device_name``)
and come from NVIDIA's data sheets; an unknown card gives None, never a
figure of another device.
"""

from __future__ import annotations

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
    depends on the row length n: 0 for rows that fit one block's shared
    memory (``cuda_fft.MAX_SMEM_TILE``), 1 above (its kernel writes a
    long row's leading levels to device memory and reads it back for the
    rest); None without n.  The reference leaves its gpu rows out of
    PLAN_CARRY_PASSES."""
    if variant == "gpu-rows":
        if n is None:
            return None
        from ..ops.cuda_fft import MAX_SMEM_TILE

        return int(n > MAX_SMEM_TILE)
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
                  storage_bytes: int = 4) -> int:
    """The traffic of an n-point transform with `carry_passes`
    materialized intermediates: the floor plus one full write+read round
    trip of the planes per carry pass."""
    floor = fft_min_hbm_bytes(n, domain, storage_bytes)
    return floor + carry_passes * floor


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
