"""The CUDA kernels of the FFT hot path, each beside its plain PyTorch
version, and the whole-transform compositions built on them.

The counterpart of the reference's ``ops/pallas_fft.py`` and of the
kernel of its ``hw/lowering.py``.  Eight kernels (``csrc/``, built by
``utils.buildlib``) carry the static and the tuned paths, the matmul
funnel and the ``gpu`` backend:

* ``tile_fft`` — the tile-point DIF of independent rows in shared
  memory (replaces ``_tile_fft_kernel`` / ``_tile_fft_compute``);
* ``long_range_sep`` — the first log2(R) DIF levels of (…, R, C) views,
  twiddles rebuilt from separable factors (replaces
  ``_long_range_kernel_sep``);
* ``long_range_dense`` — the same levels with dense per-level twiddle
  tables (replaces ``_long_range_kernel``), the ladder's
  ``two-kernel`` with ``tile_fft``;
* ``fourstep`` — a whole 1-D transform (long-range levels, then tile
  rows) in one cooperative launch (replaces ``_fourstep_kernel``), the
  plan for 2^21 <= n < 2^25; separable or dense twiddles;
* ``sixstep`` — a whole 1-D transform with the long-range levels split
  into outer and inner phases, in one cooperative launch (replaces
  ``_sixstep_kernel``), the plan for n >= 2^25; separable or dense;
* ``fused`` — a whole 1-D transform of n <= 2^20 in one cooperative
  launch whose carry stays in L2 (replaces ``_fused_fft_kernel``), the
  ladder's ``fused`` and ``fused-alias``, raced by the autotuner;
* ``matmul_funnel`` — the first log2(R) levels as one R-point DFT matrix
  product on the tensor cores (bf16 wgmma, passes per precision mode,
  B's planes cut once per card), times the twiddle grid (replaces
  ``_matmul_funnel_kernel``); with ``tile_fft`` the ladder's ``mf``;
* ``gpu_rows`` — the radix-2 DIF of every row of up to 2^18 points,
  twiddles from the per-level stack (replaces ``hw/lowering.py``'s
  ``_radix2_kernel``), the ``gpu`` backend's ``gpu-rows``.

Each wrapper checks device, dtype, shape and contiguity, launches its
kernel for CUDA tensors (or raises) and counts the launch on its
``launches`` attribute; a CPU tensor goes to the plain version, which is
also the yardstick the kernel is held against on the card.

bf16 storage (``ops.precision``): every kernel but ``matmul_funnel``
and ``gpu_rows`` (``tile_fft``, ``long_range_sep``, ``long_range_dense``,
``fourstep``, ``sixstep`` and ``fused``) also takes bfloat16 planes with
bfloat16 twiddle operands (``twiddle``'s ``storage="bfloat16"``) and launch their
kernel's bf16 instantiation, counted apart on ``launches_bf16``; every
operand must have the planes' dtype, nothing is converted in silence.
Their plain versions upcast, run the float32 levels and round the result
to the planes' dtype, which is where the kernel stores: the input and
tables arrive rounded, and each kernel's (and each kernel phase's)
output is rounded once.  The compositions take ``storage=`` as the
reference's entry points do: float32 in, rounded once at entry, float32
out, upcast once at the boundary.

Blocking follows Hopper's budget, not the TPU's 16 MB scoped VMEM: a
block may opt into 227 KB (232,448 bytes) of shared memory, so a tile
of re+im float32 holds at most 2^14 points, and a long-range block
R x cb at most 29,056 points.  Shapes past that fail before any launch
with a ValueError naming the limiting pair.
"""

from __future__ import annotations

import atexit
import functools

import torch

from ..hw.inventory import sm_count
from ..obs.spans import span as _obs_span
from ..resilience.inject import maybe_fault
from .bits import ilog2, is_power_of_two, to_natural
from .butterfly import stage_full
from .precision import (
    as_compute,
    as_storage,
    bf16_split,
    planes_dot,
    split_levels,
    storage_dtype,
)
from .twiddle import (
    FUNNEL_TILE_K,
    FUNNEL_TILE_ROWS,
    dense_long_range_tables,
    device_factors,
    device_funnel_b2_tiles,
    device_funnel_b_tiles,
    device_funnel_factors,
    device_tables,
    flat_tables,
    funnel_b2_untile,
    funnel_b_untile,
)

LANE = 128
#: largest row ``rows`` serves, as in the reference (pallas_fft.py:2067)
MAX_ROW_TILE = 1 << 16
#: dynamic shared memory one block may opt into on sm_90
SMEM_LIMIT_BYTES = 232448
#: largest tile whose re+im float32 planes fit one block's shared memory
MAX_SMEM_TILE = 1 << 14
#: long-range column block: one warp reads 32 neighbouring floats of a row
DEFAULT_CB = 32
_MAX_BLOCKS = (1 << 31) - 1


def tile_smem_bytes(tile: int) -> int:
    return 2 * tile * 4


def long_range_smem_bytes(R: int, cb: int) -> int:
    """Dynamic shared memory of one long-range block, separable or
    dense: two padded R x cb planes."""
    return 8 * padded_floats(R * cb)


def padded_floats(m: int) -> int:
    """Floats of one padded shared-memory plane of m points (one float
    of padding after every 32, fft_common.cuh: padded_floats)."""
    return m + (m >> 5)


#: the cluster widths of the cluster kernels (fused, tile_fft): 1, a
#: whole row in one block, up to Hopper's portable 8
CLUSTER_WIDTHS = (1, 2, 4, 8)
#: points of an automatic block of short rows (gpu_rows, tile_fft): the
#: fastest of 1, 64, 128 and 1024 rows of 16 points and of 1 and 4 rows
#: of 4096 for gpu_rows on an H100 SXM (chip_smoke.py phase 7, PERF.md)
AUTO_BLOCK_POINTS = 1 << 10


def auto_block_rows(rows: int, n: int) -> int:
    """The largest power of two dividing `rows` whose block of n-point
    rows holds at most AUTO_BLOCK_POINTS points (1 for longer rows)."""
    block_rows = 1
    while rows % (2 * block_rows) == 0 and \
            2 * block_rows * n <= AUTO_BLOCK_POINTS:
        block_rows *= 2
    return block_rows


def check_tile(tile: int) -> None:
    """Raise ValueError unless `tile` is a power of two >= 2 whose planes
    fit one block's shared memory."""
    if tile < 2 or not is_power_of_two(tile):
        raise ValueError(f"tile={tile} must be a power of two >= 2")
    if tile_smem_bytes(tile) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"tile={tile} needs {tile_smem_bytes(tile)} bytes of shared "
            f"memory per block (limit {SMEM_LIMIT_BYTES}); the largest "
            f"shared-memory tile is {MAX_SMEM_TILE}")


def check_long_range(R: int, cb: int) -> None:
    """Raise ValueError unless the R x cb long-range block is legal."""
    if cb < 1 or not is_power_of_two(cb):
        raise ValueError(f"cb={cb} must be a power of two")
    if long_range_smem_bytes(R, cb) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"long-range blocks R={R} x cb={cb} need "
            f"{long_range_smem_bytes(R, cb)} bytes of shared memory "
            f"(limit {SMEM_LIMIT_BYTES}); reduce cb or use a larger tile "
            f"so R shrinks")


def rql_blocking(n: int, tile: int | None = None, cb: int | None = None):
    """Validated (tile, R, cb) for an n-point rql transform.  tile
    defaults to min(n, MAX_SMEM_TILE); cb to DEFAULT_CB, halved until
    the R x cb block fits shared memory."""
    if tile is None:
        tile = min(n, MAX_SMEM_TILE)
    check_tile(tile)
    if n % tile:
        raise ValueError(f"tile={tile} must divide n={n}")
    R = n // tile
    if cb is None:
        cb = min(DEFAULT_CB, tile)
        while cb > 1 and long_range_smem_bytes(R, cb) > SMEM_LIMIT_BYTES:
            cb //= 2
    if tile % cb:
        raise ValueError(f"cb={cb} must divide tile={tile}")
    if R > 1:
        check_long_range(R, cb)
    return tile, R, cb


#: narrowest automatic column block: one whole 32-byte sector of a row
MIN_AUTO_CB = 8


def _check_cb(name: str, cb: int, tile: int) -> None:
    if cb < 1 or not is_power_of_two(cb) or tile % cb:
        raise ValueError(f"{name}={cb} must be a power of two dividing "
                         f"tile={tile}")


#: points of one phase-B row segment of sixstep and fourstep: a tile
#: row runs on a cluster of tile / ROW_SEGMENT_POINTS blocks
ROW_SEGMENT_POINTS = 1 << 12


def row_cluster_width(tile: int) -> int:
    """Blocks of the cluster that holds one tile row in sixstep's phase
    B2 and fourstep's phase B: tile / ROW_SEGMENT_POINTS (4 at tile
    2^14), at least 1."""
    return max(tile // ROW_SEGMENT_POINTS, 1)


#: points of an automatic fourstep phase-A block (R x cb): about 34 KB
#: of padded planes, as a phase-B segment, so that two blocks stay
#: resident on each SM
FOURSTEP_BLOCK_POINTS = 1 << 12


def fourstep_smem_bytes(R: int, cb: int, tile: int) -> int:
    """Dynamic shared memory of one block of csrc/fourstep.cu (its
    Layout): the persistent block holds one phase at a time,
    so the larger of phase A's two padded R x cb planes and phase B's
    two padded segments of tile / ``row_cluster_width(tile)`` points,
    rounded to 16 bytes."""
    seg = tile // row_cluster_width(tile)
    return 4 * ((max(padded_floats(R * cb), padded_floats(seg)) * 2 + 3)
                & ~3)


def fourstep_auto_cb(n: int, tile: int) -> int:
    """The fourstep column block for an n = R * tile transform:
    FOURSTEP_BLOCK_POINTS / R, but at least MIN_AUTO_CB (one whole
    32-byte sector of each row) and at most `tile` — 32 at n = 2^21, 16
    at 2^22, 8 from 2^23 on (the counterpart of the reference's
    ``fourstep_auto_cb``, pallas_fft.py:1196, for Hopper's budget: two
    blocks a SM up to 2^24, where the 128 registers of a thread set the
    limit, one at 2^25, where the 135 KB block does).  Raises ValueError
    naming (R, cb, bytes, limit) when even the narrowest block does not
    fit shared memory: R is too tall for one column block, so the
    transform needs sixstep or a larger tile."""
    check_tile(tile)
    R = n // tile
    lo = min(MIN_AUTO_CB, tile)
    cb = min(tile, max(lo, FOURSTEP_BLOCK_POINTS // max(R, 1)))
    if fourstep_smem_bytes(R, cb, tile) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fourstep is infeasible at n={n} (tile={tile}): its narrowest "
            f"block R={R} x cb={cb} needs "
            f"{fourstep_smem_bytes(R, cb, tile)} bytes of shared memory "
            f"(limit {SMEM_LIMIT_BYTES}); use sixstep or a larger tile")
    return cb


def fourstep_blocking(n: int, tile: int | None = None,
                      cb: int | None = None):
    """Validated (tile, R, cb) for an n-point fourstep transform.  tile
    defaults to min(n, MAX_SMEM_TILE), cb to ``fourstep_auto_cb``.  R = 1
    gives cb None: the transform is one tile row."""
    if tile is None:
        tile = min(n, MAX_SMEM_TILE)
    check_tile(tile)
    if n % tile:
        raise ValueError(f"tile={tile} must divide n={n}")
    R = n // tile
    if R < 2:
        return tile, R, None
    if cb is None:
        cb = fourstep_auto_cb(n, tile)
    _check_cb("cb", cb, tile)
    if fourstep_smem_bytes(R, cb, tile) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fourstep blocks R={R} x cb={cb} (tile={tile}) need "
            f"{fourstep_smem_bytes(R, cb, tile)} bytes of shared memory "
            f"(limit {SMEM_LIMIT_BYTES}); reduce cb or pass cb=None")
    return tile, R, cb


#: points of an automatic sixstep long-range block (R x cb), as of its
#: phase-B2 row segment (ROW_SEGMENT_POINTS): about 34 KB of padded
#: planes, so that two or more blocks stay resident on each SM
SIXSTEP_BLOCK_POINTS = 1 << 12


def sixstep_smem_bytes(R1: int, cb1: int, R2: int, cb2: int,
                       tile: int) -> int:
    """Dynamic shared memory of one sixstep block: the largest of the
    padded outer R1 x cb1 block, the padded inner R2 x cb2 block and the
    padded phase-B2 segment of tile / ``row_cluster_width(tile)``
    points (re + im float32) — the persistent block holds one phase at a
    time."""
    return 8 * max(padded_floats(R1 * cb1), padded_floats(R2 * cb2),
                   padded_floats(tile // row_cluster_width(tile)))


def sixstep_auto_split(n: int, tile: int) -> tuple[int, int]:
    """The balanced (R1, R2) outer/inner split of R = n/tile: R1 >= R2,
    both >= 2 — the reference's ``sixstep_auto_split``
    (pallas_fft.py:1606).  Raises ValueError for R < 4, which has
    nothing to split: fourstep owns that regime."""
    R = n // tile
    lv = ilog2(R)
    if lv < 2:
        raise ValueError(
            f"sixstep needs R = n/tile >= 4 (two nontrivial radices), "
            f"got R={R} at n={n} tile={tile} — use the fourstep kernel")
    l2 = lv // 2
    return 1 << (lv - l2), 1 << l2


def _sixstep_split(n: int, tile: int, r2: int | None) -> tuple[int, int]:
    if r2 is None:
        return sixstep_auto_split(n, tile)
    R = n // tile
    if r2 < 2 or not is_power_of_two(r2) or R % r2 or R // r2 < 2:
        raise ValueError(
            f"r2={r2} must be a power of two with 2 <= r2 <= R/2 "
            f"dividing R={R} (n={n}, tile={tile})")
    return R // r2, r2


def sixstep_auto_cbs(n: int, tile: int,
                     r2: int | None = None) -> tuple[int, int]:
    """The (cb1, cb2) column blocks of an n = R1 * R2 * tile sixstep
    transform (the counterpart of the reference's ``sixstep_auto_cbs``,
    pallas_fft.py:1621, for Hopper): each R x cb block holds about
    SIXSTEP_BLOCK_POINTS points, cb = SIXSTEP_BLOCK_POINTS / R but at
    least DEFAULT_CB (one warp reads a 128-byte row segment) and at most
    `tile`, halved while the padded block overflows shared memory, never
    below MIN_AUTO_CB.  So (cb1, cb2) is (64, 128) at n = 2^25, (32, 64)
    at 2^27.  Raises ValueError naming the limiting (R, cb) pair."""
    check_tile(tile)
    R1, R2 = _sixstep_split(n, tile, r2)
    lo = min(MIN_AUTO_CB, tile)
    cbs = []
    for name, rr in (("R1", R1), ("R2", R2)):
        cb = min(tile, max(DEFAULT_CB, SIXSTEP_BLOCK_POINTS // rr))
        while cb >= lo and 8 * padded_floats(rr * cb) > SMEM_LIMIT_BYTES:
            cb //= 2
        if cb < lo:
            raise ValueError(
                f"sixstep is infeasible at n={n} (tile={tile}): {name}="
                f"{rr} x cb={lo} needs {8 * padded_floats(rr * lo)} bytes "
                f"of shared memory (limit {SMEM_LIMIT_BYTES}); use a "
                f"larger tile or another r2")
        cbs.append(cb)
    return cbs[0], cbs[1]


def sixstep_blocking(n: int, tile: int | None = None, r2: int | None = None,
                     cb1: int | None = None, cb2: int | None = None):
    """Validated (tile, R1, R2, cb1, cb2) for an n-point sixstep
    transform.  tile defaults to min(n, MAX_SMEM_TILE), the split to
    ``sixstep_auto_split``, the column blocks to ``sixstep_auto_cbs``;
    phase B2 runs each row on ``row_cluster_width(tile)`` blocks."""
    if tile is None:
        tile = min(n, MAX_SMEM_TILE)
    check_tile(tile)
    if n % tile:
        raise ValueError(f"tile={tile} must divide n={n}")
    R1, R2 = _sixstep_split(n, tile, r2)
    if cb1 is None or cb2 is None:
        auto1, auto2 = sixstep_auto_cbs(n, tile, R2)
        cb1 = auto1 if cb1 is None else cb1
        cb2 = auto2 if cb2 is None else cb2
    _check_cb("cb1", cb1, tile)
    _check_cb("cb2", cb2, tile)
    need = sixstep_smem_bytes(R1, cb1, R2, cb2, tile)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"sixstep blocks R1={R1} x cb1={cb1} / R2={R2} x cb2={cb2} "
            f"(tile={tile}) need {need} bytes of shared memory (limit "
            f"{SMEM_LIMIT_BYTES}); reduce cb1/cb2 or pass them as None")
    return tile, R1, R2, cb1, cb2


#: largest n the fused kernel serves: its 2n-float carry (8 MB at 2^20)
#: must stay in the card's L2, as the reference's stayed in VMEM
FUSED_MAX_N = 1 << 20
#: columns of one qb unit of the fused phase-A block: a warp's width (the
#: TPU's unit was its 128 lanes)
FUSED_QB_COLS = 32
#: the cluster width fused_blocking picks when none is named: 64 tile
#: rows of 2^14 on 256 blocks of 4096 points at n = 2^20
FUSED_AUTO_CW = 4


def fused_smem_bytes(R: int, cb: int, tile: int, cw: int) -> int:
    """Dynamic shared memory of one fused block: the larger of the
    padded R x cb phase-A block and the padded tile/cw phase-B segment,
    re + im float32."""
    return 8 * max(padded_floats(R * cb), padded_floats(tile // cw))


def fused_blocking(n: int, tile: int | None = None, qb: int | None = None,
                   cw: int | None = None):
    """Validated (tile, R, qb, cw) for an n-point fused transform: phase
    A runs R x (qb * FUSED_QB_COLS)-column blocks, phase B each tile row
    on a cluster of cw blocks holding tile/cw points each.  tile
    defaults to min(n, MAX_SMEM_TILE), qb to 1 (the narrowest block, the
    most work items), cw to FUSED_AUTO_CW, halved until a segment holds
    at least one 128-byte line; R = 1 gives qb and cw None (one tile
    row, the tile kernel).  Raises ValueError naming the limiting pair
    before any launch: n above FUSED_MAX_N, a qb or cw the kernel does
    not take, or a block past the shared-memory budget."""
    if not is_power_of_two(n) or n > FUSED_MAX_N:
        raise ValueError(
            f"fused serves power-of-two n <= FUSED_MAX_N={FUSED_MAX_N} "
            f"(its 2n-float carry stays in L2), got n={n}; use fourstep")
    if tile is None:
        tile = min(n, MAX_SMEM_TILE)
    check_tile(tile)
    if n % tile:
        raise ValueError(f"tile={tile} must divide n={n}")
    R = n // tile
    if R < 2:
        return tile, R, None, None
    if tile % FUSED_QB_COLS:
        raise ValueError(f"fused: tile={tile} must be a multiple of "
                         f"{FUSED_QB_COLS} (qb counts {FUSED_QB_COLS}-column "
                         f"groups)")
    Q = tile // FUSED_QB_COLS
    if qb is None:
        qb = 1
    if qb < 1 or not is_power_of_two(qb) or Q % qb:
        raise ValueError(f"qb={qb} must be a power of two dividing "
                         f"tile/{FUSED_QB_COLS}={Q}")
    if cw is None:
        cw = FUSED_AUTO_CW
        while cw > 1 and tile // cw < FUSED_QB_COLS:
            cw //= 2
    if cw not in CLUSTER_WIDTHS:
        raise ValueError(f"fused: cluster width cw={cw} must be one of "
                         f"{CLUSTER_WIDTHS} (Hopper's portable "
                         f"cluster sizes)")
    if tile // cw < FUSED_QB_COLS:
        raise ValueError(f"fused: tile={tile} / cw={cw} leaves segments of "
                         f"{tile // cw} points; each needs at least "
                         f"{FUSED_QB_COLS} (one 128-byte line)")
    need = fused_smem_bytes(R, qb * FUSED_QB_COLS, tile, cw)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"fused blocks R={R} x qb={qb} ({qb * FUSED_QB_COLS} columns, "
            f"tile={tile}, cw={cw}) need {need} bytes of shared memory "
            f"(limit {SMEM_LIMIT_BYTES}); reduce qb, raise cw or use a "
            f"larger tile so R shrinks")
    return tile, R, qb, cw


def rows_plan_feasible(nrows: int, n: int) -> bool:
    """Can ``fft_rows_cuda`` serve a (nrows, n)-row workload?  The same
    n range as the reference (power-of-two 128..2^16); the reference's
    Mosaic block-grouping rule has no Hopper counterpart, so any row
    count is feasible."""
    return nrows >= 1 and is_power_of_two(n) and LANE <= n <= MAX_ROW_TILE


# --- shared operand checks and launch -------------------------------------


#: the plane dtypes of the kernels with a bf16 storage instantiation
PLANE_DTYPES = (torch.float32, torch.bfloat16)


def _check_planes(xr, xi, ndim: int, name: str,
                  dtypes=(torch.float32,)) -> None:
    for t in (xr, xi):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: planes must be tensors")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: planes must be "
                            f"{' or '.join(str(d) for d in dtypes)}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")
    if xi.dtype != xr.dtype:
        raise TypeError(f"{name}: re/im planes must share one dtype, got "
                        f"{xr.dtype} / {xi.dtype}")
    if xr.shape != xi.shape or xr.dim() != ndim:
        raise ValueError(f"{name}: re/im planes must share one {ndim}-D "
                         f"shape, got {tuple(xr.shape)} / "
                         f"{tuple(xi.shape)}")


def _check_operands(name, device, *tensors_and_shapes,
                    dtype=torch.float32) -> None:
    for t, shape in tensors_and_shapes:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous {dtype} "
                             f"(the planes' dtype), got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} != "
                             f"{shape}")
        if t.device != device:
            raise ValueError(f"{name}: operand on {t.device}, planes on "
                             f"{device}")


def _entry(fn: str, dtype) -> str:
    """The C entry of kernel `fn` for planes of `dtype`: the bf16
    storage instantiation is ``<fn>_bf16``."""
    return fn + "_bf16" if dtype == torch.bfloat16 else fn


def _count(kernel, dtype) -> None:
    """One more launch of `kernel`'s instantiation for `dtype`."""
    if dtype == torch.bfloat16:
        kernel.launches_bf16 += 1
    else:
        kernel.launches += 1


def _launch(name: str, fn, device: torch.device, *args) -> None:
    if device.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {device} — the kernel "
                           f"runs on CUDA tensors, the plain version on "
                           f"CPU tensors")
    from ..utils.buildlib import load_kernels

    lib = load_kernels()
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    err = getattr(lib, fn)(*ptrs, index, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"{lib.pifft_cuda_error_name(err).decode()} "
                           f"({lib.pifft_cuda_error_string(err).decode()})")


#: the float4 copies of gpu_rows and fused need 16-byte-aligned planes
_VEC_BYTES = 16
#: points one vector copy of the kernels moves: a float4, or 8 bytes of
#: bf16 (csrc/fft_common.cuh: load_four / store_four)
_VEC_POINTS = 4


def _aligned(t):
    """`t`, or a copy of it in fresh (aligned) memory where a view leaves
    it off a 16-byte boundary."""
    return t if t.data_ptr() % _VEC_BYTES == 0 else t.clone()


def _check_aligned(name: str, *planes) -> None:
    """Raise ValueError for a plane off the boundary of the kernels'
    vector copy of its dtype: 16 bytes for float32, 8 for bfloat16."""
    for t in planes:
        width = _VEC_POINTS * t.element_size()
        if t.data_ptr() % width:
            raise ValueError(f"{name}: {t.dtype} planes must be "
                             f"{width}-byte aligned (the kernel copies "
                             f"{width} bytes at a time); got a view at "
                             f"address {t.data_ptr():#x}")


# --- kernel 1: tile_fft -----------------------------------------------------

#: the shortest rows tile_fft spreads over a thread-block cluster
TILE_CLUSTER_MIN = 1 << 13


def tile_fft_smem_bytes(tile: int, block_rows: int = 1, cw: int = 1) -> int:
    """Dynamic shared memory of one tile_fft block: `block_rows` padded
    rows of `tile` points, or one padded tile/cw segment of a row on a
    cluster of cw blocks (re + im float32, one float of padding every
    32)."""
    return 8 * padded_floats(block_rows * tile // cw)


def tile_blocking(rows: int, tile: int,
                  sms: int | None = None) -> tuple[int, int]:
    """(block_rows, cw) of tile_fft on (rows, tile) planes, for a card
    of `sms` SMs.  Short rows share a block (``auto_block_rows``).  Rows
    of TILE_CLUSTER_MIN points and more take the widest cluster in
    CLUSTER_WIDTHS that keeps the launch to one wave, rows * cw <= sms
    (on 132 SMs: 64 rows of 2^14 take cw = 2, 32 rows cw = 4, 16 rows
    cw = 8, 128 rows cw = 1): one block a SM, each row on as many SMs as
    that allows.  `sms` None (no card) gives cw = 1.  Raises ValueError
    for a tile ``check_tile`` refuses."""
    check_tile(tile)
    cw = 1
    if sms and tile >= TILE_CLUSTER_MIN:
        while cw < CLUSTER_WIDTHS[-1] and rows * cw * 2 <= sms:
            cw *= 2
    return (auto_block_rows(rows, tile) if cw == 1 else 1), cw


@functools.lru_cache(maxsize=None)
def _card_tile_blocking(rows: int, tile: int, device: torch.device):
    # tile_blocking on the card at `device`, worked out once per shape
    return tile_blocking(rows, tile, sm_count(device))


def tile_fft_plain(xr, xi, twr, twi):
    """Plain version of ``tile_fft``: log2(tile) ``stage_full`` levels
    over the same flat tables, in float32 (bf16 planes and tables
    upcast), the result in the planes' dtype (rounded once for bf16,
    where the kernel stores)."""
    dt = xr.dtype
    xr, xi, twr, twi = (as_compute(t) for t in (xr, xi, twr, twi))
    tile = xr.shape[-1]
    for l in range(ilog2(tile)):
        off = tile - (tile >> l)
        half = tile >> (l + 1)
        xr, xi = stage_full(xr, xi, twr[off:off + half], twi[off:off + half])
    return xr.to(dt), xi.to(dt)


def tile_fft(xr, xi, twr, twi):
    """pi-layout DIF of each row of (rows, tile) float32 or bfloat16
    planes.

    twr/twi: the (tile - 1,) concatenated per-level tables of
    ``twiddle_tables(tile)`` (``twiddle.flat_tables``) in the planes'
    dtype.  CUDA tensors launch the kernel (csrc/tile_fft.cu; its bf16
    instantiation for bf16 planes) once, blocked by ``tile_blocking``
    for the card's SM count; the planes must be aligned to the kernel's
    vector copy (16 bytes for float32, 8 for bf16; ValueError
    otherwise).  CPU tensors take ``tile_fft_plain``.
    Returns new (rows, tile) planes of the same dtype."""
    _check_planes(xr, xi, 2, "tile_fft", PLANE_DTYPES)
    rows, tile = xr.shape
    check_tile(tile)
    _check_operands("tile_fft", xr.device,
                    (twr, (tile - 1,)), (twi, (tile - 1,)), dtype=xr.dtype)
    if xr.device.type == "cpu":
        return tile_fft_plain(xr, xi, twr, twi)
    block_rows, cw = _card_tile_blocking(rows, tile, xr.device)
    _check_aligned("tile_fft", xr, xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if rows:
        _launch("tile_fft", _entry("pifft_tile_fft", xr.dtype), xr.device,
                xr, xi, yr, yi, twr, twi, rows, ilog2(tile),
                ilog2(block_rows), ilog2(cw))
        _count(tile_fft, xr.dtype)
    return yr, yi


tile_fft.launches = 0
tile_fft.launches_bf16 = 0


# --- kernel 2: long_range_sep ----------------------------------------------


def _long_range_stage(xr, xi, half, wr, wi):
    """One long-range DIF level of (batch, R, C) planes: rows r and
    r + half of each group of 2 * half rows, the difference times the
    (half, C) twiddle (wr, wi)."""
    B_, R, C = xr.shape
    x4r = xr.reshape(B_, -1, 2, half, C)
    x4i = xi.reshape(B_, -1, 2, half, C)
    tr = x4r[:, :, 0] + x4r[:, :, 1]
    ti = x4i[:, :, 0] + x4i[:, :, 1]
    dr = x4r[:, :, 0] - x4r[:, :, 1]
    di = x4i[:, :, 0] - x4i[:, :, 1]
    ur = dr * wr - di * wi
    ui = dr * wi + di * wr
    return (torch.stack((tr, ur), dim=2).reshape(B_, R, C),
            torch.stack((ti, ui), dim=2).reshape(B_, R, C))


def long_range_sep_plain(xr, xi, ar, ai, br, bi):
    """Plain version of ``long_range_sep``: the log2(R) levels as
    reshape/stack stages, twiddle = outer product A[o:o+half] x B[l], in
    float32 (bf16 planes and factors upcast), the result in the planes'
    dtype (rounded once for bf16, where the kernel stores)."""
    dt = xr.dtype
    xr, xi, ar, ai, br, bi = (as_compute(t)
                              for t in (xr, xi, ar, ai, br, bi))
    R = xr.shape[1]
    for l in range(ilog2(R)):
        half = R >> (l + 1)
        o = R - (R >> l)
        a_r = ar[o:o + half, None]
        a_i = ai[o:o + half, None]
        b_r, b_i = br[l], bi[l]
        wr = a_r * b_r - a_i * b_i  # (half, C)
        wi = a_r * b_i + a_i * b_r
        xr, xi = _long_range_stage(xr, xi, half, wr, wi)
    return xr.to(dt), xi.to(dt)


def long_range_sep(xr, xi, ar, ai, br, bi, cb: int = DEFAULT_CB):
    """First log2(R) DIF levels of each transform of (batch, R, C)
    float32 or bfloat16 planes (n = R*C each), twiddles rebuilt from the
    separable factors of ``twiddle.long_range_factors(R, C)`` (A (R-1,),
    B (levels, C) — ``twiddle.device_factors``) in the planes' dtype.
    CUDA tensors launch the kernel (csrc/long_range.cu; its bf16
    instantiation for bf16 planes) in column blocks of `cb`; CPU tensors
    take ``long_range_sep_plain``.  Returns new planes of the same
    dtype."""
    _check_planes(xr, xi, 3, "long_range_sep", PLANE_DTYPES)
    batch, R, C = xr.shape
    if R < 2 or not is_power_of_two(R):
        raise ValueError(f"long_range_sep: R={R} must be a power of two "
                         f">= 2")
    check_long_range(R, cb)
    if C % cb:
        raise ValueError(f"cb={cb} must divide C={C}")
    levels = ilog2(R)
    _check_operands("long_range_sep", xr.device,
                    (ar, (R - 1,)), (ai, (R - 1,)),
                    (br, (levels, C)), (bi, (levels, C)), dtype=xr.dtype)
    if xr.device.type == "cpu":
        return long_range_sep_plain(xr, xi, ar, ai, br, bi)
    if batch * (C // cb) > _MAX_BLOCKS:
        raise ValueError("long_range_sep: batch x C/cb exceeds the grid "
                         "limit")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if batch:
        _launch("long_range_sep", _entry("pifft_long_range_sep", xr.dtype),
                xr.device, xr, xi, yr, yi, ar, ai, br, bi, batch, levels,
                C, ilog2(cb))
        _count(long_range_sep, xr.dtype)
    return yr, yi


long_range_sep.launches = 0
long_range_sep.launches_bf16 = 0


# --- kernel 3: long_range_dense ---------------------------------------------


def long_range_dense_plain(xr, xi, wr, wi):
    """Plain version of ``long_range_dense``: the log2(R) levels as
    reshape/stack stages, twiddle = rows [o, o + half) of the dense
    (R - 1, C) tables, in float32 (bf16 planes and tables upcast), the
    result in the planes' dtype (rounded once for bf16, where the kernel
    stores)."""
    dt = xr.dtype
    xr, xi, wr, wi = (as_compute(t) for t in (xr, xi, wr, wi))
    R = xr.shape[1]
    for l in range(ilog2(R)):
        half = R >> (l + 1)
        o = R - (R >> l)
        xr, xi = _long_range_stage(xr, xi, half, wr[o:o + half],
                                   wi[o:o + half])
    return xr.to(dt), xi.to(dt)


def long_range_dense(xr, xi, wr, wi, cb: int = DEFAULT_CB):
    """First log2(R) DIF levels of each transform of (batch, R, C)
    float32 or bfloat16 planes (n = R*C each), twiddles read from the
    dense (R - 1, C) tables of ``twiddle.dense_long_range_tables(R, C)``
    in the planes' dtype.  CUDA tensors launch the kernel
    (csrc/long_range.cu: the separable kernel's passes of 3-4 levels,
    dense tables; its bf16 instantiation for bf16 planes) in column
    blocks of `cb`; CPU tensors take ``long_range_dense_plain``.
    Returns new planes of the same dtype."""
    _check_planes(xr, xi, 3, "long_range_dense", PLANE_DTYPES)
    batch, R, C = xr.shape
    if R < 2 or not is_power_of_two(R):
        raise ValueError(f"long_range_dense: R={R} must be a power of two "
                         f">= 2")
    check_long_range(R, cb)
    if C % cb:
        raise ValueError(f"cb={cb} must divide C={C}")
    _check_operands("long_range_dense", xr.device,
                    (wr, (R - 1, C)), (wi, (R - 1, C)), dtype=xr.dtype)
    if xr.device.type == "cpu":
        return long_range_dense_plain(xr, xi, wr, wi)
    if batch * (C // cb) > _MAX_BLOCKS:
        raise ValueError("long_range_dense: batch x C/cb exceeds the grid "
                         "limit")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if batch:
        _launch("long_range_dense",
                _entry("pifft_long_range_dense", xr.dtype), xr.device,
                xr, xi, yr, yi, wr, wi, batch, ilog2(R), C, ilog2(cb))
        _count(long_range_dense, xr.dtype)
    return yr, yi


long_range_dense.launches = 0
long_range_dense.launches_bf16 = 0


def _long_range_plain(xr, xi, operands, separable: bool):
    """``long_range_sep_plain`` on the four separable factors, or
    ``long_range_dense_plain`` on the two dense tables."""
    if separable:
        return long_range_sep_plain(xr, xi, *operands)
    return long_range_dense_plain(xr, xi, *operands)


def _long_range_shapes(R: int, C: int, separable: bool) -> list:
    """The shapes of the long-range twiddle operands of an (R, C) view:
    A (R-1,) twice and B (levels, C) twice for the separable factors,
    (R-1, C) twice for the dense tables."""
    if separable:
        return [(R - 1,), (R - 1,), (ilog2(R), C), (ilog2(R), C)]
    return [(R - 1, C), (R - 1, C)]


def _split_operands(name: str, operands, groups: int, separable: bool):
    """Split the flat twiddle operands of fourstep/sixstep into `groups`
    long-range groups (4 separable factors or 2 dense tables each) and
    the trailing (twr, twi) tile tables."""
    per = 4 if separable else 2
    want = groups * per + 2
    if len(operands) != want:
        kind = "separable factors" if separable else "dense tables"
        raise ValueError(f"{name}: expected {want} twiddle operands "
                         f"({groups} x {per} {kind}, then the 2 tile "
                         f"tables), got {len(operands)}")
    return ([operands[g * per:(g + 1) * per] for g in range(groups)],
            operands[-2:])


# --- kernel 4: fourstep -----------------------------------------------------


def fourstep_plain(xr, xi, *operands, separable: bool = True):
    """Plain version of ``fourstep``: the long-range plain version on the
    (1, R, tile) view, then ``tile_fft_plain`` on the R rows.  On bf16
    planes each of the two rounds its result to bf16: the carry after
    phase A and the output, where the kernel stores."""
    R, tile = xr.shape
    (lr,), (twr, twi) = _split_operands("fourstep", operands, 1, separable)
    yr, yi = _long_range_plain(xr.reshape(1, R, tile),
                               xi.reshape(1, R, tile), lr, separable)
    return tile_fft_plain(yr.reshape(R, tile), yi.reshape(R, tile), twr, twi)


def fourstep(xr, xi, *operands, cb: int | None = None,
             separable: bool = True):
    """The whole pi-layout DIF of one n = R * tile transform held as
    (R, tile) float32 or bfloat16 planes: the log2(R) long-range levels
    in R x cb column blocks, then the tile DIF of every row, each on a
    cluster of ``row_cluster_width(tile)`` blocks.  `operands`, in the
    planes' dtype, are the long-range twiddles, then the tile tables
    (twr, twi) of ``twiddle.flat_tables(tile)``: with `separable` the
    factors (ar, ai, br, bi) of ``twiddle.device_factors(R, tile)``,
    otherwise the dense (wr, wi) of
    ``twiddle.dense_long_range_tables(R, tile)``.  cb None takes
    ``fourstep_auto_cb``.  CUDA tensors launch the kernel
    (csrc/fourstep.cu; its bf16 instantiation, carry in bf16, for bf16
    planes) once, as one cooperative launch; CPU tensors take
    ``fourstep_plain``.  Returns new (R, tile) planes of the same
    dtype."""
    _check_planes(xr, xi, 2, "fourstep", PLANE_DTYPES)
    R, tile = xr.shape
    if R < 2 or not is_power_of_two(R):
        raise ValueError(f"fourstep: R={R} must be a power of two >= 2")
    _, _, cb = fourstep_blocking(R * tile, tile, cb)
    (lr,), tw = _split_operands("fourstep", operands, 1, separable)
    _check_operands("fourstep", xr.device,
                    *zip(lr, _long_range_shapes(R, tile, separable)),
                    (tw[0], (tile - 1,)), (tw[1], (tile - 1,)),
                    dtype=xr.dtype)
    if xr.device.type == "cpu":
        return fourstep_plain(xr, xi, *operands, separable=separable)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("fourstep",
            _entry("pifft_fourstep" if separable else "pifft_fourstep_dense",
                   xr.dtype),
            xr.device, xr, xi, yr, yi, *lr, *tw, ilog2(R), ilog2(tile),
            ilog2(cb), ilog2(row_cluster_width(tile)))
    _count(fourstep, xr.dtype)
    return yr, yi


fourstep.launches = 0
fourstep.launches_bf16 = 0


def fourstep_resident_blocks(device, n: int, tile: int | None = None,
                             cb: int | None = None) -> int:
    """The blocks of the separable fourstep kernel the card at `device`
    holds at once for the n-point blocking ``fourstep_blocking(n, tile,
    cb)``: the occupancy API's answer (cudaOccupancyMaxActiveClusters
    times the cluster width), which sizes the kernel's persistent grid."""
    index = _card_index("fourstep_resident_blocks", device)
    tile, R, cb = fourstep_blocking(n, tile, cb)
    from ..utils.buildlib import load_kernels

    got = load_kernels().pifft_fourstep_resident_blocks(
        ilog2(R), ilog2(tile), ilog2(cb), ilog2(row_cluster_width(tile)),
        index)
    if got < 0:
        raise RuntimeError(f"fourstep_resident_blocks: CUDA error {-got}")
    return got


# --- kernel 5: sixstep ------------------------------------------------------


def sixstep_plain(xr, xi, *operands, separable: bool = True):
    """Plain version of ``sixstep``: the long-range plain version on the
    (1, R1, m) view with the outer twiddles, then on the (R1, R2, tile)
    view with the inner ones, then ``tile_fft_plain`` on the rows.  On
    bf16 planes each of the three rounds its result to bf16: the carries
    after phases A and B1 and the output, where the kernel stores."""
    R1, R2, tile = xr.shape
    m = R2 * tile
    (outer, inner), (twr, twi) = _split_operands("sixstep", operands, 2,
                                                 separable)
    yr, yi = _long_range_plain(xr.reshape(1, R1, m), xi.reshape(1, R1, m),
                               outer, separable)
    yr, yi = _long_range_plain(yr.reshape(R1, R2, tile),
                               yi.reshape(R1, R2, tile), inner, separable)
    yr, yi = tile_fft_plain(yr.reshape(R1 * R2, tile),
                            yi.reshape(R1 * R2, tile), twr, twi)
    return yr.reshape(R1, R2, tile), yi.reshape(R1, R2, tile)


def sixstep(xr, xi, *operands, cb1: int | None = None,
            cb2: int | None = None, separable: bool = True):
    """The whole pi-layout DIF of one n = R1 * R2 * tile transform held
    as (R1, R2, tile) float32 or bfloat16 planes (operands in the same
    dtype; bf16 launches the kernel's bf16 instantiation, both carries in
    bf16): the outer log2(R1) levels on the
    (R1, m = R2 * tile) view in R1 x cb1 blocks, the inner log2(R2)
    levels of each group on its (R2, tile) view in R2 x cb2 blocks, then
    the tile DIF of every row, each on a cluster of
    ``row_cluster_width(tile)`` blocks.  `operands` are the outer long-range
    twiddles, the inner ones, then (twr, twi) of ``flat_tables(tile)``:
    with `separable` the factors of ``device_factors(R1, m)`` and
    ``device_factors(R2, tile)``, otherwise the dense tables of
    ``dense_long_range_tables(R1, m)`` and ``(R2, tile)``.  cb1/cb2 None
    take ``sixstep_auto_cbs``.  CUDA tensors launch the kernel
    (csrc/sixstep.cu) once, as one cooperative launch; CPU tensors take
    ``sixstep_plain``.  Returns new (R1, R2, tile) planes."""
    _check_planes(xr, xi, 3, "sixstep", PLANE_DTYPES)
    R1, R2, tile = xr.shape
    if min(R1, R2) < 2 or not (is_power_of_two(R1)
                               and is_power_of_two(R2)):
        raise ValueError(f"sixstep: R1={R1} and R2={R2} must be powers "
                         f"of two >= 2")
    _, _, _, cb1, cb2 = sixstep_blocking(R1 * R2 * tile, tile, R2, cb1, cb2)
    m = R2 * tile
    (outer, inner), tw = _split_operands("sixstep", operands, 2, separable)
    _check_operands("sixstep", xr.device,
                    *zip(outer, _long_range_shapes(R1, m, separable)),
                    *zip(inner, _long_range_shapes(R2, tile, separable)),
                    (tw[0], (tile - 1,)), (tw[1], (tile - 1,)),
                    dtype=xr.dtype)
    if xr.device.type == "cpu":
        return sixstep_plain(xr, xi, *operands, separable=separable)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("sixstep",
            _entry("pifft_sixstep" if separable else "pifft_sixstep_dense",
                   xr.dtype),
            xr.device, xr, xi, yr, yi, *outer, *inner, *tw, ilog2(R1),
            ilog2(R2), ilog2(tile), ilog2(cb1), ilog2(cb2),
            ilog2(row_cluster_width(tile)))
    _count(sixstep, xr.dtype)
    return yr, yi


sixstep.launches = 0
sixstep.launches_bf16 = 0


# --- kernel 6: fused --------------------------------------------------------


def fused_plain(xr, xi, ar, ai, br, bi, twr, twi):
    """Plain version of ``fused``: the levels of ``fourstep_plain``
    (``long_range_sep_plain`` on the (1, R, tile) view, then
    ``tile_fft_plain`` on the rows; on bf16 planes the carry and the
    output rounded to bf16, where the kernel stores); where the carry
    lives is the kernel's design, not its arithmetic."""
    return fourstep_plain(xr, xi, ar, ai, br, bi, twr, twi)


def _card_index(name: str, device) -> int:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"{name}: {device} is not a card")
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _card_query(name: str, device) -> int:
    from ..utils.buildlib import load_kernels

    index = _card_index(name, device)
    got = getattr(load_kernels(), f"pifft_{name}")(index)
    if got < 0:
        raise RuntimeError(f"{name}: CUDA error {-got}")
    return got


#: card index -> fused_carry_limit there (a property of the card)
_CARRY_LIMIT: dict = {}


def fused_carry_limit(device) -> int:
    """Bytes of carry the card at `device` can keep as persisting L2
    lines in one access-policy window (0 where it has none)."""
    index = _card_index("fused_carry_limit", device)
    if index not in _CARRY_LIMIT:
        _CARRY_LIMIT[index] = _card_query("fused_carry_limit", device)
    return _CARRY_LIMIT[index]


def persisting_l2_set_aside(device) -> int:
    """Bytes of the L2 of the card at `device` set aside for persisting
    lines now.  The first ``fused`` launch on the card raises it to the
    carry's size where it is smaller; it stays so until process exit,
    when the value read before that launch is put back."""
    return _card_query("persisting_l2_set_aside", device)


def set_persisting_l2_set_aside(device, nbytes: int) -> None:
    """Set the persisting-L2 set-aside of the card at `device` to
    `nbytes` (the runtime rounds it up to its granularity)."""
    from ..utils.buildlib import load_kernels

    index = _card_index("set_persisting_l2_set_aside", device)
    lib = load_kernels()
    err = lib.pifft_set_persisting_l2_set_aside(index, int(nbytes))
    if err != 0:
        raise RuntimeError(f"set_persisting_l2_set_aside: CUDA error {err} "
                           f"{lib.pifft_cuda_error_name(err).decode()}")


#: card index -> its persisting-L2 set-aside before this process's first
#: fused launch there, put back at exit (``restore_persisting_l2``)
_SET_ASIDE_BEFORE: dict = {}


def restore_persisting_l2() -> None:
    """Put back, on every card ``fused`` has launched on, the
    persisting-L2 set-aside it had before the first launch.  Runs at
    process exit; ``fused`` raises it again on its next launch."""
    for index, nbytes in _SET_ASIDE_BEFORE.items():
        torch.cuda.synchronize(index)
        set_persisting_l2_set_aside(torch.device("cuda", index), nbytes)


def fused(xr, xi, ar, ai, br, bi, twr, twi, qb: int | None = None,
          alias_io: bool = False, cw: int | None = None):
    """The whole pi-layout DIF of one n = R * tile <= FUSED_MAX_N
    transform held as (R, tile) float32 or bfloat16 planes, in ONE
    launch whose carry stays in the card's L2: the log2(R) long-range
    levels in R x (qb * FUSED_QB_COLS) column blocks (factors of
    ``twiddle.device_factors(R, tile)``), then the tile DIF of every row
    (``twiddle.flat_tables(tile)``), each row on a cluster of cw blocks;
    factors and tables in the planes' dtype.  qb and cw None take
    ``fused_blocking``'s defaults.  `alias_io` writes the result into
    (xr, xi) themselves and returns them: the input planes are consumed,
    and must be aligned to the kernel's vector copy (16 bytes for
    float32, 8 for bf16).  CUDA tensors launch the kernel (csrc/fused.cu;
    its bf16 instantiation, carry in bf16, for bf16 planes) once, as one
    cooperative launch, after checking that the carry (2n values of the
    planes' dtype) fits the card's persisting L2 (``fused_carry_limit``);
    CPU tensors take ``fused_plain``.  The launch raises the card's persisting-L2
    set-aside to the carry's size where it is smaller: device state
    that every later kernel on the card sees, until process exit puts
    back the value read before the first launch
    (``persisting_l2_set_aside``, ``restore_persisting_l2``)."""
    _check_planes(xr, xi, 2, "fused", PLANE_DTYPES)
    R, tile = xr.shape
    if R < 2 or not is_power_of_two(R):
        raise ValueError(f"fused: R={R} must be a power of two >= 2")
    _, _, qb, cw = fused_blocking(R * tile, tile, qb, cw)
    _check_operands("fused", xr.device,
                    (ar, (R - 1,)), (ai, (R - 1,)),
                    (br, (ilog2(R), tile)), (bi, (ilog2(R), tile)),
                    (twr, (tile - 1,)), (twi, (tile - 1,)), dtype=xr.dtype)
    if xr.device.type == "cpu":
        yr, yi = fused_plain(xr, xi, ar, ai, br, bi, twr, twi)
        if alias_io:
            xr.copy_(yr)
            xi.copy_(yi)
            return xr, xi
        return yr, yi
    carry_bytes = 2 * R * tile * xr.element_size()
    limit = fused_carry_limit(xr.device)
    if carry_bytes > limit:
        raise ValueError(
            f"fused: the n={R * tile} carry needs {carry_bytes} bytes of "
            f"persisting L2; this card holds at most {limit}")
    index = xr.device.index
    if index not in _SET_ASIDE_BEFORE:
        if not _SET_ASIDE_BEFORE:
            atexit.register(restore_persisting_l2)
        _SET_ASIDE_BEFORE[index] = persisting_l2_set_aside(xr.device)
    carry = torch.empty(2 * R * tile, dtype=xr.dtype, device=xr.device)
    if alias_io:
        # the kernel writes y with vector stores
        _check_aligned("fused", xr, xi)
        yr, yi = xr, xi
    else:
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("fused", _entry("pifft_fused", xr.dtype), xr.device, xr, xi,
            yr, yi, carry, ar, ai, br, bi, twr, twi, ilog2(R), ilog2(tile),
            ilog2(qb * FUSED_QB_COLS), ilog2(cw))
    _count(fused, xr.dtype)
    return yr, yi


fused.launches = 0
fused.launches_bf16 = 0


# --- kernel 7: matmul_funnel ------------------------------------------------

#: columns (wgmma's N) of one work unit of the funnel kernel (64 rows,
#: its M, by MF_TILE_COLS): the column block cb is always MF_TILE_COLS
MF_TILE_COLS = 64
#: rows of X one wgmma step contracts (its K): R is a multiple
MF_MIN_R = 16


def check_mf_storage(precision: str) -> None:
    """Raise ValueError for a precision mode whose storage is not
    float32: the matmul funnel has no narrow-storage path (the
    reference's rejection, its ladder.py:524-533)."""
    storage = storage_dtype(precision)
    if storage != "float32":
        raise ValueError(f"variant 'mf' has no {storage} storage path — "
                         f"fp32 storage only")


def mf_blocking(n: int, R: int = LANE, cb: int | None = None):
    """Validated (R, C, cb) for the matmul funnel of an n-point
    transform viewed as (R, C = n/R).  R is a power of two of at least
    16 (one wgmma K step) dividing n; C must be a multiple of 128 (the
    twiddle factors' lane split) and at most MAX_SMEM_TILE (the tile
    kernel finishes each row of C points).  The kernel's work unit is
    64 rows of Y by MF_TILE_COLS columns (one warpgroup's m64n64
    accumulators), so cb, the column block, is MF_TILE_COLS: None takes
    it, any other value is refused.  With R = 128 that serves 2^14 <= n
    <= 2^21.  Raises ValueError naming the limiting pair before any
    launch."""
    if R < MF_MIN_R or not is_power_of_two(R):
        raise ValueError(f"mf: R={R} must be a power of two >= {MF_MIN_R} "
                         f"(one {MF_MIN_R}-row wgmma step)")
    if n % R:
        raise ValueError(f"mf: R={R} must divide n={n}")
    C = n // R
    if C % LANE:
        raise ValueError(f"mf: n/R = {C} (n={n}, R={R}) must be a "
                         f"multiple of {LANE}")
    if C > MAX_SMEM_TILE:
        raise ValueError(f"mf: n/R = {C} (n={n}, R={R}) exceeds "
                         f"MAX_SMEM_TILE={MAX_SMEM_TILE}, the longest row "
                         f"the tile kernel finishes; use a larger R")
    if cb is None:
        cb = MF_TILE_COLS
    if cb != MF_TILE_COLS:
        raise ValueError(f"mf: cb={cb} is not the kernel's column block "
                         f"of {MF_TILE_COLS} (one warpgroup's "
                         f"m64n{MF_TILE_COLS} accumulators); pass "
                         f"cb={MF_TILE_COLS} or None")
    return R, C, cb


def matmul_funnel_plain(xr, xi, bt, ar, ai, b2t, precision: str = "split3"):
    """Plain version of ``matmul_funnel``: B's planes and B2 taken back
    out of their tiles, X cut into the mode's bf16 planes and the four real
    products of B @ X summed over plane pairs (``precision.planes_dot``,
    the sum ``make_dot`` forms), then the twiddle grid rebuilt from A
    (R, Q) and B2 (R, 128) as a broadcast complex product, in the TPU
    body's order of operations."""
    levels = split_levels(precision)
    R, C = xr.shape
    bpr, bpi = funnel_b_untile(bt)
    b2r, b2i = funnel_b2_untile(b2t, R)
    xpr, xpi = bf16_split(xr, levels), bf16_split(xi, levels)
    yr = planes_dot(bpr, xpr) - planes_dot(bpi, xpi)
    yi = planes_dot(bpr, xpi) + planes_dot(bpi, xpr)
    a_r = ar.reshape(R, -1, 1)
    a_i = ai.reshape(R, -1, 1)
    w_r = b2r.reshape(R, 1, LANE)
    w_i = b2i.reshape(R, 1, LANE)
    tr = (a_r * w_r - a_i * w_i).reshape(R, C)
    ti = (a_r * w_i + a_i * w_r).reshape(R, C)
    return yr * tr - yi * ti, yr * ti + yi * tr


def _check_b_tiles(bt, levels: int, R: int, device) -> None:
    if not isinstance(bt, torch.Tensor) or bt.dtype != torch.bfloat16 \
            or not bt.is_contiguous():
        raise ValueError("matmul_funnel: B must be contiguous bfloat16 "
                         "tiles (twiddle.device_funnel_b_tiles)")
    units = -(-R // FUNNEL_TILE_ROWS)
    want = (units, R // FUNNEL_TILE_K, 2, levels, 2, FUNNEL_TILE_ROWS, 8)
    if tuple(bt.shape) != want:
        raise ValueError(f"matmul_funnel: B tiles shape {tuple(bt.shape)} "
                         f"!= {want} (the mode's {levels} planes of the "
                         f"({R}, {R}) matrix)")
    if bt.device != device:
        raise ValueError(f"matmul_funnel: B tiles on {bt.device}, planes "
                         f"on {device}")


def matmul_funnel(xr, xi, bt, ar, ai, b2t, cb: int | None = None,
                  precision: str = "split3"):
    """Y = (B @ X) * T on (R, C) float32 planes: the first log2(R) DIF
    levels of an n = R * C transform.  bt holds the L bfloat16 planes of
    the DFT matrix of ``twiddle.dft_funnel_b(R)``, Br's and Bi's, L =
    ``precision.split_levels(precision)``, as the kernel's step tiles
    (``twiddle.device_funnel_b_tiles``); (ar, ai) the factor A (R,
    C/128) of ``twiddle.dft_funnel_factors(R, n)``
    (``twiddle.device_funnel_factors``) and b2t its factor B2 (R, 128)
    as the kernel's epilogue tiles (``twiddle.device_funnel_b2_tiles``).
    `precision` sets the bf16 tensor-core passes of the product
    (``precision.dot_passes``).  cb:
    ``mf_blocking``'s.  CUDA tensors launch the kernel (csrc/mf.cu)
    once; CPU tensors take ``matmul_funnel_plain``.  Returns new (R, C)
    planes."""
    _check_planes(xr, xi, 2, "matmul_funnel")
    R, C = xr.shape
    levels = split_levels(precision)
    R, C, cb = mf_blocking(R * C, R, cb)
    _check_b_tiles(bt, levels, R, xr.device)
    _check_operands("matmul_funnel", xr.device,
                    (ar, (R, C // LANE)), (ai, (R, C // LANE)),
                    (b2t, (-(-R // FUNNEL_TILE_ROWS), 2, 4, 2, 8, 8, 4, 2,
                           2)))
    if xr.device.type == "cpu":
        return matmul_funnel_plain(xr, xi, bt, ar, ai, b2t, precision)
    # the kernel copies X 16 bytes at a time
    xr, xi = _aligned(xr), _aligned(xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    _launch("matmul_funnel", "pifft_matmul_funnel", xr.device, xr, xi, yr,
            yi, bt, ar, ai, b2t, ilog2(R), C, levels)
    matmul_funnel.launches += 1
    return yr, yi


def mf_resident_blocks(device, precision: str = "split3") -> int:
    """The persistent grid ``matmul_funnel`` launches with on `device` in
    `precision` (the blocks the card holds at once; fewer when there are
    fewer work units).  Needs the card."""
    from ..utils.buildlib import load_kernels

    index = _card_index("mf_resident_blocks", device)
    blocks = load_kernels().pifft_matmul_funnel_resident_blocks(
        index, split_levels(precision))
    if blocks < 1:
        raise RuntimeError(f"mf_resident_blocks: CUDA error {-blocks}")
    return blocks


matmul_funnel.launches = 0


# --- kernel 8: gpu_rows -----------------------------------------------------

#: longest row the gpu-rows kernel serves (the reference's bound,
#: hw/lowering.py:44)
GPU_ROWS_MAX_N = 1 << 18
#: rows longer than this go on a thread-block cluster of n / 2^14 blocks
GPU_ROWS_SEGMENT = MAX_SMEM_TILE


def gpu_rows_cluster_size(n: int) -> int:
    """Blocks of the cluster that holds one n-point gpu-rows row: 1 for
    rows one block holds (n <= GPU_ROWS_SEGMENT), n / GPU_ROWS_SEGMENT
    (2, 4, 8 or 16) above."""
    return max(n // GPU_ROWS_SEGMENT, 1)


def gpu_rows_blocking(rows: int, n: int, block_rows: int | None = None):
    """Validated rows per block for the gpu-rows kernel on (rows, n)
    planes.  n is a power of two in [2, GPU_ROWS_MAX_N]; block_rows a
    power of two dividing rows.  Rows of up to GPU_ROWS_SEGMENT points
    are staged block_rows at a time, so block_rows * n must fit one
    block's shared memory; a longer row runs on a cluster of
    ``gpu_rows_cluster_size(n)`` blocks, which walks block_rows rows one
    after the other.  block_rows None takes ``auto_block_rows`` (1 for
    long rows).  Raises ValueError naming the limiting pair before any
    launch."""
    if n < 2 or not is_power_of_two(n) or n > GPU_ROWS_MAX_N:
        raise ValueError(f"gpu-rows requires a power-of-two 2 <= n <= "
                         f"{GPU_ROWS_MAX_N}, got n={n}")
    if rows < 1:
        raise ValueError(f"gpu-rows: rows={rows} must be positive")
    if block_rows is None:
        block_rows = auto_block_rows(rows, n)
    if block_rows < 1 or not is_power_of_two(block_rows) or \
            rows % block_rows:
        raise ValueError(f"block_rows={block_rows} must be a power of two "
                         f"dividing rows={rows}")
    if n <= GPU_ROWS_SEGMENT and \
            8 * padded_floats(block_rows * n) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"gpu-rows blocks of block_rows={block_rows} x n={n} need "
            f"{8 * padded_floats(block_rows * n)} bytes of shared memory "
            f"(limit {SMEM_LIMIT_BYTES}); block_rows * n may be at most "
            f"{MAX_SMEM_TILE}")
    blocks = rows // block_rows * gpu_rows_cluster_size(n)
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"gpu-rows: {blocks} blocks exceed the grid "
                         f"limit")
    return block_rows


#: (card index, n) -> clusters of n's long-row kernel the card holds
_GPU_ROWS_CLUSTERS: dict = {}


def gpu_rows_max_clusters(device, n: int) -> int:
    """How many clusters of the long-row gpu-rows kernel for n-point rows
    (GPU_ROWS_SEGMENT < n <= GPU_ROWS_MAX_N) the card at `device` holds
    at once (cudaOccupancyMaxActiveClusters); 0 where it holds none."""
    index = _card_index("gpu_rows_max_clusters", device)
    if (index, n) not in _GPU_ROWS_CLUSTERS:
        from ..utils.buildlib import load_kernels

        got = load_kernels().pifft_gpu_rows_max_clusters(ilog2(n), index)
        if got < 0:
            raise RuntimeError(f"gpu_rows_max_clusters: CUDA error {-got}")
        _GPU_ROWS_CLUSTERS[index, n] = got
    return _GPU_ROWS_CLUSTERS[index, n]


def gpu_rows_plain(xr, xi, twr, twi):
    """Plain version of ``gpu_rows``: the reference's stage loop — stage
    s views each row as groups of m = n >> s points, butterflies their
    halves and multiplies the difference by row s of the stack."""
    rows, n = xr.shape
    m = n
    for s in range(ilog2(n)):
        half = m // 2
        ar = xr.reshape(rows, n // m, m)
        ai = xi.reshape(rows, n // m, m)
        er, eo = ar[:, :, :half], ar[:, :, half:]
        fr, fo = ai[:, :, :half], ai[:, :, half:]
        wr, wi = twr[s, :half], twi[s, :half]
        dr, di = er - eo, fr - fo
        xr = torch.cat([er + eo, dr * wr - di * wi], dim=-1).reshape(rows, n)
        xi = torch.cat([fr + fo, dr * wi + di * wr], dim=-1).reshape(rows, n)
        m = half
    return xr, xi


def gpu_rows(xr, xi, twr, twi, block_rows: int | None = None):
    """pi-layout DIF of each row of (rows, n) float32 planes, 2 <= n <=
    GPU_ROWS_MAX_N, twiddles from the (log2 n, n/2) stack (twr, twi) of
    ``hw.lowering.twiddle_stack(n)``.  `block_rows` rows share a block,
    or a cluster for rows past GPU_ROWS_SEGMENT (``gpu_rows_blocking``).
    CUDA tensors launch the kernel (csrc/gpu_rows.cu) once, after
    checking that the card holds a cluster where the rows need one
    (``gpu_rows_max_clusters``; ValueError naming n and K if not); CPU
    tensors take ``gpu_rows_plain``.
    Returns new (rows, n) planes."""
    _check_planes(xr, xi, 2, "gpu_rows")
    rows, n = xr.shape
    block_rows = gpu_rows_blocking(max(rows, 1), n, block_rows)
    stack = (ilog2(n), max(n // 2, 1))
    _check_operands("gpu_rows", xr.device, (twr, stack), (twi, stack))
    if xr.device.type == "cpu":
        return gpu_rows_plain(xr, xi, twr, twi)
    K = gpu_rows_cluster_size(n)
    if K > 1 and gpu_rows_max_clusters(xr.device, n) < 1:
        raise ValueError(
            f"gpu-rows: this card cannot hold a cluster of K={K} blocks of "
            f"{8 * padded_floats(GPU_ROWS_SEGMENT)} bytes of shared memory, "
            f"which an n={n} row needs")
    xr, xi = _aligned(xr), _aligned(xi)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    if rows:
        _launch("gpu_rows", "pifft_gpu_rows", xr.device, xr, xi, yr, yi,
                twr, twi, rows, ilog2(n), ilog2(block_rows))
        gpu_rows.launches += 1
    return yr, yi


gpu_rows.launches = 0

#: every kernel wrapper of this module, each counting its launches
KERNELS = (tile_fft, long_range_sep, long_range_dense, fourstep, sixstep,
           fused, matmul_funnel, gpu_rows)
#: the wrappers with a bf16 storage instantiation, whose launches they
#: count apart on ``launches_bf16``
BF16_KERNELS = (tile_fft, long_range_sep, long_range_dense, fourstep,
                sixstep, fused)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
    for kernel in BF16_KERNELS:
        kernel.launches_bf16 = 0


def launch_counts() -> dict:
    """{kernel: launches} of every kernel instantiation: the wrappers'
    names for float32 planes, ``<name>_bf16`` for the bf16 storage
    instantiations."""
    counts = {k.__name__: k.launches for k in KERNELS}
    counts.update({f"{k.__name__}_bf16": k.launches_bf16
                   for k in BF16_KERNELS})
    return counts


# --- compositions -----------------------------------------------------------


def _to_storage(xr, xi, storage):
    """The planes, contiguous, in `storage` (None: float32): the entry
    points' one downcast."""
    return (as_storage(xr.contiguous(), storage),
            as_storage(xi.contiguous(), storage))


def fft_pi_layout_cuda_rql(xr, xi, tile: int | None = None,
                           cb: int | None = None,
                           storage: str | None = None):
    """pi-layout n-point DIF of every length-n row of (..., n) planes:
    ``long_range_sep`` on the (rows, R, tile) view (skipped when R = 1),
    then ``tile_fft`` on the (rows * R, tile) view — two launches, no
    copy between them (the reference's rql, pallas_fft.py:742, batched
    over leading axes).  `storage` "bfloat16" rounds the input once and
    runs both kernels' bf16 instantiations on bf16 planes and tables
    (the intermediate in bf16); the result is float32 either way.
    Validates tile/cb before any launch."""
    maybe_fault("tube")  # resilience injection site
    n = xr.shape[-1]
    tile, R, cb = rql_blocking(n, tile, cb)
    lead = xr.shape[:-1]
    dev = xr.device
    xr, xi = _to_storage(xr, xi, storage)
    if R > 1:
        ar, ai, br, bi = device_factors(R, tile, dev, storage)
        xr, xi = long_range_sep(xr.reshape(-1, R, tile),
                                xi.reshape(-1, R, tile),
                                ar, ai, br, bi, cb)
    twr, twi = flat_tables(tile, dev, storage)
    yr, yi = tile_fft(xr.reshape(-1, tile), xi.reshape(-1, tile), twr, twi)
    return as_compute(yr).reshape(*lead, n), as_compute(yi).reshape(*lead, n)


def fft_pi_layout_cuda2(xr, xi, tile: int | None = None,
                        cb: int | None = None, storage: str | None = None):
    """The two-kernel whole transform of every length-n row of (..., n)
    planes: ``long_range_dense`` on the (rows, R, tile) view (skipped
    when R = 1), then ``tile_fft`` — the reference's
    fft_pi_layout_pallas2 (pallas_fft.py:678), the ladder's
    ``two-kernel``.  `storage` "bfloat16" rounds the input once and runs
    both kernels' bf16 instantiations on bf16 planes and tables (the
    intermediate in bf16, as the reference's); the result is float32
    either way.  The blocking is rql's (``rql_blocking``), validated
    before any launch."""
    maybe_fault("tube")  # resilience injection site
    n = xr.shape[-1]
    tile, R, cb = rql_blocking(n, tile, cb)
    lead = xr.shape[:-1]
    dev = xr.device
    xr, xi = _to_storage(xr, xi, storage)
    if R > 1:
        xr, xi = long_range_dense(xr.reshape(-1, R, tile),
                                  xi.reshape(-1, R, tile),
                                  *dense_long_range_tables(R, tile, dev,
                                                           storage), cb)
    twr, twi = flat_tables(tile, dev, storage)
    yr, yi = tile_fft(xr.reshape(-1, tile), xi.reshape(-1, tile), twr, twi)
    return as_compute(yr).reshape(*lead, n), as_compute(yi).reshape(*lead, n)


def _one_transform(xr, xi, name: str) -> int:
    if xr.dim() != 1 or xi.shape != xr.shape:
        raise ValueError(f"{name}: one 1-D transform of (n,) planes, got "
                         f"{tuple(xr.shape)} / {tuple(xi.shape)}")
    return xr.shape[0]


def fft_pi_layout_cuda_fused(xr, xi, tile: int | None = None,
                             qb: int | None = None, alias_io: bool = False,
                             cw: int | None = None,
                             storage: str | None = None):
    """pi-layout n-point DIF of (n,) float32 planes, n <= FUSED_MAX_N,
    in ONE launch of the fused kernel, its carry in L2 (the reference's
    fft_pi_layout_pallas_fused, pallas_fft.py:902).  `alias_io` writes
    the result over the kernel's input planes (consumed, and returned
    reshaped): the caller's float32 planes, or with bf16 `storage` the
    rounded copy made at entry.  `storage` "bfloat16" rounds the input
    once and runs the kernel's bf16 instantiation (planes, carry and
    tables in bf16); the result is float32 either way.  R = n/tile < 2
    takes the tile kernel, on the same storage, as the reference does.
    Validates tile/qb/cw before any launch."""
    maybe_fault("tube")  # resilience injection site
    n = _one_transform(xr, xi, "fft_pi_layout_cuda_fused")
    tile, R, qb, cw = fused_blocking(n, tile, qb, cw)
    dev = xr.device
    xr, xi = _to_storage(xr, xi, storage)
    xr = xr.reshape(R, tile)
    xi = xi.reshape(R, tile)
    twr, twi = flat_tables(tile, dev, storage)
    if R < 2:
        yr, yi = tile_fft(xr, xi, twr, twi)
    else:
        yr, yi = fused(xr, xi, *device_factors(R, tile, dev, storage), twr,
                       twi, qb, alias_io, cw)
    return as_compute(yr).reshape(n), as_compute(yi).reshape(n)


def fft_pi_layout_cuda_fourstep(xr, xi, tile: int | None = None,
                                cb: int | None = None,
                                separable: bool = True,
                                storage: str | None = None):
    """pi-layout n-point DIF of (n,) float32 planes in ONE launch of the
    fourstep kernel (the reference's fft_pi_layout_pallas_fourstep,
    pallas_fft.py:1228), its long-range twiddles separable factors or
    (``separable=False``) dense tables.  `storage` "bfloat16" rounds the
    input once and runs the kernel's bf16 instantiation (planes, carry
    and tables in bf16); the result is float32 either way.  R = n/tile
    < 2 takes the tile kernel, as the reference does.  Validates tile/cb
    before any launch."""
    maybe_fault("tube")  # resilience injection site
    n = _one_transform(xr, xi, "fft_pi_layout_cuda_fourstep")
    tile, R, cb = fourstep_blocking(n, tile, cb)
    dev = xr.device
    xr, xi = _to_storage(xr, xi, storage)
    xr = xr.reshape(R, tile)
    xi = xi.reshape(R, tile)
    twr, twi = flat_tables(tile, dev, storage)
    if R < 2:
        yr, yi = tile_fft(xr, xi, twr, twi)
    else:
        lr = device_factors(R, tile, dev, storage) if separable \
            else dense_long_range_tables(R, tile, dev, storage)
        yr, yi = fourstep(xr, xi, *lr, twr, twi, cb=cb, separable=separable)
    return as_compute(yr).reshape(n), as_compute(yi).reshape(n)


def fft_pi_layout_cuda_sixstep(xr, xi, tile: int | None = None,
                               r2: int | None = None,
                               cb1: int | None = None,
                               cb2: int | None = None,
                               separable: bool = True,
                               storage: str | None = None):
    """pi-layout n-point DIF of (n,) float32 planes in ONE launch of the
    sixstep kernel (the reference's fft_pi_layout_pallas_sixstep,
    pallas_fft.py:1664): n = R1 * R2 * tile, `r2` the inner radix (None
    = the balanced split), `cb1`/`cb2` the outer/inner column blocks
    (None = the widest that fit), `separable` the twiddle mode of both
    long-range phases.  `storage` "bfloat16" rounds the input once and
    runs the kernel's bf16 instantiation (planes, both carries and
    tables in bf16); the result is float32 either way.  Needs R = n/tile
    >= 4; validates every parameter before any launch."""
    maybe_fault("tube")  # resilience injection site
    n = _one_transform(xr, xi, "fft_pi_layout_cuda_sixstep")
    tile, R1, R2, cb1, cb2 = sixstep_blocking(n, tile, r2, cb1, cb2)
    dev = xr.device
    lr = device_factors if separable else dense_long_range_tables
    xr, xi = _to_storage(xr, xi, storage)
    with _obs_span("sixstep", cell={"n": n, "r1": R1, "r2": R2},
                   tile=tile, cb1=cb1, cb2=cb2, annotate=True):
        yr, yi = sixstep(xr.reshape(R1, R2, tile),
                         xi.reshape(R1, R2, tile),
                         *lr(R1, R2 * tile, dev, storage),
                         *lr(R2, tile, dev, storage),
                         *flat_tables(tile, dev, storage), cb1=cb1,
                         cb2=cb2, separable=separable)
    return as_compute(yr).reshape(n), as_compute(yi).reshape(n)


def fft_pi_layout_cuda_mf(xr, xi, R: int = LANE, cb: int | None = None,
                          precision: str = "split3"):
    """pi-layout n-point DIF of (n,) float32 planes with a matmul funnel
    (the reference's fft_pi_layout_pallas_mf, pallas_fft.py:1970): the
    first log2(R) levels as one ``matmul_funnel`` launch on the (R, n/R)
    view, its tensor-core passes set by `precision`, then ``tile_fft`` on
    the R rows of n/R points — two launches.  fp32 storage only; every
    parameter is validated before any launch (``mf_blocking``)."""
    maybe_fault("tube")  # resilience injection site
    n = _one_transform(xr, xi, "fft_pi_layout_cuda_mf")
    check_mf_storage(precision)
    R, C, cb = mf_blocking(n, R, cb)
    dev = xr.device
    yr, yi = matmul_funnel(xr.contiguous().reshape(R, C),
                           xi.contiguous().reshape(R, C),
                           device_funnel_b_tiles(R, split_levels(precision),
                                                 dev),
                           *device_funnel_factors(R, n, dev)[:2],
                           device_funnel_b2_tiles(R, n, dev), cb=cb,
                           precision=precision)
    yr, yi = tile_fft(yr, yi, *flat_tables(C, dev))
    return yr.reshape(n), yi.reshape(n)


def fft_rows_cuda(xr, xi, natural: bool = True,
                  storage: str | None = None):
    """FFT of every length-n row of (..., n) float planes, n a power of
    two in 128..2^16 (the reference's fft_rows_pallas, l.2070).  Rows up
    to MAX_SMEM_TILE are one ``tile_fft`` launch; rows of 2^15 and 2^16
    run as a per-row rql (``long_range_sep`` then ``tile_fft``).
    `natural=False` returns pi layout (per-row bit-reversed).  `storage`
    as ``fft_pi_layout_cuda_rql``'s; the natural-order gather runs on
    the float32 result."""
    maybe_fault("tube")  # resilience injection site
    n = xr.shape[-1]
    if n < LANE or n > MAX_ROW_TILE or not is_power_of_two(n):
        raise ValueError(
            f"fft_rows_cuda needs power-of-two {LANE} <= n <= "
            f"{MAX_ROW_TILE}, got {n}")
    yr, yi = fft_pi_layout_cuda_rql(xr, xi, storage=storage)
    return to_natural(yr, yi) if natural else (yr, yi)


def tube_cuda(sr, si, n: int, p: int):
    """Tube phase on the kernels: the segment-local s-point DIF of the
    trailing axis of (..., s) planes, s = n/p.  Levels log2(p).. of the
    n-point plan are a standalone s-point plan (W_{n>>(k+l)} =
    W_{s>>l}), so each segment is one rql transform.  Segments shorter
    than 128 take the stage tube, as the reference's tube_pallas does.
    The kernel tube runs under the "tube" span that ``models.pi_fft``'s
    tubes open (the stage tube opens its own)."""
    from ..models.pi_fft import tube

    if sr.shape[-1] < LANE:
        return tube(sr, si, n, p)
    with _obs_span("tube", cell={"n": n, "p": p}, annotate=True):
        return fft_pi_layout_cuda_rql(sr, si)


def pi_fft_pi_layout_cuda(xr, xi, p: int):
    """The pi-FFT (funnel + tube) with the tube on the kernels — the
    reference's pi_fft_pi_layout_pallas (l.2169).  Below a 128-point
    segment the whole transform takes the stage path, as there."""
    from ..models.pi_fft import funnel, pi_fft_pi_layout

    n = xr.shape[-1]
    if n // p < LANE:
        return pi_fft_pi_layout(xr, xi, p)
    fr, fi = funnel(xr, xi, p, device_tables(n, xr.device))
    tr, ti = tube_cuda(fr, fi, n, p)
    return tr.reshape(*xr.shape[:-1], n), ti.reshape(*xi.shape[:-1], n)
