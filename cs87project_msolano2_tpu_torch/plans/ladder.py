"""The candidate-config ladder and the static defaults: which variant
serves a key, which variants a tuning race tries, and each one's
executor (the reference's ``plans/ladder.py``).

Variants (the reference's names):

* ``rows``   — ops.cuda_fft.fft_rows_cuda: each power-of-two row
               (128..2^16 points) through the tile kernel (rows past
               2^14 as a per-row rql); the batched hot path.
* ``fused`` / ``fused-alias`` — ops.cuda_fft.fft_pi_layout_cuda_fused:
               the whole transform of n <= FUSED_MAX_N in one
               cooperative launch, its carry in L2; ``fused-alias``
               writes the result over its input planes and allocates
               no output (CONSUMES_INPUT; in bf16 storage over the
               rounded copy made at entry, so the caller's planes are
               not consumed).  Raced only: the static default never
               serves it.
* ``rql``    — ops.cuda_fft.fft_pi_layout_cuda_rql: the long-range
               kernel, then the tile kernel; 1-D n above MAX_ROW_TILE
               and below FOURSTEP_MIN_N, and a pi-layout batch of rows
               above MAX_ROW_TILE (the planned tube's (p, s) segments),
               which the reference's plan layer refuses.
* ``fourstep`` — ops.cuda_fft.fft_pi_layout_cuda_fourstep: the whole
               transform in one cooperative launch; 1-D
               FOURSTEP_MIN_N <= n < SIXSTEP_MIN_N.  ``separable=False``
               reads dense long-range tables.
* ``sixstep`` — ops.cuda_fft.fft_pi_layout_cuda_sixstep: the whole
               transform with the long-range levels split in two, in
               one cooperative launch; 1-D n >= SIXSTEP_MIN_N.
               ``separable=False`` as for fourstep.
* ``two-kernel`` — ops.cuda_fft.fft_pi_layout_cuda2: the dense
               long-range kernel, then the tile kernel.  Raced only.
* ``stages`` — the all-float32 stage path (models.fft.fft_planes); the
               reference calls this variant ``jnp``.  Natural order only;
               serves every shape no kernel covers.  Never raced.
* ``mf``     — ops.cuda_fft.fft_pi_layout_cuda_mf: the first log2(R)
               levels as one DFT matrix product on the tensor cores
               (precision from the key), then the tile kernel; params
               ``R`` (default 128) and ``cb``.  fp32 storage only.  Served
               to a Plan built with it, as the reference's research
               variant: never raced, never the static default.
* ``bluestein`` / ``rader`` / ``mixedradix`` — ops.anylen: any n that
               is not a power of two, around power-of-two c2c subplans
               resolved through this ladder (``pad`` a raced parameter of
               the first two).  Natural order only.

The real domains (the reference's ``c2c_subkey``, its ladder.py:93):
an even-n r2c or c2r key races, defaults to and builds the entries of
the half-length c2c key, the executor wrapped in the pack and
Hermitian passes of ``models.real``; an odd-n one takes the any-length
entries directly.

Precision is a raced axis, as in the reference (its ladder.py:245-251):
a key whose mode has race alternates (``precision.race_modes``: bf16
races bf16 and split3) gets every entry once per mode, the mode pinned
in ``params["precision"]``, and the executor serves the pinned mode, or
the key's where none is pinned.  bf16 storage runs on every kernel
variant the reference serves it on (``rows``, ``rql``, ``fourstep``,
``sixstep``, ``fused``, ``fused-alias`` and ``two-kernel``: their
kernels' bf16 instantiations); ``mf`` refuses it (fp32 storage only,
the reference's own refusal); ``stages`` runs float32 whatever the
mode.

Keys whose ``backend`` is "gpu" or "cpu-native" go to ``hw.lowering``
(``gpu-rows``, ``gpu-stages``, ``cpu-native``) in ``candidates``,
``static_default`` and ``build_executor``, as the reference's
ladder.py:235/327/439 do; the
``cuda`` family below never sees them.  The crossovers follow
the reference (``ladder.py:54-73``, ``353-386``) and depend only on the
key, never on whether a card is present, so CPU tests exercise the same
composition the card runs.  The plan parameter ``tail`` is gone: the
port's tile kernel runs its last levels as fp32 butterflies, not a
matmul tail, so every race entry the reference doubled along its tail
axis is raced once here.  Parameters keep the reference's names and
take Hopper-legal values: tile at most MAX_SMEM_TILE = 2^14 (the
reference's 2^16 halves to 2^14, its 2^15 to 2^13), ``qb`` counts
32-column groups of the fused kernel's phase-A block (the reference's
counted 128-lane groups), ``cb`` columns; the fused kernel's ``cw``
(blocks of the cluster sharing one tile row, 1 to 8) has no reference
counterpart and defaults to ``cuda_fft.FUSED_AUTO_CW``.
"""

from __future__ import annotations

import math

from ..ops.bits import is_power_of_two
from ..ops.cuda_fft import (
    DEFAULT_CB,
    FUSED_MAX_N,
    MAX_ROW_TILE,
    MAX_SMEM_TILE,
    MIN_AUTO_CB,
    fourstep_auto_cb,
    fourstep_blocking,
    fused_blocking,
    rows_plan_feasible,
    sixstep_auto_cbs,
    sixstep_auto_split,
    sixstep_blocking,
)
from ..ops import anylen
from ..ops.precision import race_modes, storage_dtype
from .core import PlanKey

#: variants whose executor writes its result over its input planes (in
#: float32 storage: in bf16 it writes over the rounded copy it made)
CONSUMES_INPUT = ("fused-alias",)

#: the reference's crossovers (its ladder.py:61 and :69): fourstep from
#: here (where the fused carry no longer fits), rql below
FOURSTEP_MIN_N = FUSED_MAX_N << 1
#: sixstep from here, fourstep below
SIXSTEP_MIN_N = 1 << 25
#: dense-twiddle fourstep/sixstep entries are raced only while their
#: tables (about 2n floats) stay affordable to build and stream
FOURSTEP_DENSE_MAX_N = 1 << 22
#: the reference's second tile of a race (its 2^15 beside 2^16)
_HALF_TILE = MAX_SMEM_TILE >> 1

# The flagship race below FOURSTEP_MIN_N, in the reference's order
# (ladder.py:77-86): fused, fused-alias twice, rql three times,
# two-kernel.  The fused entries take qb = 2 (a 64 x 64 phase-A block at
# n = 2^20) and qb = 1 (64 x 32, 512 work items), each tile row on the
# default cluster (fused_blocking); the reference's third entry doubles
# qb, here it halves it, as it had to when qb counted 128 columns and
# a doubled block overflowed shared memory.  The rql entries are
# the reference's tile/cb pattern at Hopper sizes (cb halved, then the
# tile halved); its fourth rql entry differed from the first only in
# tail and is raced once.  two-kernel takes the rql column block.
FLAGSHIP_LADDER = (
    ("fused", {"tile": MAX_SMEM_TILE, "qb": 2}),
    ("fused-alias", {"tile": MAX_SMEM_TILE, "qb": 2}),
    ("fused-alias", {"tile": MAX_SMEM_TILE, "qb": 1}),
    ("rql", {"tile": MAX_SMEM_TILE, "cb": DEFAULT_CB}),
    ("rql", {"tile": MAX_SMEM_TILE, "cb": DEFAULT_CB // 2}),
    ("rql", {"tile": _HALF_TILE, "cb": DEFAULT_CB}),
    ("two-kernel", {"tile": MAX_SMEM_TILE, "cb": DEFAULT_CB}),
)


def _nrows(key: PlanKey) -> int:
    return math.prod(key.batch) or 1


def c2c_subkey(key: PlanKey) -> PlanKey:
    """The half-length natural-order c2c key an EVEN-n r2c/c2r key rides:
    the pack trick turns a length-n real transform into one c2c
    transform at n/2, so candidates, static defaults and executors of
    the even real domains delegate here.  Odd n has no even/odd split
    and takes the any-length path (ops.anylen) instead."""
    import dataclasses

    return dataclasses.replace(key, n=key.n // 2, layout="natural",
                               domain="c2c")


def _fourstep_feasible(n: int) -> bool:
    """Can the fourstep kernel serve an n-point transform at tile
    MAX_SMEM_TILE?  False once its narrowest column block no longer fits
    shared memory, so the static default never serves a plan that
    raises on first execute."""
    try:
        fourstep_blocking(n, MAX_SMEM_TILE)
    except ValueError:
        return False
    return True


def _sixstep_feasible(n: int) -> bool:
    """Can the sixstep kernel serve an n-point transform at tile
    MAX_SMEM_TILE?  Needs R = n/tile >= 4 and column blocks that fit."""
    try:
        sixstep_blocking(n, MAX_SMEM_TILE)
    except ValueError:
        return False
    return True


def sixstep_candidates(n: int) -> list:
    """The sixstep race entries for an n-point 1-D key, in the
    reference's order (ladder.py:145): the auto entry, one explicit
    halving each of cb1 and cb2 (kept while the half is at least one
    warp's 128-byte row segment, DEFAULT_CB), a rebalanced split with a
    deeper inner radix, the half tile, and the dense tables while they
    stay affordable.  The reference's tail=128 entry is raced once, as
    the auto entry."""
    auto = {"tile": MAX_SMEM_TILE, "r2": None, "cb1": None, "cb2": None,
            "separable": True}
    ents = [("sixstep", dict(auto))]
    try:
        r1, r2 = sixstep_auto_split(n, MAX_SMEM_TILE)
        cb1, cb2 = sixstep_auto_cbs(n, MAX_SMEM_TILE, r2)
    except ValueError:
        r1 = r2 = cb1 = cb2 = None
    if cb1 is not None and cb1 // 2 >= DEFAULT_CB:
        ents.append(("sixstep", dict(auto, cb1=cb1 // 2)))
    if cb2 is not None and cb2 // 2 >= DEFAULT_CB:
        ents.append(("sixstep", dict(auto, cb2=cb2 // 2)))
    if r1 is not None and r1 // 2 >= 2:
        # rebalanced split: a deeper inner radix shrinks the outer
        # phase's R1 x cb1 block at the cost of more inner blocks
        ents.append(("sixstep", dict(auto, r2=r2 * 2)))
    ents.append(("sixstep", dict(auto, tile=_HALF_TILE)))
    if n <= FOURSTEP_DENSE_MAX_N:
        ents.append(("sixstep", dict(auto, separable=False)))
    return ents


def fourstep_candidates(n: int) -> list:
    """The fourstep race entries for an n-point 1-D key, in the
    reference's order (ladder.py:177): the auto entry, one explicit
    halving of the auto column block (kept while the half is at least
    MIN_AUTO_CB, one 32-byte sector of a row: 16 at n = 2^21, 8 at
    2^22), the dense tables while they stay affordable
    (FOURSTEP_DENSE_MAX_N), and the half tile.  The reference's
    tail=128 entry is raced once, as the auto entry."""
    ents = [("fourstep", {"tile": MAX_SMEM_TILE, "cb": None,
                          "separable": True})]
    try:
        auto = fourstep_auto_cb(n, MAX_SMEM_TILE)
    except ValueError:
        auto = None
    if auto is not None and auto // 2 >= MIN_AUTO_CB:
        ents.append(("fourstep", {"tile": MAX_SMEM_TILE, "cb": auto // 2,
                                  "separable": True}))
    if n <= FOURSTEP_DENSE_MAX_N:
        ents.append(("fourstep", {"tile": MAX_SMEM_TILE, "cb": None,
                                  "separable": False}))
    ents.append(("fourstep", {"tile": _HALF_TILE, "cb": None,
                              "separable": True}))
    return ents


def candidates(key: PlanKey) -> list:
    """The ordered (variant, params) race for `key`, the reference's
    ``candidates`` for a c2c power-of-two key: below FOURSTEP_MIN_N the
    flagship ladder (fused first) leads and fourstep rides at the end,
    so a surprise win is still caught; between the crossovers the
    fourstep entries lead and sixstep rides at the end; from
    SIXSTEP_MIN_N the sixstep entries lead and the fused and fourstep
    entries drop out.  An even-n real-domain key races its half-length
    c2c subkey's entries (``build_executor`` wraps them, so the race
    times the real path); a key whose n is not a power of two races the
    any-length entries (``_anylen_candidates``).  The precision race
    axis (the reference's ladder.py:245-251): where ``race_modes`` of
    the key's mode has more than one mode (bf16: bf16 then split3),
    every entry is raced once per mode, the mode pinned in
    ``params["precision"]``.  gpu keys take ``hw.lowering.candidates``."""
    if key.backend in ("gpu", "cpu-native"):
        from ..hw import lowering

        return lowering.candidates(key)
    storage_dtype(key.precision)
    if key.domain != "c2c" and key.n % 2 == 0:
        return candidates(c2c_subkey(key))
    if key.domain != "c2c":
        cands = _anylen_candidates(key)  # odd-n real: the direct path
    else:
        cands = _base_candidates(key)
    modes = race_modes(key.precision)
    if len(modes) > 1:
        cands = [(v, dict(p, precision=m)) for m in modes for v, p in cands]
    return cands


def _anylen_candidates(key: PlanKey) -> list:
    """The any-length race for a key whose n is not a power of two (the
    reference's ladder.py:254): the statically routed variant leads (its
    pads cheapest first), and the Bluestein entries at every feasible
    pad always ride, so the race can catch a routing miss.  Each entry's
    subtransforms resolve through this ladder (pads have odd part 1, 3
    or 5, so the recursion is one level deep)."""
    if key.layout != "natural":
        return []
    n = key.n
    best = anylen.plan_variant(n)
    cands = []
    if best == "rader":
        cands += [("rader", {"pad": p})
                  for p in anylen.pad_candidates(n - 1)]
    elif best == "mixedradix":
        cands.append(("mixedradix", {}))
    cands += [("bluestein", {"pad": p}) for p in anylen.pad_candidates(n)]
    return cands


def _base_candidates(key: PlanKey) -> list:
    """The variant/parameter race for a c2c key, before the precision
    axis is expanded."""
    if not is_power_of_two(key.n):
        return _anylen_candidates(key)
    cands = []
    if rows_plan_feasible(_nrows(key), key.n):
        # the reference races two tails here; the port has one row path
        cands = [("rows", {})]
    elif key.batch == () and key.n > MAX_ROW_TILE:
        if key.n < FOURSTEP_MIN_N:
            cands = [(v, dict(p)) for v, p in FLAGSHIP_LADDER]
        elif key.n < SIXSTEP_MIN_N:
            cands = fourstep_candidates(key.n)
            cands += [(v, dict(p)) for v, p in FLAGSHIP_LADDER
                      if not v.startswith("fused")]
        else:
            cands = sixstep_candidates(key.n)
            cands += [(v, dict(p)) for v, p in FLAGSHIP_LADDER
                      if not v.startswith("fused")]
        # the shared-memory-aware auto-cb rql: at large n the fixed-cb
        # entries overflow a block and reject; this one always fits
        cands.append(("rql", {"tile": MAX_SMEM_TILE, "cb": None}))
        if key.n < FOURSTEP_MIN_N:
            # below the crossover fourstep is the expected loser, raced
            # last so the record still shows the margin per n
            cands += fourstep_candidates(key.n)
        elif key.n < SIXSTEP_MIN_N and _sixstep_feasible(key.n):
            # likewise sixstep below its crossover: the second carry
            # pass should lose to fourstep's one
            cands += sixstep_candidates(key.n)
    elif key.layout != "natural" and key.n > MAX_ROW_TILE:
        # a batch of pi-layout rows past the row kernel: rql over the
        # batch (the 1-D kernels take one transform)
        cands = [(v, dict(p)) for v, p in FLAGSHIP_LADDER if v == "rql"]
        cands.append(("rql", {"tile": MAX_SMEM_TILE, "cb": None}))
    return cands


def static_default(key: PlanKey):
    """(variant, params) for `key`: ``rows`` for a feasible batch of
    rows; for a 1-D n above MAX_ROW_TILE (tile 2^14, the largest
    shared-memory tile; None = the automatic block or split) ``sixstep``
    from SIXSTEP_MIN_N, ``fourstep`` from FOURSTEP_MIN_N, and ``rql``
    below that or where neither is feasible; ``rql`` for a pi-layout
    batch of rows above MAX_ROW_TILE; the stage path elsewhere (natural
    order only).  Never a raced-only variant (fused,
    two-kernel): those serve a key only once a race chose them.  An
    even-n real-domain key takes its half-length c2c subkey's default;
    an n that is not a power of two takes ``anylen.plan_variant``'s
    variant at the cheapest pad, and refuses pi layout.  gpu keys take
    ``hw.lowering.static_default``."""
    if key.backend in ("gpu", "cpu-native"):
        from ..hw import lowering

        return lowering.static_default(key)
    storage_dtype(key.precision)
    if key.domain != "c2c" and key.n % 2 == 0:
        return static_default(c2c_subkey(key))
    if not is_power_of_two(key.n):
        if key.layout != "natural":
            raise ValueError(
                f"layout='pi' requires a power-of-two n (bit-reversed "
                f"order is undefined otherwise), got n={key.n}")
        best = anylen.plan_variant(key.n)
        if best == "rader":
            return "rader", {"pad": anylen.default_pad(key.n - 1)}
        if best == "mixedradix":
            return "mixedradix", {}
        return "bluestein", {"pad": anylen.default_pad(key.n)}
    if rows_plan_feasible(_nrows(key), key.n):
        return "rows", {}
    if key.batch == () and key.n > MAX_ROW_TILE:
        if key.n >= SIXSTEP_MIN_N and _sixstep_feasible(key.n):
            return "sixstep", {"tile": MAX_SMEM_TILE, "r2": None,
                               "cb1": None, "cb2": None, "separable": True}
        if FOURSTEP_MIN_N <= key.n < SIXSTEP_MIN_N and \
                _fourstep_feasible(key.n):
            return "fourstep", {"tile": MAX_SMEM_TILE, "cb": None,
                                "separable": True}
        return "rql", {"tile": MAX_SMEM_TILE, "cb": None}
    if key.layout != "natural" and key.n > MAX_ROW_TILE:
        return "rql", {"tile": MAX_SMEM_TILE, "cb": None}
    if key.layout != "natural":
        raise ValueError(
            f"pi-layout output requires a kernel-eligible shape "
            f"(power-of-two trailing axis 128..{MAX_ROW_TILE}, or a 1-D "
            f"n above it), got batch={key.batch} n={key.n}")
    return "stages", {}


def build_executor(key: PlanKey, variant: str, params: dict):
    """The (xr, xi) -> (yr, yi) executor for one ladder entry, serving
    ``params["precision"]`` where a race pinned it, else the key's mode
    (the reference's l.460), on that mode's storage.  Raises ValueError
    for an unknown variant, for a bf16 ``mf`` entry (the reference's
    refusal), and for infeasible tile/cb/qb/R before anything launches
    (the tuner records those as rejections).  An even-n real-domain key
    wraps the half-length c2c executor of the same entry in the pack and
    Hermitian passes (``models.real``); odd-n real keys and the
    any-length variants build in ``ops.anylen``.  gpu keys build
    through ``hw.lowering.build_executor``."""
    from ..ops import cuda_fft
    from ..ops.bits import to_natural
    if key.backend in ("gpu", "cpu-native"):
        from ..hw import lowering

        return lowering.build_executor(key, variant, params)
    storage_dtype(key.precision)
    if key.domain != "c2c" and key.n % 2:
        return anylen.build_anylen_executor(key, variant, params)
    if key.domain != "c2c":
        from ..models import real

        return real.real_executor(
            build_executor(c2c_subkey(key), variant, params), key.domain,
            key.n)
    if variant in anylen.ANYLEN_VARIANTS:
        return anylen.build_anylen_executor(key, variant, params)
    mode = params.get("precision") or key.precision
    storage = storage_dtype(mode)
    if variant == "mf":
        # fp32 storage only: a race entry records the reference's own
        # rejection
        cuda_fft.check_mf_storage(mode)
    natural = key.layout == "natural"
    if variant == "stages":
        if not natural:
            raise ValueError("the stage path only produces natural order")
        from ..models.fft import fft_planes

        return fft_planes
    if variant == "rows":
        def rows_run(xr, xi):
            return cuda_fft.fft_rows_cuda(xr, xi, natural=natural,
                                          storage=storage)

        return rows_run
    if variant not in ("rql", "two-kernel", "fourstep", "sixstep", "fused",
                       "fused-alias", "mf"):
        raise ValueError(f"unknown plan variant {variant!r}")
    if key.batch != () and variant != "rql":
        raise ValueError(f"variant {variant!r} is a 1-D whole-transform "
                         f"path; key has batch={key.batch}")
    tile = params.get("tile")
    separable = params.get("separable", True)
    if variant in ("rql", "two-kernel"):
        cb = params.get("cb")
        cuda_fft.rql_blocking(key.n, tile, cb)
        if variant == "rql":
            def run(xr, xi):
                return cuda_fft.fft_pi_layout_cuda_rql(xr, xi, tile, cb,
                                                       storage)
        else:
            def run(xr, xi):
                return cuda_fft.fft_pi_layout_cuda2(xr, xi, tile, cb,
                                                    storage)
    elif variant in ("fused", "fused-alias"):
        qb = params.get("qb")
        cw = params.get("cw")
        fused_blocking(key.n, tile, qb, cw)
        alias_io = variant == "fused-alias"

        def run(xr, xi):
            return cuda_fft.fft_pi_layout_cuda_fused(xr, xi, tile, qb,
                                                     alias_io, cw, storage)
    elif variant == "mf":
        R = params.get("R", cuda_fft.LANE)
        cb = params.get("cb")
        cuda_fft.mf_blocking(key.n, R, cb)
        def run(xr, xi):
            return cuda_fft.fft_pi_layout_cuda_mf(xr, xi, R, cb, mode)
    elif variant == "fourstep":
        cb = params.get("cb")
        fourstep_blocking(key.n, tile, cb)

        def run(xr, xi):
            return cuda_fft.fft_pi_layout_cuda_fourstep(xr, xi, tile, cb,
                                                        separable, storage)
    else:
        r2, cb1, cb2 = (params.get(k) for k in ("r2", "cb1", "cb2"))
        sixstep_blocking(key.n, tile, r2, cb1, cb2)

        def run(xr, xi):
            return cuda_fft.fft_pi_layout_cuda_sixstep(
                xr, xi, tile, r2, cb1, cb2, separable, storage)

    def whole_run(xr, xi):
        yr, yi = run(xr, xi)
        return to_natural(yr, yi) if natural else (yr, yi)

    # fused-alias writes its result over the planes it is given: a Plan
    # hands it planes it owns, a copy only where they are the caller's.
    # In bf16 storage it writes over the rounded copy made at entry
    whole_run.consumes_input = variant in CONSUMES_INPUT and \
        storage == "float32"
    return whole_run
