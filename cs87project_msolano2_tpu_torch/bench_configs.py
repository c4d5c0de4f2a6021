"""All five BASELINE.json configs measured into one record (the
reference's root ``bench_configs.py``; ``bench.py`` is the one-line
headline, this is the full table)::

    python -m cs87project_msolano2_tpu_torch.bench_configs --out FILE
        [--device cpu]

1. ``dft_direct`` at N = 1024 in complex128 on the host (the paper's CPU
   reference run), one call on the host clock, its error against numpy.
2. ``plans.measured_ms`` of the N = 2^20 complex64 transform in pi
   layout: the store's raced winner where there is one, else the static
   plan timed by the race's timer.
3. The batched 4096 x 4096 transform through the sharded entry
   (``parallel.batched.fft_batched_planes``) in natural and pi order.
4. The 2-D 4096^2 transform (``parallel.fft2d.fft2_sharded_planes``).
5. The 512^3 spectral Poisson solve
   (``parallel.poisson3d.poisson_solve_sharded``), the side halved to 256
   where ``torch.cuda.mem_get_info`` says the card cannot hold its
   working set.

Configs 3-5 run on a world-1 process group (NCCL on the card, gloo on
the CPU) and are timed by the loop slope (``utils.timing.
fitted_slope_ms``: device time per call on the card, the host clock on
the CPU).  Every row carries the reference's fields (``config``, ``ms``,
``gflops``, ``ms_pi_layout``, ...) and an ``env`` naming the device,
with the card's name and power limit.  A config that fails gives a row
with ``error``.  Each config's size is a parameter: the card runs the
BASELINE sizes, the CPU (``--device cpu``) the small ones of a check.
The record goes to ``--out`` only; the
committed ``datasets/bench_configs.json`` is the reference's and is
never written here.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

#: the BASELINE sizes: config 1's N, config 2's N, configs 3 and 4's
#: (rows, n), config 5's side
FULL_SIZES = {"n1": 1024, "n2": 1 << 20, "rows": (4096, 4096),
              "fft2": (4096, 4096), "side": 512}
#: the sizes of a run on the CPU (the plain versions)
SMALL_SIZES = {"n1": 64, "n2": 1 << 10, "rows": (8, 256),
               "fft2": (32, 64), "side": 16}
#: live plane-sized float32 arrays of the Poisson solve (the reference's
#: preflight), per rank
POISSON_PLANES = 14
SEED = 0


def _slope(fn, *args):
    from .utils.timing import fitted_slope_ms

    return fitted_slope_ms(fn, *args)


def _gflops(flops: float, ms: float) -> float:
    return round(flops / (ms * 1e-3) / 1e9, 1)


def _planes(shape, seed: int, device):
    """Uniform planes in +-1/sqrt(n) from a seeded generator on
    `device`."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(SEED + seed)
    amp = 1.0 / math.sqrt(shape[-1])
    return tuple((torch.rand(shape, generator=g, device=device) * 2 - 1)
                 * amp for _ in range(2))


def config1_direct_dft_f64(n: int = FULL_SIZES["n1"],
                           seed: int = SEED) -> dict:
    """1D complex DFT, N=1024, float64 (the CPU reference run)."""
    from .models.direct_dft import dft_direct
    from .utils.timing import time_ms

    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    # one call, as the reference times its one-shot run
    ms, y = time_ms(dft_direct, x, np.complex128, reps=1, warmup=0)
    ref = np.fft.fft(x)
    return {"config": f"1D DFT N={n} float64 (CPU einsum reference)",
            "ms": ms, "dtype": str(y.dtype),
            "rel_err_vs_numpy": float(np.max(np.abs(y - ref))
                                      / np.max(np.abs(y))),
            "rel_l2_vs_numpy": float(np.linalg.norm(y - ref)
                                     / np.linalg.norm(ref))}


def config2_fft_2e20(n: int = FULL_SIZES["n2"], device="cuda",
                     timer=None) -> dict:
    """1D radix-2 FFT, N=2^20, complex64, one card."""
    from . import plans

    # the kernel through the plan layer: the ladder bench.py races,
    # the store's winner where one was raced, with the bench's
    # measurement policy (plans.measured_ms)
    ms, plan = plans.measured_ms(
        plans.make_key(n, layout="pi", device=device), verbose=False,
        device=device, timer=timer)
    return {"config": f"1D FFT N=2^{int(math.log2(n))} complex64 (one "
                      f"card, {plan.variant})",
            "ms": ms, "gflops": _gflops(5 * n * math.log2(n), ms),
            "plan": plan.describe()}


def config3_batched(mesh, planes=None, shape=FULL_SIZES["rows"],
                    slope=_slope) -> tuple:
    """Batched 1D FFT, batch=4096 x N=4096, the batch over the mesh.
    Returns (row, this rank's natural-order output)."""
    from .parallel.batched import fft_batched_planes

    xr, xi = planes if planes is not None else _planes(shape, 31,
                                                       mesh.device)
    b, n = xr.shape[0] * mesh.shape["data"], xr.shape[-1]

    def natural(a, c):
        return fft_batched_planes(a, c, mesh)

    def pi(a, c):
        return fft_batched_planes(a, c, mesh, natural=False)

    out = natural(xr, xi)
    ms = slope(natural, xr, xi)
    ms_pi = slope(pi, xr, xi)
    flops = 5 * b * n * math.log2(n)
    return ({"config": f"batched FFT {b}x{n} (DP over {mesh.size} "
                       f"device(s))",
             "ms": ms, "gflops": _gflops(flops, ms),
             "ms_pi_layout": ms_pi,
             "gflops_pi_layout": _gflops(flops, ms_pi)}, out)


def config4_fft2d(mesh, planes=None, shape=FULL_SIZES["fft2"],
                  slope=_slope) -> tuple:
    """2D FFT 4096x4096 via row/col passes (+ all_to_all when the mesh
    has more than one rank).  Returns (row, this rank's rows)."""
    from .parallel.fft2d import fft2_sharded_planes

    xr, xi = planes if planes is not None else _planes(shape, 41,
                                                       mesh.device)
    r, c = xr.shape[0] * mesh.shape["p"], xr.shape[1]

    def run(a, b):
        return fft2_sharded_planes(a, b, mesh)

    out = run(xr, xi)
    ms = slope(run, xr, xi)
    flops = 5 * r * c * (math.log2(r) + math.log2(c))
    return ({"config": f"2D FFT {r}x{c} ({mesh.size}-device slab)",
             "ms": ms, "gflops": _gflops(flops, ms)}, out)


def poisson_side(side: int, world: int, device) -> tuple:
    """(side, preflight): the solve's side after the working-set
    preflight — POISSON_PLANES float32 planes of side^3 split over the
    ranks against the card's free memory
    (``torch.cuda.mem_get_info``), 256 where they do not fit; unchanged
    off the card."""
    import torch

    need = POISSON_PLANES * side ** 3 * 4 // world
    pre = {"need_bytes_per_rank": need}
    if torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info(torch.device(device))
        pre.update(free_bytes=free, total_bytes=total)
        if side > 256 and need > free:
            pre["demoted_from"] = side
            side = 256
    return side, pre


def config5_poisson(mesh, f=None, side: int = FULL_SIZES["side"],
                    slope=_slope) -> tuple:
    """3D spectral Poisson solve, slab decomposition, at 512^3.
    Returns (row, this rank's slab of u)."""
    import torch

    from .parallel.poisson3d import poisson_solve_sharded

    p = mesh.shape["p"]
    if f is None:
        side, pre = poisson_side(side, p, mesh.device)
        g = torch.Generator(device=mesh.device)
        g.manual_seed(SEED + 51)
        f = torch.randn((side // p, side, side), generator=g,
                        device=mesh.device)
    else:
        # the caller's field: the preflight is read and reported, the
        # size is the field's
        _, pre = poisson_side(f.shape[1], p, mesh.device)
    s = f.shape[1]

    def run(v):
        return poisson_solve_sharded(v, mesh)

    out = run(f)
    ms = slope(run, f)
    return ({"config": f"3D Poisson {s}^3 slab solve ({p} device(s))",
             "ms": ms, "preflight": pre}, out)


def record(rows, device) -> list:
    """The five rows, each stamped with the run's ``env`` (the device;
    on a card its name and power limit)."""
    from .analyze.records import env_fingerprint

    env = env_fingerprint(device=device)
    return [dict(row, env=env) for row in rows]


def check_record(rows) -> list:
    """Problems with a five-config record (empty = complete)."""
    problems = []
    if len(rows) != 5:
        problems.append(f"{len(rows)} rows, not 5")
    for i, row in enumerate(rows, start=1):
        if "error" in row:
            problems.append(f"config {i}: {row['error']}")
        elif not (isinstance(row.get("ms"), float) and row["ms"] > 0):
            problems.append(f"config {i}: ms {row.get('ms')!r}")
        if "env" not in row:
            problems.append(f"config {i}: no env")
    return problems


def write_record(rows, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(rows, fh, indent=2)


def _failed(fn, e: Exception) -> dict:
    return {"config": fn.__doc__.splitlines()[0],
            "error": f"{type(e).__name__}: {e}"}


def world1_configs(sizes: dict) -> list:
    """Configs 3, 4 and 5 on this rank of a world-1 job (a job's rank
    function: ``parallel.multihost.spawn_local``)."""
    from .parallel.mesh import make_mesh

    rows = []
    for fn, mesh_axis, kw in (
            (config3_batched, "data", {"shape": sizes["rows"]}),
            (config4_fft2d, "p", {"shape": sizes["fft2"]}),
            (config5_poisson, "p", {"side": sizes["side"]})):
        try:
            row, _ = fn(make_mesh(axis=mesh_axis), **kw)
        except Exception as e:
            row = _failed(fn, e)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    from .utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch.bench_configs",
        description="the five BASELINE configs measured into one record")
    ap.add_argument("--out", required=True,
                    help="where the record's JSON goes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    sizes = FULL_SIZES if device.type == "cuda" else SMALL_SIZES
    rows = []
    for fn, kw in ((config1_direct_dft_f64, {"n": sizes["n1"]}),
                   (config2_fft_2e20, {"n": sizes["n2"],
                                       "device": device})):
        try:
            rows.append(fn(**kw))
        except Exception as e:
            rows.append(_failed(fn, e))
    if device.type == "cuda":
        from .utils import buildlib

        buildlib.build()   # before the rank, as spawn_local asks
    from .parallel.multihost import spawn_local

    try:
        (world,) = spawn_local(world1_configs, 1, None, device, sizes)
    except Exception as e:
        world = [_failed(fn, e) for fn in (config3_batched, config4_fft2d,
                                           config5_poisson)]
    rows += world
    rows = record(rows, device)
    for row in rows:
        print(json.dumps(row))
    write_record(rows, args.out)
    return 1 if check_record(rows) else 0


if __name__ == "__main__":
    sys.exit(main())
