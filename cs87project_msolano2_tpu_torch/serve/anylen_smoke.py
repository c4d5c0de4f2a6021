"""The any-length serving smoke (the reference's
``serve/anylen_smoke.py``): prove on this machine that the serve front
door answers a NON-power-of-two length with a real plan, not a degrade
rung.

    python -m cs87project_msolano2_tpu_torch.serve.anylen_smoke [--device cpu]

n = 1000 c2c and r2c requests travel the real wire (the JSON dialect
over a loopback socket) through the real dispatcher on ``--device`` (the
card by default), and every reply must carry

* numpy parity within the split3 error budget,
* a ``plan_variant`` of the any-length ladder (n = 1000 = 8 * 125 routes
  to ``mixedradix``), not ``torch-fft``/``numpy-ref``,
* ``degraded: false`` with an empty degrade trail.

Exit 0 only when every assertion holds.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

import numpy as np

#: the served non-power-of-two length (8 * 125: odd part 125 <= 512, so
#: the static ladder picks mixedradix)
N = 1000

#: the split3 budget: the served precision here
TOL = 1e-5


def _relerr(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _check(problems, label, reply, ref, want_bins=None) -> bool:
    """Append what is wrong with one reply; True when it was served."""
    from ..ops.anylen import ANYLEN_VARIANTS

    if not reply.get("ok"):
        problems.append(f"{label} refused: {reply.get('error')}")
        return False
    got = np.asarray(reply["yr"]) + 1j * np.asarray(reply["yi"])
    if want_bins is not None and got.shape[-1] != want_bins:
        problems.append(f"{label} returned {got.shape[-1]} bins, want "
                        f"{want_bins}")
    else:
        err = _relerr(got, ref)
        if err > TOL:
            problems.append(f"{label} parity {err:.2e} > {TOL:.0e}")
    if reply.get("plan_variant") not in ANYLEN_VARIANTS:
        problems.append(f"{label} served by {reply.get('plan_variant')!r}"
                        f": want an any-length plan {ANYLEN_VARIANTS}")
    if reply.get("degraded"):
        problems.append(f"{label} tagged degraded "
                        f"({reply.get('degrade')})")
    return True


async def _run(problems: list, device) -> int:
    from .dispatcher import Dispatcher, ServeConfig
    from .protocol import handle_connection, request_over_socket
    from .shapes import ShapeSpec

    rng = np.random.default_rng(87)
    specs = [ShapeSpec(n=N), ShapeSpec(n=N, domain="r2c")]
    cfg = ServeConfig(max_wait_ms=2.0)
    served = 0
    async with Dispatcher(cfg, specs, device=device) as d:
        server = await asyncio.start_server(
            lambda r, w: handle_connection(d, r, w), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            # c2c at n = 1000: parity vs numpy, a plan not a rung
            xr = rng.standard_normal(N).astype(np.float32)
            xi = rng.standard_normal(N).astype(np.float32)
            reply = await request_over_socket("127.0.0.1", port, xr, xi)
            ref = np.fft.fft(xr.astype(np.float64)
                             + 1j * xi.astype(np.float64))
            served += _check(problems, f"c2c n={N}", reply, ref)
            # r2c at n = 1000: the even-n pack over the wire
            xr = rng.standard_normal(N).astype(np.float32)
            reply = await request_over_socket("127.0.0.1", port, xr,
                                              domain="r2c")
            ref = np.fft.rfft(xr.astype(np.float64))
            served += _check(problems, f"r2c n={N}", reply, ref,
                             want_bins=N // 2 + 1)
        finally:
            server.close()
            await server.wait_closed()
    return served


def main(argv=None) -> int:
    from .. import obs
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch.serve.anylen_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    owned = not obs.enabled()
    if owned:
        obs.enable()
    problems: list = []
    try:
        served = asyncio.run(_run(problems, device))
    finally:
        if owned:
            obs.disable()
    for p in problems:
        print(f"# FAIL: {p}", file=sys.stderr)
    if problems:
        return 1
    print(f"# anylen serve smoke ok on {device}: {served} non-pow2 "
          f"(n={N}) requests served over the socket on a mixed-radix "
          f"plan, numpy parity within {TOL:.0e}, zero degrade rungs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
