"""Command line: the reference-parity pi-FFT run.

    python -m cs87project_msolano2_tpu_torch -n 1048576 -p 4 -b cuda --verify
    python -m cs87project_msolano2_tpu_torch -t -b cuda

prints the reference's 5-column TSV (n, p, total_ms, funnel_ms,
tube_ms); ``-t`` runs the exact 8-point golden test for p in {1,2,4,8}.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .backends.registry import get_backend, list_backends
from .utils import verify


def make_input(n: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-random input with amplitude 1/sqrt(n), as
    the reference's CLI makes it."""
    rng = np.random.default_rng(seed)
    amp = 1.0 / np.sqrt(n)
    x = (rng.uniform(-amp, amp, n) + 1j * rng.uniform(-amp, amp, n))
    return x.astype(np.complex64)


def run_golden(backend_name: str, device=None) -> int:
    b = get_backend(backend_name, device)
    ok_all = True
    for p in (1, 2, 4, 8):
        res = b.run(verify.golden_input(), p)
        nat = verify.pi_layout_to_natural(res.out)
        ok = verify.golden_check_tol(nat, b.golden_atol)
        print(f"golden test: backend={backend_name} n=8 p={p} ... "
              f"{'PASSED' if ok else 'FAILED'}")
        ok_all &= ok
    return 0 if ok_all else 1


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch",
        description="communication-free pi-FFT on PyTorch/CUDA",
    )
    ap.add_argument("-n", type=int, help="input length (power of two)")
    ap.add_argument("-p", type=int,
                    help="virtual processors (power of two, <= n)")
    ap.add_argument("-t", action="store_true", help="golden test mode")
    ap.add_argument("-o", action="store_true", help="omit TSV header")
    ap.add_argument("-b", "--backend", default="cuda",
                    choices=list_backends())
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions (median)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="also check the result against numpy's FFT")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    if args.t:
        return run_golden(args.backend, args.device)
    if not args.n or not args.p:
        ap.print_usage(sys.stderr)
        return 2

    b = get_backend(args.backend, args.device)
    x = make_input(args.n, args.seed)
    try:
        res = b.run(x, args.p, reps=args.reps)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.verify:
        ref = np.fft.fft(x.astype(np.complex128))
        err = verify.rel_err(verify.pi_layout_to_natural(res.out), ref)
        if err > 1e-5:
            print(f"error: verification failed, rel err {err:.3e} > 1e-5",
                  file=sys.stderr)
            return 1
        print(f"# verified vs numpy fft: rel err {err:.3e}", file=sys.stderr)

    if not args.o:
        print("n\tp\ttotal_ms\tfunnel_ms\ttube_ms")
    print(f"{args.n}\t{args.p}\t{res.total_ms:.6f}\t{res.funnel_ms:.6f}\t"
          f"{res.tube_ms:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
