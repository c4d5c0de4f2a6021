"""``python -m cs87project_msolano2_tpu_torch apps {conv,corr,solve}``:
the spectral operation suite's front door and its smokes (the
reference's ``apps/cli.py``).

``--smoke`` is the gate, one op per invocation:

* **conv**: (1) ``fftconv`` and overlap-save/add parity against numpy at
  2^10..2^14 (block sweep included); (2) the METERED fusion gate — the
  ``pifft_hbm_bytes_total`` delta of a fused conv, read from the bytes
  meter (``utils.roofline.HBM_METER``), must sit within FUSED_TOL of
  the op's fused floor while the deliberately UNFUSED control (a host
  round trip between the transforms) exceeds it, so the gate
  discriminates.  The reference's third conv check, a conv request
  served end to end over the socket protocol, comes with the serving
  layer.
* **corr**: ``fftcorr`` against ``numpy.correlate`` in every mode, and
  the conjugation mattering (corr != conv on an asymmetric kernel).
* **solve**: the 1-D solve against its oracle, and the pde family —
  3-D Poisson against the spectral reference, constant- and
  variable-coefficient Helmholtz, the exact heat step.

Without ``--smoke`` it runs a small demo of the op and prints a summary.
Everything runs on ``--device`` (the card by default; ``cpu`` runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: parity tolerance of the float32 fused pipelines against float64
#: oracles
TOL = 1e-4

#: the metered fusion gate: a fused cell must charge within this factor
#: of the fused floor
FUSED_TOL = 1.05

SMOKE_LOGNS = (10, 12, 14)


def _rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-30))


def _parity_problems(op: str, device) -> list:
    """Oracle parity of one op at the smoke sizes."""
    from .spectral import fftconv, fftcorr, numpy_oracle, solve_spectral_1d
    from .stream import overlap_add, overlap_save

    problems = []
    rng = np.random.default_rng(0)
    for logn in SMOKE_LOGNS:
        n = 1 << logn
        x = rng.standard_normal(n).astype(np.float32)
        k = rng.standard_normal(33).astype(np.float32)
        if op == "solve":
            got = solve_spectral_1d(x, device=device)
            err = _rel(got, numpy_oracle("solve", x, None, n))
            if err > TOL:
                problems.append(f"solve n=2^{logn}: rel err {err:.2e} > "
                                f"{TOL:.0e} vs spectral oracle")
            continue
        fn = fftconv if op == "conv" else fftcorr
        oracle = np.convolve if op == "conv" else np.correlate
        for mode in ("full", "same", "valid"):
            err = _rel(fn(x, k, mode, device=device),
                       oracle(x.astype(np.float64), k.astype(np.float64),
                              mode))
            if err > TOL:
                problems.append(f"{op} n=2^{logn} mode={mode}: rel err "
                                f"{err:.2e} > {TOL:.0e} vs "
                                f"numpy.{oracle.__name__}")
        if op == "conv" and logn == SMOKE_LOGNS[0]:
            # the streaming path across block sizes: block == padded
            # signal, block > signal, tails that do not divide
            ref = np.convolve(x.astype(np.float64), k.astype(np.float64),
                              "full")
            for block in (64, 256, n, 2 * n):
                for stitcher, name in ((overlap_save, "overlap-save"),
                                       (overlap_add, "overlap-add")):
                    err = _rel(stitcher(x, k, block=block, device=device),
                               ref)
                    if err > TOL:
                        problems.append(f"{name} block={block}: rel err "
                                        f"{err:.2e} > {TOL:.0e}")
    if op == "corr":
        # the conjugation must matter: an asymmetric kernel's corr and
        # conv differ
        x = rng.standard_normal(256).astype(np.float32)
        k = np.zeros(9, np.float32)
        k[1] = 1.0
        if np.allclose(fftcorr(x, k, "full", device=device),
                       fftconv(x, k, "full", device=device), atol=1e-3):
            problems.append("corr == conv on an asymmetric kernel: the "
                            "conjugation is not applied")
    return problems


def _fusion_gate_problems(device) -> list:
    """The metered fusion gate: the ``pifft_hbm_bytes_total`` delta of a
    fused conv and of the unfused control, read FROM THE METER, the
    fused one held at the floor."""
    from ..utils.roofline import meter_value, spectral_min_hbm_bytes
    from .spectral import fftconv, fftconv_unfused

    problems = []
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1 << 12) - 32).astype(np.float32)
    k = rng.standard_normal(33).astype(np.float32)
    # len(x) + len(k) - 1 is exactly 2^12: the fused path and the
    # next-pow2 unfused control land on the same n
    n_pad = 1 << 12

    def delta(fn):
        before = meter_value("pifft_hbm_bytes_total")
        y = fn(x, k, device=device)
        return y, int(meter_value("pifft_hbm_bytes_total") - before)

    y_fused, fused_bytes = delta(fftconv)
    y_unfused, unfused_bytes = delta(fftconv_unfused)
    floor = spectral_min_hbm_bytes("conv", n_pad)
    gate = int(floor * FUSED_TOL)
    if not fused_bytes:
        problems.append("fused conv charged ZERO metered bytes: the op "
                        "meter is not wired")
    elif fused_bytes > gate:
        problems.append(f"fused conv metered {fused_bytes} B > fused floor "
                        f"{floor} B x {FUSED_TOL}: the pipeline moves more "
                        f"than the fused model (a host round trip?)")
    if unfused_bytes <= gate:
        problems.append(f"UNFUSED control metered {unfused_bytes} B <= the "
                        f"gate bound {gate} B: the gate does not "
                        f"discriminate")
    if not np.allclose(y_fused, y_unfused, atol=1e-3):
        problems.append("fused and unfused conv disagree: the control is "
                        "not computing the same thing")
    return problems


def _solve_family_problems(device) -> list:
    """The pde family beyond the 1-D solve: 3-D Poisson against the
    spectral reference, Helmholtz (constant and variable coefficient),
    the exact heat step."""
    from .pde import (
        helmholtz_solve,
        helmholtz_solve_variable,
        poisson_solve,
        spectral_step,
    )

    problems = []
    rng = np.random.default_rng(3)
    f = rng.standard_normal((16, 16, 32)).astype(np.float32)
    f -= f.mean()
    axes = [np.fft.fftfreq(m) * m for m in f.shape]
    ksq = (axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2
           + axes[2][None, None, :] ** 2)

    def spectral_ref(mult):
        return np.real(np.fft.ifftn(np.fft.fftn(f.astype(np.float64))
                                    * mult))

    def host(u):
        return u.cpu().numpy()

    u = host(poisson_solve(f, device=device))
    with np.errstate(divide="ignore"):
        m_poi = np.where(ksq > 0, -1.0 / np.maximum(ksq, 1e-30), 0.0)
    err = float(np.max(np.abs(u - spectral_ref(m_poi))))
    if err > TOL:
        problems.append(f"3-D poisson: abs err {err:.2e} > {TOL:.0e}")
    uh = host(helmholtz_solve(f, 2.5, device=device))
    err = float(np.max(np.abs(uh - spectral_ref(1.0 / (2.5 + ksq)))))
    if err > TOL:
        problems.append(f"helmholtz alpha=2.5: abs err {err:.2e}")
    us = host(spectral_step(f, nu=0.05, dt=0.02, steps=4, device=device))
    err = float(np.max(np.abs(us - spectral_ref(np.exp(-0.05 * ksq
                                                        * 0.08)))))
    if err > TOL:
        problems.append(f"heat step: abs err {err:.2e}")
    alpha = (2.0 + 0.5 * np.cos(np.linspace(0, 2 * np.pi, 16))[:, None, None]
             * np.ones_like(f)).astype(np.float32)
    uv = host(helmholtz_solve_variable(f, alpha, iters=60, device=device))
    lap = np.real(np.fft.ifftn(np.fft.fftn(uv.astype(np.float64)) * (-ksq)))
    res = float(np.max(np.abs(alpha * uv - lap - f)) / np.max(np.abs(f)))
    if res > 1e-3:
        problems.append(f"variable helmholtz residual {res:.2e} > 1e-3: "
                        f"the fixed point did not converge")
    return problems


def apps_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch apps",
        description="the spectral operation suite: fused conv/corr, "
                    "streaming overlap-save, the spectral PDE family")
    ap.add_argument("op", choices=("conv", "corr", "solve"))
    ap.add_argument("--smoke", action="store_true",
                    help="the gate for this op: oracle parity, and the "
                         "metered fusion gate (conv)")
    ap.add_argument("-n", type=int, default=1 << 12,
                    help="demo size (no --smoke)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from ..utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not args.smoke:
        return _demo(args, device)

    problems = _parity_problems(args.op, device)
    checks = [f"{args.op} oracle parity at "
              + ",".join(f"2^{g}" for g in SMOKE_LOGNS)]
    if args.op == "conv":
        problems += _fusion_gate_problems(device)
        checks.append("metered fusion gate (fused floor vs unfused "
                      "control)")
    if args.op == "solve":
        problems += _solve_family_problems(device)
        checks.append("pde family (3-D poisson, helmholtz, variable "
                      "helmholtz, heat step)")

    if args.json:
        print(json.dumps({"op": args.op, "ok": not problems,
                          "device": str(device), "checks": checks,
                          "problems": problems}, indent=1, sort_keys=True))
    else:
        for p in problems:
            print(f"# FAIL: {p}", file=sys.stderr)
    if problems:
        return 1
    print(f"# apps {args.op} smoke ok ({'; '.join(checks)})",
          file=sys.stderr)
    return 0


def _demo(args, device) -> int:
    """The no-smoke path: run the op once and summarize."""
    rng = np.random.default_rng(0)
    n = args.n
    if args.op == "solve":
        from .spectral import solve_spectral_1d

        f = rng.standard_normal(n).astype(np.float32)
        u = solve_spectral_1d(f, device=device)
        print(f"solve: n={n} |u|_max={np.max(np.abs(u)):.4f} "
              f"mean={u.mean():.2e} (mean-free)")
        return 0
    from .spectral import fftconv, fftcorr
    from .stream import choose_block

    x = rng.standard_normal(n).astype(np.float32)
    k = rng.standard_normal(65).astype(np.float32)
    fn = fftconv if args.op == "conv" else fftcorr
    y = fn(x, k, device=device)
    print(f"{args.op}: n={n} m=65 -> {y.shape[0]} samples, "
          f"|y|_max={np.max(np.abs(y)):.4f}; streaming block choice for "
          f"m=65: {choose_block(65, n)}")
    return 0
