"""``python -m cs87project_msolano2_tpu_torch apps {conv,corr,solve}``:
the spectral operation suite's front door and its smokes (the
reference's ``apps/cli.py``).

``--smoke`` is the gate, one op per invocation:

* **conv**: (1) ``fftconv`` and overlap-save/add parity against numpy at
  2^10..2^14 (block sweep included); (2) the METERED fusion gate — the
  ``pifft_hbm_bytes_total`` delta of a fused conv, read from the bytes
  meter (observability is armed for the gate where it is off, and
  disarmed after: "owned"), must sit within FUSED_TOL of
  the op's fused floor while the deliberately UNFUSED control (a host
  round trip between the transforms) exceeds it, so the gate
  discriminates; (3) a conv request served end to end over the socket
  protocol (``_served_conv_problems``): op-tagged, coalesced, in its SLO
  row and on ``pifft_serve_ops_total``, and under one injected capacity
  fault degrade-tagged on the CPU (the ``torch-fft`` rung speaks conv)
  or, on the card, where no library rung serves, failed structured with
  the next request served.
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
    from .. import obs
    from ..obs import metrics
    from ..utils.roofline import spectral_min_hbm_bytes
    from .spectral import fftconv, fftconv_unfused

    problems = []
    with obs.armed():
        rng = np.random.default_rng(1)
        x = rng.standard_normal((1 << 12) - 32).astype(np.float32)
        k = rng.standard_normal(33).astype(np.float32)
        # len(x) + len(k) - 1 is exactly 2^12: the fused path and the
        # next-pow2 unfused control land on the same n
        n_pad = 1 << 12

        def delta(fn):
            before = metrics.counter_value("pifft_hbm_bytes_total")
            y = fn(x, k, device=device)
            return y, int(metrics.counter_value("pifft_hbm_bytes_total")
                          - before)

        y_fused, fused_bytes = delta(fftconv)
        y_unfused, unfused_bytes = delta(fftconv_unfused)
        floor = spectral_min_hbm_bytes("conv", n_pad)
        gate = int(floor * FUSED_TOL)
        if not fused_bytes:
            problems.append("fused conv charged ZERO metered bytes: the "
                            "op meter is not wired")
        elif fused_bytes > gate:
            problems.append(f"fused conv metered {fused_bytes} B > fused "
                            f"floor {floor} B x {FUSED_TOL}: the pipeline "
                            f"moves more than the fused model (a host "
                            f"round trip?)")
        if unfused_bytes <= gate:
            problems.append(f"UNFUSED control metered {unfused_bytes} B "
                            f"<= the gate bound {gate} B: the gate does "
                            f"not discriminate")
        if not np.allclose(y_fused, y_unfused, atol=1e-3):
            problems.append("fused and unfused conv disagree: the control "
                            "is not computing the same thing")
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


def _served_conv_problems(device) -> list:
    """A conv request served end to end through the SOCKET protocol on
    `device`: op-tagged GroupKey, coalesced, visible in the SLO rows and
    the op counter, schema-valid events; one more request under an
    injected capacity fault at the ``serve`` site must come back
    degrade-tagged on CPU planes, or, on the card (no library rung
    serves a card request), as a structured ``request_failed`` of kind
    capacity, the request after it served."""
    import asyncio

    from .. import obs
    from ..obs import events as obs_events
    from ..obs import metrics
    from ..resilience import inject
    from ..serve import Dispatcher, ServeConfig
    from ..serve.batcher import GroupKey
    from ..serve.protocol import handle_connection, request_over_socket
    from ..serve.shapes import ShapeSpec
    from .spectral import numpy_oracle

    problems = []
    owned = not obs.enabled()
    if owned:
        obs.enable()
    n = 1 << 10
    k_burst = 6
    rng = np.random.default_rng(2)
    spec = ShapeSpec(n=n, op="conv")
    label = GroupKey(n=n, domain="r2c", op="conv").label()
    inputs = [(rng.standard_normal(n).astype(np.float32),
               rng.standard_normal(n).astype(np.float32))
              for _ in range(k_burst)]
    on_card = device.type != "cpu"

    async def main():
        d = Dispatcher(ServeConfig(max_wait_ms=25.0), [spec], device=device)
        await asyncio.get_running_loop().run_in_executor(None, d.warm)
        server = await asyncio.start_server(
            lambda r, w: handle_connection(d, r, w), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        replies = await asyncio.gather(*[
            request_over_socket("127.0.0.1", port, xr, xi, op="conv")
            for xr, xi in inputs])
        # one more with the serve site armed: on the CPU the batch falls
        # to a rung that still speaks conv, degrade-tagged on the wire;
        # on the card it fails structured and the next one is served
        with inject("serve", "capacity", count=1):
            faulted = await request_over_socket(
                "127.0.0.1", port, inputs[0][0], inputs[0][1], op="conv")
        after = await request_over_socket(
            "127.0.0.1", port, inputs[1][0], inputs[1][1], op="conv")
        server.close()
        await server.wait_closed()
        await d.close()
        return d, replies, faulted, after

    def wrong(rep, xr, xi):
        ref = numpy_oracle("conv", xr.astype(np.float64),
                           xi.astype(np.float64), n)
        err = float(np.max(np.abs(np.asarray(rep["yr"]) - ref))
                    / np.max(np.abs(ref)))
        return f"rel err {err:.2e} > {TOL:.0e}" if err > TOL else None

    try:
        d, replies, faulted, after = asyncio.run(main())
        for (xr, xi), rep in zip(inputs, replies):
            if not rep.get("ok"):
                problems.append(f"served conv failed: {rep}")
                break
            if wrong(rep, xr, xi):
                problems.append(f"served conv wrong: {wrong(rep, xr, xi)}")
                break
        batches = int(metrics.counter_value(
            "pifft_serve_batches_total", shape=label))
        if not (0 < batches < k_burst):
            problems.append(
                f"no coalescing: {k_burst} concurrent conv requests "
                f"-> {batches} invocation(s) on group {label!r}")
        if on_card:
            err = faulted.get("error") or {}
            if faulted.get("ok") or err.get("type") != "request_failed" \
                    or err.get("kind") != "capacity":
                problems.append(f"fault-injected conv on the card was not "
                                f"a structured capacity failure: "
                                f"{faulted}")
        elif not faulted.get("ok"):
            problems.append(f"fault-injected conv request FAILED instead "
                            f"of degrading: {faulted}")
        elif not faulted.get("degraded") or not faulted.get("degrade"):
            problems.append(
                f"fault-injected conv served UNTAGGED "
                f"(degraded={faulted.get('degraded')}, "
                f"trail={faulted.get('degrade')})")
        if not after.get("ok") or after.get("degraded") \
                or wrong(after, *inputs[1]):
            problems.append(f"the conv request after the fault was not "
                            f"served healthy: {after.get('error')} "
                            f"{after.get('degrade')}")
        if label not in d.stats.summary():
            problems.append(f"op-tagged SLO row {label!r} missing from "
                            f"{sorted(d.stats.summary())}")
        ops_served = metrics.counter_value("pifft_serve_ops_total",
                                           op="conv")
        if ops_served < k_burst:
            problems.append(f"pifft_serve_ops_total{{op=conv}} = "
                            f"{ops_served} < {k_burst}")
        bad = [p for rec in obs_events.snapshot()
               for p in obs_events.validate_event(rec)]
        if bad:
            problems.append(f"{len(bad)} schema-invalid event(s): "
                            f"{bad[:3]}")
    finally:
        if owned:
            obs.disable()
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
        problems += _served_conv_problems(device)
        checks.append("served socket conv (op-tagged, coalesced, "
                      + ("a capacity fault failed structured, the next "
                         "request served)" if device.type != "cpu" else
                         "degrade-tagged under a capacity fault)"))
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
