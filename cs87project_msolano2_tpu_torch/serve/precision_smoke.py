"""The precision degrade-up smoke (the reference's
``serve/precision_smoke.py``): prove on this machine that an error-budget
violation walks a served plan UP the precision chain to fp32, tagged
everywhere the contract demands.

Run under ``PIFFT_PRECISION_BUDGET=0`` (the injection knob: every
sampled batch then violates its budget):

    PIFFT_PRECISION_BUDGET=0 python -m \\
        cs87project_msolano2_tpu_torch.serve.precision_smoke [--device cpu]

One bf16-storage request is served through the real dispatcher on
``--device`` (the card by default); the batcher's per-batch sample sees
the injected violation and must promote bf16 -> default -> split3 ->
fp32, with

* ``degraded: true`` and the ``precision:*`` trail on the RESPONSE,
* ``degraded: true``, ``direction: "up"`` demotion records and the
  promoted effective precision on the PLAN,
* the ``pifft_precision_rel_err`` gauge published per sampled mode.

Exit 0 only when every assertion holds.
"""

from __future__ import annotations

import argparse
import asyncio
import sys

import numpy as np


def main(argv=None) -> int:
    from .. import obs, plans
    from ..obs import metrics
    from ..utils.device import resolve_device
    from . import Dispatcher, ServeConfig, ShapeSpec

    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch.serve."
             "precision_smoke",
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
    spec = ShapeSpec(n=1024, precision="bf16")
    rng = np.random.default_rng(0)
    xr = rng.standard_normal(spec.n).astype(np.float32)
    xi = rng.standard_normal(spec.n).astype(np.float32)

    async def serve_one():
        cfg = ServeConfig(max_batch=4, max_wait_ms=1.0)
        async with Dispatcher(cfg, [spec], device=device) as d:
            return await d.submit(xr, xi, precision="bf16")

    resp = asyncio.run(serve_one())

    problems = []
    if not resp.degraded:
        problems.append("response not tagged degraded")
    if "precision:fp32" not in (resp.degrade or []):
        problems.append(f"response trail lacks precision:fp32 "
                        f"({resp.degrade})")
    plan = plans.plan_for((1, spec.n), precision="bf16", device=device)
    if not plan.degraded:
        problems.append("plan not tagged degraded")
    if plan.effective_precision() != "fp32":
        problems.append(f"plan did not walk to fp32 "
                        f"(effective {plan.effective_precision()!r})")
    ups = [rec for rec in plan.demotions if rec.get("direction") == "up"]
    if not ups or ups[-1]["to"] != "precision:fp32":
        problems.append(f"demotion trail wrong: {plan.demotions}")
    gauges = [k for k in metrics.snapshot()["gauges"]
              if k.startswith("pifft_precision_rel_err")]
    if not gauges:
        problems.append("pifft_precision_rel_err gauge never published")
    if owned:
        obs.disable()
    for p in problems:
        print(f"# FAIL: {p}", file=sys.stderr)
    if problems:
        return 1
    trail = " -> ".join([ups[0]["from"]]
                        + [rec["to"].split(":", 1)[1] for rec in ups])
    print(f"# precision degrade-up ok on {device}: injected violation "
          f"walked {trail}, degraded tagged on plan AND response, "
          f"{len(gauges)} rel-err gauge series published")
    return 0


if __name__ == "__main__":
    sys.exit(main())
