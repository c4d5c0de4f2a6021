"""``fleet`` — the closed-loop fleet controls (the reference's
``fleet/cli.py``).

``fleet smoke [--device cpu]`` runs the end-to-end acceptance drive
(:mod:`.smoke`): shifted synthetic traffic → live drift detection →
canary shadow race → Mann-Whitney promotion → p99 recovery →
injected-fault rollback (byte-identical store) → drain-persisted
arrival model → restart prewarm.

``fleet model [--json]`` prints the persisted arrival model's hot set —
what the NEXT mesh start would prewarm, heaviest first.
"""

from __future__ import annotations

import argparse
import json
import sys

from .prewarm import ArrivalModel, model_path


def fleet_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="cs87project_msolano2_tpu_torch fleet",
        description="closed-loop fleet control: drift detection, "
                    "canary promotion, rollback, predictive prewarm")
    sub = ap.add_subparsers(dest="cmd")
    smoke_p = sub.add_parser("smoke", help="the end-to-end fleet-loop "
                                           "gate")
    smoke_p.add_argument("--device", default="cuda",
                         help="cuda (default: the card) or cpu (the "
                              "plain versions)")
    model_p = sub.add_parser("model", help="show the persisted "
                                           "arrival model's hot set")
    model_p.add_argument("--json", action="store_true",
                         help="machine-readable output")
    args = ap.parse_args(argv)

    if args.cmd == "smoke":
        from .smoke import main as smoke_main

        return smoke_main(["--device", args.device])
    if args.cmd == "model":
        path = model_path()
        model = ArrivalModel.load(path)
        hot = model.hot()
        if args.json:
            print(json.dumps({
                "path": path,
                "hot": [{"weight": round(w, 4), "n": k[0],
                         "layout": k[1], "precision": k[2],
                         "domain": k[3], "op": k[4]}
                        for w, k in hot]}, indent=1))
        elif not hot:
            print(f"# arrival model at {path or '<disabled>'}: "
                  f"no hot shapes")
        else:
            print(f"# arrival model at {path}")
            for w, (n, layout, precision, domain, op) in hot:
                print(f"{w:10.3f}  n={n} {layout}/{precision}"
                      f"/{domain}/{op}")
        return 0
    ap.print_help(sys.stderr)
    return 2
