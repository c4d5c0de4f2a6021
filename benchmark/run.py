"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with a trace ``breakdown``, and last the
``checks``: each number compared with its limit); the last lines of
standard error repeat the checks.  Before the cell starts, the port's
settings are unset and those of the traffic mix's ``env`` set.
``--precision bf16`` runs the program's own bf16 storage mode in the
configuration's place: the lower-precision control, which has to come
out not correct.

The run exits non-zero without a result where no CUDA card is present
or fewer than the cell asks for, and where ``jax``, ``jaxlib``, ``flax``
or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

#: top-level module names the run may not hold, compared whole (the
#: port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cs87project_msolano2_tpu")

#: settings of the port that change what a run measures: unset, unless
#: the traffic mix states them
PORT_SETTINGS = ("PIFFT_PLAN_CACHE", "PIFFT_PLAN_AUTOTUNE", "PIFFT_FAULT",
                 "PIFFT_OBS", "PIFFT_OBS_EVENTS", "PIFFT_PRECISION_BUDGET")

#: a traffic mix's ``env`` value that stands for a fresh directory under
#: the run's temporary directory, removed when the run ends
FRESH_DIR = "$FRESH_DIR"


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among `modules` (sys.modules)."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def isolate(env: dict, tmp_root: str) -> list:
    """Unset the port's settings, then set those of the traffic's `env`
    (a null value unsets, ``$FRESH_DIR`` is a new directory under
    `tmp_root`); every kernel cache goes to a fixed directory inside the
    checkout.  Returns the fresh directories."""
    for name in PORT_SETTINGS:
        os.environ.pop(name, None)
    fresh = []
    for name, value in env.items():
        if value is None:
            os.environ.pop(name, None)
            continue
        if value == FRESH_DIR:
            value = tempfile.mkdtemp(prefix="bench-", dir=tmp_root)
            fresh.append(value)
        os.environ[name] = value
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, ".cache", "torch_extensions")
    return fresh


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", default=None,
                    help="run the program in this precision mode instead "
                         "of the configuration's (the control: bf16)")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchlib import spec

    cell = spec.load_cell(args.workload)
    fresh = isolate(cell.traffic.get("env") or {}, tempfile.gettempdir())
    try:
        import torch

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from benchlib import cell as cell_run

        result, notes = cell_run.run_cell(
            cell, args.seed, args.seconds, bool(args.trace),
            precision=args.precision, t_start=T_START)
        notes.insert(0, f"# device {power_limit()} (data-sheet peaks at "
                        f"the full power limit)")
    finally:
        for path in fresh:
            shutil.rmtree(path, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in notes:
        print(line)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
