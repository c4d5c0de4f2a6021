"""Puts ``benchmark/`` and the checkout's root on the path, and keeps the
port's plan store off disk for the CPU runs of the harness."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for path in (ROOT, BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)

os.environ["PIFFT_PLAN_CACHE"] = "off"
os.environ.pop("PIFFT_PLAN_AUTOTUNE", None)
