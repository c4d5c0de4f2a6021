#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` (the fleet loop, the two-backend smoke
and the five-config record) alone.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 tools/fleet_phase.py

Phase 22 runs as in the whole script, on a plan store that is a fresh
temporary directory.  The rows the whole script takes from earlier
phases are made here by the same functions: config 1 as phase 15 makes
it, configs 3-5 on a world-1 NCCL job (``bench_configs.world1_configs``
in place of phase 16's job), config 2 from the store (empty here, so
``plans.measured_ms`` races the 2^20 key first, as phase 8 does).
"""

import importlib.util
import os
import sys
import tempfile
import time


def main() -> int:
    os.environ["PIFFT_PLAN_CACHE"] = tempfile.mkdtemp()
    sys.path.insert(0, os.getcwd())
    import torch

    from cs87project_msolano2_tpu_torch import bench_configs
    from cs87project_msolano2_tpu_torch.parallel.multihost import spawn_local
    from cs87project_msolano2_tpu_torch.utils import buildlib

    t0 = time.perf_counter()
    buildlib.build()
    buildlib.load_kernels()
    print(f"# build {time.perf_counter() - t0:.1f} s", flush=True)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    t0 = time.perf_counter()
    config1 = bench_configs.config1_direct_dft_f64()
    (world,) = spawn_local(bench_configs.world1_configs, 1, "nccl", "cuda",
                           bench_configs.FULL_SIZES)
    parallel = {f"config {k}": {"bench_config": row}
                for k, row in zip((3, 4, 5), world)}
    print(f"# configs 1, 3-5 in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    try:
        _, fleet_launches, hw_launches = smoke.phase_fleet(
            torch.device("cuda"), config1, parallel)
    except AssertionError as e:
        print(f"# phase 22 FAILED ({e})", flush=True)
        return 1
    print(f"# phase 22 ok in {time.perf_counter() - t0:.1f} s: fleet "
          f"launches {fleet_launches}, hw smoke launches {hw_launches}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
