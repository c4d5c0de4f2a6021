"""A cell as ``BENCHMARK.json`` names it, resolved to its files by name.

The benchmark's folder is the first of the spec's ``paths``.  Inside it,
a workload pairs a configuration (``configs/<config>.json``, which names
its plain reference ``reference/<reference>.py``) with a traffic mix
(``traffic/<traffic>.json``, which names its entry
``entries/<entry>.py``); its limits are ``limits/<workload>.json`` and
every metric has its reader in ``metrics/<metric>.py``, or, for a metric
``<name>.<qualifier>``, in ``metrics/<name>.py``.  A later cell,
configuration, traffic mix, entry, reference or metric is added as files
and entries, never by editing a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")

_modules = {}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The Python file at `path` as a module, loaded once a process."""
    path = os.path.abspath(path)
    if path not in _modules:
        name = "benchmark_" + re.sub(r"\W", "_", os.path.relpath(path, ROOT))
        mod_spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        _modules[path] = module
    return _modules[path]


@dataclasses.dataclass
class Cell:
    """One workload with everything its run needs."""

    name: str
    chips: int
    bench_dir: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def shape(self) -> tuple:
        return tuple(self.config["shape"])

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` of this cell's benchmark folder."""
        return load_module(os.path.join(self.bench_dir, kind, name + ".py"))

    @property
    def entry(self):
        """The traffic's entry: ``make_inputs``, ``bind``, ``flops`` and
        optionally ``plan`` (see ``benchlib``)."""
        return self.module("entries", self.traffic["entry"])

    def reference(self):
        """The configuration's ``expected(inputs, **reference_args)``."""
        return self.module("reference", self.config["reference"]).expected

    def reader(self, metric: str):
        """The ``read(run)`` of `metric`: ``metrics/<metric>.py``, else
        the reader of the name before its first dot."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        if not os.path.exists(path):
            path = os.path.join(self.bench_dir, "metrics",
                                metric.split(".", 1)[0] + ".py")
        return load_module(path).read

    def port_kernels(self) -> list:
        """The ``__global__`` names of the port's own kernels."""
        return load_json(os.path.join(self.bench_dir,
                                      "kernels.json"))["kernels"]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, spec_path: str = SPEC_PATH) -> Cell:
    """The cell named `workload`; KeyError names the known cells."""
    spec = load_json(spec_path)
    root = os.path.dirname(os.path.abspath(spec_path))
    bench_dir = os.path.join(root, spec["paths"][0])
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {spec_path}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        bench_dir=bench_dir,
        config=load_json(os.path.join(root, config["file"])),
        traffic=load_json(os.path.join(bench_dir, "traffic",
                                       w["traffic"] + ".json")),
        limits=load_json(os.path.join(bench_dir, "limits",
                                      workload + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
    )
