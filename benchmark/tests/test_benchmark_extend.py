"""A later cell comes as new files and entries: a toy entry, its traffic,
configuration, reference and limits, added beside a copy of the
benchmark, run without a change to any file that was there."""

import filecmp
import json
import os
import shutil

from benchlib import cell, spec

TOY_ENTRY = '''"""models.fft.ifft(x) on complex tensors: a toy entry."""

import torch

from benchlib import counts, inputs


def make_inputs(shape, count, seed, device, config):
    block = inputs.normal_block(shape, count, seed, device,
                                getattr(torch, config["dtype"]))
    return [(block[i],) for i in range(count)]


def bind(precision, scale=1.0):
    ifft = inputs.port("models.fft").ifft

    def call(ins):
        return (ifft(ins[0], precision=precision) * scale,)
    return call


def flops(shape, scale=1.0):
    return counts.transform_flops(shape, "c2c")
'''

TOY_REFERENCE = '''"""numpy's inverse DFT, scaled."""

import numpy as np


def expected(inputs, scale):
    return np.fft.ifft(inputs[0].astype(np.complex128), axis=-1) * scale
'''


def _add(root, rel, text):
    path = os.path.join(root, rel)
    assert not os.path.exists(path), f"{rel} is there already"
    with open(path, "w") as f:
        f.write(text if isinstance(text, str) else json.dumps(text))


def test_a_toy_cell_runs_from_added_files_only(tmp_path):
    root = str(tmp_path)
    shutil.copy(spec.SPEC_PATH, os.path.join(root, "BENCHMARK.json"))
    shutil.copytree(spec.BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    _add(root, "benchmark/entries/toy_ifft.py", TOY_ENTRY)
    _add(root, "benchmark/reference/toy_ifft.py", TOY_REFERENCE)
    _add(root, "benchmark/configs/toy-ifft.json",
         {"shape": [8, 64], "dtype": "complex64", "precision": "split3",
          "reference": "toy_ifft", "check_samples": 3, "reduced": []})
    _add(root, "benchmark/traffic/toy_ifft.json",
         {"entry": "toy_ifft", "kwargs": {"scale": 2.0},
          "reference_args": {"scale": 2.0}, "in_flight": 2, "ring": 3,
          "env": {"PIFFT_PLAN_CACHE": "$FRESH_DIR"}})
    _add(root, "benchmark/limits/toy-ifft.rows.json",
         {"rel_l2": 1e-5, "max_err": 3e-4})
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-ifft", "source": "a test",
                             "file": "benchmark/configs/toy-ifft.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy-ifft.rows", "config": "toy-ifft",
                               "traffic": "toy_ifft", "chips": 1,
                               "why": "a toy"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    # every file that was there is as it was
    cmp = filecmp.dircmp(spec.BENCH_DIR, os.path.join(root, "benchmark"),
                         ignore=["__pycache__"])

    def changed(d):
        return d.diff_files + d.left_only + [
            x for sub in d.subdirs.values() for x in changed(sub)]
    assert changed(cmp) == []

    c = spec.load_cell("toy-ifft.rows",
                       os.path.join(root, "BENCHMARK.json"))
    result, notes = cell.run_cell(c, 2**31 + 41, 0.2, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in c.end_to_end}
    assert "# plan not stated by the entry" in notes
    assert "samples compared 6 of 6 planned, ring slots [0, 1, 2]" in \
        "\n".join(notes)
