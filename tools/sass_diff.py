#!/usr/bin/env python3
"""Do two checkouts of the PyTorch/CUDA port compile a kernel to the same
machine code?  Compares the SASS of every kernel the two builds of each
named source share.

    python3 tools/sass_diff.py OLD_ROOT NEW_ROOT [SOURCE ...]

Each root holds ``cs87project_msolano2_tpu_torch/csrc``.  Every source
(default: sixstep.cu, fused.cu, tile_fft.cu, gpu_rows.cu, fourstep.cu
and long_range.cu) is compiled in both roots with the package's nvcc
flags to a cubin (the nvcc processes started together), disassembled
with cuobjdump -sass, and cut into one instruction list per kernel.
Kernel names are compared with the anonymous namespace's per-file tag
taken out, and instructions with their addresses and comments taken
out.  One JSON line a kernel the two builds share ("identical" true or
false, its instruction count), then one a kernel found in only one
build; each line also counts the kernel's tensor-core instructions
(``HGMMA``, Hopper's wgmma, and ``HMMA``, mma.sync) in each build that
has it.  Exit status 1 if a shared kernel differs.  Runs where nvcc and
cuobjdump are (the machine with the card); needs no card.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROLS = ("sixstep.cu", "fused.cu", "tile_fft.cu", "gpu_rows.cu",
            "fourstep.cu", "long_range.cu")
#: the anonymous namespace's per-file tag in a mangled name
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
#: "/*0040*/   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;   /* 0x... */"
_INSTRUCTION = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def kernels(sass: str) -> dict:
    """{kernel name without the file tag: [instruction, ...]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = _ANON.sub("ANON", m.group(1))
            out[name] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and name is not None:
            out[name].append(m.group(1))
    return out


def tensor_ops(instructions: list) -> dict:
    """{"HGMMA": n, "HMMA": n}: the kernel's tensor-core instructions."""
    return {op: sum(1 for ins in instructions
                    if re.match(rf"(@\S+\s+)?{op}\.", ins))
            for op in ("HGMMA", "HMMA")}


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (os.path.abspath(r) for r in sys.argv[1:3])
    names = sys.argv[3:] or CONTROLS
    sys.path.insert(0, ROOT)
    from cs87project_msolano2_tpu_torch.utils import buildlib

    cuobjdump = os.path.join(os.path.dirname(buildlib.nvcc_path()),
                             "cuobjdump")
    flags = [f for f in buildlib.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    differ = False
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for i, root in enumerate((old, new)):
            csrc = os.path.join(root, "cs87project_msolano2_tpu_torch",
                                "csrc")
            for name in names:
                cubin = os.path.join(tmp, f"{i}_{name}.cubin")
                procs[i, name] = (cubin, subprocess.Popen(
                    [buildlib.nvcc_path(), *flags, "-I", csrc, "-cubin",
                     "-o", cubin, os.path.join(csrc, name)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
        sass = {}
        for key, (cubin, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc {key} failed:\n{err}")
            sass[key] = kernels(subprocess.run(
                [cuobjdump, "-sass", cubin], capture_output=True, text=True,
                check=True).stdout)
        for name in names:
            a, b = sass[0, name], sass[1, name]
            for kernel in sorted(set(a) | set(b)):
                if kernel in a and kernel in b:
                    same = a[kernel] == b[kernel]
                    differ |= not same
                    print(json.dumps({"source": name, "kernel": kernel,
                                      "identical": same,
                                      "instructions": [len(a[kernel]),
                                                       len(b[kernel])],
                                      "tensor_ops": [tensor_ops(a[kernel]),
                                                     tensor_ops(b[kernel])]}))
                else:
                    ins = a[kernel] if kernel in a else b[kernel]
                    print(json.dumps({"source": name, "kernel": kernel,
                                      "only_in": old if kernel in a
                                      else new,
                                      "instructions": len(ins),
                                      "tensor_ops": tensor_ops(ins)}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
