"""Build (at first use) and load the port's CUDA kernels.

The counterpart of the reference's ``utils/buildlib.py``, which builds
the native C core.  Here every ``csrc/*.cu`` is compiled for Hopper
(``sm_90a``) by its own nvcc process, all started together, and the
objects are linked into one shared library with a plain C interface,
loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -I csrc -c -o k.o csrc/k.cu  # each
    nvcc -shared -o _build/libpifft_cuda_<hash>.so *.o

The library's name carries a hash of the flags and of every source and
header (``csrc/*.cu``, ``csrc/*.cuh``), so editing either rebuilds it;
the ``_build/`` directory is not committed.  ptxas's report (registers,
shared memory, spills per kernel) is kept beside the library.  Nothing
is ever fetched.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built on a machine with the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources() + headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libpifft_cuda_{h.hexdigest()[:16]}.so")


def build_log_path() -> str:
    """Where ``build`` keeps ptxas's report for the current library."""
    return library_path()[:-len(".so")] + ".ptxas.txt"


def _run_all(cmds) -> list:
    """Start every command at once and wait for all of them; returns
    [(returncode, output)] in order, stdout and stderr merged."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    return [(p.returncode, out) for p, (out, _) in
            ((p, p.communicate()) for p in procs)]


def build() -> str:
    """Compile csrc/*.cu into the hashed library if it is missing;
    returns its path.  Objects and the library are written in a
    temporary directory and the library renamed into place, so a
    concurrent loader never sees a partial file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    srcs = sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        done = _run_all([[nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o",
                          obj, src] for obj, src in zip(objs, srcs)])
        failed = [f"nvcc failed (exit {rc}) on {os.path.basename(src)}:"
                  f"\n{out}" for src, (rc, out) in zip(srcs, done) if rc]
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        [(rc, out)] = _run_all([[nvcc, *LINK_FLAGS, "-o", lib, *objs]])
        if rc:
            raise RuntimeError(f"nvcc link failed (exit {rc}):\n{out}")
        log = os.path.join(tmp, "ptxas.txt")
        with open(log, "w") as f:
            f.writelines(f"== {os.path.basename(src)}\n{out}"
                         for src, (_, out) in zip(srcs, done))
        os.replace(log, build_log_path())
        os.replace(lib, path)
    return path


@lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Load (building if needed) and type the flat pifft_* C API.  Each
    launcher returns the cudaError_t of its launch (0 = success)."""
    lib = ctypes.CDLL(build())
    c = ctypes
    ptr = c.c_void_p
    lib.pifft_tile_fft.restype = c.c_int
    lib.pifft_tile_fft.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,   # xr, xi, yr, yi, twr, twi
        c.c_longlong, c.c_int,          # rows, log2(tile)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_long_range_sep.restype = c.c_int
    lib.pifft_long_range_sep.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr, ptr, ptr,             # ar, ai, br, bi
        c.c_longlong, c.c_int,          # batch, log2(R)
        c.c_int, c.c_int,               # C, log2(cb)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_fourstep.restype = c.c_int
    lib.pifft_fourstep.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr, ptr, ptr,             # ar, ai, br, bi
        ptr, ptr,                       # twr, twi
        c.c_int, c.c_int, c.c_int,      # log2(R), log2(tile), log2(cb)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_sixstep.restype = c.c_int
    lib.pifft_sixstep.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr, ptr, ptr,             # a1r, a1i, b1r, b1i (outer)
        ptr, ptr, ptr, ptr,             # a2r, a2i, b2r, b2i (inner)
        ptr, ptr,                       # twr, twi
        c.c_int, c.c_int, c.c_int,      # log2(R1), log2(R2), log2(tile)
        c.c_int, c.c_int,               # log2(cb1), log2(cb2)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_long_range_dense.restype = c.c_int
    lib.pifft_long_range_dense.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr,                       # wr, wi (dense tables)
        c.c_longlong, c.c_int,          # batch, log2(R)
        c.c_int, c.c_int,               # C, log2(cb)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_fourstep_dense.restype = c.c_int
    lib.pifft_fourstep_dense.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr,                       # wr, wi (dense tables)
        ptr, ptr,                       # twr, twi
        c.c_int, c.c_int, c.c_int,      # log2(R), log2(tile), log2(cb)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_sixstep_dense.restype = c.c_int
    lib.pifft_sixstep_dense.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr, ptr, ptr,             # w1r, w1i (outer), w2r, w2i (inner)
        ptr, ptr,                       # twr, twi
        c.c_int, c.c_int, c.c_int,      # log2(R1), log2(R2), log2(tile)
        c.c_int, c.c_int,               # log2(cb1), log2(cb2)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_fused.restype = c.c_int
    lib.pifft_fused.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi (y may be x)
        ptr,                            # carry (2 n floats)
        ptr, ptr, ptr, ptr,             # ar, ai, br, bi
        ptr, ptr,                       # twr, twi
        c.c_int, c.c_int, c.c_int,      # log2(R), log2(tile), log2(cb)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_matmul_funnel.restype = c.c_int
    lib.pifft_matmul_funnel.argtypes = [
        ptr, ptr, ptr, ptr,             # xr, xi, yr, yi
        ptr, ptr,                       # br, bi (the DFT matrix)
        ptr, ptr, ptr, ptr,             # ar, ai, b2r, b2i (factors)
        c.c_int, c.c_int, c.c_int,      # log2(R), C, log2(cb)
        c.c_int,                        # bf16 planes per operand
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_gpu_rows.restype = c.c_int
    lib.pifft_gpu_rows.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,   # xr, xi, yr, yi, twr, twi (stack)
        c.c_longlong, c.c_int,          # rows, log2(n)
        c.c_int,                        # log2(block_rows)
        c.c_int, ptr,                   # device, stream
    ]
    lib.pifft_fused_carry_limit.restype = c.c_longlong
    lib.pifft_fused_carry_limit.argtypes = [c.c_int]
    lib.pifft_persisting_l2_set_aside.restype = c.c_longlong
    lib.pifft_persisting_l2_set_aside.argtypes = [c.c_int]
    lib.pifft_set_persisting_l2_set_aside.restype = c.c_int
    lib.pifft_set_persisting_l2_set_aside.argtypes = [c.c_int, c.c_longlong]
    lib.pifft_cuda_error_string.restype = c.c_char_p
    lib.pifft_cuda_error_string.argtypes = [c.c_int]
    lib.pifft_cuda_error_name.restype = c.c_char_p
    lib.pifft_cuda_error_name.argtypes = [c.c_int]
    return lib
