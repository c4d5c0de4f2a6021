"""Build (at first use) and load the port's CUDA kernels.

The counterpart of the reference's ``utils/buildlib.py``, which builds
the native C core.  Here every ``csrc/*.cu`` is compiled by ONE nvcc
call for Hopper (``sm_90a``) into a shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/libpifft_cuda_<hash>.so csrc/*.cu

The library's name carries a hash of the sources and flags, so editing a
source rebuilds it; the ``_build/`` directory is not committed.  Nothing
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libpifft_cuda_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the hashed library if it is missing;
    returns its path.  The library is written under a temporary name and
    renamed, so a concurrent loader never sees a partial file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources()],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
    lib.pifft_cuda_error_string.restype = c.c_char_p
    lib.pifft_cuda_error_string.argtypes = [c.c_int]
    return lib
