"""The port's copy of the native C core (``native/``), its build
(``utils.buildlib.build_native``/``load_native``) and the ``serial`` /
``pthreads`` backends (``backends.cpu``) on the CPU, held against the
reference's: the sources byte for byte, the output bit for bit, the
golden test, the capacity probes; the build's hashed name, its rebuild
after a source edit, two processes building at once, a failed build's
error; the core's own timer guarantees."""

import ctypes
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from cs87project_msolano2_tpu.backends.cpu import (
    NativeBackend as RefNativeBackend,
)
from cs87project_msolano2_tpu.backends.cpu import num_cores as ref_num_cores
from cs87project_msolano2_tpu_torch.backends.cpu import (
    NativeBackend,
    num_cores,
)
from cs87project_msolano2_tpu_torch.backends.registry import get_backend
from cs87project_msolano2_tpu_torch.cli import make_input
from cs87project_msolano2_tpu_torch.resilience import KernelBuildError
from cs87project_msolano2_tpu_torch.utils import buildlib
from cs87project_msolano2_tpu_torch.utils.verify import (
    pi_layout_to_natural,
    rel_err,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(REPO, "cs87project_msolano2_tpu", "native")
COPIED = ("pifft_core.c", "pifft_backends.c", "pifft.h",
          "pifft_internal.h", "main.c", "how_many_cores.c")


@pytest.mark.parametrize("name", COPIED)
def test_native_sources_are_the_reference_s(name):
    with open(os.path.join(buildlib.NATIVE_DIR, name), "rb") as f:
        ours = f.read()
    with open(os.path.join(REF_NATIVE, name), "rb") as f:
        assert ours == f.read()


def test_library_builds_into_the_build_dir():
    path = buildlib.build_native()
    assert os.path.dirname(path) == buildlib.BUILD_DIR
    assert os.path.basename(path).startswith("libpifft_native_")
    assert path == buildlib.native_library_path() and os.path.exists(path)
    assert buildlib.build_native() == path  # built once
    lib = buildlib.load_native()
    assert lib.pifft_golden_test(b"serial", 8) == 0


def test_library_rebuilds_after_a_source_edit(tmp_path):
    src = tmp_path / "native"
    shutil.copytree(buildlib.NATIVE_DIR, src)
    out = tmp_path / "build"
    first = buildlib.build_native(str(src), str(out))
    with open(src / "pifft_core.c", "a") as f:
        f.write("\n/* an edit */\n")
    second = buildlib.build_native(str(src), str(out))
    assert first != second and os.path.exists(first) \
        and os.path.exists(second)
    assert os.path.basename(second).startswith("libpifft_native_")
    lib = buildlib.type_native(ctypes.CDLL(second))
    assert lib.pifft_golden_test(b"pthreads", 4) == 0


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "native"
    shutil.copytree(buildlib.NATIVE_DIR, src)
    with open(src / "pifft_core.c", "a") as f:
        f.write("\nthis is not C;\n")
    with pytest.raises(KernelBuildError, match="gcc failed") as e:
        buildlib.build_native(str(src), str(tmp_path / "build"))
    assert "error" in str(e.value)
    assert not [p for p in os.listdir(tmp_path / "build")
                if p.endswith(".so") or p.endswith(".tmp")]


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two builds of the same sources into one empty directory at once
    (as two test workers may start): each renames a whole library into
    place and both load it."""
    code = (
        "import ctypes, sys\n"
        "from cs87project_msolano2_tpu_torch.utils import buildlib\n"
        "path = buildlib.build_native(buildlib.NATIVE_DIR, sys.argv[1])\n"
        "lib = buildlib.type_native(ctypes.CDLL(path))\n"
        "assert lib.pifft_golden_test(b'serial', 2) == 0\n"
        "print(path)\n")
    out = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", code, out], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], results
    paths = {stdout.strip() for stdout, _ in results}
    assert len(paths) == 1
    assert os.listdir(out) == [os.path.basename(paths.pop())]


@pytest.fixture(scope="module")
def reference_core(tmp_path_factory):
    """The reference's NativeBackend on its own library, built by its
    own Makefile from a copy of its sources in a temporary directory:
    the library in the reference's tree is neither written nor read,
    so the reference's tests in other workers never see a build of ours
    in progress."""
    from cs87project_msolano2_tpu.utils import buildlib as ref_buildlib

    src = tmp_path_factory.mktemp("ref") / "native"
    shutil.copytree(REF_NATIVE, src,
                    ignore=shutil.ignore_patterns("*.so", "pifft",
                                                  "how-many-cpu-cores"))
    saved = (ref_buildlib.NATIVE_DIR, ref_buildlib.LIB_PATH)
    ref_buildlib.NATIVE_DIR = str(src)
    ref_buildlib.LIB_PATH = str(src / "libpifft.so")
    ref_buildlib.load_native.cache_clear()
    try:
        yield RefNativeBackend
    finally:
        ref_buildlib.NATIVE_DIR, ref_buildlib.LIB_PATH = saved
        ref_buildlib.load_native.cache_clear()


@pytest.mark.parametrize("variant", ["serial", "pthreads"])
@pytest.mark.parametrize("n", [1 << 4, 1 << 10, 1 << 14])
@pytest.mark.parametrize("p", [1, 2, 8])
def test_output_is_the_reference_s_bit_for_bit(variant, n, p,
                                               reference_core):
    x = make_input(n, seed=n + p)
    got = NativeBackend(variant).run(x, p).out
    ref = reference_core(variant).run(x, p).out
    assert got.dtype == np.complex64 and np.array_equal(got, ref)
    err = rel_err(pi_layout_to_natural(got),
                  np.fft.fft(x.astype(np.complex128)))
    assert err <= 1e-5


@pytest.mark.parametrize("variant", ["serial", "pthreads"])
def test_golden_test_passes_at_every_p(variant):
    backend = NativeBackend(variant)
    assert backend.golden_atol == 0.0
    assert all(backend.golden_test(p) for p in (1, 2, 4, 8))


def test_capacity_and_num_cores_equal_the_reference_s(reference_core):
    assert num_cores() == ref_num_cores() >= 1
    for variant in ("serial", "pthreads"):
        assert NativeBackend(variant).capacity() == \
            reference_core(variant).capacity()
    assert NativeBackend("serial").capacity() is None
    assert NativeBackend("pthreads").capacity() == num_cores()


def test_registry_names_the_native_variants():
    assert get_backend("cpu").name == "pthreads"
    assert get_backend("pthreads", "cpu").name == "pthreads"
    assert get_backend("serial").name == "serial"
    with pytest.raises(ValueError, match="not in"):
        NativeBackend("phi")


@pytest.mark.parametrize("variant", ["serial", "pthreads"])
def test_timers_hold_what_the_core_guarantees(variant):
    """total_ms is the coordinator's wall clock around the region,
    funnel_ms and tube_ms processor 0's: total covers each phase, all
    three finite and non-negative (they need not add up at small n)."""
    res = NativeBackend(variant).run(make_input(1 << 12, 1), 4, reps=2)
    times = (res.total_ms, res.funnel_ms, res.tube_ms)
    assert all(math.isfinite(t) and t >= 0 for t in times)
    assert res.total_ms >= max(res.funnel_ms, res.tube_ms)
    assert res.degraded is False


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="power of two"):
        NativeBackend("serial").run(make_input(12, 0), 1)
    with pytest.raises(ValueError, match="p=16"):
        NativeBackend("serial").run(make_input(8, 0), 16)
