"""The port's two kernels through their wrappers: each plain version
against the JAX package's Pallas kernel (interpret mode on the CPU) and
numpy float64, the wrappers' operand checks and budget errors, the
launch counters, and the kernels' nvcc build.  The kernels themselves
run in ``test_torch_cuda.py``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import twiddle
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.utils import buildlib
from cs87project_msolano2_tpu_torch.utils.verify import pi_layout_to_natural

CPU = torch.device("cpu")
# the reference's split3 MXU tail is ~4e-6 from exact; the port runs
# fp32 butterflies: both sides sit inside the split3 budget
SPLIT3_TOL = 1e-5
# both long-range sides are pure fp32 butterflies on the same factors
FP32_TOL = 1e-6


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _numpy_pi(xr, xi):
    y = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64))
    return pi_layout_to_natural(y)  # bit reversal is an involution


@pytest.mark.parametrize("rows,tile", [(8, 1024), (4, 4096)])
@pytest.mark.parametrize("entry", ["tile_fft_grid", "fft_rows_pallas"])
def test_tile_fft_plain_vs_reference(rows, tile, entry):
    xr, xi = _planes(rows + tile, (rows, tile))
    twr, twi = twiddle.flat_tables(tile, CPU)
    yr, yi = cf.tile_fft(*_t(xr, xi), twr, twi)
    if entry == "tile_fft_grid":
        rr, ri = ref_pf.tile_fft_grid(
            jnp.asarray(xr.reshape(-1, 128)), jnp.asarray(xi.reshape(-1, 128)),
            tile)
        rr, ri = np.asarray(rr).reshape(rows, tile), \
            np.asarray(ri).reshape(rows, tile)
    else:
        rr, ri = ref_pf.fft_rows_pallas(jnp.asarray(xr), jnp.asarray(xi),
                                        natural=False)
    assert rel_err(yr, yi, rr, ri) <= SPLIT3_TOL
    exact = _numpy_pi(xr, xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL
    assert rel_err(rr, ri, exact.real, exact.imag) <= SPLIT3_TOL


def test_long_range_plain_vs_reference():
    n, tile = 1 << 12, 1 << 9
    R = n // tile
    xr, xi = _planes(21, (R, tile))
    fac = twiddle.factors_from_reference(*ref_pf._long_range_factors(R, tile),
                                         "cpu")
    yr, yi = cf.long_range_sep(*_t(xr[None], xi[None]), *fac, cb=128)
    rr, ri = ref_pf.long_range_grid(jnp.asarray(xr), jnp.asarray(xi),
                                    separable=True)
    assert yr.shape == (1, R, tile)
    assert rel_err(yr[0], yi[0], rr, ri) <= FP32_TOL


def test_long_range_then_tile_is_the_transform():
    # the two kernels' plain versions compose to the n-point pi layout
    n, tile = 1 << 12, 1 << 9
    xr, xi = _planes(22, (n,))
    yr, yi = cf.fft_pi_layout_cuda_rql(*_t(xr, xi), tile=tile, cb=64)
    exact = _numpy_pi(xr, xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


@pytest.mark.parametrize("batch", [1, 3])
def test_long_range_batched_matches_unbatched(batch):
    R, C = 4, 256
    xr, xi = _planes(23, (batch, R, C))
    fac = twiddle.device_factors(R, C, CPU)
    yr, yi = cf.long_range_sep(*_t(xr, xi), *fac, cb=32)
    for b in range(batch):
        br_, bi_ = cf.long_range_sep(*_t(xr[b:b + 1], xi[b:b + 1]), *fac,
                                     cb=32)
        assert torch.equal(yr[b], br_[0]) and torch.equal(yi[b], bi_[0])


def test_plain_paths_do_not_count_launches():
    cf.reset_launch_counts()
    xr, xi = _t(*_planes(24, (2, 256)))
    cf.tile_fft(xr, xi, *twiddle.flat_tables(256, CPU))
    cf.fft_pi_layout_cuda_rql(*_t(*_planes(25, (1024,))), tile=256)
    assert cf.tile_fft.launches == 0
    assert cf.long_range_sep.launches == 0


@pytest.mark.parametrize("tile", [1 << 15, 1 << 16])
def test_over_budget_tile_raises_before_launch(tile):
    xr, xi = torch.zeros(2, tile), torch.zeros(2, tile)
    twr, twi = torch.zeros(tile - 1), torch.zeros(tile - 1)
    with pytest.raises(ValueError, match=f"tile={tile}.*limit 232448"):
        cf.tile_fft(xr, xi, twr, twi)


def test_over_budget_cb_raises_before_launch():
    with pytest.raises(ValueError, match="R=64 x cb=1024"):
        cf.rql_blocking(1 << 20, 1 << 14, 1024)
    R, C = 64, 1 << 11
    fac = twiddle.device_factors(R, C, CPU)
    with pytest.raises(ValueError, match="R=64 x cb=1024"):
        cf.long_range_sep(torch.zeros(1, R, C), torch.zeros(1, R, C), *fac,
                          cb=1024)


def test_rql_blocking_defaults():
    assert cf.rql_blocking(1 << 20) == (1 << 14, 64, 32)
    assert cf.rql_blocking(1 << 12) == (1 << 12, 1, 32)
    # cb halves until the R x cb block fits shared memory
    tile, R, cb = cf.rql_blocking(1 << 24)
    assert (tile, R) == (1 << 14, 1024)
    assert cf.long_range_smem_bytes(R, cb) <= cf.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="must divide"):
        cf.rql_blocking(1 << 12, tile=1 << 13)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "table", "ndim"])
def test_tile_fft_rejects_bad_operands(bad):
    xr, xi = torch.zeros(2, 256), torch.zeros(2, 256)
    twr, twi = twiddle.flat_tables(256, CPU)
    if bad == "dtype":
        xr = xr.double()
    elif bad == "contiguous":
        xr = torch.zeros(256, 2).t()
    elif bad == "table":
        twr = twr[:100].contiguous()
    else:
        xr, xi = xr.reshape(-1), xi.reshape(-1)
    with pytest.raises((TypeError, ValueError)):
        cf.tile_fft(xr, xi, twr, twi)


@pytest.mark.parametrize("bad", ["R", "factors", "cb"])
def test_long_range_rejects_bad_operands(bad):
    R, C = 8, 256
    fac = list(twiddle.device_factors(R, C, CPU))
    shape, cb = (1, R, C), 32
    if bad == "R":
        shape = (1, 6, C)
    elif bad == "factors":
        fac[2] = fac[2][:2].contiguous()
    else:
        cb = 512
    with pytest.raises(ValueError):
        cf.long_range_sep(torch.zeros(shape), torch.zeros(shape), *fac,
                          cb=cb)


def test_non_cpu_non_cuda_tensor_raises():
    # the wrapper launches its kernel or raises; only CPU tensors take
    # the plain version
    m = torch.device("meta")
    xr, xi = torch.zeros(2, 256, device=m), torch.zeros(2, 256, device=m)
    twr, twi = torch.zeros(255, device=m), torch.zeros(255, device=m)
    with pytest.raises(RuntimeError, match="kernel runs on CUDA tensors"):
        cf.tile_fft(xr, xi, twr, twi)


def test_library_path_tracks_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(buildlib, "CSRC_DIR", str(src))
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "_build"))
    first = buildlib.library_path()
    assert first == buildlib.library_path()
    (src / "k.cu").write_text("// v2\n")
    assert buildlib.library_path() != first
    assert os.path.dirname(first) == str(tmp_path / "_build")


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(buildlib, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(buildlib, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        buildlib.build()
    assert os.listdir(tmp_path / "_build") == []  # no partial library
