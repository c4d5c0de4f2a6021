"""The matmul funnel (``mf``) on the CPU (plain versions): the funnel
tables bit-identical to the JAX package's, the precision modes' bf16
split planes and dot against the reference's ``make_dot``, the funnel
composition against ``fft_pi_layout_pallas_mf`` (interpret mode) and
numpy float64 in every fp32-storage mode, the Hopper blocking rules and
the ladder's ``mf`` variant.  The kernel itself runs in
``test_torch_cuda.py``."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu.ops import precision as ref_prec
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import precision, twiddle
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans.core import Plan
from cs87project_msolano2_tpu_torch.utils.verify import pi_layout_to_natural

CPU = torch.device("cpu")
FP32_MODES = ("split3", "default", "highest", "fp32")
# each mode's error budget (ops/precision.py).  The reference's dot on
# the CPU runs DEFAULT and HIGHEST as full float32 products, where the
# port's default is one bf16 pass, as on the TPU's MXU and the card's
# tensor cores: so the port and the reference may each sit anywhere
# inside the mode's budget, and are held to it against each other too.
BUDGET = precision.ERROR_BUDGETS
# the same bf16 planes and products, summed in another order
DOT_TOL = 1e-6
# the reference test's cases (tests/test_pallas.py:91-95): n, R, cb, tail
REF_CASES = [(1 << 14, 128, 1 << 7, 128), (1 << 15, 128, 1 << 8, 256),
             (1 << 14, 16, 1 << 10, 128)]


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _ref_rel(yr, yi, ref):
    return rel_err(yr, yi, ref.real, ref.imag)


# ------------------------------------------------------------ tables


@pytest.mark.parametrize("R", [16, 128])
def test_funnel_b_bit_identical(R):
    for mine, theirs in zip(twiddle.dft_funnel_b(R), ref_pf.dft_funnel_b(R)):
        assert mine.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("R", [16, 128])
@pytest.mark.parametrize("n", [1 << 14, 1 << 15])
def test_funnel_factors_bit_identical(R, n):
    mine = twiddle.dft_funnel_factors(R, n)
    theirs = ref_pf.dft_funnel_factors(R, n)
    assert mine[0].shape == (R, n // R // 128) and mine[2].shape == (R, 128)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_funnel_tables_from_reference():
    R, n = 16, 1 << 14
    b = twiddle.funnel_b_from_reference(*ref_pf.dft_funnel_b(R), CPU)
    f = twiddle.funnel_factors_from_reference(
        *ref_pf.dft_funnel_factors(R, n), CPU)
    for mine, theirs in zip(b + f, twiddle.device_funnel_b(R, CPU)
                            + twiddle.device_funnel_factors(R, n, CPU)):
        assert mine.dtype == torch.float32 and mine.is_contiguous()
        assert torch.equal(mine, theirs)


def test_funnel_grid_is_the_dense_twiddle():
    # T[r, c] = A[r, c // 128] * B2[r, c % 128] = W_n^{bitrev(r) c}
    R, n = 16, 1 << 13
    ar, ai, br, bi = (a.astype(np.float64)
                      for a in twiddle.dft_funnel_factors(R, n))
    a = (ar + 1j * ai)[:, :, None] * (br + 1j * bi)[:, None, :]
    rev = np.array([int(f"{r:04b}"[::-1], 2) for r in range(R)])
    t = np.exp(-2j * np.pi * np.outer(rev, np.arange(n // R)) / n)
    assert np.abs(a.reshape(R, -1) - t).max() < 1e-6


# --------------------------------------------------- precision modes


def test_mode_tables_match_reference():
    assert precision.SPLIT3 == ref_prec.SPLIT3
    assert precision.RACE_ALTERNATES == ref_prec.RACE_ALTERNATES
    for mode in precision.PRECISIONS:
        assert precision.race_modes(mode) == ref_prec.race_modes(mode)
        assert precision.promote(mode) == ref_prec.promote(mode)
    assert {m: precision.dot_passes(m) for m in precision.PRECISIONS} == \
        {"bf16": 1, "default": 1, "split3": 3, "highest": 6, "fp32": 6}
    assert {m: precision.split_levels(m) for m in precision.PRECISIONS} == \
        {"bf16": 1, "default": 1, "split3": 2, "highest": 3, "fp32": 3}
    with pytest.raises(ValueError, match="unknown precision"):
        precision.dot_passes("tf32")


def _bits(t):
    return t.view(torch.int16).numpy()


def test_split_planes_bit_identical_to_reference():
    # the reference's split3 casts (precision.py:225-229): round to
    # nearest even in both packages
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    x[:4] = [1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -(1.0 + 2 ** -8), 0.0]
    hi, lo = precision.bf16_split(torch.from_numpy(x), 2)
    xh = jnp.asarray(x).astype(jnp.bfloat16)
    xl = (jnp.asarray(x) - xh.astype(jnp.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(hi),
                                  np.asarray(xh).view(np.int16))
    np.testing.assert_array_equal(_bits(lo),
                                  np.asarray(xl).view(np.int16))


def test_split_planes_sum_back():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        1000).astype(np.float32))
    for levels, tol in ((1, 2 ** -8), (2, 2 ** -16), (3, 2 ** -24)):
        planes = precision.bf16_split(x, levels)
        back = sum(p.to(torch.float64) for p in planes)
        assert float(((back - x.double()).abs() / x.double().abs()).max()) \
            <= tol


@pytest.mark.parametrize("mode", FP32_MODES)
def test_make_dot_vs_reference(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    mine = precision.make_dot(mode)(torch.from_numpy(x), torch.from_numpy(b))
    theirs = np.asarray(ref_prec.make_dot(ref_prec.dot_precision(mode))(
        jnp.asarray(x), jnp.asarray(b)))
    exact = x.astype(np.float64) @ b.astype(np.float64)
    err = np.linalg.norm(mine.double().numpy() - exact) / np.linalg.norm(
        exact)
    diff = np.linalg.norm(mine.numpy() - theirs) / np.linalg.norm(theirs)
    if mode == "split3":
        # the same three products of the same planes
        assert diff <= DOT_TOL
    else:
        # the reference's DEFAULT/HIGHEST on the CPU are float32 dots
        assert diff <= BUDGET[mode]
    assert err <= BUDGET[mode]


# ------------------------------------------------ the funnel composition


@lru_cache(maxsize=None)
def _reference_mf(n, R, cb, tail, mode):
    xr, xi = _planes(13, n)
    yr, yi = ref_pf.fft_pi_layout_pallas_mf(
        xr, xi, R=R, cb=cb, tail=tail,
        precision=ref_prec.dot_precision(mode))
    return np.asarray(yr), np.asarray(yi)


def _port_cb(R, cb):
    # the reference's (R=128, cb=256) block needs 270,336 bytes of
    # shared memory, past a block's 232,448: the port takes its own
    return cb if cf.mf_smem_bytes(R, cb) <= cf.SMEM_LIMIT_BYTES else None


@pytest.mark.parametrize("mode", FP32_MODES)
@pytest.mark.parametrize("n,R,cb,tail", REF_CASES)
def test_mf_vs_reference_and_numpy(n, R, cb, tail, mode):
    xr, xi = _planes(13, n)
    yr, yi = cf.fft_pi_layout_cuda_mf(*_t(xr, xi), R=R,
                                      cb=_port_cb(R, cb), precision=mode)
    ref_r, ref_i = _reference_mf(n, R, cb, tail, mode)
    assert rel_err(yr, yi, ref_r, ref_i) <= BUDGET[mode]
    nat = pi_layout_to_natural(yr.numpy() + 1j * yi.numpy())
    exact = np.fft.fft(xr.astype(np.complex128) + 1j * xi)
    assert _ref_rel(nat.real, nat.imag, exact) <= BUDGET[mode]


@pytest.mark.parametrize("mode", FP32_MODES)
def test_matmul_funnel_plain_is_the_first_levels(mode):
    # Y = (B @ X) * T leaves the first log2(R) DIF levels: finishing
    # each row with the float64 FFT of its C points gives the transform
    n, R = 1 << 13, 16
    C = n // R
    xr, xi = _planes(14, (R, C))
    args = _t(xr, xi) + twiddle.device_funnel_b(R, CPU) + \
        twiddle.device_funnel_factors(R, n, CPU)
    yr, yi = cf.matmul_funnel(*args, precision=mode)
    assert yr.shape == (R, C) and cf.matmul_funnel.launches == 0
    y = np.fft.fft(yr.double().numpy() + 1j * yi.double().numpy(), axis=1)
    nat = pi_layout_to_natural(np.concatenate(
        [row[[int(f"{c:09b}"[::-1], 2) for c in range(C)]] for row in y]))
    exact = np.fft.fft((xr.astype(np.complex128) + 1j * xi).reshape(n))
    assert _ref_rel(nat.real, nat.imag, exact) <= BUDGET[mode]


def test_mf_blocking_defaults_and_limits():
    assert cf.mf_blocking(1 << 20) == (128, 1 << 13, 64)
    assert cf.mf_blocking(1 << 14) == (128, 128, 64)
    assert cf.mf_blocking(1 << 21) == (128, 1 << 14, 64)
    # eight 64-column work items for the block's eight warps at R = 16
    assert cf.mf_blocking(1 << 14, 16) == (16, 1024, 512)
    with pytest.raises(ValueError, match="R=8 must be a power of two >= 16"):
        cf.mf_blocking(1 << 14, 8)
    with pytest.raises(ValueError, match="exceeds MAX_SMEM_TILE"):
        cf.mf_blocking(1 << 22)
    with pytest.raises(ValueError, match="multiple of 128"):
        cf.mf_blocking(1 << 13, 128)
    with pytest.raises(ValueError, match="cb=96 must be a multiple of 64"):
        cf.mf_blocking(1 << 20, 128, 96)
    with pytest.raises(ValueError, match="limit 232448"):
        cf.mf_blocking(1 << 20, 128, 256)


def test_mf_refuses_narrow_storage_and_bad_shapes():
    xr, xi = _t(*_planes(15, 1 << 14))
    with pytest.raises(ValueError, match="fp32 storage only"):
        cf.fft_pi_layout_cuda_mf(xr, xi, precision="bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        cf.fft_pi_layout_cuda_mf(xr, xi, precision="tf32")
    R, C = 16, 1024
    args = twiddle.device_funnel_b(R, CPU) + \
        twiddle.device_funnel_factors(R, R * C, CPU)
    with pytest.raises(ValueError, match="operand shape"):
        cf.matmul_funnel(*_t(*_planes(16, (R, C))), *args[:2],
                         *twiddle.device_funnel_factors(R, 2 * R * C, CPU))


# ------------------------------------------------------------ the ladder


@pytest.mark.parametrize("layout", ["pi", "natural"])
@pytest.mark.parametrize("mode", FP32_MODES)
def test_plan_mf_executes(layout, mode):
    n = 1 << 14
    key = plans.make_key(n, layout=layout, precision=mode, device="cpu")
    plan = Plan(key, "mf", {"R": 128})
    xr, xi = _planes(17, n)
    yr, yi = plan.execute(xr, xi)
    y = yr.numpy() + 1j * yi.numpy()
    if layout == "pi":
        y = pi_layout_to_natural(y)
    exact = np.fft.fft(xr.astype(np.complex128) + 1j * xi)
    assert _ref_rel(y.real, y.imag, exact) <= BUDGET[mode]


def test_plan_mf_refuses_bf16_and_bad_params():
    key = plans.make_key(1 << 20, precision="bf16", device="cpu")
    with pytest.raises(ValueError, match="variant 'mf' has no bfloat16 "
                                         "storage path — fp32 storage only"):
        ladder.build_executor(key, "mf", {"R": 128})
    key = plans.make_key(1 << 20, device="cpu")
    with pytest.raises(ValueError, match="limit 232448"):
        ladder.build_executor(key, "mf", {"R": 128, "cb": 256})
    with pytest.raises(ValueError, match="MAX_SMEM_TILE"):
        ladder.build_executor(plans.make_key(1 << 22, device="cpu"), "mf",
                              {})


@pytest.mark.parametrize("n", [1 << 14, 1 << 20, 1 << 21])
def test_mf_is_never_raced_or_static(n):
    # the reference's research variant: served to a Plan built with it
    key = plans.make_key(n, layout="pi", device="cpu")
    assert all(v != "mf" for v, _ in ladder.candidates(key))
    assert ladder.static_default(key)[0] != "mf"
    assert "mf" not in ladder.UNPORTED


def test_mf_counts_no_launch_on_the_cpu():
    cf.reset_launch_counts()
    cf.fft_pi_layout_cuda_mf(*_t(*_planes(18, 1 << 14)))
    assert cf.matmul_funnel.launches == 0 and cf.tile_fft.launches == 0
    assert cf.matmul_funnel in cf.KERNELS


def test_every_kernel_entry_point_is_built_and_typed():
    # both new sources land in the build (and its hash), and every C
    # entry point the sources define has its ctypes signature declared
    import glob
    import os
    import re

    from cs87project_msolano2_tpu_torch.utils import buildlib

    names = {os.path.basename(s) for s in buildlib.sources()}
    assert {"mf.cu", "gpu_rows.cu"} <= names
    assert [os.path.basename(h) for h in buildlib.headers()] == \
        ["fft_common.cuh"]
    with open(buildlib.__file__) as f:
        binding = f.read()
    for src in glob.glob(os.path.join(buildlib.CSRC_DIR, "*.cu")):
        with open(src) as f:
            found = re.findall(r'extern "C" [^(]*?\b(pifft_\w+)\(', f.read())
            for fn in found:
                assert f"lib.{fn}.argtypes" in binding, (src, fn)
