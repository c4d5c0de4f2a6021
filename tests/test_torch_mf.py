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


def _jnp_split(x, levels):
    # the reference's casts (precision.py:231-235), carried to `levels`
    # planes: each the round to nearest even of what the planes before it
    # left
    planes, rest = [], jnp.asarray(x)
    for _ in range(levels):
        p = rest.astype(jnp.bfloat16)
        planes.append(np.asarray(p).view(np.int16))
        rest = rest - p.astype(jnp.float32)
    return planes


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("R", [16, 32, 64, 128, 256])
def test_funnel_b_planes_are_the_reference_split(R, levels):
    # the B operand the funnel kernel reads: the reference's dft_funnel_b
    # cut into `levels` bf16 planes, bit for bit, made once per R and L
    planes = twiddle.device_funnel_b_planes(R, levels, CPU)
    assert planes is twiddle.device_funnel_b_planes(R, levels, CPU)
    for mine, theirs in zip(planes, ref_pf.dft_funnel_b(R)):
        assert mine.dtype == torch.bfloat16 and mine.is_contiguous()
        assert tuple(mine.shape) == (levels, R, R)
        for got, want in zip(mine, _jnp_split(theirs, levels)):
            np.testing.assert_array_equal(_bits(got), want)
        # and they sum back to B as test_split_planes_sum_back's planes
        back = sum(p.to(torch.float64) for p in mine)
        tol = {1: 2 ** -8, 2: 2 ** -16, 3: 2 ** -24}[levels]
        b = torch.from_numpy(theirs).double()
        big = b.abs() > 0
        assert float(((back - b)[big].abs() / b[big].abs()).max()) <= tol
        assert torch.equal(back[~big], b[~big])
    # the kernel's step tiles hold exactly these planes: slice (u, k) of
    # Br then Bi is rows 64 u .., columns 16 k .. of every plane, first
    # columns 16 k .. + 7 of the 64 rows, then the next 8 (wgmma's
    # K-major core matrices), rows past R zero
    tiles = twiddle.device_funnel_b_tiles(R, levels, CPU)
    assert tiles is twiddle.device_funnel_b_tiles(R, levels, CPU)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    assert tuple(tiles.shape) == (-(-R // 64), R // 16, 2, levels, 2, 64, 8)
    for got, want in zip(twiddle.funnel_b_untile(tiles), planes):
        assert torch.equal(got, want)
    P = np.stack([_bits(p) for p in planes])          # (2, L, R, R)
    u, k, m, s, h, row, e = np.ix_(*(range(d) for d in tiles.shape))
    r = 64 * u + row
    c = 16 * k + 8 * h + e
    want = np.where(r < R, P[m, s, np.minimum(r, R - 1), c], 0)
    np.testing.assert_array_equal(_bits(tiles), want)


@pytest.mark.parametrize("R", [16, 32, 64, 128, 256])
def test_funnel_b2_tiles_are_the_factor(R):
    # the kernel epilogue's B2: dft_funnel_factors' (R, 128) factor, each
    # warp's (h, j) pairs of 32 lanes contiguous, rows past R zero
    n = R * 1024
    _, _, b2r, b2i = twiddle.device_funnel_factors(R, n, CPU)
    wt = twiddle.device_funnel_b2_tiles(R, n, CPU)
    assert wt is twiddle.device_funnel_b2_tiles(R, n, CPU)
    assert wt.dtype == torch.float32 and wt.is_contiguous()
    assert tuple(wt.shape) == (-(-R // 64), 2, 4, 2, 8, 8, 4, 2, 2)
    back = twiddle.funnel_b2_untile(wt, R)
    assert torch.equal(back[0], b2r) and torch.equal(back[1], b2i)
    B2 = np.stack([b2r.numpy(), b2i.numpy()])           # (2, R, 128)
    u, lh, w, h, j, g, t, p, e = np.ix_(*(range(d) for d in wt.shape))
    r = 64 * u + 16 * w + 8 * h + g
    c = 64 * lh + 8 * j + 2 * t + e
    want = np.where(r < R, B2[p, np.minimum(r, R - 1), c], 0)
    np.testing.assert_array_equal(wt.numpy(), want)


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
    # the reference's column blocks (128 .. 1024) are its VMEM's; the
    # port's wgmma kernel has one column block, its m64n64 unit's 64
    return None


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
    args = _t(xr, xi) + (twiddle.device_funnel_b_tiles(
        R, precision.split_levels(mode), CPU),) + \
        twiddle.device_funnel_factors(R, n, CPU)[:2] + \
        (twiddle.device_funnel_b2_tiles(R, n, CPU),)
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
    # one warpgroup's 64 x 64 unit at every R: the column block is 64
    assert cf.mf_blocking(1 << 14, 16) == (16, 1024, 64)
    assert cf.mf_blocking(1 << 15, 256, 64) == (256, 128, 64)
    with pytest.raises(ValueError, match="R=8 must be a power of two >= 16"):
        cf.mf_blocking(1 << 14, 8)
    with pytest.raises(ValueError, match="R=48 must be a power of two"):
        cf.mf_blocking(48 * 1024, 48)
    with pytest.raises(ValueError, match="exceeds MAX_SMEM_TILE"):
        cf.mf_blocking(1 << 22)
    with pytest.raises(ValueError, match="multiple of 128"):
        cf.mf_blocking(1 << 13, 128)
    with pytest.raises(ValueError, match="cb=96 is not the kernel's column "
                                         "block of 64"):
        cf.mf_blocking(1 << 20, 128, 96)
    with pytest.raises(ValueError, match="cb=256 is not the kernel's "
                                         "column block of 64"):
        cf.mf_blocking(1 << 20, 128, 256)
    with pytest.raises(ValueError, match="cb=32 is not the kernel's column "
                                         "block of 64"):
        cf.mf_blocking(1 << 20, 128, 32)


def test_mf_refuses_narrow_storage_and_bad_shapes():
    xr, xi = _t(*_planes(15, 1 << 14))
    with pytest.raises(ValueError, match="fp32 storage only"):
        cf.fft_pi_layout_cuda_mf(xr, xi, precision="bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        cf.fft_pi_layout_cuda_mf(xr, xi, precision="tf32")
    R, C = 16, 1024
    tiles = twiddle.device_funnel_b_tiles(R, 2, CPU)
    with pytest.raises(ValueError, match="operand shape"):
        cf.matmul_funnel(*_t(*_planes(16, (R, C))), tiles,
                         *twiddle.device_funnel_factors(R, 2 * R * C,
                                                        CPU)[:2],
                         twiddle.device_funnel_b2_tiles(R, 2 * R * C, CPU))
    # split3's two planes of B, not highest's three nor fp32 matrices
    fac = twiddle.device_funnel_factors(R, R * C, CPU)[:2] + \
        (twiddle.device_funnel_b2_tiles(R, R * C, CPU),)
    # B2 as the (R, 128) factor, not the epilogue's tiles
    with pytest.raises(ValueError, match="operand shape"):
        cf.matmul_funnel(*_t(*_planes(16, (R, C))), tiles,
                         *twiddle.device_funnel_factors(R, R * C, CPU)[:3])
    with pytest.raises(ValueError, match=r"B tiles shape \(1, 1, 2, 2, 2, "
                                         r"64, 8\) != \(1, 1, 2, 3, 2, 64, "
                                         r"8\)"):
        cf.matmul_funnel(*_t(*_planes(16, (R, C))), tiles, *fac,
                         precision="highest")
    with pytest.raises(ValueError, match="contiguous bfloat16"):
        cf.matmul_funnel(*_t(*_planes(16, (R, C))),
                         twiddle.device_funnel_b(R, CPU)[0], *fac)


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
    with pytest.raises(ValueError, match="cb=256 is not the kernel's "
                                         "column block of 64"):
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
    assert "mf" not in ladder.anylen.ANYLEN_VARIANTS


def _phase9_planes(n):
    # chip_smoke.py phase 9's input: its own default_rng(0), re then im,
    # uniform in +-1/sqrt(n)
    rng = np.random.default_rng(0)
    amp = 1.0 / np.sqrt(n)
    return (rng.uniform(-amp, amp, n).astype(np.float32),
            rng.uniform(-amp, amp, n).astype(np.float32))


def split3_errors(n):
    """{"reference", "port": (max abs, rel L2)} of the split3 mf path
    against complex128 on phase 9's n-point input, pi layout: the
    reference's fft_pi_layout_pallas_mf (interpret mode, R = 128) and the
    port's plain composition (matmul_funnel_plain, then tile_fft_plain)."""
    xr, xi = _phase9_planes(n)
    exact = pi_layout_to_natural(np.fft.fft(
        xr.astype(np.complex128) + 1j * xi.astype(np.complex128)))
    rr, ri = ref_pf.fft_pi_layout_pallas_mf(
        jnp.asarray(xr), jnp.asarray(xi), R=128,
        precision=ref_prec.dot_precision("split3"))
    pr, pi = cf.fft_pi_layout_cuda_mf(*_t(xr, xi), precision="split3")
    out = {}
    for name, y in (("reference", np.asarray(rr) + 1j * np.asarray(ri)),
                    ("port", pr.double().numpy() + 1j * pi.double().numpy())):
        d = y.astype(np.complex128) - exact
        out[name] = (float(np.abs(d).max()),
                     float(np.linalg.norm(d) / np.linalg.norm(exact)))
    return out


@pytest.mark.parametrize("n", [1 << 14, 1 << 20])
def test_split3_max_abs_matches_the_reference(n):
    # split3 keeps 16 bits of each operand, and its contract is rel L2
    # (ops/precision.py).  On phase 9's input the card's split3 path
    # reads max abs 1.11e-5 at 2^20, past BASELINE's 1e-5: the
    # reference's split3 on the same input reads more, so the bound holds
    # the fp32 modes only (ROADMAP, deliberate differences)
    errs = split3_errors(n)
    assert errs["port"][0] <= 1.05 * errs["reference"][0], errs
    assert max(errs["port"][1], errs["reference"][1]) <= BUDGET["split3"]


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
    # and each declared list matches the C parameters, type for type
    assert _argtypes(binding, "pifft_matmul_funnel") == \
        _c_params("mf.cu", "pifft_matmul_funnel") == ["p"] * 8 + \
        ["i", "i", "i", "i", "p"]
    assert _argtypes(binding, "pifft_matmul_funnel_resident_blocks") == \
        _c_params("mf.cu", "pifft_matmul_funnel_resident_blocks") == \
        ["i", "i"]
    for src in glob.glob(os.path.join(buildlib.CSRC_DIR, "*.cu")):
        with open(src) as f:
            for fn in re.findall(r'extern "C" [^(]*?\b(pifft_\w+)\(',
                                 f.read()):
                assert _argtypes(binding, fn) == \
                    _c_params(os.path.basename(src), fn), (src, fn)


def _argtypes(binding, fn):
    # lib.<fn>.argtypes as type letters: p pointer, i int, L long long
    import re
    import types

    m = re.search(rf"lib\.{fn}\.argtypes = (\[.*?\](?: \* \d+)?)\n",
                  binding, re.S)
    c = types.SimpleNamespace(c_int="i", c_longlong="L")
    return eval(re.sub(r"#[^\n]*", "", m.group(1)), {"ptr": "p", "c": c})


def _c_params(source, fn):
    # the C entry's parameters as the same letters
    import os
    import re

    from cs87project_msolano2_tpu_torch.utils import buildlib

    with open(os.path.join(buildlib.CSRC_DIR, source)) as f:
        text = f.read()
    params = re.search(rf"\b{fn}\(([^)]*)\)", text).group(1).split(",")
    return ["p" if "*" in q else "L" if "long long" in q else "i"
            for q in params if q.strip()]


if __name__ == "__main__":
    # the readings behind the test above, at both sizes:
    #   JAX_PLATFORMS=cpu python tests/test_torch_mf.py
    for k in (14, 20):
        for name, (mabs, rel) in split3_errors(1 << k).items():
            print(f"n=2^{k} split3 {name}: max abs {mabs:.4e}, rel L2 "
                  f"{rel:.4e}")
