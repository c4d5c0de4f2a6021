"""The bf16 storage mode of the port on the CPU, mirroring the
reference's tests/test_precision.py where it covers bf16: the storage
rounding and tables bit for bit against the JAX package, the byte
table, the plain bf16 rql, rows and two-kernel paths against the
reference's ``storage="bfloat16"`` kernels in interpret mode, fused
against the reference's rql, fourstep and sixstep against complex128
and the reference's rql, the entry points' "narrow but float32"
contract, plans on every bf16 ladder variant, the precision race and
its stored winner, ``Plan.storage_bytes``, the gpu backend's bf16 keys,
and the ``plan`` CLI.  Card tests of the bf16 kernels are in
``test_torch_cuda.py``.

Tolerances (inputs uniform in +-1/sqrt(n), numpy seeds).  The reference
rounds its last log2(tail) levels once, as one product with a
bf16-rounded tail matrix; the port runs them as butterflies, each with
a bf16-rounded twiddle, and rounds at the same storage points otherwise.
Its error against complex128 reads 1.06-1.13 times the reference's
(4.38e-3 against 4.02e-3 at 2^14, 4.61e-3 against 4.29e-3 at 2^16, on
a CPU), and the two outputs lie about 3.0e-3 apart, so the limits
are 1.25 times the reference's error, 5e-3 apart, and the bf16 budget
3e-2.  Two port paths that round at the same points (fourstep and rql)
differ only where a float32 difference crosses a bf16 boundary: 1e-3.
The two-kernel path (dense tables) and fused (rql's arithmetic, its
carry rounded where rql rounds its intermediate) read 1.07 and 1.09-1.12
times the reference's error, 2.9e-3 to 3.3e-3 apart (the readings of
``bf16_errors`` below, on a CPU), so they are held to 1.15 times and
4e-3 apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.hw import lowering as ref_lowering
from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu.ops import precision as ref_prec
from cs87project_msolano2_tpu.ops import twiddle as ref_twiddle
from cs87project_msolano2_tpu.plans.core import PlanKey as RefPlanKey
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.hw import lowering
from cs87project_msolano2_tpu_torch.models.fft import fft, fft_planes_fast
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops import precision, twiddle
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.plans import autotune, ladder
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans.core import Plan, PlanKey
from cs87project_msolano2_tpu_torch.utils.verify import pi_layout_to_natural

CPU = torch.device("cpu")
CARD = "NVIDIA H100 80GB HBM3"
BF16 = "bfloat16"
#: the bf16 mode's budget against complex128 (ops/precision.py)
BUDGET = precision.ERROR_BUDGETS["bf16"]
#: the port's bf16 error over the reference's (Motivation above)
REF_RATIO = 1.25
#: port and reference bf16 outputs apart, rel L2
APART = 5e-3
#: two port paths rounding at the same points, rel L2
SAME_POINTS = 1e-3
#: the two-kernel and fused bf16 error over the reference's, and the
#: two outputs apart, rel L2 (the readings above)
RAISED_RATIO = 1.15
RAISED_APART = 4e-3
#: the shapes of the plain bf16 paths held against the reference
REF_SHAPES = [(1 << 14, 1 << 10), (1 << 16, 1 << 12)]


@pytest.fixture(autouse=True)
def fresh_memory_cache():
    plan_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)


def _planes(n, shape=None, seed=0):
    rng = np.random.default_rng(seed)
    amp = 1.0 / np.sqrt(n)
    shape = shape or (n,)
    return (rng.uniform(-amp, amp, shape).astype(np.float32),
            rng.uniform(-amp, amp, shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _exact_pi(xr, xi):
    y = np.fft.fft(xr.astype(np.float64) + 1j * xi.astype(np.float64),
                   axis=-1)
    return pi_layout_to_natural(y)  # bit reversal is an involution


def _bits(a):
    """The 16 bits of bf16 tensors or arrays, as uint16 numpy."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _jax_bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


# ------------------------------------------------ storage and tables


def test_as_storage_rounds_as_jax_astype():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1 << 14).astype(np.float32)
    # exact ties: the low 16 bits 0x8000, above an even and an odd bf16
    # value, either sign, and values one ulp either side of a tie
    ties = rng.integers(0, 1 << 16, 512, dtype=np.uint32) << 16
    ties = ties & np.uint32(0x7F7F0000) | np.uint32(0x8000)
    near = np.concatenate([ties, ties + 1, ties - 1]).view(np.float32)
    x = np.concatenate([x, near, -near])
    got = precision.as_storage(torch.from_numpy(x), BF16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    assert np.array_equal(_bits(got), _bits(want))
    # the upcast is exact, and float32 storage is the tensor itself
    back = precision.as_compute(got)
    assert back.dtype == torch.float32
    assert np.array_equal(back.numpy(), want.astype(np.float32))
    t = torch.from_numpy(x)
    assert precision.as_storage(t, None) is t
    assert precision.as_storage(t, "float32") is t
    assert precision.as_compute(t) is t


@pytest.mark.parametrize("R,C", [(8, 256), (64, 1024), (2, 4096)])
def test_bf16_tables_match_the_reference(R, C):
    # flat tables and separable factors: the reference rounds its float32
    # tables with jnp.asarray(t, bfloat16); dense tables come from its
    # twiddle_tables(n, dtype="bfloat16")
    fr, fi = twiddle.flat_tables(C, CPU, BF16)
    tabs = ref_twiddle.twiddle_tables(C)
    assert fr.dtype == torch.bfloat16 and fr.shape == (C - 1,)
    assert np.array_equal(_bits(fr), _bits(_jax_bf16(
        np.concatenate([t[0] for t in tabs]))))
    assert np.array_equal(_bits(fi), _bits(_jax_bf16(
        np.concatenate([t[1] for t in tabs]))))
    got = twiddle.device_factors(R, C, CPU, BF16)
    for g, want in zip(got, ref_pf._long_range_factors(R, C)):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(_bits(g), _bits(_jax_bf16(want)).reshape(
            g.shape))
    wr, wi = twiddle.dense_long_range_tables(R, C, CPU, BF16)
    levels = ref_twiddle.twiddle_tables(R * C, dtype=BF16)[:R.bit_length()
                                                             - 1]
    assert np.array_equal(_bits(wr), np.concatenate(
        [_bits(w) for w, _ in levels]).reshape(R - 1, C))
    assert np.array_equal(_bits(wi), np.concatenate(
        [_bits(w) for _, w in levels]).reshape(R - 1, C))
    # float32 is the default and its own cache entry
    assert twiddle.flat_tables(C, CPU)[0].dtype == torch.float32
    assert twiddle.flat_tables(C, CPU, "float32") is twiddle.flat_tables(
        C, CPU)


def test_storage_bytes_match_the_reference():
    for mode in precision.PRECISIONS:
        assert precision.storage_bytes(mode) == ref_prec.storage_bytes(mode)
    for dtype in ("float32", BF16):
        assert precision.dtype_bytes(dtype) == ref_prec.dtype_bytes(dtype)
    assert precision.storage_bytes("bf16") == 2
    assert precision.torch_dtype(BF16) is torch.bfloat16
    assert precision.torch_dtype(None) is torch.float32
    with pytest.raises(ValueError, match="storage dtype"):
        precision.torch_dtype("float16")


# ----------------------------- the plain bf16 paths vs the reference


@pytest.mark.parametrize("n,tile", [(1 << 14, 1 << 10), (1 << 16, 1 << 12)])
def test_bf16_rql_vs_reference(n, tile):
    xr, xi = _planes(n)
    rr, ri = ref_pf.fft_pi_layout_pallas_rql(
        jnp.asarray(xr), jnp.asarray(xi), tile=tile, storage=BF16,
        interpret=True)
    rr, ri = np.asarray(rr), np.asarray(ri)
    pr, pi_ = cf.fft_pi_layout_cuda_rql(*_t(xr, xi), tile=tile,
                                        storage=BF16)
    assert pr.dtype == torch.float32 and pi_.dtype == torch.float32
    assert pr.shape == (n,)
    exact = _exact_pi(xr, xi)
    e_ref = rel_err(rr, ri, exact.real, exact.imag)
    e_port = rel_err(pr, pi_, exact.real, exact.imag)
    assert e_port <= min(REF_RATIO * e_ref, BUDGET)
    assert rel_err(pr, pi_, rr, ri) <= APART
    # and the storage really narrowed: far from the float32 path
    fr, fi = cf.fft_pi_layout_cuda_rql(*_t(xr, xi), tile=tile)
    assert rel_err(fr, fi, exact.real, exact.imag) < 1e-5 < e_port


def test_bf16_rows_vs_reference():
    xr, xi = _planes(1024, (8, 1024), seed=1)
    rr, ri = ref_pf.fft_rows_pallas(jnp.asarray(xr), jnp.asarray(xi),
                                    storage=BF16, interpret=True)
    rr, ri = np.asarray(rr), np.asarray(ri)
    pr, pi_ = cf.fft_rows_cuda(*_t(xr, xi), storage=BF16)
    assert pr.dtype == torch.float32 and pr.shape == (8, 1024)
    exact = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    e_ref = rel_err(rr, ri, exact.real, exact.imag)
    e_port = rel_err(pr, pi_, exact.real, exact.imag)
    assert e_port <= min(REF_RATIO * e_ref, BUDGET)
    assert rel_err(pr, pi_, rr, ri) <= APART
    # and the storage really narrowed: far from the float32 rows
    fr, fi = cf.fft_rows_cuda(*_t(xr, xi))
    assert rel_err(fr, fi, exact.real, exact.imag) < 1e-5 < e_port


def _reference_bf16(variant, xr, xi, tile):
    """The reference's bf16 output (numpy) that the port's `variant` is
    held to: ``fft_pi_layout_pallas2`` for two-kernel; for fused its rql
    with fused's own tail (256), which rounds at fused's points (the
    input, the intermediate after the long-range levels, the output),
    because the reference's carry kernels do not run on this jax
    (``pltpu.TPUCompilerParams`` is gone, pallas_fft.py:990)."""
    x = jnp.asarray(xr), jnp.asarray(xi)
    if variant == "two-kernel":
        out = ref_pf.fft_pi_layout_pallas2(*x, tile=tile, storage=BF16,
                                           interpret=True)
    else:
        out = ref_pf.fft_pi_layout_pallas_rql(*x, tile=tile, tail=256,
                                              storage=BF16, interpret=True)
    return tuple(np.asarray(a) for a in out)


def _port_bf16(variant, xr, xi, tile):
    if variant == "two-kernel":
        return cf.fft_pi_layout_cuda2(*_t(xr, xi), tile=tile, storage=BF16)
    return cf.fft_pi_layout_cuda_fused(*_t(xr, xi), tile=tile, storage=BF16,
                                       alias_io=variant == "fused-alias")


@pytest.mark.parametrize("variant", ["two-kernel", "fused"])
@pytest.mark.parametrize("n,tile", REF_SHAPES)
def test_bf16_raced_paths_vs_reference(variant, n, tile):
    xr, xi = _planes(n)
    rr, ri = _reference_bf16(variant, xr, xi, tile)
    pr, pi_ = _port_bf16(variant, xr, xi, tile)
    assert pr.dtype == torch.float32 and pr.shape == (n,)
    exact = _exact_pi(xr, xi)
    e_ref = rel_err(rr, ri, exact.real, exact.imag)
    e_port = rel_err(pr, pi_, exact.real, exact.imag)
    assert e_port <= min(RAISED_RATIO * e_ref, BUDGET)
    assert rel_err(pr, pi_, rr, ri) <= RAISED_APART
    assert 1e-4 < e_port  # the storage really narrowed


@pytest.mark.parametrize("n,tile", REF_SHAPES)
def test_bf16_fused_plain_is_the_plain_rql(n, tile):
    # the same factors, tables and rounding points: bit for bit, in
    # both alias modes
    xr, xi = _t(*_planes(n, seed=8))
    want = cf.fft_pi_layout_cuda_rql(xr, xi, tile=tile, storage=BF16)
    for alias_io in (False, True):
        got = cf.fft_pi_layout_cuda_fused(xr, xi, tile=tile, storage=BF16,
                                          alias_io=alias_io)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # R = 1 takes the tile kernel on the same storage, as the reference's
    # l.926-931 does
    one = cf.fft_pi_layout_cuda_fused(xr[:tile], xi[:tile], storage=BF16,
                                      tile=tile)
    rows = cf.fft_pi_layout_cuda_rql(xr[:tile], xi[:tile], tile=tile,
                                     storage=BF16)
    assert one[0].dtype == torch.float32
    assert torch.equal(one[0], rows[0]) and torch.equal(one[1], rows[1])


def test_bf16_fourstep_plain_rounds_where_rql_does():
    # the same separable factors and rounding points (the dense tables
    # round each twiddle once where the factors round two: about 3e-3
    # apart, and held to the budget below)
    n, tile = 1 << 14, 1 << 10
    xr, xi = _t(*_planes(n, seed=2))
    fr, fi = cf.fft_pi_layout_cuda_fourstep(xr, xi, tile=tile, storage=BF16)
    rr, ri = cf.fft_pi_layout_cuda_rql(xr, xi, tile=tile, storage=BF16)
    assert fr.dtype == torch.float32
    assert rel_err(fr, fi, rr, ri) <= SAME_POINTS


@pytest.mark.parametrize("separable", [True, False])
def test_bf16_fourstep_and_sixstep_within_budget(separable):
    n, tile = 1 << 14, 1 << 10
    xr, xi = _planes(n, seed=3)
    exact = _exact_pi(xr, xi)
    rr, ri = ref_pf.fft_pi_layout_pallas_rql(
        jnp.asarray(xr), jnp.asarray(xi), tile=tile, storage=BF16,
        interpret=True)
    e_ref = rel_err(np.asarray(rr), np.asarray(ri), exact.real, exact.imag)
    fr, fi = cf.fft_pi_layout_cuda_fourstep(*_t(xr, xi), tile=tile,
                                            separable=separable,
                                            storage=BF16)
    assert rel_err(fr, fi, exact.real, exact.imag) <= BUDGET
    # sixstep rounds one more carry (after B1): 1.5 times the reference
    # rql's error at the same n and tile
    sr, si = cf.fft_pi_layout_cuda_sixstep(*_t(xr, xi), tile=tile,
                                           separable=separable,
                                           storage=BF16)
    assert sr.dtype == torch.float32 and sr.shape == (n,)
    e_six = rel_err(sr, si, exact.real, exact.imag)
    assert e_six <= min(1.5 * e_ref, BUDGET)


def test_bf16_plain_versions_round_their_stores():
    # each plain version returns the planes' dtype, rounded once
    R, tile = 8, 256
    xr, xi = (t.to(torch.bfloat16) for t in _t(*_planes(R * tile,
                                                        (R, tile))))
    tw = twiddle.flat_tables(tile, CPU, BF16)
    launched = cf.launch_counts()
    yr, yi = cf.tile_fft(xr, xi, *tw)
    assert yr.dtype == torch.bfloat16
    f32 = cf.tile_fft_plain(xr.float(), xi.float(), *(t.float() for t in tw))
    assert torch.equal(yr, f32[0].to(torch.bfloat16))
    fac = twiddle.device_factors(R, tile, CPU, BF16)
    lr = cf.long_range_sep(xr.reshape(1, R, tile), xi.reshape(1, R, tile),
                           *fac)
    assert lr[0].dtype == torch.bfloat16
    # fourstep = long-range, rounded (the carry), then the tile rows
    y4 = cf.fourstep(xr, xi, *fac, *tw)
    want = cf.tile_fft_plain(lr[0].reshape(R, tile), lr[1].reshape(R, tile),
                             *tw)
    assert torch.equal(y4[0], want[0]) and torch.equal(y4[1], want[1])
    # no launch was counted: the CPU runs the plain versions
    assert cf.launch_counts() == launched


@pytest.mark.parametrize("bad", ["planes", "mixed", "tables", "factors"])
def test_wrappers_refuse_a_dtype_that_does_not_match(bad):
    R, tile = 8, 256
    xr, xi = _t(*_planes(R * tile, (R, tile)))
    tw = list(twiddle.flat_tables(tile, CPU, BF16))
    fac = list(twiddle.device_factors(R, tile, CPU, BF16))
    xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
    if bad == "planes":
        xr, xi = xr.half(), xi.half()
    elif bad == "mixed":
        xi = xi.float()
    elif bad == "tables":
        tw = [t.float() for t in tw]
    else:
        fac = [t.float() for t in fac]
    with pytest.raises((TypeError, ValueError)):
        cf.fourstep(xr, xi, *fac, *tw)
    with pytest.raises((TypeError, ValueError)):
        cf.fused(xr, xi, *fac, *tw)
    if bad != "factors":
        with pytest.raises((TypeError, ValueError)):
            cf.tile_fft(xr, xi, *tw)
        dense = twiddle.dense_long_range_tables(R, tile, CPU, BF16)
        if bad == "tables":
            dense = [t.float() for t in dense]
        with pytest.raises((TypeError, ValueError)):
            cf.long_range_dense(xr.reshape(1, R, tile),
                                xi.reshape(1, R, tile), *dense)


def test_alignment_check_follows_the_copy_width():
    # the kernels copy four points at a time: 16 bytes of float32, 8 of
    # bf16, so a plane is checked against its own dtype's width
    buf16 = torch.zeros(64, dtype=torch.bfloat16)
    buf32 = torch.zeros(64)
    cf._check_aligned("fused", buf16[4:], buf32[4:])
    with pytest.raises(ValueError, match="bfloat16 planes must be 8-byte"):
        cf._check_aligned("fused", buf16[2:])
    with pytest.raises(ValueError, match="float32 planes must be 16-byte"):
        cf._check_aligned("fused", buf32[2:])


# ---------------------------------------------- the entry points


def test_bf16_storage_is_actually_narrow_but_output_is_f32():
    n = 4096
    xr, xi = _planes(n, seed=4)
    x = xr + 1j * xi
    exact = np.fft.fft(x.astype(np.complex128))
    y16 = fft(x, precision="bf16", device="cpu")
    y32 = fft(x, precision="split3", device="cpu")
    assert y16.dtype == torch.complex64 and y16.shape == (n,)
    e16 = rel_err(y16.real, y16.imag, exact.real, exact.imag)
    e32 = rel_err(y32.real, y32.imag, exact.real, exact.imag)
    assert e32 < 1e-5
    assert 1e-4 < e16 <= BUDGET  # narrow, in budget
    # the plane entry point and the plan layer serve the same mode
    pr, pi_ = fft_planes_fast(*_t(xr, xi), precision="bf16", device="cpu")
    assert pr.dtype == torch.float32
    assert torch.equal(torch.complex(pr, pi_), y16)
    pl = plans.plan_for((n,), precision="bf16", device="cpu")
    assert pl.variant == "rows" and pl.effective_precision() == "bf16"


@pytest.mark.parametrize("n,variant", [(1 << 21, "fourstep"),
                                       (1 << 17, "rql")])
def test_bf16_plans_on_the_static_ladder(n, variant):
    xr, xi = _planes(n, seed=5)
    pl = plans.plan(n, layout="natural", precision="bf16", device="cpu")
    assert pl.variant == variant and pl.storage_bytes() == 2
    yr, yi = pl.execute(*_t(xr, xi))
    assert yr.dtype == torch.float32
    exact = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    assert 1e-4 < rel_err(yr, yi, exact.real, exact.imag) <= BUDGET


@pytest.mark.parametrize("variant", ["fused", "fused-alias", "two-kernel"])
def test_bf16_plans_on_the_raced_variants(variant):
    # a Plan built with each raced variant for a bf16 key at 2^14, tile
    # 1024 (R = 16: the long-range levels run), served in bf16 storage
    n, tile = 1 << 14, 1 << 10
    xr, xi = _planes(n, seed=9)
    key = plans.make_key(n, layout="pi", precision="bf16", device="cpu")
    pl = Plan(key=key, variant=variant, params={"tile": tile})
    assert pl.storage_bytes() == 2
    yr, yi = pl.execute(*_t(xr, xi))
    assert yr.dtype == torch.float32 and yr.shape == (n,)
    exact = _exact_pi(xr, xi)
    rr, ri = _reference_bf16(variant, xr, xi, tile)
    e_ref = rel_err(rr, ri, exact.real, exact.imag)
    e_port = rel_err(yr, yi, exact.real, exact.imag)
    assert 1e-4 < e_port <= min(RAISED_RATIO * e_ref, BUDGET)
    # the same answer as the composition called directly
    want = _port_bf16(variant, xr, xi, tile)
    assert torch.equal(yr, want[0]) and torch.equal(yi, want[1])


@pytest.mark.parametrize("layout", ["pi", "natural"])
def test_bf16_fused_alias_consumes_only_its_own_copy(layout):
    # in bf16 the executor writes over the rounded copy it made at
    # entry, so it is not marked consumes_input and the Plan hands it the
    # caller's float32 planes uncopied; float32 fused-alias still is
    n, tile = 1 << 12, 256
    key16 = plans.make_key(n, layout=layout, precision="bf16", device="cpu")
    key32 = plans.make_key(n, layout=layout, device="cpu")
    params = {"tile": tile, "qb": 1}
    assert not ladder.build_executor(key16, "fused-alias",
                                     params).consumes_input
    assert ladder.build_executor(key32, "fused-alias", params).consumes_input
    assert not ladder.build_executor(key32, "fused-alias", dict(
        params, precision="bf16")).consumes_input
    xr, xi = _t(*_planes(n, seed=10))
    keep = xr.clone(), xi.clone()
    yr, yi = Plan(key=key16, variant="fused-alias", params=params).execute(
        xr, xi)
    assert torch.equal(xr, keep[0]) and torch.equal(xi, keep[1])
    assert yr.dtype == torch.float32
    exact = np.fft.fft(keep[0].double().numpy() + 1j * keep[1].double()
                       .numpy())
    if layout == "pi":
        exact = pi_layout_to_natural(exact)
    assert 1e-4 < rel_err(yr, yi, exact.real, exact.imag) <= BUDGET


# ---------------------------------------------- the precision race


def test_bf16_candidates_race_both_storages_pinned():
    key = plans.make_key(1 << 20, layout="pi", precision="bf16",
                         device_kind=CARD)
    cands = ladder.candidates(key)
    modes = [p.get("precision") for _, p in cands]
    assert modes[0] == "bf16"  # expected winner (half the bytes) first
    half = len(cands) // 2
    assert modes == ["bf16"] * half + ["split3"] * half
    # each mode races the fp32 key's entries, in the same order
    base = ladder.candidates(plans.make_key(1 << 20, layout="pi",
                                            device_kind=CARD))
    assert [(v, {k: x for k, x in p.items() if k != "precision"})
            for v, p in cands[:half]] == base
    for mode in ("split3", "fp32", "highest", "default"):
        k = plans.make_key(1 << 20, layout="pi", precision=mode,
                           device_kind=CARD)
        assert all("precision" not in p for _, p in ladder.candidates(k))
    # every entry builds in both storages: each variant the reference
    # serves in bf16 has its bf16 instantiation
    assert {v for v, _ in cands} >= {"fused", "fused-alias", "two-kernel",
                                     "rql", "fourstep"}
    for variant, params in cands:
        assert callable(ladder.build_executor(key, variant, params))
    assert not hasattr(ladder, "NO_BF16_YET")
    with pytest.raises(ValueError, match="variant 'mf' has no bfloat16 "
                                         "storage path — fp32 storage "
                                         "only"):
        ladder.build_executor(key, "mf", {"R": 128, "precision": "bf16"})
    assert callable(ladder.build_executor(key, "mf", {
        "R": 128, "precision": "split3"}))


def test_pinned_mode_serves_its_storage():
    n = 4096
    xr, xi = _t(*_planes(n, seed=6))
    key = plans.make_key(n, layout="pi", precision="bf16", device="cpu")
    y16 = ladder.build_executor(key, "rows", {"precision": "bf16"})(xr, xi)
    y32 = ladder.build_executor(key, "rows", {"precision": "split3"})(xr, xi)
    want16 = cf.fft_rows_cuda(xr, xi, natural=False, storage=BF16)
    want32 = cf.fft_rows_cuda(xr, xi, natural=False)
    assert torch.equal(y16[0], want16[0]) and torch.equal(y32[0], want32[0])
    assert not torch.equal(y16[0], y32[0])


def test_tuned_bf16_winner_persists_its_mode(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    key = plans.make_key(1 << 20, layout="pi", precision="bf16",
                         device_kind=CARD)

    def timer(fn, k):
        # the first timed entry (a bf16 one) wins
        timer.calls += 1
        return 0.1 if timer.calls == 1 else 1.0 + timer.calls

    timer.calls = 0
    plan = plans.tune(key, timer=timer, allow_offline=True, verbose=False)
    assert plan.params.get("precision") == "bf16"
    assert plan.effective_precision() == "bf16"
    assert plan.storage_bytes() == 2
    # describe() names a pinned mode where it is not the key's
    assert "precision" not in plan.describe()
    assert Plan(key=key, variant="rql", params={
        "precision": "split3"}).describe()["precision"] == "split3"
    raced = {r.params.get("precision") for r in plan.tuning}
    assert raced == {"bf16", "split3"}
    # no bf16 entry is rejected: every ladder variant runs in bf16
    assert [r for r in plan.tuning if r.status == "rejected"] == []
    assert {r.variant for r in plan.tuning
            if r.params["precision"] == "bf16"} >= {
        "fused", "fused-alias", "two-kernel", "rql", "fourstep"}
    # a fresh process (the memory level cleared) reads the pinned winner
    plan_cache.clear(memory=True, disk=False)
    hit = plan_cache.lookup(key)
    assert hit is not None and hit.source == "cache"
    assert hit.params == plan.params
    assert hit.effective_precision() == "bf16" and hit.storage_bytes() == 2


def test_plan_storage_bytes():
    def plan(variant, precision="bf16", backend="cuda", params=None):
        key = PlanKey(device_kind=CARD, n=4096, batch=(64,),
                      precision=precision, backend=backend)
        return Plan(key=key, variant=variant, params=params or {})

    for variant in ("rows", "rql", "fourstep", "sixstep", "fused",
                    "fused-alias", "two-kernel"):
        assert plan(variant).storage_bytes() == 2
        assert plan(variant, "split3").storage_bytes() == 4
    assert plan("stages").storage_bytes() == 4
    assert plan("rows", params={"precision": "split3"}).storage_bytes() == 4
    for variant in ("gpu-rows", "gpu-stages"):
        assert plan(variant, backend="gpu").storage_bytes() == 4
    assert plan("rows").describe() == {"variant": "rows", "params": {},
                                       "source": "static"}


# ---------------------------------------------- gpu backend and CLI


@pytest.mark.parametrize("n,batch,layout,kind", [
    (4096, (64,), "natural", "cpu"), (4096, (64,), "pi", CARD),
    (1 << 18, (64,), "natural", CARD), (1 << 20, (), "natural", "cpu"),
    (256, (), "pi", "cpu")])
def test_gpu_backend_bf16_keys_match_the_reference(n, batch, layout, kind):
    key = PlanKey(device_kind=kind, n=n, batch=batch, layout=layout,
                  precision="bf16", backend="gpu")
    ref_key = RefPlanKey(device_kind=kind, n=n, batch=batch, layout=layout,
                         precision="bf16", backend="gpu")

    def port_name(entry):
        v, p = entry
        return ("gpu-stages" if v == "gpu-jnp" else v, p)

    assert lowering.static_default(key) == port_name(
        ref_lowering.static_default(ref_key))
    assert lowering.candidates(key) == [
        port_name(e) for e in ref_lowering.candidates(ref_key)]
    assert ladder.candidates(key) == lowering.candidates(key)
    variant, params = ladder.static_default(key)
    assert Plan(key=key, variant=variant, params=params).storage_bytes() == 4
    # it runs, in float32, as the reference's gpu family does
    if n <= 4096:
        xr, xi = _t(*_planes(n, batch + (n,), seed=7))
        yr, _ = ladder.build_executor(key, variant, params)(xr, xi)
        assert yr.dtype == torch.float32


def test_cli_plan_precision_bf16(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(plans, "current_device_kind", lambda device: CARD)
    monkeypatch.setattr(autotune, "device_is_tunable", lambda device: True)
    monkeypatch.setattr(autotune, "default_timer",
                        lambda fn, key, device="cuda": 0.5)
    assert cli_main(["plan", "warm", "-n", "2^20", "--layout", "pi",
                     "--precision", "bf16"]) == 0
    out = capsys.readouterr().out
    assert '"precision":"bf16"' in out and "'precision': 'bf16'" in out
    assert cli_main(["plan", "show"]) == 0
    out = capsys.readouterr().out
    assert "pi bf16 [bfloat16, budget 3e-02]" in out


def bf16_errors():
    """{case: (reference's, port's error vs complex128, the two apart)}
    at the shapes of test_bf16_rql_vs_reference,
    test_bf16_rows_vs_reference and test_bf16_raced_paths_vs_reference:
    the readings behind their limits."""
    out = {}
    for n, tile in REF_SHAPES:
        xr, xi = _planes(n)
        exact = _exact_pi(xr, xi)
        for variant in ("two-kernel", "fused"):
            rr, ri = _reference_bf16(variant, xr, xi, tile)
            pr, pi_ = _port_bf16(variant, xr, xi, tile)
            out[f"{variant} n={n} tile={tile}"] = (
                rel_err(rr, ri, exact.real, exact.imag),
                rel_err(pr, pi_, exact.real, exact.imag),
                rel_err(pr, pi_, rr, ri))
    for n, tile in REF_SHAPES:
        xr, xi = _planes(n)
        rr, ri = (np.asarray(a) for a in ref_pf.fft_pi_layout_pallas_rql(
            jnp.asarray(xr), jnp.asarray(xi), tile=tile, storage=BF16,
            interpret=True))
        pr, pi_ = cf.fft_pi_layout_cuda_rql(*_t(xr, xi), tile=tile,
                                            storage=BF16)
        exact = _exact_pi(xr, xi)
        out[f"rql n={n} tile={tile}"] = (
            rel_err(rr, ri, exact.real, exact.imag),
            rel_err(pr, pi_, exact.real, exact.imag), rel_err(pr, pi_, rr, ri))
    xr, xi = _planes(1024, (8, 1024), seed=1)
    rr, ri = (np.asarray(a) for a in ref_pf.fft_rows_pallas(
        jnp.asarray(xr), jnp.asarray(xi), storage=BF16, interpret=True))
    pr, pi_ = cf.fft_rows_cuda(*_t(xr, xi), storage=BF16)
    exact = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-1)
    out["rows 8 x 1024"] = (rel_err(rr, ri, exact.real, exact.imag),
                            rel_err(pr, pi_, exact.real, exact.imag),
                            rel_err(pr, pi_, rr, ri))
    return out


if __name__ == "__main__":
    # the readings behind the limits above:
    #   JAX_PLATFORMS=cpu python tests/test_torch_bf16.py
    for case, (ref, port, apart) in bf16_errors().items():
        print(f"{case}: reference {ref:.3e}, port {port:.3e} "
              f"({port / ref:.2f}x), apart {apart:.3e}")
