"""The port's direct DFT and phased einsum model
(``cs87project_msolano2_tpu_torch.models.direct_dft``) on the CPU, each
of the reference's tests/test_direct_dft.py cases held against the
reference's own function on the same seeded input, and numpy; the
``einsum`` backend's tube blocking against the reference's policy; the
products in full float32 with TF32 switched on globally."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.backends.jax_backend import (
    EINSUM_TUBE_ABS_MAX_S as REF_ABS_MAX_S,
)
from cs87project_msolano2_tpu.backends.jax_backend import (
    EINSUM_TUBE_MAX_PROGRAMS as REF_MAX_PROGRAMS,
)
from cs87project_msolano2_tpu.backends.jax_backend import (
    EINSUM_TUBE_MAX_S as REF_MAX_S,
)
from cs87project_msolano2_tpu.backends.jax_backend import (
    einsum_tube_kblock as ref_kblock,
)
from cs87project_msolano2_tpu.models import direct_dft as ref_dd
from cs87project_msolano2_tpu.models import pi_fft as ref_pi_fft
from cs87project_msolano2_tpu_torch.backends import torch_backend
from cs87project_msolano2_tpu_torch.backends.registry import get_backend
from cs87project_msolano2_tpu_torch.models import direct_dft as dd
from cs87project_msolano2_tpu_torch.models import pi_fft
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices
from cs87project_msolano2_tpu_torch.utils import verify

#: BASELINE config 1: float64 end to end, rel L2
CONFIG1_TOL = 1e-12
#: the einsum model (float32 products) vs the reference's and numpy,
#: rel L2 (the split3 budget)
EINSUM_TOL = 1e-5


def rand_c64(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64)


def rel_l2(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def planes(x, shape=None):
    xr = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
    if shape is not None:
        xr, xi = xr.reshape(shape), xi.reshape(shape)
    return xr, xi


def ref_planes(x, shape=None):
    xr = jnp.asarray(x.real.astype(np.float32))
    xi = jnp.asarray(x.imag.astype(np.float32))
    if shape is not None:
        xr, xi = xr.reshape(shape), xi.reshape(shape)
    return xr, xi


def cplx(yr, yi):
    return np.asarray(yr) + 1j * np.asarray(yi)


def test_config1_n1024_float64():
    x = rand_c64(1024, seed=1).astype(np.complex128)
    y = dd.dft_direct(x, dtype=np.complex128)
    assert y.dtype == np.complex128
    assert rel_l2(y, np.fft.fft(x)) <= CONFIG1_TOL
    ref = np.asarray(ref_dd.dft_direct(x, dtype=np.complex128))
    assert rel_l2(y, ref) <= CONFIG1_TOL


@pytest.mark.parametrize("n", [8, 256, 1024])
def test_dft_direct_vs_numpy(n):
    x = rand_c64(n, seed=2)
    got = dd.dft_direct(x, device="cpu").numpy()
    assert rel_l2(got, np.fft.fft(x.astype(np.complex128))) <= EINSUM_TOL
    assert rel_l2(got, np.asarray(ref_dd.dft_direct(x))) <= EINSUM_TOL


@pytest.mark.parametrize("p", [1, 4, 64])
def test_dft_direct_pi_layout_and_p_invariance(p):
    n = 1024
    x = rand_c64(n, seed=3)
    y = dd.dft_direct_pi(x, p, device="cpu").numpy()
    nat = verify.pi_layout_to_natural(y)
    assert rel_l2(nat, np.fft.fft(x.astype(np.complex128))) <= EINSUM_TOL
    assert rel_l2(y, np.asarray(ref_dd.dft_direct_pi(x, p))) <= EINSUM_TOL
    base = dd.dft_direct_pi(x, 1, device="cpu").numpy()
    assert np.allclose(y, base, atol=1e-5)


def test_pi_layout_matches_butterfly_models():
    n, p = 512, 8
    x = rand_c64(n, seed=4)
    butterfly = cplx(*pi_fft.pi_fft_pi_layout(*planes(x), p))
    einsum = dd.dft_direct_pi(x, p, device="cpu").numpy()
    assert rel_l2(einsum, butterfly) <= EINSUM_TOL
    ref = cplx(*jax.jit(lambda a, b: ref_pi_fft.pi_fft_pi_layout(a, b, p))(
        *ref_planes(x)))
    assert rel_l2(butterfly, ref) <= EINSUM_TOL


def test_dft_direct_pi_planes_matches_complex():
    n, p = 512, 8
    x = rand_c64(n, seed=5)
    got = cplx(*dd.dft_direct_pi_planes(*planes(x), p))
    assert rel_l2(got, dd.dft_direct_pi(x, p, device="cpu").numpy()) \
        <= EINSUM_TOL
    ref = cplx(*ref_dd.dft_direct_pi_planes(x.real, x.imag, p))
    assert rel_l2(got, ref) <= EINSUM_TOL


def test_max_n_guard():
    assert dd.MAX_N == ref_dd.MAX_N == 1 << 13
    with pytest.raises(ValueError, match="capped"):
        dd.dft_matrix(dd.MAX_N * 2)
    with pytest.raises(ValueError, match="capped"):
        ref_dd.dft_matrix(ref_dd.MAX_N * 2)
    assert np.array_equal(dd.dft_matrix(64), ref_dd.dft_matrix(64))


def test_einsum_backend_golden():
    res = get_backend("einsum", "cpu").run(verify.golden_input(), 4)
    nat = verify.pi_layout_to_natural(res.out)
    assert verify.max_abs_err(nat, verify.golden_expected()) < 1e-4
    assert get_backend("einsum", "cpu").golden_atol == 1e-4
    # phase timers that compose (the reference's nesting)
    assert res.funnel_ms > 0.0 and res.tube_ms > 0.0
    assert abs(res.funnel_ms + res.tube_ms - res.total_ms) < 1e-9


@pytest.mark.parametrize("n,p", [(64, 8), (1024, 1), (4096, 16),
                                 (16384, 64)])
def test_phased_einsum_matches_butterfly(n, p):
    x = rand_c64(n, seed=6)
    got = cplx(*dd.pi_dft_einsum_planes(*planes(x), p))
    butterfly = cplx(*pi_fft.pi_fft_pi_layout(*planes(x), p))
    assert rel_l2(got, butterfly) <= EINSUM_TOL
    rr, ri = jax.jit(lambda a, b: ref_dd.pi_dft_einsum_planes(a, b, p))(
        *ref_planes(x))
    assert rel_l2(got, cplx(rr, ri)) <= EINSUM_TOL


def test_funnel_einsum_is_the_funnel():
    """The polyphase identity: the funnel is a coefficient einsum."""
    n, p = 2048, 16
    x = rand_c64(n, seed=7)
    got = cplx(*dd.funnel_einsum_planes(*planes(x), p))
    assert got.shape == (p, n // p)
    assert rel_l2(got, cplx(*pi_fft.funnel(*planes(x), p))) <= EINSUM_TOL
    ref = cplx(*ref_dd.funnel_einsum_planes(*ref_planes(x), p))
    assert rel_l2(got, ref) <= EINSUM_TOL
    cr, ci = dd.funnel_coeff_planes(n, p)
    rcr, rci = ref_dd.funnel_coeff_planes(n, p)
    assert np.array_equal(cr, rcr) and np.array_equal(ci, rci)


def test_tube_einsum_scan_path_matches_dense():
    """Row blocks of the DIF matrix == the whole matrix at once."""
    n, p = 4096, 4  # s = 1024
    x = rand_c64(n, seed=8)
    sr, si = planes(x, (p, n // p))
    dense = cplx(*dd.tube_einsum_planes(sr, si, n, p, block=n // p))
    blocked = cplx(*dd.tube_einsum_planes(sr, si, n, p, block=64))
    assert np.max(np.abs(dense - blocked)) < 1e-3
    rr, ri = ref_dd.tube_einsum_planes(*ref_planes(x, (p, n // p)), n, p,
                                       block=64)
    assert rel_l2(blocked, cplx(rr, ri)) <= EINSUM_TOL


def test_einsum_capacity_guard():
    assert dd.COEF_MAX_ENTRIES == ref_dd.COEF_MAX_ENTRIES == 1 << 24
    assert dd.FULL_TABLE_MAX == ref_dd.FULL_TABLE_MAX == 1 << 20
    with pytest.raises(ValueError, match="p\\*n"):
        dd.funnel_coeff_planes(dd.COEF_MAX_ENTRIES, 4)
    with pytest.raises(ValueError, match="p\\*n"):
        ref_dd.funnel_coeff_planes(ref_dd.COEF_MAX_ENTRIES, 4)
    with pytest.raises(ValueError, match="capped"):
        dd.full_twiddle(dd.FULL_TABLE_MAX * 2)
    wr, wi = dd.full_twiddle(1024)
    rwr, rwi = ref_dd.full_twiddle(1024)
    assert np.array_equal(wr, rwr) and np.array_equal(wi, rwi)


def test_tube_hostblocked_matches_scan():
    n, p = 4096, 4  # s = 1024
    x = rand_c64(n, seed=9)
    sr, si = planes(x, (p, n // p))
    a = cplx(*dd.tube_einsum_planes(sr, si, n, p))
    b = cplx(*dd.tube_einsum_planes_hostblocked(sr, si, n, p, kblock=128))
    assert np.max(np.abs(a - b)) < 1e-3
    rr, ri = ref_dd.tube_einsum_planes_hostblocked(
        *ref_planes(x, (p, n // p)), n, p, kblock=128)
    assert rel_l2(b, cplx(rr, ri)) <= EINSUM_TOL
    with pytest.raises(ValueError, match="must divide"):
        dd.tube_einsum_planes_hostblocked(sr, si, n, p, kblock=96)


def test_hostblocked_full_pi_dft_vs_numpy():
    n, p = 4096, 2  # s = 2048
    kblock = 256
    x = rand_c64(n, seed=10)
    fr, fi = dd.funnel_einsum_planes(*planes(x), p)
    tr, ti = dd.tube_einsum_planes_hostblocked(fr, fi, n, p, kblock)
    y = cplx(tr, ti).reshape(n)
    ref = np.fft.fft(x.astype(np.complex128))[bit_reverse_indices(n)]
    assert rel_l2(y, ref) <= EINSUM_TOL
    rfr, rfi = ref_dd.funnel_einsum_planes(*ref_planes(x), p)
    block_fn = jax.jit(partial(ref_dd.tube_einsum_block, n=n, p=p,
                               kblock=kblock))
    rtr, rti = ref_dd.tube_einsum_planes_hostblocked(rfr, rfi, n, p, kblock,
                                                     block_fn=block_fn)
    assert rel_l2(y, cplx(rtr, rti).reshape(n)) <= EINSUM_TOL


def test_einsum_tube_kblock_policy():
    assert torch_backend.EINSUM_TUBE_MAX_S == REF_MAX_S
    assert torch_backend.EINSUM_TUBE_MAX_PROGRAMS == REF_MAX_PROGRAMS
    assert torch_backend.EINSUM_TUBE_ABS_MAX_S == REF_ABS_MAX_S == 1 << 17
    for k in range(10, 19):
        s = 1 << k
        assert torch_backend.einsum_tube_kblock(s) == ref_kblock(s), s
    assert torch_backend.einsum_tube_kblock(REF_MAX_S) is None
    for s in (1 << 15, 1 << 16, 1 << 17):
        kb = torch_backend.einsum_tube_kblock(s)
        assert kb is not None and s % kb == 0
        assert kb * s <= REF_MAX_S ** 2
        assert s // kb <= REF_MAX_PROGRAMS


def test_products_stay_float32_with_tf32_on(monkeypatch):
    """With TF32 switched on for the whole process, every product of the
    einsum model still runs with it off and the process's setting comes
    back after the call."""
    seen = []
    real_einsum = torch.einsum

    def spy(spec, *ops):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.get_float32_matmul_precision()))
        return real_einsum(spec, *ops)

    was_mode = torch.get_float32_matmul_precision()
    was_tf32 = torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(dd.torch, "einsum", spy)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        assert torch.get_float32_matmul_precision() != "highest"
        x = rand_c64(256, seed=11)
        dd.pi_dft_einsum_planes(*planes(x), 4)
        dd.dft_direct(x, device="cpu")
        assert seen and all(s == (False, "highest") for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(was_mode)
        torch.backends.cuda.matmul.allow_tf32 = was_tf32
