"""The port's constant-geometry (scan) tube on the CPU, held against the
reference's ``fft_stages_scan`` and ``pi_fft_pi_layout_scan`` (jitted on
the CPU), against numpy in complex128 and against the port's own stage
tube, mirroring the reference's tests/test_fft_property.py:82-120; and
the ``torch-scan`` / ``torch-unrolled`` backends against the reference's
``jax-scan`` / ``jax-unrolled``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.backends.registry import (
    get_backend as ref_get_backend,
)
from cs87project_msolano2_tpu.models import pi_fft as ref_pi_fft
from cs87project_msolano2_tpu_torch.backends.registry import get_backend
from cs87project_msolano2_tpu_torch.cli import make_input
from cs87project_msolano2_tpu_torch.models import pi_fft
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices

#: the port vs the reference: the same float32 stage arithmetic, cos and
#: sin of the same float32 angles in another library (a last-ulp
#: difference at most), rel L2
REF_TOL = 1e-6
#: whole transform vs numpy complex128, rel L2 (the split3 budget)
NUMPY_TOL = 1e-5


def rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def rel_l2(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def planes(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real)),
            torch.from_numpy(np.ascontiguousarray(x.imag)))


def cplx(yr, yi):
    return yr.numpy() + 1j * yi.numpy()


@pytest.mark.parametrize("n", [2, 8, 256, 4096])
def test_fft_stages_scan_vs_reference_and_numpy(n):
    x = rand(n, seed=8)
    got = cplx(*pi_fft.fft_stages_scan(*planes(x)))
    rr, ri = jax.jit(ref_pi_fft.fft_stages_scan)(jnp.asarray(x.real),
                                                 jnp.asarray(x.imag))
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    assert rel_l2(got, ref) <= REF_TOL
    nat = got[bit_reverse_indices(n)]
    assert rel_l2(nat, np.fft.fft(x.astype(np.complex128))) <= NUMPY_TOL


@pytest.mark.parametrize("n,p", [(256, 1), (256, 16), (4096, 64)])
def test_pi_fft_scan_vs_reference_and_unrolled(n, p):
    x = rand(n, seed=9)
    got = cplx(*pi_fft.pi_fft_pi_layout_scan(*planes(x), p))
    rr, ri = jax.jit(lambda a, b: ref_pi_fft.pi_fft_pi_layout_scan(a, b, p))(
        jnp.asarray(x.real), jnp.asarray(x.imag))
    assert rel_l2(got, np.asarray(rr) + 1j * np.asarray(ri)) <= REF_TOL
    unrolled = cplx(*pi_fft.pi_fft_pi_layout(*planes(x), p))
    assert rel_l2(got, unrolled) <= REF_TOL
    nat = got[bit_reverse_indices(n)]
    assert rel_l2(nat, np.fft.fft(x.astype(np.complex128))) <= NUMPY_TOL


def test_tube_scan_on_batched_segments_equals_the_stage_tube():
    """The scan tube over a batch of funnel outputs (leading dims kept)
    is the stage tube's transform."""
    n, p = 1 << 12, 8
    xr, xi = planes(rand((3, n), seed=10))
    fr, fi = pi_fft.funnel(xr, xi, p)
    a = cplx(*pi_fft.tube_scan(fr, fi, n, p))
    b = cplx(*pi_fft.tube(fr, fi, n, p))
    assert a.shape == (3, p, n // p)
    assert rel_l2(a, b) <= REF_TOL


@pytest.mark.parametrize("name,ref_name", [("torch-scan", "jax-scan"),
                                           ("torch-unrolled",
                                            "jax-unrolled")])
@pytest.mark.parametrize("p", [1, 8])
def test_backend_vs_reference_backend(name, ref_name, p):
    x = make_input(1 << 10, 0)
    got = get_backend(name, "cpu").run(x, p, fetch=True, timers=False)
    ref = ref_get_backend(ref_name).run(x, p, fetch=True, timers=False)
    assert rel_l2(got.out, ref.out) <= REF_TOL
    nat = got.out[bit_reverse_indices(1 << 10)]
    assert rel_l2(nat, np.fft.fft(x.astype(np.complex128))) <= NUMPY_TOL


def test_torch_and_torch_unrolled_are_one_path():
    """``torch`` takes the stage tube at every n, as ``torch-unrolled``
    (no compile ceiling to switch for): the same bits."""
    x = make_input(1 << 12, 3)
    a = get_backend("torch", "cpu").run(x, 16, timers=False).out
    b = get_backend("torch-unrolled", "cpu").run(x, 16, timers=False).out
    assert np.array_equal(a, b)
