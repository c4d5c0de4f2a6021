"""The planned tube (``models.pi_fft.resolve_tube_plan`` and
``tube_planned``) on the CPU: every case of the reference's resolution
policy, the ``resolve`` injection site (on CPU planes CAPACITY and
PERMANENT give the stage tube with one warning and TRANSIENT re-raises;
for the card every fault re-raises), the batch of segments above 2^16
that the port serves by ``rql`` where the reference takes its stage
tube, and the planned tube against the reference's ``tube_planned`` and
numpy at (p, s) = (4, 2^10), (4, 2^17) and on a 1-D segment of 2^17."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.models import pi_fft as ref_pi_fft
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.models import pi_fft
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans.core import Plan
from cs87project_msolano2_tpu_torch.resilience import (
    FaultKind,
    InjectedFault,
    classify,
    inject,
)

CPU = "cpu"
#: the planned tube vs the reference's, rel L2: the split3 budget both
#: are held to.  The reference's rows and rql run their last levels as a
#: split3 matmul tail (16 bits of each operand): 3.6e-6 and 3.7e-6 of
#: numpy on these inputs, where the port's butterflies read 1.3e-7 and
#: 1.7e-7
REF_TOL = 1e-5
#: the planned tube vs the stage tube on the same segment: float32
#: butterflies both, rel L2
STAGE_TOL = 1e-6
#: vs numpy complex128, rel L2 (the split3 budget)
NUMPY_TOL = 1e-5
WARNING = "DEGRADED to the stage tube"


@pytest.fixture(autouse=True)
def fresh_memory_cache(monkeypatch):
    monkeypatch.delenv("PIFFT_FAULT", raising=False)
    plan_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)


def rel_l2(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def resolve(shape, **kw):
    return pi_fft.resolve_tube_plan(shape, device=CPU, **kw)


def test_false_pins_the_stage_tube_and_a_plan_passes_through():
    assert resolve((4, 1024), plan=False) is None
    plan = plans.plan_for((1 << 17,), layout="pi", device=CPU)
    assert resolve((4, 1024), plan=plan) is plan


def test_min_segment():
    assert resolve((1 << 17,), min_segment=1 << 17) is None
    assert resolve((1 << 17,), min_segment=1 << 16).variant == "rql"


@pytest.mark.parametrize("shape,variant", [
    ((4, 1024), "rows"), ((1024,), "rows"), ((1 << 17,), "rql"),
    ((1 << 21,), "fourstep"), ((1 << 25,), "sixstep")])
def test_kernel_plans(shape, variant):
    plan = resolve(shape)
    assert plan.variant == variant and plan.key.layout == "pi"
    assert plan.key.device_kind == "cpu"


@pytest.mark.parametrize("shape", [(8, 64), (32,), (2, 64)])
def test_no_kernel_for_the_shape_gives_the_stage_tube(shape):
    """Segments shorter than the row kernel's least tile: plan_for
    raises ValueError in pi layout."""
    with pytest.raises(ValueError):
        plans.plan_for(shape, layout="pi", device=CPU)
    assert resolve(shape) is None


@pytest.mark.parametrize("shape", [(4, 1 << 17), (2, 1 << 20)])
def test_a_batch_of_long_segments_takes_rql(shape):
    """A batch of segments above 2^16: rql over the batch, where the
    reference's plan_for raises and its tube_planned takes the stage
    tube (a deliberate difference: no card planes reach the plain
    stage tube for want of a plan).  Natural order keeps the stage
    path."""
    plan = resolve(shape)
    assert plan.variant == "rql" and plan.key.batch == shape[:-1]
    assert plans.plan_for(shape, layout="natural",
                          device=CPU).variant == "stages"


def test_the_stages_variant_gives_the_stage_tube(monkeypatch):
    key = plans.make_key(1 << 17, layout="pi", device=CPU)
    monkeypatch.setattr(plans, "plan_for", lambda *a, **k: Plan(
        key=key, variant="stages", params={}))
    assert resolve((1 << 17,)) is None


@pytest.mark.parametrize("kind", ["capacity", "permanent"])
def test_resolve_fault_degrades_with_one_warning(kind, capsys):
    """On CPU planes: the reference's policy."""
    with inject("resolve", kind) as spec:
        assert resolve((1 << 17,)) is None
    assert spec.fired == 1
    err = capsys.readouterr().err
    assert err.count(WARNING) == 1 and kind in err


@pytest.mark.parametrize("kind", ["capacity", "permanent", "transient"])
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_resolve_fault_on_the_card_raises(kind, device, capsys):
    """For card planes every resolution fault re-raises: the stage tube
    is a plain version, which card planes never fall back to.  The
    fault fires before the plan layer is asked, so no card is needed."""
    with inject("resolve", kind) as spec:
        with pytest.raises(InjectedFault) as e:
            pi_fft.resolve_tube_plan((1 << 17,), device=device)
    assert spec.fired == 1 and classify(e.value).value == kind
    assert WARNING not in capsys.readouterr().err


def test_resolve_transient_fault_reraises(capsys):
    with inject("resolve", "transient"):
        with pytest.raises(InjectedFault) as e:
            resolve((1 << 17,))
    assert classify(e.value) is FaultKind.TRANSIENT
    assert WARNING not in capsys.readouterr().err


def test_resolve_fault_from_the_environment(monkeypatch, capsys):
    """``PIFFT_FAULT=resolve:capacity:1.0:1``: the first resolution
    takes the stage tube with one warning, the next a kernel again."""
    monkeypatch.setenv("PIFFT_FAULT", "resolve:capacity:1.0:1")
    n, p = 1 << 19, 4
    rng = np.random.default_rng(3)
    sr, si = (torch.from_numpy(rng.standard_normal(n // p)
                               .astype(np.float32)) for _ in range(2))
    a = pi_fft.tube_planned(sr, si, n, p)
    assert capsys.readouterr().err.count(WARNING) == 1
    b = pi_fft.tube_planned(sr, si, n, p)
    assert WARNING not in capsys.readouterr().err
    stage = pi_fft.tube(sr, si, n, p)
    assert all(torch.equal(u, v) for u, v in zip(a, stage))
    assert rel_l2(b[0].numpy() + 1j * b[1].numpy(),
                  stage[0].numpy() + 1j * stage[1].numpy()) <= STAGE_TOL


def _segments_vs_reference(n, p, batched):
    """(port, reference, numpy) pi-layout outputs of the funnel then the
    planned tube: all p segments at once (batched) or processor 2's
    segment alone through funnel_single (the sharded path's shape)."""
    rng = np.random.default_rng(n + p)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    xr = torch.from_numpy(np.ascontiguousarray(x.real))
    xi = torch.from_numpy(np.ascontiguousarray(x.imag))
    jr, ji = jnp.asarray(x.real), jnp.asarray(x.imag)
    full = np.fft.fft(x.astype(np.complex128))[bit_reverse_indices(n)]
    s = n // p
    if batched:
        fr, fi = pi_fft.funnel(xr, xi, p)
        rr, ri = ref_pi_fft.funnel(jr, ji, p)
        want = full.reshape(p, s)
    else:
        fr, fi = pi_fft.funnel_single(xr, xi, 2, p)
        rr, ri = ref_pi_fft.funnel_single(jr, ji, 2, p)
        want = full[2 * s:3 * s]
    yr, yi = pi_fft.tube_planned(fr, fi, n, p)
    zr, zi = ref_pi_fft.tube_planned(rr, ri, n, p)
    return (yr.numpy() + 1j * yi.numpy(),
            np.asarray(zr) + 1j * np.asarray(zi), want)


@pytest.mark.parametrize("n,p,batched,variant", [
    (1 << 12, 4, True, "rows"), (1 << 19, 4, True, "rql"),
    (1 << 19, 4, False, "rql")])
def test_tube_planned_vs_reference_and_numpy(n, p, batched, variant):
    shape = (p, n // p) if batched else (n // p,)
    assert resolve(shape).variant == variant
    got, ref, want = _segments_vs_reference(n, p, batched)
    assert got.shape == want.shape
    assert rel_l2(got, ref) <= REF_TOL
    assert rel_l2(got, want) <= NUMPY_TOL
