"""The port's main path as a whole against the JAX package, on the CPU
(plain versions): the rql and rows compositions, the natural-order
APIs, the pi-FFT for several p, the backends' golden test and their
agreement with the reference's C core, the twiddle carry-over, the
plan ladder, the device rule, and the package's isolation from JAX."""

import importlib
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.backends.registry import \
    get_backend as ref_get_backend
from cs87project_msolano2_tpu.models import pi_fft as ref_pi
from cs87project_msolano2_tpu.ops import pallas_fft as ref_pf
from cs87project_msolano2_tpu.ops.twiddle import twiddle_tables as ref_tw
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.backends.registry import get_backend
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.cli import make_input
from cs87project_msolano2_tpu_torch.models import fft as F
from cs87project_msolano2_tpu_torch.models import pi_fft
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.ops.twiddle import tables_from_reference
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.utils import verify

ref_fft = importlib.import_module("cs87project_msolano2_tpu.models.fft")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# split3 budget: the reference's MXU tail is ~4e-6 from exact, the
# port's fp32 butterflies ~1e-7
SPLIT3_TOL = 1e-5
# same stage decomposition and float32 ops on both sides
STAGE_TOL = 1e-6


def _complex(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(a, b):
    a = np.asarray(a, dtype=np.complex128)
    b = np.asarray(b, dtype=np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _planes(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real)),
            torch.from_numpy(np.ascontiguousarray(x.imag)))


def test_rql_vs_reference_rql():
    n, tile = 1 << 14, 1 << 12
    x = _complex(41, (n,))
    yr, yi = cf.fft_pi_layout_cuda_rql(*_planes(x), tile=tile)
    rr, ri = ref_pf.fft_pi_layout_pallas_rql(
        jnp.asarray(x.real), jnp.asarray(x.imag), tile=tile)
    ours = yr.numpy() + 1j * yi.numpy()
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    exact = verify.pi_layout_to_natural(np.fft.fft(x.astype(np.complex128)))
    assert _rel(ours, ref) <= SPLIT3_TOL
    assert _rel(ours, exact) <= SPLIT3_TOL


@pytest.mark.parametrize("shape", [(16, 2048), (1 << 17,)])
def test_fft_vs_reference_and_numpy(shape):
    x = _complex(42, shape)
    variant = plans.plan_for(shape, device="cpu").variant
    assert variant == ("rows" if len(shape) == 2 else "rql")
    ours = F.fft(x, device="cpu").numpy()
    ref = np.asarray(ref_fft.fft(jnp.asarray(x)))
    exact = np.fft.fft(x.astype(np.complex128))
    assert ours.dtype == np.complex64 and ours.shape == shape
    assert _rel(ours, ref) <= SPLIT3_TOL
    assert _rel(ours, exact) <= SPLIT3_TOL


@pytest.mark.parametrize("shape", [(16, 2048), (1 << 17,)])
@pytest.mark.parametrize("natural", [True, False])
def test_fft_planes_fast_vs_reference(shape, natural):
    x = _complex(43, shape)
    yr, yi = F.fft_planes_fast(x.real, x.imag, natural=natural,
                               device="cpu")
    exact = np.fft.fft(x.astype(np.complex128))
    if not natural:
        exact = verify.pi_layout_to_natural(exact)
    if len(shape) == 2:
        rr, ri = ref_fft.fft_planes_fast(jnp.asarray(x.real),
                                         jnp.asarray(x.imag),
                                         natural=natural)
        ref = np.asarray(rr) + 1j * np.asarray(ri)
        assert _rel(yr.numpy() + 1j * yi.numpy(), ref) <= SPLIT3_TOL
    assert _rel(yr.numpy() + 1j * yi.numpy(), exact) <= SPLIT3_TOL


def test_inverse_round_trips():
    x = _complex(44, (4, 1024))
    back = F.ifft(F.fft(x, device="cpu")).numpy()
    assert _rel(back, x) <= SPLIT3_TOL
    yr, yi = F.fft_planes_fast(x.real, x.imag, device="cpu")
    br, bi = F.ifft_planes_fast(yr, yi)
    assert _rel(br.numpy() + 1j * bi.numpy(), x) <= SPLIT3_TOL
    ir, ii = F.ifft_planes(*F.fft_planes(x.real, x.imag, device="cpu"))
    assert _rel(ir.numpy() + 1j * ii.numpy(), x) <= SPLIT3_TOL


def test_fft2_and_fftn_vs_numpy():
    x = _complex(45, (2, 128, 256))
    assert _rel(F.fft2(x, device="cpu").numpy(),
                np.fft.fft2(x.astype(np.complex128))) <= SPLIT3_TOL
    assert _rel(F.fftn(x, device="cpu").numpy(),
                np.fft.fftn(x.astype(np.complex128))) <= SPLIT3_TOL


@pytest.mark.parametrize("p", [1, 4, 32])
def test_pi_fft_vs_reference(p):
    n = 256
    x = _complex(46, (n,))
    yr, yi = pi_fft.pi_fft_pi_layout(*_planes(x), p)
    rr, ri = ref_pi.pi_fft_pi_layout(jnp.asarray(x.real),
                                     jnp.asarray(x.imag), p)
    assert rel_err(yr, yi, rr, ri) <= STAGE_TOL


@pytest.mark.parametrize("p", [1, 4, 32])
def test_pi_fft_cuda_path_vs_reference_pallas(p):
    n = 4096
    x = _complex(47, (n,))
    yr, yi = cf.pi_fft_pi_layout_cuda(*_planes(x), p)
    rr, ri = ref_pf.pi_fft_pi_layout_pallas(jnp.asarray(x.real),
                                            jnp.asarray(x.imag), p)
    assert rel_err(yr, yi, rr, ri) <= SPLIT3_TOL


@pytest.mark.parametrize("p", [1, 2, 4])
def test_funnel_single_matches_funnel_rows(p):
    x = _complex(48, (256,))
    xr, xi = _planes(x)
    fr, fi = pi_fft.funnel(xr, xi, p)
    for pi in range(p):
        sr, si = pi_fft.funnel_single(xr, xi, pi, p)
        assert torch.equal(sr, fr[pi]) and torch.equal(si, fi[pi])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_golden_exact(backend, p):
    res = get_backend(backend, "cpu").run(verify.golden_input(), p)
    assert verify.golden_check_exact(verify.pi_layout_to_natural(res.out))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_cli_golden_mode(backend, capsys):
    assert cli_main(["-t", "-b", backend, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("PASSED") == 4


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("p", [1, 4, 32])
def test_backend_vs_reference_serial(backend, n, p):
    x = make_input(n, seed=11)
    try:
        ref = ref_get_backend("serial").run(x, p).out
    except RuntimeError as e:  # libpifft.so could not be built here
        pytest.skip(f"reference C core unavailable: {e}")
    res = get_backend(backend, "cpu").run(x, p)
    assert res.total_ms == pytest.approx(res.funnel_ms + res.tube_ms)
    assert verify.rel_err(res.out, ref.astype(np.complex128)) < 1e-6


def test_cli_tsv_and_verify(capsys):
    assert cli_main(["-n", "4096", "-p", "4", "-b", "cuda", "--device",
                     "cpu", "--verify"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "n\tp\ttotal_ms\tfunnel_ms\ttube_ms"
    assert out[1].split("\t")[:2] == ["4096", "4"]
    assert len(out[1].split("\t")) == 5


def test_tables_carry_over():
    n = 1 << 12
    x = _complex(49, (n,))
    tables = tables_from_reference(ref_tw(n), "cpu")
    with_tables = F.fft(x, tables=tables, device="cpu")
    # the rows plan's plain tile DIF runs the same stage_full levels on
    # the same table values: bit-identical
    assert torch.equal(with_tables, F.fft(x, device="cpu"))
    ref = np.asarray(ref_fft.fft(jnp.asarray(x), tables=ref_tw(n)))
    assert _rel(with_tables.numpy(), ref) <= STAGE_TOL


def test_static_default_crossovers():
    key = plans.make_key(4096, (4096,), device="cpu")
    assert ladder.static_default(key) == ("rows", {})
    variant, params = ladder.static_default(
        plans.make_key(1 << 20, device="cpu"))
    assert variant == "rql" and params["tile"] <= cf.MAX_SMEM_TILE
    assert ladder.static_default(plans.make_key(64, device="cpu")) == \
        ("stages", {})
    assert ladder.static_default(
        plans.make_key(1 << 17, (2,), device="cpu"))[0] == "stages"
    with pytest.raises(ValueError, match="pi-layout"):
        ladder.static_default(plans.make_key(64, layout="pi",
                                             device="cpu"))


def test_plans_are_memoized():
    a = plans.plan_for((8, 256), device="cpu")
    assert a is plans.plan_for((8, 256), device="cpu")
    assert (a.variant, a.params, a.device) == ("rows", {}, "cpu")


@pytest.mark.parametrize("params", [{"tile": 1 << 15, "cb": None},
                                   {"tile": 1 << 14, "cb": 1024}])
def test_over_budget_plan_params_raise_at_build(params):
    key = plans.make_key(1 << 20, device="cpu")
    with pytest.raises(ValueError, match="limit 232448"):
        ladder.build_executor(key, "rql", params)


@pytest.mark.parametrize("variant", ("bluestein", "rader", "mixedradix"))
def test_unported_variants_raise(variant):
    # the any-length variants are served since their slice: what they
    # still refuse is pi layout, which a power-of-two n alone has
    key = plans.make_key(1 << 20, layout="pi", device="cpu")
    with pytest.raises(ValueError, match="natural order only"):
        ladder.build_executor(key, variant, {})


def test_unported_keys_raise():
    # bf16 storage is served now, on the rows kernel's bf16 instantiation
    assert plans.plan(1024, precision="bf16",
                      device="cpu").storage_bytes() == 2
    # so are any-length n and the real domains (tests/test_torch_anylen.py,
    # tests/test_torch_real.py)
    assert plans.plan(1000, device="cpu").variant == "mixedradix"
    assert plans.plan(1024, domain="r2c", device="cpu").variant == "rows"
    with pytest.raises(ValueError, match="power-of-two"):
        plans.plan(1000, layout="pi", device="cpu")
    with pytest.raises(ValueError, match="natural layout"):
        plans.plan(1024, layout="pi", domain="r2c", device="cpu")
    with pytest.raises(ValueError):
        plans.make_key(1024, backend="tpu")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_backends_raise_without_gpu(no_gpu, backend):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_backend(backend).run(make_input(256), 4)
    assert get_backend(backend, "cpu").run(make_input(256), 4).out \
        is not None


def test_plan_execute_and_fft_raise_without_gpu(no_gpu):
    x = _complex(50, (256,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plans.plan(256).execute(x.real, x.imag)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.fft(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["-n", "256", "-p", "2"])
    # tensors already on the CPU stay there: the caller asked for it
    yr, _ = plans.plan(256).execute(*_planes(x))
    assert yr.device.type == "cpu"


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cs87project_msolano2_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.') if not m.name.endswith('__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 21, mods\n"
        "new = ['utils.roofline', 'bench', 'harness.run_experiments', "
        "'analyze.records', 'resilience.inject', 'resilience.retry', "
        "'resilience.journal', 'resilience.degrade', 'backends.cpu', "
        "'models.direct_dft', 'utils.debug', 'probes', "
        "'resilience.watchdog', 'parallel.collectives', 'parallel.mesh', "
        "'parallel.multihost', 'parallel.pi_shard', 'parallel.batched', "
        "'parallel.fft2d', 'parallel.poisson3d', 'parallel.escape', "
        "'parallel.checks', 'apps.pde', "
        "'harness.run_sharded_experiments', 'apps.spectral', "
        "'apps.stream', 'apps.cli', 'obs', 'obs.events', 'obs.spans', "
        "'obs.metrics', 'obs.export', 'obs.trace', 'obs.profiler', "
        "'obs.http', 'obs.slomon', 'utils.tracing']\n"
        "assert all(pkg.__name__ + '.' + m in mods for m in new), mods\n"
        "from cs87project_msolano2_tpu_torch.utils.roofline import (\n"
        "    SPECTRAL_OPS, charge_spectral_traffic,\n"
        "    spectral_hbm_bytes, spectral_min_hbm_bytes,\n"
        "    spectral_roofline_utilization)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'cs87project_msolano2_tpu' or "
        "m.startswith('cs87project_msolano2_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_no_demotions_sees_a_demotion_past_a_cache_clear():
    """chip_smoke's demotion check fails on a demotion made before the
    plan cache was cleared (as phase 12 clears it) with obs disarmed,
    passes with none, and gives the cache its own ``memoize`` back."""
    from cs87project_msolano2_tpu_torch import obs
    from cs87project_msolano2_tpu_torch.resilience import inject

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    memoize = plans.cache.memoize
    assert not obs.enabled()
    plans.cache.clear(memory=True)
    try:
        smoke.no_demotions("healthy", smoke.watch_demotions())
        assert plans.cache.memoize is memoize
        restore = smoke.watch_demotions()
        rng = np.random.default_rng(0)
        xr, xi = (rng.standard_normal(1 << 9).astype(np.float32)
                  for _ in range(2))
        with inject("tube", "capacity"):
            plan = plans.get_plan(plans.make_key(1 << 9, layout="pi",
                                                 device="cpu"), "cpu")
            plan.execute(xr, xi)
        assert plan.degraded
        plans.cache.clear(memory=True)
        with pytest.raises(AssertionError, match="a plan demoted"):
            smoke.no_demotions("planted", restore)
        assert plans.cache.memoize is memoize
    finally:
        plans.cache.memoize = memoize
        plans.cache.clear(memory=True)


def test_chip_smoke_imports_no_jax_and_refuses_the_cpu():
    """chip_smoke.py names no module of JAX or of the JAX package, and
    with no card it exits non-zero and prints no result."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    bad = [m for m in names if m.split(".")[0] in
           ("jax", "cs87project_msolano2_tpu")]
    assert not bad, bad
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == ""
