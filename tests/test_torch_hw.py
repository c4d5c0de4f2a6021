"""The ``gpu`` and ``cpu-native`` plan backends and the device inventory
on the CPU (plain versions), mirroring the reference's tests/test_hw.py:
the cpu-native family (its ceiling's environment override, the p race
capacity first, static defaults, executors against numpy in both
layouts and against the reference's rung, the build error with no
numpy stand-in, the host-clock race); the twiddle stack
bit-identical to the JAX package's, the gpu-rows plain version against
the reference's ``fft_rows_gpu`` (interpret mode) and numpy float64, the
kernel's blocking rules, the backend's candidates, static defaults and
executors, the backend axis in the plan keys and the store (winners kept
per backend, with an injected timer), ``hw probe`` and the roofline's
gpu-rows carries.  The kernel itself runs in ``test_torch_cuda.py``."""

import json

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu.hw import inventory as ref_inventory
from cs87project_msolano2_tpu.hw import lowering as ref_lowering
from cs87project_msolano2_tpu.plans.core import PlanKey as RefPlanKey
from cs87project_msolano2_tpu_torch import plans
from cs87project_msolano2_tpu_torch.backends.cpu import num_cores
from cs87project_msolano2_tpu_torch.cli import main as cli_main
from cs87project_msolano2_tpu_torch.hw import inventory, lowering
from cs87project_msolano2_tpu_torch.ops import cuda_fft as cf
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices
from cs87project_msolano2_tpu_torch.ops.precision import rel_err
from cs87project_msolano2_tpu_torch.plans import ladder
from cs87project_msolano2_tpu_torch.plans import cache as plan_cache
from cs87project_msolano2_tpu_torch.plans.core import (
    BACKENDS,
    Plan,
    PlanKey,
)
from cs87project_msolano2_tpu_torch.utils import roofline

CPU = torch.device("cpu")
CARD = "NVIDIA H100 80GB HBM3"
# the same float32 stage arithmetic as the reference's kernel body, in
# another framework (FMA contraction may differ)
FP32_TOL = 1e-6
# whole transform vs float64 numpy: the split3 budget
SPLIT3_TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_memory_cache():
    plan_cache.clear(memory=True, disk=False)
    yield
    plan_cache.clear(memory=True, disk=False)


@pytest.fixture
def plan_cache_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path / "cache"))
    yield tmp_path


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def gpu_key(n=256, layout="pi", batch=(), device_kind="cpu", **kw):
    return PlanKey(device_kind=device_kind, n=n, batch=batch, layout=layout,
                   backend="gpu", **kw)


# ------------------------------------------------------ the twiddle stack


@pytest.mark.parametrize("n", [2, 8, 256, 1 << 12])
def test_twiddle_stack_bit_identical(n):
    mine = lowering.twiddle_stack(n)
    theirs = ref_lowering._twiddle_stack(n)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape == (n.bit_length() - 1, max(n // 2, 1))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    dev = lowering.device_twiddle_stack(n, CPU)
    assert all(torch.equal(d, torch.from_numpy(m)) for d, m in zip(dev, mine))


# ------------------------------------------------------------ gpu-rows


@pytest.mark.parametrize("n", [2, 8, 256, 1024])
@pytest.mark.parametrize("rows,block_rows", [(1, None), (8, None), (8, 8)])
def test_fft_rows_gpu_plain_vs_reference(n, rows, block_rows):
    xr, xi = _planes(60 + n, (rows, n))
    ref_r, ref_i = ref_lowering.fft_rows_gpu(xr, xi, block_rows=block_rows,
                                             interpret=True)
    yr, yi = lowering.fft_rows_gpu_plain(*_t(xr, xi))
    assert rel_err(yr, yi, np.asarray(ref_r), np.asarray(ref_i)) <= FP32_TOL
    # the kernel's wrapper takes the same plain version for CPU tensors
    kr, ki = lowering.fft_rows_gpu(*_t(xr, xi), block_rows=block_rows)
    assert torch.equal(kr, yr) and torch.equal(ki, yi)


@pytest.mark.parametrize("n", [1 << 15, 1 << 17])
def test_fft_rows_gpu_plain_vs_numpy_long_rows(n):
    # rows the kernel runs on a cluster of 2 and 8 blocks
    xr, xi = _planes(61, (2, n))
    yr, yi = lowering.fft_rows_gpu_plain(*_t(xr, xi))
    exact = np.fft.fft(xr.astype(np.complex128) + 1j * xi, axis=-1)
    exact = exact[:, bit_reverse_indices(n)]
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


def test_fft_rows_gpu_keeps_leading_axes():
    xr, xi = _planes(62, (2, 3, 64))
    yr, yi = lowering.fft_rows_gpu(*_t(xr, xi))
    assert yr.shape == (2, 3, 64)
    flat = lowering.fft_rows_gpu_plain(*_t(xr.reshape(6, 64),
                                           xi.reshape(6, 64)))
    assert torch.equal(yr.reshape(6, 64), flat[0])


def test_gpu_rows_blocking():
    # automatic: a power of two dividing the rows, up to 1024 points
    assert cf.gpu_rows_blocking(4096, 4096) == 1
    assert cf.gpu_rows_blocking(8, 16) == 8
    assert cf.gpu_rows_blocking(96, 16) == 32
    assert cf.gpu_rows_blocking(3, 2) == 1
    assert cf.gpu_rows_blocking(64, 1 << 18) == 1
    # long rows run one after the other: any dividing block_rows
    assert cf.gpu_rows_blocking(64, 1 << 18, 8) == 8
    assert cf.gpu_rows_blocking(8, 1 << 11, 8) == 8
    with pytest.raises(ValueError, match="limit 232448"):
        cf.gpu_rows_blocking(4096, 4096, 8)
    with pytest.raises(ValueError, match="dividing rows=12"):
        cf.gpu_rows_blocking(12, 64, 8)
    with pytest.raises(ValueError, match="power of two"):
        cf.gpu_rows_blocking(12, 64, 3)
    for n in (1, 3, 1 << 19):
        with pytest.raises(ValueError, match="power-of-two 2 <= n"):
            cf.gpu_rows_blocking(1, n)


@pytest.mark.parametrize("n,K", [(2, 1), (1 << 14, 1), (1 << 15, 2),
                                 (1 << 16, 4), (1 << 17, 8), (1 << 18, 16)])
def test_gpu_rows_cluster_choice(n, K):
    # rows one block holds run alone; a longer row goes on a cluster of
    # one 2^14-point segment a block, which walks block_rows rows
    assert cf.gpu_rows_cluster_size(n) == K
    assert cf.gpu_rows_blocking(64, n) == (1 if K > 1 else
                                           min(64, max(1024 // n, 1)))
    if K > 1:
        assert cf.gpu_rows_blocking(64, n, 4) == 4
        with pytest.raises(ValueError, match="dividing rows=6"):
            cf.gpu_rows_blocking(6, n, 4)


def test_gpu_rows_refuses_a_card_without_the_cluster(monkeypatch):
    # a card that holds no cluster of K blocks refuses before launch,
    # naming n and K; nothing else runs in the kernel's place ("meta"
    # tensors stand for planes on a card: no data, no CPU fallback)
    n = 1 << 18
    monkeypatch.setattr(cf, "gpu_rows_max_clusters", lambda device, n: 0)
    meta = torch.device("meta")
    xr, xi = torch.empty(2, n, device=meta), torch.empty(2, n, device=meta)
    stack = [torch.empty(18, n // 2, device=meta) for _ in range(2)]
    before = cf.gpu_rows.launches
    with pytest.raises(ValueError, match=r"cluster of K=16 .*n=262144"):
        cf.gpu_rows(xr, xi, *stack)
    assert cf.gpu_rows.launches == before


def test_gpu_rows_checks_its_stack():
    xr, xi = _t(*_planes(63, (2, 64)))
    with pytest.raises(ValueError, match="operand shape"):
        cf.gpu_rows(xr, xi, *lowering.device_twiddle_stack(128, CPU))


# ------------------------------------------------------- the ladder


def test_gpu_candidates_rows_and_stages():
    cands = ladder.candidates(gpu_key(256))
    assert ("gpu-rows", {"block_rows": None}) in cands
    # pi layout: the stage rung (natural order only) must not race
    assert all(v != "gpu-stages" for v, _ in cands)
    nat = ladder.candidates(gpu_key(256, layout="natural"))
    assert ("gpu-stages", {}) in nat
    # batched rows divisible by 8 unlock the blocked kernel entry
    batched = ladder.candidates(gpu_key(256, batch=(8,)))
    assert ("gpu-rows", {"block_rows": 8}) in batched
    # past the kernel's bound only the stage path is left
    assert ladder.candidates(gpu_key(1 << 20, layout="natural")) == \
        [("gpu-stages", {})]


@pytest.mark.parametrize("n,layout,batch", [
    (256, "pi", ()), (256, "natural", (8,)), (1 << 18, "natural", ()),
    (1 << 20, "natural", ()), (1 << 20, "pi", ()), (4096, "natural", (4096,))])
def test_candidates_match_the_reference(n, layout, batch):
    # the reference's names: gpu-jnp is the port's gpu-stages
    ref = ref_lowering.candidates(RefPlanKey(
        device_kind="NVIDIA H100", n=n, batch=batch, layout=layout,
        backend="gpu"))
    ref = [("gpu-stages" if v == "gpu-jnp" else v, p) for v, p in ref]
    assert ladder.candidates(gpu_key(n, layout, batch)) == ref


def test_non_pow2_and_unported_keys_raise():
    with pytest.raises(ValueError, match="power-of-two"):
        ladder.candidates(gpu_key(100, layout="natural"))
    with pytest.raises(ValueError, match="power-of-two"):
        ladder.static_default(gpu_key(100, layout="natural"))
    # an even-n real key rides the half-length c2c subkey; odd n has no
    # gpu rung
    assert ladder.static_default(gpu_key(512, layout="natural",
                                         domain="r2c")) == \
        ladder.static_default(gpu_key(256, layout="natural"))
    with pytest.raises(ValueError, match="power-of-two"):
        ladder.static_default(gpu_key(511, layout="natural", domain="r2c"))
    # a bf16 gpu key is served as the reference serves it: float32
    # gpu-rows (tests/test_torch_bf16.py compares the two packages)
    assert ladder.candidates(gpu_key(256, precision="bf16")) == \
        ladder.candidates(gpu_key(256))


@pytest.mark.parametrize("n,layout,batch,kind,want", [
    (256, "pi", (), "cpu", "gpu-rows"),
    (4096, "natural", (4096,), "cpu", "gpu-rows"),
    (1 << 14, "natural", (), "cpu", "gpu-rows"),
    # past GPU_ROWS_STATIC_MAX_N only a key naming a card gets the kernel
    (1 << 18, "natural", (64,), "cpu", "gpu-stages"),
    (1 << 18, "natural", (64,), CARD, "gpu-rows"),
    (1 << 18, "pi", (64,), "cpu", "gpu-rows"),
    (1 << 20, "natural", (), CARD, "gpu-stages"),
    (1, "natural", (), CARD, "gpu-stages")])
def test_static_defaults(n, layout, batch, kind, want):
    key = gpu_key(n, layout, batch, device_kind=kind)
    assert ladder.static_default(key) == (
        want, {"block_rows": None} if want == "gpu-rows" else {})
    ref = ref_lowering.static_default(RefPlanKey(
        device_kind="cpu-interpret" if kind == "cpu" else kind, n=n,
        batch=batch, layout=layout, backend="gpu"))
    assert ref[0] == ("gpu-jnp" if want == "gpu-stages" else want)


def test_pi_layout_past_the_kernel_raises():
    with pytest.raises(ValueError, match="no gpu rung serves it"):
        ladder.static_default(gpu_key(1 << 20, device_kind=CARD))
    with pytest.raises(ValueError, match="no gpu rung serves it"):
        plans.plan_for((1 << 20,), layout="pi", backend="gpu", device="cpu")


def test_plan_for_backend_default_is_unchanged():
    # the cuda family still serves the default plan_for exactly as before
    assert plans.plan_for((4096, 4096), device="cpu").variant == "rows"
    assert plans.plan_for((1 << 20,), device="cpu").variant == "rql"
    assert plans.plan_for((4096, 4096), device="cpu").key.backend == "cuda"
    gpu = plans.plan_for((4096, 4096), backend="gpu", device="cpu")
    assert gpu.variant == "gpu-rows" and gpu.key.backend == "gpu"
    assert plans.plan_for((1 << 20,), backend="gpu",
                          device="cpu").variant == "gpu-stages"


def test_gpu_executor_refuses_what_the_kernel_cannot_take():
    key = gpu_key(4096, "natural", (4096,))
    with pytest.raises(ValueError, match="limit 232448"):
        ladder.build_executor(key, "gpu-rows", {"block_rows": 8})
    with pytest.raises(ValueError, match="natural order"):
        ladder.build_executor(gpu_key(256), "gpu-stages", {})
    with pytest.raises(ValueError, match="unknown gpu plan variant 'rql'"):
        ladder.build_executor(gpu_key(256), "rql", {})


@pytest.mark.parametrize("layout", ["pi", "natural"])
@pytest.mark.parametrize("shape", [(256,), (8, 64), (2, 1 << 15)])
def test_gpu_plan_executes_with_numpy_parity(layout, shape):
    key = plans.make_key(shape[-1], shape[:-1], layout=layout,
                         backend="gpu", device="cpu")
    plan = Plan(key, "gpu-rows", {"block_rows": None})
    xr, xi = _planes(64, shape)
    yr, yi = plan.execute(xr, xi)
    exact = np.fft.fft(xr.astype(np.complex128) + 1j * xi, axis=-1)
    if layout == "pi":
        exact = exact[..., bit_reverse_indices(shape[-1])]
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


def test_gpu_stages_executes():
    plan = plans.plan_for((1 << 20,), backend="gpu", device="cpu")
    xr, xi = _planes(65, 1 << 20)
    yr, yi = plan.execute(xr, xi)
    exact = np.fft.fft(xr.astype(np.complex128) + 1j * xi)
    assert rel_err(yr, yi, exact.real, exact.imag) <= SPLIT3_TOL


# --------------------------------------------------- keys and the store


def test_backend_axis_token_round_trip_and_distinct():
    a = plans.make_key(256, device="cpu")
    b = plans.make_key(256, backend="gpu", device="cpu")
    assert a.backend == "cuda" and b.backend == "gpu"
    assert BACKENDS == ("cuda", "gpu", "cpu-native")
    assert a.token() != b.token()
    assert PlanKey.from_token(b.token()) == b
    assert json.loads(b.token())["backend"] == "gpu"


def test_bogus_and_unported_backends_refused():
    with pytest.raises(ValueError, match="not in"):
        plans.make_key(256, backend="phi", device="cpu")
    # the reference's TPU family is the port's "cuda"; no "tpu" tag here
    with pytest.raises(ValueError, match="not in"):
        plans.make_key(256, backend="tpu", device="cpu")
    assert plans.make_key(256, backend="cpu-native",
                          device="cpu").backend == "cpu-native"


def test_per_backend_winners_cached_separately(plan_cache_tmp):
    # one shape raced under both backends with an injected timer: each
    # winner lands under its own token and serves only its own backend
    k_cuda = PlanKey(device_kind=CARD, n=256, batch=(64,))
    k_gpu = PlanKey(device_kind=CARD, n=256, batch=(64,), backend="gpu")
    p_cuda = plans.tune(k_cuda, timer=lambda fn, key: 0.5,
                        allow_offline=True, verbose=False)
    times = iter([0.3, 0.2, 0.9])
    p_gpu = plans.tune(k_gpu, timer=lambda fn, key: next(times),
                       allow_offline=True, verbose=False)
    assert p_cuda.variant == "rows"
    assert (p_gpu.variant, p_gpu.params) == ("gpu-rows", {"block_rows": 8})
    assert [r.status for r in p_gpu.tuning] == ["lost", "won", "lost"]
    tokens = set(plan_cache.disk_entries(CARD))
    assert {k_cuda.token(), k_gpu.token()} <= tokens
    plan_cache.clear(memory=True, disk=False)
    assert plan_cache.lookup(k_gpu).variant == "gpu-rows"
    assert plan_cache.lookup(k_cuda).variant == "rows"
    assert plans.get_plan(k_gpu, "cpu").source == "cache"


def test_gpu_race_records_rejections():
    # 8 rows of 4096 points overflow one block: rejected before launch
    key = PlanKey(device_kind=CARD, n=4096, batch=(4096,), backend="gpu")
    plan = plans.tune(key, timer=lambda fn, key: 1.0, allow_offline=True,
                      persist=False, verbose=False)
    fates = [(r.variant, r.params, r.status) for r in plan.tuning]
    assert fates[1] == ("gpu-rows", {"block_rows": 8}, "rejected")
    assert "limit 232448" in plan.tuning[1].reason
    assert plan.variant in ("gpu-rows", "gpu-stages")


def test_tune_sweep_per_backend():
    out, _ = plans.tune_sweep([256, 1024], backend="gpu", verbose=False,
                              timer=lambda fn, key: 1.0, allow_offline=True,
                              persist=False, device="cpu")
    assert [p.key.backend for p in out] == ["gpu", "gpu"]
    assert all(p.variant == "gpu-rows" for p in out)


def test_cli_plan_backend(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PIFFT_PLAN_CACHE", str(tmp_path))
    kind = plans.current_device_kind("cuda")
    plan_cache.store(Plan(key=PlanKey(device_kind=kind, n=4096,
                                      batch=(64,), backend="gpu"),
                          variant="gpu-rows", params={"block_rows": 8},
                          source="tuned", ms=0.01))
    plan_cache.store(Plan(key=PlanKey(device_kind=kind, n=1 << 20),
                          variant="rql", params={}, source="tuned", ms=0.05))
    assert cli_main(["plan", "show"]) == 0
    out = capsys.readouterr().out
    assert "backend=gpu" in out and "backend=cuda" in out
    assert cli_main(["plan", "show", "--backend", "gpu"]) == 0
    out = capsys.readouterr().out
    assert "gpu-rows" in out and "rql" not in out
    # warming needs a card, whichever the backend
    assert cli_main(["plan", "warm", "-n", "4096", "--backend", "gpu"]) == 2
    assert "offline" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli_main(["plan", "show", "--backend", "tpu"])


# ------------------------------------------------- inventory and roofline


def test_probe_returns_typed_inventory_on_the_cpu():
    inv = inventory.probe()
    d = inv.to_dict()
    assert d["schema"] == inventory.INVENTORY_SCHEMA == 1
    assert inv.backend in BACKENDS and inv.cpu_cores >= 1
    # no card here: every card row is empty, never an error
    assert inv.platform == "cpu" and inv.device_count == 0
    for field in ("sm_count", "smem_per_block_bytes", "smem_per_sm_bytes",
                  "l2_bytes", "persisting_l2_max_bytes",
                  "total_memory_bytes"):
        assert d[field] is None
    assert set(inv.bandwidth) == set(BACKENDS)
    assert json.loads(inv.to_json()) == d


def test_peak_bytes_per_s_per_backend(monkeypatch):
    for backend in ("cuda", "gpu"):
        assert inventory.peak_bytes_per_s(backend, CARD) == 3.35e12
        assert inventory.peak_bytes_per_s(backend, "mystery") is None
    monkeypatch.delenv("PIFFT_DRAM_GBPS", raising=False)
    # the host's DRAM ceiling, whatever card is named
    assert inventory.peak_bytes_per_s("cpu-native", CARD) == 50e9
    assert inventory.peak_bytes_per_s("cpu-interpret", CARD) is None


def test_cli_hw_probe(capsys):
    assert cli_main(["hw", "probe", "--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["platform"] == "cpu" and d["schema"] == 1
    assert cli_main(["hw", "probe", "--cores"]) == 0
    cores, native = capsys.readouterr().out.splitlines()
    assert int(cores) >= 1
    assert native == f"pifft_num_cores {num_cores()}"
    assert cli_main(["hw", "probe"]) == 0
    assert capsys.readouterr().out.strip() == "0"
    assert cli_main(["hw"]) == 2


def test_roofline_charges_gpu_rows_by_row_length():
    # rows one block holds, and long rows on a cluster (2^15..2^18),
    # cross device memory once each way: no carry pass, ceiling 1
    assert roofline.plan_carry_passes("gpu-rows", 1 << 14) == 0
    assert roofline.plan_carry_passes("gpu-rows", 4096) == 0
    assert roofline.plan_carry_passes("gpu-rows", 1 << 15) == 0
    assert roofline.plan_carry_passes("gpu-rows", 1 << 18) == 0
    assert roofline.roofline_ceiling(
        roofline.plan_carry_passes("gpu-rows", 1 << 18)) == 1.0
    assert roofline.plan_carry_passes("gpu-rows", 1 << 19) is None
    assert roofline.plan_carry_passes("gpu-rows") is None
    assert roofline.plan_carry_passes("mf") == 1
    assert roofline.plan_carry_passes("gpu-stages") is None
    ms, by = roofline.bound_ms(16 << 20, 0, CARD, bf16_flops=3 << 30)
    assert by == "bytes" and ms == pytest.approx(16 * 2 ** 20 / 3.35e9)


# ------------------------------------------------------------ cpu-native


@pytest.fixture(scope="module")
def reference_core(tmp_path_factory):
    """The reference's cpu-native rung on its own library, built by its
    own Makefile from a copy of its sources in a temporary directory, so
    the library in the reference's tree is neither written nor read
    here while other workers' reference tests load it."""
    import os
    import shutil

    from cs87project_msolano2_tpu.utils import buildlib as ref_buildlib

    src = tmp_path_factory.mktemp("ref") / "native"
    shutil.copytree(ref_buildlib.NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("*.so", "pifft",
                                                  "how-many-cpu-cores"))
    saved = (ref_buildlib.NATIVE_DIR, ref_buildlib.LIB_PATH)
    ref_buildlib.NATIVE_DIR = str(src)
    ref_buildlib.LIB_PATH = os.path.join(str(src), "libpifft.so")
    ref_buildlib.load_native.cache_clear()
    ref_lowering._native_or_none.cache_clear()
    try:
        yield ref_lowering
    finally:
        ref_buildlib.NATIVE_DIR, ref_buildlib.LIB_PATH = saved
        ref_buildlib.load_native.cache_clear()
        ref_lowering._native_or_none.cache_clear()


def cpun_key(n=256, layout="pi", domain="c2c", batch=()):
    return plans.make_key(n, batch, layout=layout, domain=domain,
                          backend="cpu-native", device="cpu")


def test_peak_bytes_per_s_cpu_native_env_override(monkeypatch):
    monkeypatch.delenv("PIFFT_DRAM_GBPS", raising=False)
    assert inventory.DRAM_DEFAULT_GBPS == ref_inventory.DRAM_DEFAULT_GBPS
    for env in (None, "123.5", "not-a-number"):
        if env is not None:
            monkeypatch.setenv("PIFFT_DRAM_GBPS", env)
        assert inventory.peak_bytes_per_s("cpu-native") == \
            ref_inventory.peak_bytes_per_s("cpu-native")
    monkeypatch.setenv("PIFFT_DRAM_GBPS", "123.5")
    assert inventory.peak_bytes_per_s("cpu-native") == 123.5e9
    assert inventory.probe().bandwidth["cpu-native"] == 123.5e9


def test_cpu_native_candidates_sweep_p_capacity_first(reference_core):
    for n in (4, 1024):
        cands = lowering.candidates(cpun_key(n))
        assert cands and all(v == "cpu-native" for v, _ in cands)
        ps = [prm["p"] for _, prm in cands]
        assert ps == sorted(ps, reverse=True) and ps[-1] == 1
        assert ps[0] == lowering.native_capacity_p(n)
        assert cands == reference_core.candidates(
            RefPlanKey(device_kind="cpu", n=n, layout="pi",
                       backend="cpu-native"))


def test_cpu_native_static_default_and_capacity_p(reference_core):
    cap = lowering.native_capacity_p(1 << 20)
    assert cap == reference_core.native_capacity_p(1 << 20)
    assert cap & (cap - 1) == 0 and cap <= inventory.cpu_cores()
    assert lowering.native_capacity_p(2) <= 2
    assert lowering.static_default(cpun_key(1024)) == \
        ("cpu-native", {"p": lowering.native_capacity_p(1024)})
    assert plans.get_plan(cpun_key(1024), "cpu").variant == "cpu-native"
    # the even real domains ride the half-length c2c key
    r2c = cpun_key(512, layout="natural", domain="r2c")
    assert lowering.static_default(r2c) == lowering.static_default(
        cpun_key(256, layout="natural"))
    with pytest.raises(ValueError, match="power-of-two"):
        lowering.static_default(cpun_key(100, layout="natural"))
    assert plans.get_plan(cpun_key(256), "cpu").storage_bytes() == 4


@pytest.mark.parametrize("layout", ["pi", "natural"])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_cpu_native_plan_executes_with_numpy_parity(layout, batch,
                                                    reference_core):
    n = 256
    plan = plans.get_plan(cpun_key(n, layout, batch=batch), "cpu")
    xr, xi = _planes(30, batch + (n,))
    yr, yi = plan.execute(xr, xi)
    assert yr.dtype == torch.float32 and yr.shape == batch + (n,)
    got = yr.numpy() + 1j * yi.numpy()
    if layout == "pi":
        got = got[..., bit_reverse_indices(n)]
    ref = np.fft.fft(xr.astype(np.complex128) + 1j * xi, axis=-1)
    assert rel_err(got.real, got.imag, ref.real, ref.imag) <= SPLIT3_TOL
    # the reference's rung on the same planes: the same C arithmetic
    ref_key = RefPlanKey(device_kind="cpu", n=n, batch=batch,
                         layout=layout, backend="cpu-native")
    rr, ri = reference_core.build_executor(ref_key, "cpu-native",
                                           dict(plan.params))(xr, xi)
    assert np.array_equal(yr.numpy(), np.asarray(rr))
    assert np.array_equal(yi.numpy(), np.asarray(ri))


def test_cpu_native_real_domain_rides_the_c2c_rung():
    n = 512
    plan = plans.get_plan(cpun_key(n, "natural", "r2c"), "cpu")
    x, _ = _planes(31, (n,))
    yr, yi = plan.execute(x, np.zeros_like(x))
    ref = np.fft.rfft(x.astype(np.float64))
    assert yr.shape == (n // 2 + 1,)
    assert rel_err(yr.numpy(), yi.numpy(), ref.real, ref.imag) \
        <= SPLIT3_TOL


def test_cpu_native_refuses_bad_p_and_variants():
    with pytest.raises(ValueError, match="power of two"):
        lowering.build_executor(cpun_key(256), "cpu-native", {"p": 3})
    with pytest.raises(ValueError, match="power of two"):
        lowering.build_executor(cpun_key(8), "cpu-native", {"p": 16})
    with pytest.raises(ValueError, match="unknown"):
        lowering.build_executor(cpun_key(256), "gpu-rows", {})


def test_cpu_native_without_the_core_raises_the_build_error(monkeypatch):
    """No numpy stand-in: a core that cannot be built raises its build
    error (never demoted by the degradation chain)."""
    from cs87project_msolano2_tpu_torch.backends import cpu as native
    from cs87project_msolano2_tpu_torch.resilience import KernelBuildError

    def no_core():
        raise KernelBuildError("gcc failed (exit 1) on the native C core")

    monkeypatch.setattr(native, "load_native", no_core)
    with pytest.raises(KernelBuildError, match="gcc failed"):
        lowering.build_executor(cpun_key(256), "cpu-native", {"p": 1})
    with pytest.raises(KernelBuildError):
        lowering.candidates(cpun_key(256))


def test_cpu_native_race_on_the_host_clock():
    """The race's timer runs a cpu-native candidate on the host (the
    default timer, no CUDA graph), each p timed, the winner stored
    under its own backend token."""
    key = PlanKey(device_kind=CARD, n=1024, layout="pi",
                  backend="cpu-native")
    plan = plans.tune(key, allow_offline=True, persist=False,
                      verbose=False, device="cpu")
    assert plan.variant == "cpu-native" and plan.ms > 0
    assert [r.params for r in plan.tuning] == \
        [p for _, p in lowering.candidates(key)]
    assert all(r.status in ("won", "lost") for r in plan.tuning)
    assert key.token() != PlanKey(device_kind=CARD, n=1024,
                                  layout="pi").token()
