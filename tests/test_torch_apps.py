"""The port's spectral operation suite (``cs87project_msolano2_tpu_torch.apps``
and the spectral half of ``utils/roofline.py``) on the CPU, case for
case against the reference's ``tests/test_apps.py`` (TestSpectral,
TestFusionMeter, TestOverlapSave): the same seeded numpy inputs go
through the reference's function and the port's (``device="cpu"``: the
kernels' plain versions), each output held to numpy's oracle and to the
reference's within TOL.  The port's armed bytes meter charges what the
reference's armed obs counters charge for the same calls; the spectral byte models
and the block chooser equal the reference's; the op executor's rungs
serve CPU planes and its library rungs refuse card planes; the ``apps``
CLI's smokes and demo exit 0; an AST guard stands in for the
reference's check rule PIF116 (no fused pipeline takes the
half-spectrum to the host between its paired transforms).
"""

import ast
import os

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import obs
from cs87project_msolano2_tpu.apps import pde as ref_pde
from cs87project_msolano2_tpu.apps import spectral as ref_spectral
from cs87project_msolano2_tpu.apps import stream as ref_stream
from cs87project_msolano2_tpu.obs import metrics as ref_metrics
from cs87project_msolano2_tpu.utils import roofline as ref_roofline
from cs87project_msolano2_tpu_torch.apps import cli as apps_cli
from cs87project_msolano2_tpu_torch import obs as port_obs
from cs87project_msolano2_tpu_torch.apps import pde, spectral, stream
from cs87project_msolano2_tpu_torch.obs import metrics as port_metrics
from cs87project_msolano2_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = os.path.join(REPO, "cs87project_msolano2_tpu_torch", "apps")
CPU = "cpu"
#: max |got - ref| / max |ref| of the port against numpy float64 and
#: against the reference: both pipelines are float32 (the port's plain
#: versions read about 2e-7 against numpy, the reference's split3 tail
#: up to about 4.4e-6)
TOL = 1e-5
#: the meter's series the spectral ops charge, by their reference names
SERIES = ("pifft_hbm_bytes_total", "pifft_hbm_min_bytes_total")


def rng_for(*key):
    return np.random.default_rng([7, *key])


def rel_err(got, ref):
    return float(np.max(np.abs(np.asarray(got) - ref))
                 / max(np.max(np.abs(ref)), 1e-30))


def held(got, ref_fn_out, exact):
    """The port's `got` within TOL of numpy's `exact` and of the
    reference's output."""
    assert rel_err(got, exact) < TOL
    assert rel_err(got, np.asarray(ref_fn_out, np.float64)) < TOL


@pytest.fixture
def obs_armed():
    """Both packages' obs switched on for the test (the reference's own
    fixture), their counters dropped after: disarming keeps them, and a
    later test file in the same worker (``tests/test_obs.py``) holds the
    disarmed registry empty."""
    owned = [o for o in (obs, port_obs) if not o.enabled()]
    for o in owned:
        o.enable()
    yield
    for o in owned:
        o.disable()
    ref_metrics.reset()
    port_metrics.reset()


def meter_deltas(port_call, ref_call, ops):
    """{series: (port delta, reference delta)} of one call each."""
    names = [(s, {}) for s in SERIES] + [
        ("pifft_apps_hbm_bytes_total", {"op": op}) for op in ops]
    before = [(port_metrics.counter_value(s, **lb),
               ref_metrics.counter_value(s, **lb)) for s, lb in names]
    port_call()
    ref_call()
    return {(s, tuple(lb.items())): (
        port_metrics.counter_value(s, **lb) - b[0],
        ref_metrics.counter_value(s, **lb) - b[1])
        for (s, lb), b in zip(names, before)}


# ------------------------------------------------------ fused spectral

CONV_CASES = [(200, 33), (256, 1), (100, 100), (512, 7), (8, 13), (33, 200)]
CORR_CASES = [(200, 33), (128, 5), (8, 13), (33, 200), (7, 12), (100, 100)]


class TestSpectral:
    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    @pytest.mark.parametrize("la,lv", CONV_CASES)
    def test_fftconv_matches_numpy_and_reference(self, mode, la, lv):
        rng = rng_for(la, lv)
        x = rng.standard_normal(la).astype(np.float32)
        k = rng.standard_normal(lv).astype(np.float32)
        got = spectral.fftconv(x, k, mode, device=CPU)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        held(got, ref_spectral.fftconv(x, k, mode),
             np.convolve(x.astype(np.float64), k.astype(np.float64), mode))

    @pytest.mark.parametrize("mode", ["full", "same", "valid"])
    @pytest.mark.parametrize("la,lv", CORR_CASES)
    def test_fftcorr_matches_numpy_and_reference(self, mode, la, lv):
        rng = rng_for(la, lv, 1)
        x = rng.standard_normal(la).astype(np.float32)
        k = rng.standard_normal(lv).astype(np.float32)
        held(spectral.fftcorr(x, k, mode, device=CPU),
             ref_spectral.fftcorr(x, k, mode),
             np.correlate(x.astype(np.float64), k.astype(np.float64),
                          mode))

    def test_tensor_in_tensor_out(self):
        rng = rng_for(3)
        x = rng.standard_normal(200).astype(np.float32)
        k = rng.standard_normal(33).astype(np.float32)
        got = spectral.fftconv(torch.from_numpy(x), torch.from_numpy(k))
        assert isinstance(got, torch.Tensor) and got.device.type == CPU
        np.testing.assert_array_equal(got.numpy(),
                                      spectral.fftconv(x, k, device=CPU))

    def test_corr_conjugation_matters(self):
        # a shifted-delta kernel: conv shifts right, corr shifts left
        x = rng_for(4).standard_normal(128).astype(np.float32)
        k = np.zeros(5, np.float32)
        k[3] = 1.0
        conv = spectral.fftconv(x, k, "full", device=CPU)
        corr = spectral.fftcorr(x, k, "full", device=CPU)
        assert not np.allclose(conv, corr, atol=1e-3)
        assert rel_err(corr, np.correlate(x.astype(np.float64), k,
                                          "full")) < TOL

    def test_circular_conv_is_the_served_primitive(self):
        n = 256
        rng = rng_for(5)
        x = rng.standard_normal(n).astype(np.float32)
        k = rng.standard_normal(n).astype(np.float32)
        held(spectral.circular_conv(x, k, "conv", device=CPU),
             ref_spectral.circular_conv(x, k, "conv"),
             ref_spectral.numpy_oracle("conv", x, k, n))

    def test_circular_serves_any_length(self):
        rng = rng_for(6)
        x = rng.standard_normal(100).astype(np.float32)
        k = rng.standard_normal(3).astype(np.float32)
        got = spectral.circular_conv(x, k, device=CPU)
        ref = np.real(np.fft.ifft(np.fft.fft(x.astype(np.float64))
                                  * np.fft.fft(k.astype(np.float64), 100)))
        held(got, ref_spectral.circular_conv(x, k), ref)
        with pytest.raises(ValueError, match="n=1 must be >= 2"):
            spectral.circular_conv(np.zeros(1, np.float32),
                                   np.zeros(1, np.float32), device=CPU)

    def test_kernel_spectrum_cache_one_forward_transform(self, obs_armed):
        def stats():
            return {r: port_metrics.counter_value(
                "pifft_apps_kspec_cache_total", result=r)
                for r in ("hit", "miss")}

        spectral.kernel_spectrum_cache_clear()
        k = rng_for(8).standard_normal(17).astype(np.float32)
        spectral.kernel_spectrum(k, 256, device=CPU)
        before = stats()
        spectral.kernel_spectrum(k, 256, device=CPU)
        # same VALUES, another array, a tensor: the same entry
        spectral.kernel_spectrum(np.array(k), 256, device=CPU)
        spectral.kernel_spectrum(torch.from_numpy(k), 256)
        assert stats()["miss"] == before["miss"]
        assert stats()["hit"] == before["hit"] + 3
        # a different n (or kernel) is its own entry
        kr, ki = spectral.kernel_spectrum(k, 512, device=CPU)
        assert stats()["miss"] == before["miss"] + 1
        ref = np.fft.rfft(np.pad(k, (0, 512 - 17)).astype(np.float64))
        assert rel_err(kr.numpy() + 1j * ki.numpy(), ref) < TOL

    def test_solve_1d_oracle(self):
        n = 1 << 10
        f = rng_for(9).standard_normal(n).astype(np.float32)
        held(spectral.solve_spectral_1d(f, device=CPU),
             ref_spectral.solve_spectral_1d(f),
             ref_spectral.numpy_oracle("solve", f, None, n))

    def test_check_op_and_numpy_oracle_are_the_reference_s(self):
        assert spectral.check_op("conv") == "conv"
        with pytest.raises(ValueError, match="warp"):
            spectral.check_op("warp")
        assert spectral.OPS == ref_spectral.OPS == ("fft", "conv", "corr",
                                                    "solve")
        rng = rng_for(10)
        x = rng.standard_normal((2, 64)).astype(np.float32)
        k = rng.standard_normal((2, 64)).astype(np.float32)
        for op in ("conv", "corr", "solve"):
            np.testing.assert_array_equal(
                spectral.numpy_oracle(op, x, k, 64),
                ref_spectral.numpy_oracle(op, x, k, 64))
        np.testing.assert_array_equal(spectral.poisson_multiplier_1d(96),
                                      ref_spectral.poisson_multiplier_1d(96))

    def test_lengths_are_the_reference_s(self):
        for v in list(range(1, 300)) + [3 * (1 << 18), (1 << 20) + 1]:
            assert spectral.next_pow2(v) == ref_spectral.next_pow2(v)
            assert spectral.cheapest_length(v) \
                == ref_spectral.cheapest_length(v), v


# ------------------------------------------------------ the op executor


class TestOpExecutor:
    N = 512

    @pytest.mark.parametrize("op", ["conv", "corr", "solve"])
    @pytest.mark.parametrize("rung,ref_rung", [
        (None, "jnp-fft"), ("torch-fft", "jnp-fft"),
        ("numpy-ref", "numpy-ref")])
    def test_rungs_speak_the_op_on_cpu_planes(self, op, rung, ref_rung):
        rng = rng_for(11, len(op))
        xr = rng.standard_normal((2, self.N)).astype(np.float32)
        xi = rng.standard_normal((2, self.N)).astype(np.float32)
        run, plan = spectral.op_executor(op, (2,), self.N, rung=rung,
                                         device=CPU)
        assert plan.key.domain == "r2c" and plan.key.batch == (2,)
        yr, yi = run(torch.from_numpy(xr), torch.from_numpy(xi))
        assert not yi.any()
        ref_run, _ = ref_spectral.op_executor(op, (2,), self.N,
                                              rung=ref_rung)
        held(yr.numpy(), ref_run(xr, xi)[0],
             ref_spectral.numpy_oracle(op, xr, xi, self.N))

    @pytest.mark.parametrize("rung", ["torch-fft", "numpy-ref"])
    def test_library_rungs_refuse_card_planes(self, rung, monkeypatch):
        run, _ = spectral.op_executor("conv", (), 64, rung=rung, device=CPU)
        planes = (torch.ones(64), torch.ones(64))
        assert run(*planes)[0].shape == (64,)
        monkeypatch.setattr(spectral, "_on_card", lambda plane: True)
        with pytest.raises(ValueError, match="CPU planes only"):
            run(*planes)
        # the fused pipeline is what serves card planes
        fused, _ = spectral.op_executor("conv", (), 64, device=CPU)
        assert fused(*planes)[0].shape == (64,)

    def test_refusals(self):
        with pytest.raises(ValueError, match="plain transform"):
            spectral.op_executor("fft", (), 64, device=CPU)
        with pytest.raises(ValueError, match="unknown op rung"):
            spectral.op_executor("conv", (), 64, rung="jnp-fft", device=CPU)


# --------------------------------------------------- the metered gate


class TestFusionMeter:
    def test_fused_at_floor_unfused_above(self, obs_armed):
        rng = rng_for(12)
        x = rng.standard_normal(1000).astype(np.float32)
        k = rng.standard_normal(25).astype(np.float32)
        n_pad = 1024

        def delta(fn):
            before = port_metrics.counter_value("pifft_hbm_bytes_total")
            y = fn(x, k, device=CPU)
            return y, int(port_metrics.counter_value("pifft_hbm_bytes_total")
                          - before)

        y_f, fused = delta(spectral.fftconv)
        y_u, unfused = delta(spectral.fftconv_unfused)
        floor = roofline.spectral_min_hbm_bytes("conv", n_pad)
        assert 0 < fused <= floor * apps_cli.FUSED_TOL
        assert unfused > floor * apps_cli.FUSED_TOL
        assert unfused == roofline.spectral_hbm_bytes("conv", n_pad,
                                                      host_round_trips=1)
        np.testing.assert_allclose(y_f, y_u, atol=1e-3)
        exact = np.convolve(x.astype(np.float64), k.astype(np.float64))
        held(y_u, ref_spectral.fftconv_unfused(x, k), exact)

    @pytest.mark.parametrize("call", ["fftconv", "fftconv_unfused",
                                      "circular_corr", "solve_1d",
                                      "overlap_save", "overlap_add"])
    def test_meter_charges_the_reference_s_bytes(self, call, obs_armed):
        rng = rng_for(13)
        x = rng.standard_normal(1000).astype(np.float32)
        k = rng.standard_normal(25).astype(np.float32)
        port, ref, ops = {
            "fftconv": (lambda: spectral.fftconv(x, k, device=CPU),
                        lambda: ref_spectral.fftconv(x, k), ("conv",)),
            "fftconv_unfused": (
                lambda: spectral.fftconv_unfused(x, k, device=CPU),
                lambda: ref_spectral.fftconv_unfused(x, k), ("conv",)),
            "circular_corr": (
                lambda: spectral.circular_conv(x[:256], k, "corr",
                                               device=CPU),
                lambda: ref_spectral.circular_conv(x[:256], k, "corr"),
                ("corr",)),
            "solve_1d": (lambda: spectral.solve_spectral_1d(x, device=CPU),
                         lambda: ref_spectral.solve_spectral_1d(x),
                         ("solve",)),
            "overlap_save": (
                lambda: stream.overlap_save(x, k, block=256, device=CPU),
                lambda: ref_stream.overlap_save(x, k, block=256),
                ("conv",)),
            "overlap_add": (
                lambda: stream.overlap_add(x, k, block=256, device=CPU),
                lambda: ref_stream.overlap_add(x, k, block=256),
                ("conv",)),
        }[call]
        deltas = meter_deltas(port, ref, ops)
        assert all(p == r > 0 for p, r in deltas.values()), deltas

    def test_pde_solves_charge_solve(self, obs_armed):
        rng = rng_for(14)
        f = rng.standard_normal((8, 8, 16)).astype(np.float32)
        f -= f.mean()
        deltas = meter_deltas(lambda: pde.poisson_solve(f, device=CPU),
                              lambda: ref_pde.poisson_solve(f), ("solve",))
        assert all(p == r for p, r in deltas.values()), deltas
        assert deltas[("pifft_hbm_bytes_total", ())][0] \
            == roofline.spectral_hbm_bytes("solve", f.size)
        before = port_metrics.counter_value("pifft_apps_hbm_bytes_total",
                                            op="solve")
        solves = port_metrics.counter_value("pifft_apps_ops_total",
                                            op="solve")
        pde.spectral_step(f[0], nu=0.1, dt=0.05, device=CPU)
        pde.helmholtz_solve(f, 2.0, device=CPU)
        assert port_metrics.counter_value("pifft_apps_ops_total",
                                          op="solve") == solves + 2
        assert port_metrics.counter_value("pifft_apps_hbm_bytes_total",
                                          op="solve") - before \
            == roofline.spectral_hbm_bytes("solve", 128) \
            + roofline.spectral_hbm_bytes("solve", f.size)

    def test_spectral_byte_models_are_the_reference_s(self):
        for op in ("fft", "conv", "corr", "solve"):
            for n in (2, 7, 1000, 1024, 3 << 18, 1 << 27):
                for storage in (2, 4):
                    assert roofline.spectral_min_hbm_bytes(op, n, storage) \
                        == ref_roofline.spectral_min_hbm_bytes(op, n,
                                                               storage)
                    for trips in (0, 1, 2):
                        assert roofline.spectral_hbm_bytes(
                            op, n, trips, storage) \
                            == ref_roofline.spectral_hbm_bytes(
                                op, n, trips, storage)
        with pytest.raises(ValueError, match="not in"):
            roofline.spectral_min_hbm_bytes("warp", 64)
        assert roofline.SPECTRAL_OPS == ref_roofline.SPECTRAL_OPS

    def test_spectral_roofline_utilization(self):
        n, ms = 1 << 24, 1.0
        want = roofline.spectral_min_hbm_bytes("conv", n) / 1e-3 / 3.35e12
        assert roofline.spectral_roofline_utilization(
            "conv", n, ms, "NVIDIA H100 80GB HBM3") == pytest.approx(want)
        assert roofline.spectral_roofline_utilization(
            "conv", n, ms, "no such card") is None
        assert roofline.spectral_roofline_utilization(
            "conv", n, 0.0, "NVIDIA H100 80GB HBM3") is None

    def test_charge_counts_and_labels(self, obs_armed):
        port_metrics.reset()
        assert roofline.charge_spectral_traffic("corr", 64, count=3) \
            == 3 * roofline.spectral_hbm_bytes("corr", 64)
        assert port_metrics.counter_value("pifft_apps_hbm_bytes_total",
                                          op="corr") \
            == port_metrics.counter_value("pifft_hbm_bytes_total")
        assert port_metrics.counter_value("pifft_apps_hbm_bytes_total") == 0
        assert port_metrics.counter_value("pifft_hbm_min_bytes_total") \
            == 3 * roofline.spectral_min_hbm_bytes("corr", 64)


# --------------------------------------------------------- streaming


class TestOverlapSave:
    KERNEL = rng_for(15).standard_normal(17).astype(np.float32)

    def ref(self, x):
        return np.convolve(x.astype(np.float64),
                           self.KERNEL.astype(np.float64), "full")

    @pytest.mark.parametrize("n,block", [
        (300, 64),     # many chunks, a tail that does not divide
        (64, 64),      # block == signal
        (30, 64),      # block > signal
        (100, 256),    # block > the whole padded output (one chunk)
        (257, 32),     # odd length, small block
    ])
    def test_matches_direct_convolve_and_reference(self, n, block):
        x = rng_for(16, n).standard_normal(n).astype(np.float32)
        held(stream.overlap_save(x, self.KERNEL, block=block, device=CPU),
             ref_stream.overlap_save(x, self.KERNEL, block=block),
             self.ref(x))
        held(stream.overlap_add(x, self.KERNEL, block=block, device=CPU),
             ref_stream.overlap_add(x, self.KERNEL, block=block),
             self.ref(x))

    def test_push_api_arbitrary_chunking(self):
        x = rng_for(17).standard_normal(500).astype(np.float32)
        conv = stream.OverlapSave(self.KERNEL, block=64, device=CPU)
        pieces = [conv.push(x[i:i + 41]) for i in range(0, 500, 41)]
        pieces.append(conv.flush())
        y = np.concatenate(pieces)
        assert y.shape == self.ref(x).shape
        assert rel_err(y, self.ref(x)) < TOL

    def test_generator_api_drains_incrementally(self):
        x = rng_for(18).standard_normal(400).astype(np.float32)
        chunks = [torch.from_numpy(x[i:i + 100]) for i in range(0, 400, 100)]
        outs = list(stream.overlap_save_stream(chunks, self.KERNEL,
                                               block=64, device=CPU))
        assert len(outs) > 1  # incremental, not one lump at the end
        assert all(isinstance(o, torch.Tensor) for o in outs)
        assert rel_err(torch.cat(outs).numpy(), self.ref(x)) < TOL

    def test_one_plan_pair_for_all_chunks(self):
        x = rng_for(19).standard_normal(1000).astype(np.float32)
        conv = stream.OverlapSave(self.KERNEL, block=64, device=CPU)
        fused = conv._fused
        conv.push(x)
        conv.flush()
        assert conv.chunks == stream.chunk_count(1000, 17, 64)
        assert spectral._fused_circular("conv", 64, None, CPU) is fused

    def test_block_validation(self):
        with pytest.raises(ValueError, match="even"):
            stream.OverlapSave(self.KERNEL, block=101, device=CPU)
        with pytest.raises(ValueError, match="kernel length"):
            stream.OverlapSave(rng_for(20).standard_normal(80)
                               .astype(np.float32), block=64, device=CPU)

    def test_block_mixed_radix_accepted(self):
        x = rng_for(21).standard_normal(1000).astype(np.float32)
        conv = stream.OverlapSave(self.KERNEL, block=96, device=CPU)
        y = np.concatenate([conv.push(x), conv.flush()])
        assert rel_err(y, self.ref(x)) < TOL

    @pytest.mark.parametrize("m", [1, 2, 17, 33, 129, 1000])
    def test_block_chooser_is_the_reference_s(self, m):
        for n in (None, 1, 100, 10_000, 1 << 20, 1 << 26):
            assert stream.block_candidates(m, n) \
                == ref_stream.block_candidates(m, n)
            assert stream.choose_block(m, n) == ref_stream.choose_block(m, n)
            for b in stream.block_candidates(m, n):
                assert stream.block_cost(b, m, n) \
                    == ref_stream.block_cost(b, m, n)
                assert stream.overlap_waste(b, m) \
                    == ref_stream.overlap_waste(b, m)
                if n is not None:
                    assert stream.chunk_count(n, m, b) \
                        == ref_stream.chunk_count(n, m, b)
        assert stream.MAX_BLOCK == ref_stream.MAX_BLOCK
        # off the card the race serves the analytic choice
        assert stream.tune_block(m, 10_000, device=CPU) \
            == ref_stream.choose_block(m, 10_000)

    def test_block_race_rejects_and_times(self, monkeypatch, obs_armed):
        """The race on a card, its timer and device check stood in: a
        candidate whose run raises a CAPACITY fault is rejected and
        counted, the rest timed; a TRANSIENT fault re-raises."""
        from cs87project_msolano2_tpu_torch import plans
        from cs87project_msolano2_tpu_torch.resilience import (
            CapacityError,
            TransientBackendError,
        )
        from cs87project_msolano2_tpu_torch.utils import timing

        monkeypatch.setattr(plans, "device_is_tunable", lambda dev: True)
        monkeypatch.setattr(stream, "_device",
                            lambda device=None, like=None:
                            torch.device(CPU))

        def fake_time(fn, xp, kr, ki, reps, warmup):
            if xp.shape[0] == 96:
                raise CapacityError("no room for 96")
            return 1.0 / xp.shape[0], None

        monkeypatch.setattr(timing, "time_ms", fake_time)
        port_metrics.reset()
        best = stream.tune_block(17, 100, verbose=True)
        cands = stream.block_candidates(17, 100)
        race = {k: v for k, v in port_metrics.snapshot()["counters"].items()
                if k.startswith("pifft_apps_block_race_total{")}
        assert port_metrics.counter_value("pifft_apps_block_race_total",
                                          block="96", fate="rejected") == 1
        assert sum(race.values()) == len(cands)
        costs = {b: stream.chunk_count(100, 17, b) / b for b in cands
                 if b != 96}
        assert best == min(costs, key=costs.get)

        def transient(*a, **kw):
            raise TransientBackendError("busy")

        monkeypatch.setattr(timing, "time_ms", transient)
        with pytest.raises(TransientBackendError):
            stream.tune_block(17, 100)

    def test_kill_mid_stream_resume(self, tmp_path):
        """The journaled variant resumes at the first chunk a kill took,
        recomputing only those, byte-identical."""
        x = rng_for(22).standard_normal(700).astype(np.float32)
        jp = str(tmp_path / "os.jsonl")
        y1, computed1 = stream.overlap_save_journaled(
            x, self.KERNEL, jp, block=128, device=CPU)
        total = stream.chunk_count(700, 17, 128)
        assert computed1 == total
        assert rel_err(y1, self.ref(x)) < TOL
        # the kill: drop the last two chunk records (plus a torn
        # half-line, which the tolerant reader skips)
        with open(jp, encoding="utf-8") as fh:
            lines = fh.readlines()
        kept = [ln for ln in lines
                if f'"cell": "os:{total - 1}"' not in ln
                and f'"cell": "os:{total - 2}"' not in ln]
        with open(jp, "w", encoding="utf-8") as fh:
            fh.writelines(kept)
            fh.write('{"cell": "os:torn')
        y2, computed2 = stream.overlap_save_journaled(
            x, self.KERNEL, jp, block=128, device=CPU)
        assert computed2 == 2
        np.testing.assert_array_equal(y1, y2)
        # another configuration refuses the journal: block AND kernel
        with pytest.raises(ValueError, match="different"):
            stream.overlap_save_journaled(x, self.KERNEL, jp, block=256,
                                          device=CPU)
        with pytest.raises(ValueError, match="different"):
            stream.overlap_save_journaled(x, self.KERNEL + np.float32(1.0),
                                          jp, block=128, device=CPU)

    def test_resume_of_finished_journal_computes_nothing(self, tmp_path):
        x = rng_for(23).standard_normal(300).astype(np.float32)
        jp = str(tmp_path / "os.jsonl")
        y1, _ = stream.overlap_save_journaled(x, self.KERNEL, jp, block=64,
                                              device=CPU)
        y2, computed = stream.overlap_save_journaled(x, self.KERNEL, jp,
                                                     block=64, device=CPU)
        assert computed == 0
        np.testing.assert_array_equal(y1, y2)


# --------------------------------------------------------- the CLI


@pytest.mark.parametrize("op", ["conv", "corr", "solve"])
def test_apps_smoke_on_the_cpu(op, capsys):
    import json

    assert apps_cli.apps_main([op, "--smoke", "--json", "--device",
                               CPU]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["problems"] == [] and rep["device"] == CPU
    # the served socket conv is conv's third check, as the reference's
    served = [c for c in rep["checks"] if "served" in c]
    assert len(served) == (op == "conv")
    if served:
        assert "degrade-tagged" in served[0]


def test_apps_cli_demo_and_dispatch(capsys):
    from cs87project_msolano2_tpu_torch.cli import main

    assert apps_cli.apps_main(["conv", "-n", "512", "--device", CPU]) == 0
    assert "conv" in capsys.readouterr().out
    assert main(["apps", "solve", "-n", "256", "--device", CPU]) == 0
    assert "mean-free" in capsys.readouterr().out


# ------------------------------------------- the PIF116 stand-in guard

#: calls that force a value onto the host
HOST_METHODS = ("cpu", "numpy", "item", "tolist")
HOST_FUNCS = ("asarray", "array")
#: the one function whose host round trip is its purpose
EXEMPT = ("fftconv_unfused",)


def _names(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _call_direction(call):
    """"forward", "inverse" or None for one call: a plan executor call
    (``.fn``/``.execute``) whose receiver name says the direction, or
    the real-domain entry points by name."""
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    if name in ("rfft", "rfft_planes_fast"):
        return "forward"
    if name in ("irfft", "irfft_planes_fast"):
        return "inverse"
    if isinstance(f, ast.Attribute) and name in ("fn", "execute") \
            and isinstance(f.value, ast.Name):
        recv = f.value.id
        if any(s in recv for s in ("inv", "c2r")):
            return "inverse"
        if any(s in recv for s in ("fwd", "rfft", "r2c")):
            return "forward"
    return None


def host_round_trips(fn) -> list:
    """Host uses of half-spectrum values in `fn`: names bound from a
    forward transform, and names computed from them, reaching a
    host-forcing call before an inverse consumes them."""
    spectrum, found = set(), []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        forward = isinstance(value, ast.Call) \
            and _call_direction(value) == "forward"
        inverse = isinstance(value, ast.Call) \
            and _call_direction(value) == "inverse"
        if forward or (not inverse and _names(value) & spectrum):
            for t in node.targets:
                spectrum |= _names(t)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in HOST_METHODS \
                and _names(f.value) & spectrum:
            found.append((fn.name, node.lineno))
        if isinstance(f, ast.Attribute) and f.attr in HOST_FUNCS \
                and isinstance(f.value, ast.Name) \
                and f.value.id in ("np", "numpy") \
                and any(_names(a) & spectrum for a in node.args):
            found.append((fn.name, node.lineno))
    # a comprehension over spectrum values (``t.cpu() for t in (ar,
    # ai)``) binds its loop name from them
    for comp in ast.walk(fn):
        if isinstance(comp, (ast.GeneratorExp, ast.ListComp)):
            for gen in comp.generators:
                if _names(gen.iter) & spectrum:
                    loop = _names(gen.target)
                    for node in ast.walk(comp.elt):
                        if isinstance(node, ast.Call) \
                                and isinstance(node.func, ast.Attribute) \
                                and node.func.attr in HOST_METHODS \
                                and _names(node.func.value) & loop:
                            found.append((fn.name, node.lineno))
    return found


def _functions(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def test_no_fused_pipeline_takes_the_spectrum_to_the_host():
    found = []
    for module in ("spectral.py", "stream.py"):
        for fn in _functions(os.path.join(APPS, module)):
            if fn.name not in EXEMPT and "oracle" not in fn.name:
                found += host_round_trips(fn)
    assert not found, found


def test_the_guard_sees_the_unfused_control_s_round_trip():
    """The guard is not vacuous: the named exemption does what the guard
    forbids, and a fused run with a host copy between its transforms is
    caught."""
    unfused = [fn for fn in _functions(os.path.join(APPS, "spectral.py"))
               if fn.name == "fftconv_unfused"]
    assert host_round_trips(unfused[0])
    src = ("def run(xp, kr, ki):\n"
           "    ar, ai = fwd.fn(xp, xp)\n"
           "    pr, pi = _mul_half_spectrum(ar, ai, kr, ki, False)\n"
           "    stash = np.asarray(pr)\n"
           "    yr, _ = inv.fn(pr, pi)\n"
           "    return yr.cpu()\n")
    fn = ast.parse(src).body[0]
    assert host_round_trips(fn) == [("run", 4)]
