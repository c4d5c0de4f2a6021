"""The port's serving layer (``cs87project_msolano2_tpu_torch.serve``) on
the CPU, case for case against the reference's ``tests/test_serve.py``
(less its load-generator and ``--serve-load`` cases), every case of
``tests/test_slo_window.py``, and the serve cases of ``tests/test_real.py``
and ``tests/test_anylen.py``: shape-set parsing and warm, buffer
pooling, coalescing (k concurrent requests -> fewer invocations, every
row still its own), bounded-queue backpressure, the admission-time and
fault-driven degradation ladders, the socket protocol and the smokes.

Parity with the JAX package: the same requests through the reference's
``Dispatcher`` and the port's agree within the split3 budget (1e-5 rel
L2), and on the reference's split3 rows the port is at least as close to
complex128 as the reference (its MXU tail is the looser side);
``GroupKey.label``, ``batch_bucket``, ``ShapeSpec`` parsing and refusals
and ``format_summary`` under a fake clock are equal; the armed serve
spans and counters carry the reference's names, and each package's
validator accepts the other's events.

The card rule: for planes on the card no serve rung is a library rung;
with ``BatchRunner._on_card`` mocked, a forced ``torch-fft`` is refused,
an overload stops at window collapse and a capacity fault fails the
batch with a structured ``RequestFailed`` (the next batch served)."""

import asyncio
import json

import numpy as np
import pytest
import torch

from cs87project_msolano2_tpu import obs as ref_obs
from cs87project_msolano2_tpu import serve as ref_serve
from cs87project_msolano2_tpu.serve import protocol as ref_protocol
from cs87project_msolano2_tpu.serve import slo as ref_slo
from cs87project_msolano2_tpu_torch import obs, plans, resilience
from cs87project_msolano2_tpu_torch.ops.bits import bit_reverse_indices
from cs87project_msolano2_tpu_torch.serve import (
    BufferPool,
    Dispatcher,
    DispatcherClosed,
    QueueFull,
    RequestFailed,
    ServeConfig,
    ServeError,
    ShapeNotServed,
    ShapeSpec,
    batch_bucket,
    load_shapes,
    percentile,
    percentile_or_none,
)
from cs87project_msolano2_tpu_torch.serve import slo
from cs87project_msolano2_tpu_torch.serve.batcher import (
    SERVE_FALLBACK_RUNGS,
    BatchRunner,
    GroupKey,
)
from cs87project_msolano2_tpu_torch.serve.slo import LatencyStats
from cs87project_msolano2_tpu_torch.utils.verify import (
    pi_layout_to_natural,
    rel_err,
)

CPU = "cpu"
N = 256
#: the split3 budget: port vs reference, rel L2
SPLIT3_TOL = 1e-5


def planes(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def real_input(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(
        np.float32)


def ref_fft(xr, xi):
    return np.fft.fft(xr.astype(np.complex128)
                      + 1j * xi.astype(np.complex128))


def got(resp):
    return np.asarray(resp.yr) + 1j * np.asarray(resp.yi)


def run_async(coro, timeout_s=120.0):
    """Every async test runs under a hard deadline: a serving-path bug
    must FAIL, never hang the suite."""

    async def bounded():
        return await asyncio.wait_for(coro, timeout=timeout_s)

    return asyncio.run(bounded())


def cpu_dispatcher(config=None, specs=None):
    return Dispatcher(config, specs, device=CPU)


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    for var in ("PIFFT_OBS", "PIFFT_OBS_EVENTS", "PIFFT_TRACE_SAMPLE",
                "PIFFT_FAULT", "PIFFT_PLAN_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    yield
    for o in (obs, ref_obs):
        if o.enabled():
            o.disable()
        o.metrics.reset()


@pytest.fixture
def obs_run():
    obs.enable()
    yield obs
    obs.disable()


# ------------------------------------------------------------- shapes


def test_shape_spec_parsing_and_labels(tmp_path):
    p = tmp_path / "shapes.jsonl"
    p.write_text('{"n": 1024}\n'
                 "# a comment line\n"
                 "\n"
                 '{"n": 2048, "layout": "pi", "precision": "fp32"}\n'
                 '{"n": 1024}\n'  # duplicate: warmed once
                 '{"n": 512, "batch": [4]}\n')
    specs = load_shapes(str(p))
    assert [s.n for s in specs] == [1024, 2048, 512]
    assert specs[1].layout == "pi" and specs[1].precision == "fp32"
    assert specs[2].batch == (4,)
    assert specs[2].label() == "4x512:natural:split3"
    assert specs[0].key(CPU).n == 1024
    # the reference parses the same file to the same records and labels
    ref = ref_serve.load_shapes(str(p))
    assert [s.to_record() for s in specs] == [s.to_record() for s in ref]
    assert [s.label() for s in specs] == [s.label() for s in ref]


def test_load_shapes_rejects_bad_records(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"n": 1024}\n{"batch": [2]}\n')
    with pytest.raises(ValueError, match="line 2|bad.jsonl:2"):
        load_shapes(str(p))
    p.write_text("# only comments\n")
    with pytest.raises(ValueError, match="no shapes"):
        load_shapes(str(p))
    assert ShapeSpec(n=1000).n == 1000
    with pytest.raises(ValueError, match="2 <= n"):
        ShapeSpec(n=1)
    with pytest.raises(ValueError, match="power-of-two"):
        ShapeSpec(n=1000, layout="pi")


#: records both packages must accept (to equal records) or both refuse
SPEC_RECORDS = (
    {"n": 1024}, {"n": 1000}, {"n": 999, "domain": "r2c"},
    {"n": 1024, "layout": "pi"}, {"n": 4096, "precision": "bf16"},
    {"n": 4096, "op": "conv"}, {"n": 512, "op": "solve", "domain": "c2c"},
    {"n": 64, "batch": [2, 3]}, {"n": 1}, {"n": 1 << 24},
    {"n": (1 << 24) + 1}, {"n": 1000, "layout": "pi"},
    {"n": 512, "domain": "zzz"}, {"n": 512, "layout": "pi",
                                  "domain": "r2c"},
    {"n": 512, "op": "nope"}, {"n": 512, "op": "conv", "layout": "pi"},
    {"n": 512, "op": "conv", "domain": "c2r"}, {"batch": [2]})


@pytest.mark.parametrize("rec", SPEC_RECORDS, ids=json.dumps)
def test_shape_spec_parsing_equals_the_reference(rec):
    def parse(cls):
        try:
            spec = cls.from_record(dict(rec))
        except ValueError:
            return "refused"
        return spec.to_record(), spec.label()

    assert parse(ShapeSpec) == parse(ref_serve.ShapeSpec)


def test_dispatcher_warm_memoizes_plans():
    spec = ShapeSpec(n=N)
    d = cpu_dispatcher(ServeConfig(), [spec])
    warmed = d.warm()
    assert len(warmed) == 1
    hit = plans.cache.lookup(spec.key(CPU))
    assert hit is not None and hit.variant == warmed[0].variant


def test_plan_warm_shapes_cli(tmp_path, capsys):
    from cs87project_msolano2_tpu_torch.cli import main

    p = tmp_path / "shapes.jsonl"
    p.write_text('{"n": 256}\n{"n": 512, "op": "conv"}\n'
                 '{"n": 256, "domain": "r2c"}\n')
    assert main(["plan", "warm", "--shapes", str(p), "--device", CPU]) == 0
    out = capsys.readouterr().out
    assert "warmed 3 shape(s)" in out
    assert "512:natural:split3:r2c:conv" in out
    p.write_text('{"n": 1}\n')
    assert main(["plan", "warm", "--shapes", str(p), "--device", CPU]) == 2


# ------------------------------------------------- buffers and buckets


def test_batch_bucket_powers_of_two():
    sizes = (1, 2, 3, 5, 8, 9, 31, 32, 33)
    assert [batch_bucket(s) for s in sizes[:6]] == [1, 2, 4, 8, 8, 16]
    assert [batch_bucket(s) for s in sizes] == \
        [ref_serve.batch_bucket(s) for s in sizes]


def test_group_key_labels_equal_the_reference():
    for kw in ({}, {"layout": "pi"}, {"inverse": True},
               {"domain": "r2c"}, {"domain": "c2r"},
               {"domain": "r2c", "op": "conv"}, {"precision": "bf16"}):
        ours, ref = GroupKey(n=N, **kw), ref_serve.GroupKey(n=N, **kw)
        assert ours.label() == ref.label()
        assert ours.input_width() == ref.input_width()


def test_buffer_pool_reuses_staging_planes():
    pool = BufferPool(max_per_key=2)
    a = pool.acquire((4, 64))
    b = pool.acquire((4, 64))
    pool.release(a, b)
    c = pool.acquire((4, 64))
    assert c is a or c is b
    stats = pool.stats()
    assert stats["hits"] == 1 and stats["misses"] == 2
    # a different shape never aliases
    d = pool.acquire((2, 64))
    assert d.shape == (2, 64)
    # a CPU pool pins nothing and keeps no device planes
    assert not pool.pinned and "device_hits" not in pool.stats()


def test_percentile_nearest_rank():
    vals = [4.0, 1.0, 3.0, 2.0]
    assert percentile(vals, 50) == 2.0
    assert percentile(vals, 99) == 4.0
    assert percentile([7.0], 99) == 7.0
    with pytest.raises(ValueError):
        percentile([], 50)
    rng = np.random.default_rng(3)
    for size in (1, 2, 7, 100):
        v = list(rng.standard_normal(size))
        for q in (0, 1, 50, 90, 99, 100):
            assert percentile(v, q) == ref_slo.percentile(v, q) == \
                np.percentile(v, q, method="inverted_cdf")


def test_percentile_or_none_contract():
    assert percentile_or_none([], 99) is None
    assert percentile_or_none([3.0, 1.0, 2.0], 50) == 2.0


# -------------------------------------------------- correctness paths


def test_single_request_matches_numpy():
    xr, xi = planes(seed=1)

    async def main():
        async with cpu_dispatcher() as d:
            return await d.submit(xr, xi)

    resp = run_async(main())
    assert not resp.degraded
    assert resp.queue_wait_ms >= 0 and resp.compute_ms > 0
    assert resp.plan_variant == "rows"
    assert rel_err(got(resp), ref_fft(xr, xi)) < 1e-4


def test_inverse_and_pi_layout_requests():
    xr, xi = planes(seed=2)
    ref = ref_fft(xr, xi)

    async def main():
        async with cpu_dispatcher() as d:
            fwd_pi = await d.submit(xr, xi, layout="pi")
            inv = await d.submit(np.real(ref).astype(np.float32),
                                 np.imag(ref).astype(np.float32),
                                 inverse=True)
            return fwd_pi, inv

    fwd_pi, inv = run_async(main())
    assert rel_err(pi_layout_to_natural(got(fwd_pi)), ref) < 1e-4
    assert rel_err(got(inv), (xr + 1j * xi).astype(np.complex128)) < 1e-4


def test_submit_validates_requests():
    async def main():
        async with cpu_dispatcher() as d:
            with pytest.raises(ServeError, match="2 <= n"):
                await d.submit(np.zeros(1, np.float32),
                               np.zeros(1, np.float32))
            with pytest.raises(ServeError, match="1-D"):
                await d.submit(np.zeros((2, 64), np.float32),
                               np.zeros((2, 64), np.float32))
            with pytest.raises(ServeError, match="natural"):
                await d.submit(*planes(), layout="pi", inverse=True)
            with pytest.raises(ServeError, match="op="):
                await d.submit(*planes(), op="nope")
            with pytest.raises(ServeError, match="kernel plane"):
                await d.submit(planes()[0], None, op="conv")

    run_async(main())


def test_strict_shapes_rejects_unwarmed():
    async def main():
        cfg = ServeConfig(strict_shapes=True)
        async with cpu_dispatcher(cfg, [ShapeSpec(n=N)]) as d:
            await d.submit(*planes())  # served
            with pytest.raises(ShapeNotServed):
                await d.submit(*planes(n=2 * N))

    run_async(main())


def test_close_races_concurrent_submits_no_orphans_no_hang():
    """close() racing a burst of concurrent submits serves everything
    admitted before the close, gives late submits a structured
    DispatcherClosed, joins every worker, and leaves no orphaned future
    (the run_async deadline is the no-hang proof)."""
    xr, xi = planes()

    async def main():
        d = cpu_dispatcher(ServeConfig(max_wait_ms=25.0, queue_depth=256))

        async def client():
            try:
                return ("ok", await d.submit(xr, xi))
            except (DispatcherClosed, QueueFull) as e:
                return ("rejected", e)

        tasks = [asyncio.ensure_future(client()) for _ in range(24)]
        await asyncio.sleep(0)  # submits enqueue before the close
        await d.close()
        with pytest.raises(DispatcherClosed):
            await d.submit(xr, xi)
        outcomes = await asyncio.gather(*tasks)
        return d, outcomes

    d, outcomes = run_async(main())
    assert len(outcomes) == 24
    served = [r for tag, r in outcomes if tag == "ok"]
    assert len(served) == 24, [tag for tag, _ in outcomes]
    assert rel_err(got(served[0]), ref_fft(xr, xi)) < 1e-4
    assert all(w.done() for w in d._workers.values())
    assert all(q.empty() for q in d._queues.values())


def test_drain_alias_serves_then_stops():
    xr, xi = planes()

    async def main():
        d = cpu_dispatcher(ServeConfig(max_wait_ms=5.0))
        pending = [asyncio.ensure_future(d.submit(xr, xi))
                   for _ in range(3)]
        await asyncio.sleep(0)
        await d.drain()
        done = await asyncio.gather(*pending)
        with pytest.raises(DispatcherClosed):
            await d.submit(xr, xi)
        return done

    done = run_async(main())
    assert len(done) == 3 and all(r.batch_size >= 1 for r in done)


def test_submit_after_close_raises():
    async def main():
        d = cpu_dispatcher()
        async with d:
            await d.submit(*planes())
        with pytest.raises(DispatcherClosed):
            await d.submit(*planes())

    run_async(main())


def test_the_dispatcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dispatcher()
    assert Dispatcher(device=CPU).device == torch.device(CPU)


# ---------------------------------------------------------- coalescing


def test_concurrent_requests_coalesce_and_rows_stay_per_request():
    """k concurrent same-shape requests are served by fewer invocations
    than k, and every response carries ITS OWN transform."""
    k = 9
    inputs = [planes(seed=10 + i) for i in range(k)]

    async def main():
        cfg = ServeConfig(max_batch=8, max_wait_ms=50.0)
        async with cpu_dispatcher(cfg) as d:
            resps = await asyncio.gather(
                *(d.submit(xr, xi) for xr, xi in inputs))
            return d, resps

    d, resps = run_async(main())
    row = d.stats.summary()[f"{N}:natural:split3"]
    assert row["requests"] == k
    assert 0 < row["batches"] < k, row
    assert {r.batch_size for r in resps} <= {1, 2, 4, 8}
    for (xr, xi), resp in zip(inputs, resps):
        assert rel_err(got(resp), ref_fft(xr, xi)) < 1e-4
    assert row["queue_p99_ms"] >= row["queue_p50_ms"] >= 0
    assert row["compute_p99_ms"] > 0


def test_mixed_shapes_group_separately():
    async def main():
        cfg = ServeConfig(max_wait_ms=25.0)
        async with cpu_dispatcher(cfg) as d:
            a = planes(n=N, seed=3)
            b = planes(n=2 * N, seed=4)
            ra, rb = await asyncio.gather(d.submit(*a), d.submit(*b))
            return d, (a, ra), (b, rb)

    d, (a, ra), (b, rb) = run_async(main())
    assert rel_err(got(ra), ref_fft(*a)) < 1e-4
    assert rel_err(got(rb), ref_fft(*b)) < 1e-4
    summary = d.stats.summary()
    assert summary[f"{N}:natural:split3"]["requests"] == 1
    assert summary[f"{2 * N}:natural:split3"]["requests"] == 1


# ------------------------------------------------- backpressure / chaos


def test_saturated_queue_returns_structured_backpressure():
    k, depth = 12, 4

    async def main():
        cfg = ServeConfig(queue_depth=depth, max_batch=2, max_wait_ms=5.0)
        async with cpu_dispatcher(cfg) as d:
            return await asyncio.gather(
                *(d.submit(*planes(seed=i)) for i in range(k)),
                return_exceptions=True)

    results = run_async(main())
    rejected = [r for r in results if isinstance(r, QueueFull)]
    served = [r for r in results if not isinstance(r, Exception)]
    assert len(served) + len(rejected) == k
    assert served and rejected
    rec = rejected[0].to_record()
    assert rec["type"] == "queue_full"
    assert rec["retry_after_ms"] >= 1.0


def test_chaos_injected_fault_degrades_and_tags_every_response(obs_run):
    """Under an always-on serve:capacity fault the tuned path dies, the
    batch of CPU planes falls to the torch-fft rung, every response is
    tagged degraded with the trail, the stream carries serve_degrade,
    and results stay correct."""
    from cs87project_msolano2_tpu_torch.obs import events as obs_events

    inputs = [planes(seed=20 + i) for i in range(4)]

    async def main():
        with resilience.inject("serve", "capacity"):
            async with cpu_dispatcher(ServeConfig(max_wait_ms=25.0)) as d:
                return await asyncio.gather(
                    *(d.submit(xr, xi) for xr, xi in inputs))

    resps = run_async(main())
    for (xr, xi), r in zip(inputs, resps):
        assert r.degraded is True
        assert "fault:capacity:torch-fft" in r.degrade
        assert r.plan_variant == "torch-fft"
        assert rel_err(got(r), ref_fft(xr, xi)) < 1e-4
    recs = obs_events.snapshot()
    kinds = {r["kind"] for r in recs}
    assert "serve_degrade" in kinds and "serve_request" in kinds
    req_events = [r for r in recs if r["kind"] == "serve_request"]
    assert all(r["payload"]["degraded"] for r in req_events)
    assert all(not obs_events.validate_event(r) for r in recs)


def test_chaos_saturation_under_injection_never_hangs(obs_run):
    k, depth = 10, 3

    async def main():
        cfg = ServeConfig(queue_depth=depth, max_batch=2, max_wait_ms=2.0)
        with resilience.inject("serve", "capacity"):
            async with cpu_dispatcher(cfg) as d:
                return await asyncio.gather(
                    *(d.submit(*planes(seed=30 + i)) for i in range(k)),
                    return_exceptions=True)

    results = run_async(main(), timeout_s=90.0)
    assert len(results) == k
    for r in results:
        assert isinstance(r, QueueFull) or not isinstance(r, Exception)
    served = [r for r in results if not isinstance(r, Exception)]
    assert served and all(r.degraded for r in served)


def test_degraded_rungs_preserve_inverse_direction():
    """An inverse group served through a degradation rung (overload or a
    fault fallback) still computes the INVERSE."""
    xr, xi = planes(seed=50)
    ref = np.fft.ifft(xr.astype(np.complex128)
                      + 1j * xi.astype(np.complex128))
    out = BatchRunner(device=CPU).run(GroupKey(n=N, inverse=True),
                                      [(xr, xi)], rung="torch-fft")
    assert rel_err(out.yr[0] + 1j * out.yi[0], ref) < 1e-4
    assert out.degrade == ["overload:torch-fft"] and out.degraded

    async def main():
        with resilience.inject("serve", "capacity"):
            async with cpu_dispatcher() as d:
                return await d.submit(xr, xi, inverse=True)

    r = run_async(main())
    assert r.degraded
    assert rel_err(got(r), ref) < 1e-4


def test_transient_injection_is_retried_not_degraded():
    xr, xi = planes(seed=5)

    async def main():
        with resilience.inject("serve", "transient", count=1) as spec:
            async with cpu_dispatcher() as d:
                r = await d.submit(xr, xi)
            return spec.fired, r

    fired, resp = run_async(main())
    assert fired == 1
    assert resp.degraded is False and resp.degrade == []
    assert rel_err(got(resp), ref_fft(xr, xi)) < 1e-4


def test_admission_overload_serves_cheap_rung_tagged():
    """A near-full queue flips the worker into overload mode: on CPU
    planes the batch skips the tuned plan for the torch-fft rung and
    every response says so."""
    depth = 8

    async def main():
        cfg = ServeConfig(queue_depth=depth, max_batch=depth,
                          max_wait_ms=5.0, overload_watermark=0.8)
        async with cpu_dispatcher(cfg) as d:
            return await asyncio.gather(
                *(d.submit(*planes(seed=40 + i)) for i in range(depth)))

    resps = run_async(main())
    overloaded = [r for r in resps if "overload:torch-fft" in r.degrade]
    assert overloaded and all(r.degraded for r in overloaded)
    assert all(r.plan_variant == "torch-fft" for r in overloaded)


# ----------------------------------------------------------- the card rule


def test_no_serve_rung_is_a_library_rung_on_the_card(monkeypatch):
    from cs87project_msolano2_tpu_torch.resilience.degrade import (
        LIBRARY_RUNGS,
        rungs_for,
    )

    assert SERVE_FALLBACK_RUNGS == LIBRARY_RUNGS
    assert BatchRunner(device=CPU).fallback_rungs() == LIBRARY_RUNGS
    assert BatchRunner(device=CPU).overload_rung() == "torch-fft"
    # a runner of the card (built, not run: no card here)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = BatchRunner(device=torch.device("cuda"))
    assert card.fallback_rungs() == () and card.overload_rung() is None
    assert card.pool.pinned
    # the plan chain agrees: nothing of it below rows is a library rung
    assert not set(rungs_for("rows", torch.device("cuda"))) \
        & set(LIBRARY_RUNGS)


def test_a_card_batch_refuses_library_rungs_and_fails_structured(
        monkeypatch, obs_run):
    """With the runner's planes taken to be on the card: a forced
    torch-fft is refused before it runs, the overload level stops at
    window collapse (counted and evented), and a capacity fault fails
    every request of its batch with a structured RequestFailed of kind
    capacity while the next batch is served healthy."""
    from cs87project_msolano2_tpu_torch.obs import events as obs_events
    from cs87project_msolano2_tpu_torch.obs import metrics

    monkeypatch.setattr(BatchRunner, "_on_card", lambda self: True)
    runner = BatchRunner(device=CPU)
    assert runner.fallback_rungs() == () and runner.overload_rung() is None
    with pytest.raises(ValueError, match="CPU planes only"):
        runner.run(GroupKey(n=N), [planes()], rung="torch-fft")

    xr, xi = planes(seed=60)

    async def main():
        d = cpu_dispatcher(ServeConfig(queue_depth=8, max_batch=8,
                                       max_wait_ms=5.0,
                                       overload_watermark=0.8))
        async with d:
            q = asyncio.Queue()
            for _ in range(7):
                q.put_nowait(None)
            level = d._admission(GroupKey(n=N), q)
            with resilience.inject("serve", "capacity", count=1):
                failed = await asyncio.gather(
                    d.submit(xr, xi), d.submit(xr, xi),
                    return_exceptions=True)
            after = await d.submit(xr, xi)
            burst = await asyncio.gather(
                *(d.submit(*planes(seed=70 + i)) for i in range(8)))
        return level, failed, after, burst

    level, failed, after, burst = run_async(main())
    assert level == (0.0, None, "overload:window")
    assert all(isinstance(e, RequestFailed) for e in failed), failed
    assert {e.to_record()["kind"] for e in failed} == {"capacity"}
    assert failed[0].to_record()["type"] == "request_failed"
    assert not after.degraded and after.plan_variant == "rows"
    assert rel_err(got(after), ref_fft(xr, xi)) < 1e-4
    # the overloaded burst: served by the plan, window collapse tagged
    tagged = [r for r in burst if "overload:window" in r.degrade]
    assert tagged and all(r.plan_variant == "rows" for r in burst)
    assert metrics.counter_value("pifft_serve_admission_degrade_total",
                                 level="overload:window") >= 1
    assert metrics.counter_value("pifft_serve_errors_total",
                                 kind="capacity") == 1
    kinds = [e["kind"] for e in obs_events.snapshot()]
    assert "serve_error" in kinds and "serve_degrade" in kinds


# ----------------------------------------------------------- protocol


def test_protocol_frame_roundtrip_and_socket_server():
    from cs87project_msolano2_tpu_torch.serve import protocol

    obj = {"op": "fft", "id": 3, "xr": [0.0, 1.0]}
    frame = protocol.encode_frame(obj)
    assert frame[:4] == len(frame[4:]).to_bytes(4, "big")
    assert json.loads(frame[4:].decode()) == obj
    assert frame == ref_protocol.encode_frame(obj)

    xr, xi = planes(seed=6)

    async def main():
        async with cpu_dispatcher(ServeConfig(max_wait_ms=5.0)) as d:
            server = await asyncio.start_server(
                lambda r, w: protocol.handle_connection(d, r, w),
                "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            async with server:
                reply = await protocol.request_over_socket(
                    "127.0.0.1", port, xr, xi)
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port)
                writer.write(protocol.encode_frame({"op": "nope",
                                                    "id": 9}))
                await writer.drain()
                bad = await protocol.read_frame(reader)
                writer.close()
            return reply, bad

    reply, bad = run_async(main())
    assert reply["ok"] is True and reply["degraded"] is False
    ours = np.asarray(reply["yr"]) + 1j * np.asarray(reply["yi"])
    assert rel_err(ours, ref_fft(xr, xi)) < 1e-4
    assert reply["batch_size"] >= 1 and reply["compute_ms"] > 0
    assert bad["ok"] is False and bad["error"]["type"] == "bad_request"
    assert bad["id"] == 9


def test_protocol_client_disconnect_mid_write_never_escapes(obs_run):
    """A client vanishing mid-write closes THAT connection with one
    warn event, never propagating into the accept loop."""
    from cs87project_msolano2_tpu_torch.serve.protocol import (
        encode_frame,
        handle_connection,
    )

    class FakeReader:
        def __init__(self, frames):
            self._data = b"".join(encode_frame(f) for f in frames)
            self._pos = 0

        async def readexactly(self, k):
            if self._pos + k > len(self._data):
                raise asyncio.IncompleteReadError(
                    self._data[self._pos:], k)
            chunk = self._data[self._pos:self._pos + k]
            self._pos += k
            return chunk

    class DyingWriter:
        def __init__(self):
            self.closed = False
            self.drains = 0

        def write(self, data):
            pass

        async def drain(self):
            self.drains += 1
            raise ConnectionResetError("Connection reset by peer")

        def close(self):
            self.closed = True

        def get_extra_info(self, name):
            return ("198.51.100.7", 40213)

    async def main():
        async with cpu_dispatcher(ServeConfig(max_wait_ms=1.0)) as d:
            writer = DyingWriter()
            reader = FakeReader([{"op": "ping", "id": 1},
                                 {"op": "ping", "id": 2}])
            await handle_connection(d, reader, writer)
            return writer

    writer = run_async(main())
    assert writer.closed and writer.drains >= 1
    lost = [r for r in obs.snapshot() if r.get("kind") == "serve_conn_lost"]
    assert lost and "ConnectionResetError" in lost[0]["payload"]["error"]
    assert len(lost) == 1


# ------------------------------------------------------- entry points


def test_serve_smoke_cli_end_to_end(capsys):
    from cs87project_msolano2_tpu_torch.cli import main

    rc = main(["serve", "--smoke", "-k", "8", "--json", "--device", CPU])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out["problems"]
    assert out["ok"] is True and out["device"] == CPU
    assert 0 < out["same_shape_batches"] < out["same_shape_requests"]
    assert out["schema_invalid_events"] == 0
    assert out["events"] > 0


def test_serve_cli_refuses_the_mesh_and_a_missing_card(monkeypatch,
                                                       capsys):
    from cs87project_msolano2_tpu_torch.serve.cli import serve_main

    assert serve_main(["--mesh-smoke"]) == 2
    assert serve_main(["--devices", "4", "--smoke"]) == 2
    assert "mesh slice" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_main(["--smoke"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_precision_smoke_walks_to_fp32(monkeypatch, capsys):
    from cs87project_msolano2_tpu_torch.serve import precision_smoke

    monkeypatch.setenv("PIFFT_PRECISION_BUDGET", "0")
    plans.cache.clear(memory=True)
    try:
        assert precision_smoke.main(["--device", CPU]) == 0
    finally:
        plans.cache.clear(memory=True)
    assert "bf16 -> default -> split3 -> fp32" in capsys.readouterr().out


def test_anylen_smoke_serves_a_plan(capsys):
    from cs87project_msolano2_tpu_torch.serve import anylen_smoke

    assert anylen_smoke.main(["--device", CPU]) == 0
    assert "mixed-radix" in capsys.readouterr().out


# -------------------------------------------------- real and any-length


def test_serve_r2c_requests_coalesce_half_width():
    n, k = 256, 9
    inputs = [real_input(n, seed=20 + i) for i in range(k)]

    async def main():
        cfg = ServeConfig(max_batch=8, max_wait_ms=50.0)
        async with cpu_dispatcher(cfg) as d:
            resps = await asyncio.gather(
                *(d.submit(x, domain="r2c") for x in inputs))
            return d, resps

    d, resps = run_async(main())
    row = d.stats.summary()[f"{n}:natural:split3:r2c"]
    assert row["requests"] == k
    assert 0 < row["batches"] < k
    for x, resp in zip(inputs, resps):
        assert got(resp).shape == (n // 2 + 1,)
        assert rel_err(got(resp), np.fft.rfft(x.astype(np.float64))) < 1e-4
        assert not resp.degraded


def test_serve_r2c_validation():
    async def main():
        async with cpu_dispatcher() as d:
            x = real_input(256, seed=30)
            ok = await d.submit(x, domain="r2c")
            with pytest.raises(ServeError, match="nonzero imaginary"):
                await d.submit(x, np.ones_like(x), domain="r2c")
            with pytest.raises(ServeError, match="both planes"):
                await d.submit(x, None)
            with pytest.raises(ServeError, match="conj trick|inverse"):
                await d.submit(x, domain="r2c", inverse=True)
            with pytest.raises(ServeError, match="domain"):
                await d.submit(x, np.zeros_like(x), domain="zzz")
            return ok

    ok = run_async(main())
    assert np.asarray(ok.yr).shape == (129,)


def test_serve_c2r_round_trip():
    n = 256
    x = real_input(n, seed=31)
    spec = np.fft.rfft(x.astype(np.float64))

    async def main():
        async with cpu_dispatcher() as d:
            return await d.submit(spec.real.astype(np.float32),
                                  spec.imag.astype(np.float32),
                                  domain="c2r")

    resp = run_async(main())
    assert np.asarray(resp.yr).shape == (n,)
    assert np.max(np.abs(np.asarray(resp.yr) - x)) < 1e-4


def test_shape_spec_domain_parsing(tmp_path):
    p = tmp_path / "shapes.jsonl"
    p.write_text('{"n": 1024, "domain": "r2c"}\n{"n": 1024}\n')
    specs = load_shapes(str(p))
    assert specs[0].domain == "r2c" and specs[1].domain == "c2c"
    assert specs[0].label() == "1024:natural:split3:r2c"
    assert specs[0].key(CPU).domain == "r2c"
    assert specs[0] != specs[1]
    with pytest.raises(ValueError, match="domain"):
        ShapeSpec(n=512, domain="zzz")
    with pytest.raises(ValueError, match="natural"):
        ShapeSpec(n=512, layout="pi", domain="r2c")


def test_serve_smoke_with_mixed_domain_shapes(tmp_path, capsys):
    from cs87project_msolano2_tpu_torch.serve.cli import serve_main

    p = tmp_path / "mixed.jsonl"
    p.write_text('{"n": 512, "domain": "r2c"}\n{"n": 512}\n'
                 '{"n": 512, "op": "conv"}\n{"n": 512, "layout": "pi"}\n')
    rc = serve_main(["--smoke", "-k", "6", "--shapes", str(p), "--json",
                     "--device", CPU])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out["problems"]
    assert out["ok"] is True
    assert 0 < out["same_shape_batches"] < out["same_shape_requests"]
    assert out["schema_invalid_events"] == 0


def test_shape_spec_any_n():
    from cs87project_msolano2_tpu_torch.serve.shapes import MAX_SERVED_N

    ShapeSpec(n=1000)
    ShapeSpec(n=999, domain="r2c")
    with pytest.raises(ValueError):
        ShapeSpec(n=1)
    with pytest.raises(ValueError):
        ShapeSpec(n=MAX_SERVED_N + 1)
    with pytest.raises(ValueError):
        ShapeSpec(n=1000, layout="pi")
    ShapeSpec(n=1024, layout="pi")


def test_dispatcher_serves_non_pow2():
    from cs87project_msolano2_tpu_torch.ops.anylen import ANYLEN_VARIANTS

    xr, xi = planes(n=1000, seed=9)

    async def main():
        async with cpu_dispatcher(ServeConfig(max_wait_ms=1.0)) as d:
            resp = await d.submit(xr, xi)
            with pytest.raises(ServeError):
                await d.submit(np.zeros(1, np.float32),
                               np.zeros(1, np.float32))
            return resp

    resp = run_async(main())
    assert resp.plan_variant in ANYLEN_VARIANTS
    assert not resp.degraded
    ref = ref_fft(xr, xi)
    assert np.max(np.abs(got(resp) - ref)) / np.max(np.abs(ref)) <= 1e-5


def test_served_ops_match_their_oracles():
    from cs87project_msolano2_tpu_torch.apps.spectral import numpy_oracle

    n = 512
    sig, ker = planes(n=n, seed=80)

    async def main():
        async with cpu_dispatcher(ServeConfig(max_wait_ms=5.0)) as d:
            return await asyncio.gather(
                d.submit(sig, ker, op="conv"), d.submit(sig, ker, op="corr"),
                d.submit(sig, op="solve"))

    for resp, op in zip(run_async(main()), ("conv", "corr", "solve")):
        ref = numpy_oracle(op, sig.astype(np.float64),
                           ker.astype(np.float64), n)
        assert np.asarray(resp.yr).shape == (n,)
        assert rel_err(np.asarray(resp.yr, np.float64), ref) < 1e-5, op
        assert resp.plan_variant == "rows" and not resp.degraded


# ------------------------------------------------ parity with the reference


#: (n, submit keywords) of the parity requests: the reference's split3
#: rows (its MXU tail) in natural, pi and inverse order, a half-spectrum
#: request, and an any-length one
PARITY_CASES = ((N, {}), (N, {"layout": "pi"}), (N, {"inverse": True}),
                (4096, {}), (N, {"domain": "r2c"}), (1000, {}))


def _parity_inputs():
    out = []
    for i, (n, kw) in enumerate(PARITY_CASES):
        xr, xi = planes(n=n, seed=90 + i)
        if kw.get("domain") == "r2c":
            xi = np.zeros_like(xr)
        out.append((n, kw, xr, xi))
    return out


def _oracle(n, kw, xr, xi):
    x = xr.astype(np.complex128) + 1j * xi.astype(np.complex128)
    if kw.get("domain") == "r2c":
        return np.fft.rfft(xr.astype(np.float64))
    y = np.fft.ifft(x) if kw.get("inverse") else np.fft.fft(x)
    return y[bit_reverse_indices(n)] if kw.get("layout") == "pi" else y


def test_dispatcher_parity_with_the_reference():
    """The same concurrent requests through the reference's Dispatcher
    (JAX on the CPU) and the port's: the responses agree within the
    split3 budget, and where the reference runs its split3 rows kernel
    the port is at least as close to complex128."""
    cases = _parity_inputs()

    async def serve(dispatcher):
        async with dispatcher as d:
            out = []
            for n, kw, xr, xi in cases:
                out.append(await asyncio.gather(
                    *(d.submit(xr, xi, **kw) for _ in range(3))))
            return out

    ours = run_async(serve(cpu_dispatcher(ServeConfig(max_wait_ms=5.0))))
    ref = run_async(serve(ref_serve.Dispatcher(
        ref_serve.ServeConfig(max_wait_ms=5.0))))
    for (n, kw, xr, xi), o3, r3 in zip(cases, ours, ref):
        for o, r in zip(o3, r3):
            assert o.plan_variant == r.plan_variant, (n, kw)
            assert o.degraded is r.degraded is False
            assert rel_err(got(o), got(r)) <= SPLIT3_TOL, (n, kw)
        exact = _oracle(n, kw, xr, xi)
        e_port, e_ref = rel_err(got(o3[0]), exact), rel_err(got(r3[0]),
                                                            exact)
        assert e_port <= SPLIT3_TOL and e_ref <= SPLIT3_TOL
        if r3[0].plan_variant == "rows":
            assert e_port <= e_ref, (n, kw, e_port, e_ref)


# ----------------------------------------------------- slo, the live window


@pytest.fixture
def fake_clock(monkeypatch):
    """A settable clock for both packages' slo modules: aging is tested
    against controlled time, not sleeps."""
    state = {"t": 1000.0}
    monkeypatch.setattr(slo, "clock", lambda: state["t"])
    monkeypatch.setattr(ref_slo, "clock", lambda: state["t"])

    def advance(dt):
        state["t"] += dt
        return state["t"]

    return advance


def test_reservoir_bounded_under_sustained_load(fake_clock):
    stats = LatencyStats(window_s=60.0, window_max=32)
    for _ in range(10 * 32):
        stats.record("256:natural:split3", 0.001, 0.002, device="vdev0")
    totals = stats.window_totals()
    assert len(totals["256:natural:split3@vdev0"]) == 32
    assert stats.summary()["256:natural:split3"]["requests"] == 320


def test_reservoir_keeps_newest_when_full(fake_clock):
    stats = LatencyStats(window_s=600.0, window_max=4)
    for i in range(8):
        stats.record("lbl", 0.0, float(i))
        fake_clock(1.0)
    assert stats.window_totals() == {"lbl": [4.0, 5.0, 6.0, 7.0]}


def test_old_samples_age_out(fake_clock):
    stats = LatencyStats(window_s=10.0)
    stats.record("lbl", 0.001, 0.001)
    fake_clock(5.0)
    stats.record("lbl", 0.002, 0.002)
    assert len(stats.window_totals()) == 1
    assert len(stats.window_totals()["lbl"]) == 2
    fake_clock(7.0)
    assert stats.window_totals()["lbl"] == [0.004]
    assert stats.window_summary()["lbl"]["requests"] == 1
    fake_clock(20.0)
    assert stats.window_totals()["lbl"] == []
    row = stats.window_summary()["lbl"]
    assert row["requests"] == 0
    assert row["total_p99_ms"] is None
    stats.record("lbl", 0.001, 0.001)
    fake_clock(2.0)
    stats.record("lbl", 0.003, 0.003)
    assert len(stats.window_totals(window_s=1.0)["lbl"]) == 1


def test_retired_device_keys_do_not_leak(fake_clock):
    stats = LatencyStats(window_s=60.0)
    for dev in ("vdev0", "vdev1"):
        stats.record("a", 0.001, 0.001, device=dev)
        stats.record("b", 0.001, 0.001, device=dev)
    stats.record("a", 0.001, 0.001)
    assert len(stats.window_summary()) == 5
    removed = stats.retire(device="vdev1")
    assert sorted(removed) == ["a@vdev1", "b@vdev1"]
    assert sorted(stats.window_summary()) == ["a", "a@vdev0", "b@vdev0"]
    removed = stats.retire(label="a")
    assert sorted(removed) == ["a", "a@vdev0"]
    assert sorted(stats.window_summary()) == ["b@vdev0"]
    assert stats.retire() == []
    assert sorted(stats.window_summary()) == ["b@vdev0"]
    assert stats.summary()["a"]["requests"] == 3
    stats.record("a", 0.001, 0.001, device="vdev0")
    assert "a@vdev0" in stats.window_summary()


def test_retire_label_and_device_intersection(fake_clock):
    stats = LatencyStats()
    stats.record("a", 0.0, 0.001, device="vdev0")
    stats.record("a", 0.0, 0.001, device="vdev1")
    assert stats.retire(label="a", device="vdev0") == ["a@vdev0"]
    assert sorted(stats.window_summary()) == ["a@vdev1"]


def test_summaries_equal_the_reference_under_a_fake_clock(fake_clock):
    """The same records into both packages' LatencyStats give the same
    summary, live window, totals and formatted table."""
    rng = np.random.default_rng(5)
    ours, ref = LatencyStats(window_s=30.0), ref_slo.LatencyStats(
        window_s=30.0)
    for i in range(200):
        label = ("4096:natural:split3", "1048576:pi:split3",
                 "4096:natural:split3:r2c")[i % 3]
        q, c = float(rng.exponential(0.002)), float(rng.exponential(0.001))
        dev = None if i % 4 else "cuda:0"
        for s in (ours, ref):
            s.record(label, q, c, degraded=bool(i % 7 == 0), device=dev)
            if i % 5 == 0:
                s.record_batch(label)
            if i % 11 == 0:
                s.record_rejected(label)
        fake_clock(0.25)
    assert ours.summary() == ref.summary()
    assert ours.window_summary() == ref.window_summary()
    assert ours.window_totals() == ref.window_totals()
    assert slo.format_summary(ours.summary()) == \
        ref_slo.format_summary(ref.summary())
    assert slo.format_summary({}) == ref_slo.format_summary({})


# ------------------------------------------ telemetry names and the stream


def test_armed_serve_telemetry_carries_the_reference_names():
    """One coalesced batch through each package, armed: the same serve
    span names and counter series, and each package's validator accepts
    the other's events."""
    from cs87project_msolano2_tpu.obs import events as ref_events
    from cs87project_msolano2_tpu_torch.obs import events

    inputs = [planes(seed=100 + i) for i in range(3)]

    async def serve(dispatcher):
        async with dispatcher as d:
            return await asyncio.gather(*(d.submit(xr, xi)
                                          for xr, xi in inputs))

    def armed(package, dispatcher):
        package.enable()
        try:
            run_async(serve(dispatcher))
            recs = package.events.snapshot()
            counters = {k.split("{")[0]
                        for k in package.metrics.snapshot()["counters"]
                        if k.startswith("pifft_serve")}
            hist = {k.split("{")[0]
                    for k in package.metrics.snapshot()["histograms"]
                    if k.startswith("pifft_serve")}
        finally:
            package.disable()
        spans = {r["payload"]["name"] for r in recs if r["kind"] == "span"}
        kinds = {r["kind"] for r in recs}
        return recs, spans, kinds, counters, hist

    ours = armed(obs, cpu_dispatcher(ServeConfig(max_wait_ms=20.0)))
    ref = armed(ref_obs, ref_serve.Dispatcher(
        ref_serve.ServeConfig(max_wait_ms=20.0)))
    assert "serve_batch" in ours[1] and "serve_batch" in ref[1]
    assert {s for s in ours[1] if s.startswith("serve")} == \
        {s for s in ref[1] if s.startswith("serve")}
    assert {k for k in ours[2] if k.startswith("serve")} == \
        {k for k in ref[2] if k.startswith("serve")}
    assert ours[3] == ref[3]
    assert {"pifft_serve_batches_total",
            "pifft_serve_batched_requests_total",
            "pifft_serve_ops_total", "pifft_serve_requests_total"} <= ours[3]
    assert ours[4] == ref[4] and "pifft_serve_batch_size" in ours[4]
    for rec in ours[0]:
        assert ref_events.validate_event(rec) == [], rec
    for rec in ref[0]:
        assert events.validate_event(rec) == [], rec


def test_concurrent_groups_share_the_pools_and_the_cache():
    """Many groups' workers run their batches in executor threads at
    once (more than the cores), with a short switch interval: every
    response is still its own transform, and the shared pool's counts
    add up to two staging arrays a batch (a lost update would not)."""
    import sys

    groups = [(128 << (i % 5), {"layout": "pi"} if i % 2 else {})
              for i in range(12)]
    inputs = [(n, kw, *planes(n=n, seed=200 + i))
              for i, (n, kw) in enumerate(groups) for _ in range(3)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        async def main():
            cfg = ServeConfig(max_batch=2, max_wait_ms=0.5)
            async with cpu_dispatcher(cfg) as d:
                resps = await asyncio.gather(
                    *(d.submit(xr, xi, **kw) for _, kw, xr, xi in inputs))
                return d, resps

        d, resps = run_async(main(), timeout_s=60.0)
    finally:
        sys.setswitchinterval(old)
    for (n, kw, xr, xi), resp in zip(inputs, resps):
        ref = ref_fft(xr, xi)
        if kw:
            ref = ref[bit_reverse_indices(n)]
        assert rel_err(got(resp), ref) < 1e-4
    batches = sum(row["batches"] for row in d.stats.summary().values())
    stats = d.buffer_stats()
    assert stats["hits"] + stats["misses"] == 2 * batches
    assert len(d.runner.cached_groups()) == len({(n, tuple(kw.items()))
                                                for n, kw in groups})
