"""The heterogeneous-backend acceptance drive: the whole backend plane,
end-to-end (the reference's ``hw/smoke.py``)::

    python -m cs87project_msolano2_tpu_torch hw smoke [--device cpu]

On the card by default; ``--device cpu`` runs the kernels' plain
versions.  Phases — every transition asserted, not just exercised:

A. PLAN-KEY AXIS — a token of the port's ``PlanKey`` schema (v1, with
   its ``backend`` field) round-trips through ``PlanKey.from_token``;
   a token with a foreign ``v``, or one without ``backend``, is
   REFUSED; a made-up backend tag is refused at construction; ``cuda``
   and ``gpu`` plans for one n land in the shared store under DISTINCT
   tokens and each key reads ITS winner back; a stale token
   hand-merged into the store is skipped with one warning, never
   served and never crashed on.
B. INVENTORY — ``hw probe --json`` (through the real CLI entry) emits
   the schema'd DeviceInventory record, field by field.
C. CEILINGS — ``cuda`` and ``gpu`` both read the card's data-sheet HBM
   rate (both run on the H100), ``cpu-native`` reads the host's DRAM
   figure, and an unknown card reads None.  (The reference's three
   distinct ceilings came from a TPU table the port has no use for.)
D. MESH — a two-backend mesh (``cuda`` + ``gpu``) serves
   parity-checked answers from BOTH families (on the card through
   ``tile_fft`` and ``gpu_rows``, their launches counted); a mid-run
   kill of the ``cuda`` home re-routes across the backend boundary
   with zero drops, the ``failover:backend:gpu`` and
   ``failover:<home>`` trail entries, ``degraded: true`` on the
   re-routed responses, and the cross-backend failover metric/event.
E. BENCH ROWS — ``bench.measure_backend_row`` emits ``gpu2^8_*`` and
   ``cpun2^8_*`` rows and the analyze loader parses them back onto
   ``Sample.backend``, tagging an untagged row of the port's record
   ``cuda``.

Every event emitted across the run is schema-validated at the end.
Prints a JSON summary; exit 0 only if every assertion held, 2 when the
card is asked for and there is none.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from .. import plans
from ..obs import events, metrics
from ..plans import cache
from ..plans.core import BACKENDS, SCHEMA_VERSION, PlanKey
from ..resilience import inject
from ..serve.mesh import MeshConfig, MeshDispatcher
from ..serve.shapes import ShapeSpec
from .inventory import peak_bytes_per_s

#: the served shape: on the card, the rows of BASELINE config 3 (the
#: ``cuda`` device serves them through tile_fft, the ``gpu`` device
#: through gpu_rows); on the CPU the reference's
CARD_N = 4096
CPU_N = 256

#: the card the ceilings are read for where none is present
DATASHEET_CARD = "NVIDIA H100 80GB HBM3"

#: (row logn) of the bench rows of phase E
BENCH_LOGN = 8


def _say(msg: str) -> None:
    print(f"[backend-smoke] {msg}", file=sys.stderr, flush=True)


def _phase_a(n: int, device) -> dict:
    """Plan-key backend axis: round-trip, foreign-schema refusal,
    per-backend winners under distinct tokens in ONE store."""
    key_cuda = plans.make_key(n, layout="pi", backend="cuda",
                              device=device)
    key_gpu = plans.make_key(n, layout="pi", backend="gpu",
                             device=device)

    # tokens round-trip and differ ONLY in the backend field
    for key in (key_cuda, key_gpu):
        assert PlanKey.from_token(key.token()) == key, key
    assert key_cuda.token() != key_gpu.token()
    assert json.loads(key_gpu.token())["v"] == SCHEMA_VERSION

    # a foreign schema (the reference's v5) and a token without the
    # backend field are refused, not misread
    foreign = json.loads(key_cuda.token())
    foreign["v"] = 5
    stale_token = json.dumps(foreign, sort_keys=True,
                             separators=(",", ":"))
    try:
        PlanKey.from_token(stale_token)
    except ValueError as e:
        assert "schema 5" in str(e), e
    else:
        raise AssertionError("a v5 token must be refused")
    no_backend = json.loads(key_cuda.token())
    no_backend.pop("backend")
    try:
        PlanKey.from_token(json.dumps(no_backend, sort_keys=True))
    except (ValueError, KeyError) as e:
        assert "backend" in str(e), e
    else:
        raise AssertionError("a token without backend must be refused")

    # an unknown backend tag is refused at construction
    try:
        plans.make_key(n, layout="pi", backend="phi", device=device)
    except ValueError as e:
        assert "phi" in str(e), e
    else:
        raise AssertionError("backend='phi' must be refused")

    # per-backend winners: same n/layout, different backend => distinct
    # store tokens, distinct lowering families, each read back intact
    plan_cuda = plans.get_plan(key_cuda, device=device)
    plan_gpu = plans.get_plan(key_gpu, device=device)
    assert plan_gpu.variant.startswith("gpu"), plan_gpu.variant
    assert plan_cuda.variant != plan_gpu.variant, \
        (plan_cuda.variant, plan_gpu.variant)
    cache.store(plan_cuda, persist=True)
    cache.store(plan_gpu, persist=True)
    entries = cache.disk_entries(key_cuda.device_kind)
    assert key_cuda.token() in entries and key_gpu.token() in entries, \
        sorted(entries)
    cache.clear(memory=True, disk=False)
    for key, variant in ((key_cuda, plan_cuda.variant),
                         (key_gpu, plan_gpu.variant)):
        hit = cache.lookup(key)
        assert hit is not None and hit.variant == variant, (key, hit)

    # a hand-merged stale token in the store is SKIPPED (warned once),
    # while every current entry still serves
    path = cache.store_path(key_cuda.device_kind)
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    data["plans"][stale_token] = {"variant": "rows", "params": {}}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh)
    cache.clear(memory=True, disk=False)
    warned = []
    saved_warn = cache.warn
    cache.warn = warned.append
    try:
        kept = cache.disk_entries(key_cuda.device_kind)
        cache.disk_entries(key_cuda.device_kind)
    finally:
        cache.warn = saved_warn
    assert stale_token not in kept, "a stale token must be skipped"
    assert key_gpu.token() in kept and key_cuda.token() in kept, \
        "current tokens must survive"
    assert len(warned) == 1 and "stale" in warned[0], warned
    return {"tokens": 2, "cuda_variant": plan_cuda.variant,
            "gpu_variant": plan_gpu.variant, "stale_warnings": 1}


def _phase_b() -> dict:
    """``hw probe --json`` through the real CLI entry point,
    schema-validated field by field."""
    from ..cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["hw", "probe", "--json"])
    assert rc == 0, f"hw probe rc={rc}"
    rec = json.loads(buf.getvalue())
    required = {"schema": int, "platform": str, "backend": str,
                "device_kind": str, "device_count": int,
                "cpu_cores": int, "bandwidth": dict}
    for field, typ in required.items():
        assert isinstance(rec.get(field), typ), \
            f"inventory field {field!r}: {rec.get(field)!r}"
    assert rec["schema"] == 1
    assert rec["backend"] in BACKENDS, rec["backend"]
    assert rec["cpu_cores"] >= 1
    assert set(rec["bandwidth"]) == set(BACKENDS), rec["bandwidth"]
    if rec["platform"] == "cuda":
        assert rec["device_count"] >= 1 and rec["sm_count"], rec
    return {"backend": rec["backend"], "platform": rec["platform"],
            "device_kind": rec["device_kind"]}


def _phase_c(card: str) -> dict:
    """Per-backend ceilings: the two card backends read the card's
    data-sheet HBM rate, the host backend its DRAM figure, an unknown
    card nothing."""
    from ..utils.roofline import peak_bytes_per_s as card_peak

    hbm = card_peak(card)
    cuda = peak_bytes_per_s("cuda", card)
    gpu = peak_bytes_per_s("gpu", card)
    dram = peak_bytes_per_s("cpu-native", card)
    assert hbm and cuda == gpu == hbm, (card, cuda, gpu, hbm)
    assert dram and dram != hbm, (dram, hbm)
    assert peak_bytes_per_s("cuda", "unknown-part") is None
    assert peak_bytes_per_s("gpu", "unknown-part") is None
    return {"card": card, "cuda_gbps": cuda / 1e9, "gpu_gbps": gpu / 1e9,
            "dram_gbps": dram / 1e9}


async def _phase_d(n: int, device) -> dict:
    """Two-backend mesh: parity on both families, then a mid-run kill
    whose failover CROSSES the backend boundary — zero drops, the
    backend trail entry, degraded responses."""
    from ..ops import cuda_fft as cf

    rng = np.random.default_rng(17)
    xr = rng.standard_normal(n).astype(np.float32)
    xi = rng.standard_normal(n).astype(np.float32)
    ref = np.fft.fft(xr.astype(np.complex128)
                     + 1j * xi.astype(np.complex128))

    def check(resp):
        got = np.asarray(resp.yr) + 1j * np.asarray(resp.yi)
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        assert err < 1e-4, f"parity {err} on {resp.device}"
        return err

    cfg = MeshConfig(devices=2, max_batch=2, max_wait_ms=2.0,
                     queue_depth=256, backends=("cuda", "gpu"))
    async with MeshDispatcher(cfg, [ShapeSpec(n=n)],
                              device=device) as mesh:
        tags = {d.id: d.backend for d in mesh.devices}
        assert set(tags.values()) == {"cuda", "gpu"}, tags
        home = mesh.devices[0]
        survivor = mesh.devices[1]
        # warmth never crosses tags: the gpu member is COLD for the
        # group the cuda member warmed
        group = next(iter(home.warm_groups))
        assert survivor.warmth(group) == 0, \
            "warmth must be 0 across backend tags"
        with cf.library_fft_refused() as launched:
            # parity on BOTH families (route around the home to prime
            # the other)
            cuda_err = check(await mesh.submit(xr, xi))
            home.state = "draining"
            gpu_err = check(await mesh.submit(xr, xi))
            home.state = "healthy"
            served = {d.id: d.served for d in mesh.devices}
            assert all(c >= 1 for c in served.values()), served
            # mid-run kill: the cuda home dies under load and its
            # requests land on the gpu-family survivor
            with inject(home.site, "permanent", count=1):
                results = await asyncio.gather(
                    *[mesh.submit(xr, xi) for _ in range(8)])
        assert len(results) == 8, "zero drops"
        assert home.state == "dead"
        errs = [check(r) for r in results]
        crossed = [r for r in results
                   if f"failover:backend:{survivor.backend}"
                   in r.degrade]
        assert crossed, \
            f"no cross-backend trail: {[r.degrade for r in results]}"
        for r in crossed:
            assert f"failover:{home.id}" in r.degrade, r.degrade
            assert r.degraded is True, r.to_record()
            assert r.device == survivor.id, r.device
    assert metrics.counter_value(
        "pifft_serve_failover_cross_backend_total",
        device=home.id) >= len(crossed)
    if device.type == "cuda":
        for name in ("tile_fft", "gpu_rows"):
            assert launched.get(name), \
                f"the two-backend mesh never launched {name}: {launched}"
    return {"devices": tags, "killed": home.id, "crossed": len(crossed),
            "n": n, "cuda_parity_relerr": cuda_err,
            "gpu_parity_relerr": gpu_err,
            "max_parity_relerr": max([cuda_err, gpu_err] + errs),
            "launches": launched}


def _phase_e(device) -> dict:
    """Backend bench rows end to end: emit gpu + cpu-native rows, then
    parse them back through the analyze loader's backend axis."""
    from .. import bench
    from ..analyze.loader import (
        BenchRound,
        Fingerprint,
        bench_samples,
        untagged_backend,
    )

    k = BENCH_LOGN
    gpu_row = bench.measure_backend_row(k, "gpu", device, smoke=True)
    cpun_row = bench.measure_backend_row(k, "cpu-native", device,
                                         smoke=True)
    assert gpu_row[f"gpu2^{k}_parity_relerr"] < 1e-4, gpu_row
    assert cpun_row[f"cpun2^{k}_parity_relerr"] < 1e-4, cpun_row
    assert gpu_row[f"gpu2^{k}_backend"] == "gpu", gpu_row
    assert cpun_row[f"cpun2^{k}_backend"] == "cpu-native", cpun_row

    rec = dict(gpu_row)
    rec.update(cpun_row)
    rec["n2^13_ms"] = 1.0          # an untagged row of a port record
    env = {"platform": "gpu", "torch": True}
    rnd = BenchRound(index=1, path="backend-smoke.json", metrics=rec,
                     fingerprint=Fingerprint.from_env(env),
                     backend=untagged_backend(env))
    samples = bench_samples(rnd)
    by_backend: dict = {}
    for s in samples:
        by_backend.setdefault(s.backend, []).append(s)
    assert set(by_backend) >= {"gpu", "cpu-native", "cuda"}, \
        sorted(by_backend)
    assert all(s.n == 1 << k for s in by_backend["gpu"])
    assert all(s.n == 1 << k for s in by_backend["cpu-native"])
    assert all(s.n == 8192 for s in by_backend["cuda"])
    return {"backends": sorted(by_backend), "samples": len(samples),
            "gpu_ms": gpu_row.get(f"gpu2^{k}_ms"),
            "cpun_ms": cpun_row.get(f"cpun2^{k}_ms")}


def _main(tmp: str, device) -> dict:
    import torch

    summary: dict = {"phases": {}, "device": str(device)}
    events_path = os.path.join(tmp, "events.jsonl")
    events.enable(events_path, run_id="backend-smoke")
    on_card = device.type == "cuda"
    n = CARD_N if on_card else CPU_N
    card = torch.cuda.get_device_name(device) if on_card \
        else DATASHEET_CARD

    _say("phase A: plan-key backend axis")
    summary["phases"]["A"] = _phase_a(n, device)
    _say("phase B: inventory probe")
    summary["phases"]["B"] = _phase_b()
    _say("phase C: per-backend ceilings")
    summary["phases"]["C"] = _phase_c(card)
    _say("phase D: two-backend mesh + cross-backend failover")
    summary["phases"]["D"] = asyncio.run(_phase_d(n, device))
    _say("phase E: backend bench rows + loader axis")
    summary["phases"]["E"] = _phase_e(device)

    # ---- validate every event emitted across the run ------------
    events.flush()
    records, dropped = events.load_events(events_path)
    assert dropped == 0, f"{dropped} malformed event lines"
    bad = [(r.get("kind"), p) for r in records
           for p in events.validate_event(r)]
    assert not bad, f"schema-invalid events: {bad[:8]}"
    failovers = [r for r in records
                 if r.get("kind") == "serve_failover"]
    assert any((r.get("payload") or {}).get("cross_backend")
               for r in failovers), \
        "serve_failover must carry the cross_backend count"
    summary["events"] = {"total": len(records),
                         "failover": len(failovers)}
    summary["ok"] = True
    events.disable()
    return summary


def main(argv=None) -> int:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m cs87project_msolano2_tpu_torch hw smoke",
        description="the backend plane's gate: the plan-key axis, the "
                    "inventory, the ceilings, a two-backend mesh with a "
                    "cross-backend failover, the backend bench rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    owned, prior = None, os.environ.get("PIFFT_PLAN_CACHE")
    if not prior or cache.cache_dir() is None:
        # hermetic by default (the fleet smoke's policy): phase A writes
        # plans into the store, so the smoke needs an ENABLED cache dir
        # — but never the operator's real one
        owned = tempfile.mkdtemp(prefix="pifft-backend-cache-")
        os.environ["PIFFT_PLAN_CACHE"] = owned
    try:
        with tempfile.TemporaryDirectory(prefix="pifft-backend-") as tmp:
            summary = _main(tmp, device)
    finally:
        if owned is not None:
            if prior is None:
                os.environ.pop("PIFFT_PLAN_CACHE", None)
            else:
                os.environ["PIFFT_PLAN_CACHE"] = prior
            shutil.rmtree(owned, ignore_errors=True)
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
