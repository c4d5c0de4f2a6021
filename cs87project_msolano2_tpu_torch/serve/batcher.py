"""The coalescing batcher: many requests in, ONE padded invocation of the
plan out (the reference's ``serve/batcher.py``).

Requests grouped under one :class:`GroupKey` (same n, layout, precision,
direction, domain, op) are staged into a pooled ``(B_pad, width)`` plane
pair (``B_pad`` rounded up to the next power of two, so a session
resolves a handful of batch buckets, not one plan per observed batch
size), copied to the card in one host-to-device copy, and run through
the plan ``plans.plan_for`` resolves for the PADDED batched shape: on
the card that is one launch of the port's Hopper kernels for the whole
batch (``rows``: one ``tile_fft``; ``rql`` over a pi batch:
``long_range_sep`` then ``tile_fft``).  The reference jits the plan's
executor with its inputs donated; here the executor is called as it is
(no ``torch.compile``), and the device plane pair comes from the pool
(``serve/buffers.py``), the donation's counterpart.

Execution is synchronous: the dispatcher calls :meth:`BatchRunner.run`
from an executor thread so the event loop keeps admitting requests
mid-kernel.  ``compute_s`` spans the host-to-device copy, the kernels
and the device-to-host copy of the outputs, which synchronizes: the
device work is inside it.

The serving half of the resilience ladder:

* TRANSIENT faults retry in place (``resilience.call_with_retry`` on the
  fast policy);
* CAPACITY / PERMANENT faults of a batch on CPU planes fall to the
  library rungs (``torch-fft``, then ``numpy-ref``) for THIS batch,
  tagged in every response it carried;
* on the card no library rung serves (``resilience.degrade.rungs_for``):
  such a fault fails the batch, and the dispatcher answers each of its
  requests with a structured ``RequestFailed`` carrying the fault kind;
* an explicit ``rung=`` (the dispatcher's overload mode, CPU planes
  only) skips the tuned plan and serves the cheap rung directly.

Inside the tuned path the plan's own executor is wrapped in the plan
degradation chain, so kernel faults demote there too (on the card down
to rql); ``plan.degraded`` is mirrored into the batch outcome.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from .. import plans
from ..obs import metrics
from ..obs.spans import clock, span
from ..resilience import FAST_POLICY, FaultKind, call_with_retry, classify
from ..resilience.degrade import LIBRARY_RUNGS, build_rung
from ..resilience.inject import maybe_fault
from ..utils.device import resolve_device
from .buffers import BufferPool

#: serve-side fallback rungs, weakest demand last: the library rungs of
#: ``resilience.degrade`` (the reference's "jnp-fft" / "numpy-ref").  They
#: serve CPU planes only (``BatchRunner.fallback_rungs``)
SERVE_FALLBACK_RUNGS = LIBRARY_RUNGS

#: the rung the dispatcher's overload and SLO levels serve on CPU planes
OVERLOAD_RUNG = SERVE_FALLBACK_RUNGS[0]


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """The coalescing identity: requests may share an invocation iff they
    share all six fields.  ``domain`` separates the half-spectrum real
    paths from c2c at the same n (an r2c group runs the half-width packed
    plan); ``op`` the fused spectral operations from the bare transform
    (mixing them would multiply the wrong spectra)."""

    n: int
    layout: str = "natural"
    precision: str = "split3"
    inverse: bool = False
    domain: str = "c2c"
    op: str = "fft"

    def label(self) -> str:
        d = ":inv" if self.inverse else ""
        d += f":{self.domain}" if self.domain != "c2c" else ""
        d += f":{self.op}" if self.op != "fft" else ""
        return f"{self.n}:{self.layout}:{self.precision}{d}"

    def input_width(self) -> int:
        """Trailing-axis length of this group's staged request planes
        (half-spectrum bins for c2r, the signal length otherwise)."""
        return self.n // 2 + 1 if self.domain == "c2r" else self.n


def batch_bucket(size: int) -> int:
    """The padded batch dim: the next power of two >= size."""
    b = 1
    while b < size:
        b *= 2
    return b


@dataclasses.dataclass
class BatchOutcome:
    """One invocation's results, still batch-shaped (numpy planes on the
    host): the dispatcher slices per-request rows out."""

    yr: np.ndarray
    yi: np.ndarray
    compute_s: float
    size: int
    bucket: int
    plan_variant: str
    degraded: bool = False
    degrade: list = dataclasses.field(default_factory=list)


class BatchRunner:
    """Stages, pads and executes one dispatcher's batches on `device`
    (None: the card); caches the callable per (group, bucket, rung), so
    every batch after the first reuses the resolved plan and executor."""

    def __init__(self, pool: Optional[BufferPool] = None,
                 backend: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.pool = pool or BufferPool(device=self.device)
        #: the plan backend every key this runner builds carries
        #: (``plans.core.BACKENDS``; None: "cuda", the port's kernels)
        self.backend = backend
        self._callables: dict = {}
        self._lock = threading.Lock()

    def _on_card(self) -> bool:
        """True when this runner's batches are planes on the card, which
        no library rung may serve."""
        return self.device.type != "cpu"

    def fallback_rungs(self) -> tuple:
        """The fallback rungs this runner's batches may take: the library
        rungs on the CPU, none on the card (a card request is served by
        the Hopper kernels or fails structured)."""
        return () if self._on_card() else SERVE_FALLBACK_RUNGS

    def overload_rung(self) -> Optional[str]:
        """The cheap rung the dispatcher's overload level serves: the
        first library rung on the CPU, None on the card (where the
        admission ladder stops at window collapse)."""
        rungs = self.fallback_rungs()
        return rungs[0] if rungs else None

    def cached_groups(self) -> set:
        """GroupKeys with a cached callable in this runner: the warmth
        signal (a cached group serves its next batch with no plan
        resolution)."""
        with self._lock:
            return {key[0] for key in self._callables}

    def adopt_callables(self, other: "BatchRunner",
                        group: Optional[GroupKey] = None) -> int:
        """Copy `other`'s cached callables (all, or one `group`'s) into
        this runner without displacing any here; returns how many were
        adopted.  Across backends or devices nothing is adopted: a
        callable built for one serves planes of that one only."""
        if other.backend != self.backend or other.device != self.device:
            return 0
        adopted = 0
        with other._lock:
            items = list(other._callables.items())
        with self._lock:
            for key, val in items:
                if group is not None and key[0] != group:
                    continue
                if key not in self._callables:
                    self._callables[key] = val
                    adopted += 1
        return adopted

    # ---------------------------------------------------- callables

    def _plan_for(self, group: GroupKey, bucket: int):
        # no race in a serving thread: the store's plan or the static one
        return plans.plan_for((bucket, group.n), layout=group.layout,
                              precision=group.precision,
                              domain=group.domain, device=self.device,
                              backend=self.backend or "cuda",
                              autotune=False)

    def _callable(self, group: GroupKey, bucket: int,
                  rung: Optional[str]):
        """(callable, plan) for the group at this bucket: the plan's
        executor, or a degradation rung built for the batched key.  The
        direction is applied outside the rung choice: an inverse group
        stays an inverse on every rung, and an op group's rungs speak the
        op (``apps.spectral.op_executor``).  A library rung on the card
        is refused here, before anything runs."""
        ck = (group, bucket, rung)
        with self._lock:
            hit = self._callables.get(ck)
        if hit is not None:
            return hit
        if rung in SERVE_FALLBACK_RUNGS and self._on_card():
            raise ValueError(
                f"the {rung} rung serves CPU planes only, and this batch "
                f"lies on {self.device}: a card request is served by the "
                f"Hopper kernels or fails")
        if group.op != "fft":
            from ..apps.spectral import op_executor

            run, plan = op_executor(group.op, (bucket,), group.n,
                                    precision=group.precision, rung=rung,
                                    device=self.device, autotune=False)
        else:
            plan = self._plan_for(group, bucket)
            forward = build_rung(plan.key, rung) if rung is not None \
                else plan.fn
            if group.inverse:
                inv_n = float(group.n)

                def run(xr, xi):  # the conj trick (plans.core contract)
                    yr, yi = forward(xr, -xi)
                    return yr / inv_n, -yi / inv_n
            else:
                run = forward
        with self._lock:
            self._callables[ck] = (run, plan)
        return run, plan

    def _drop(self, *keys) -> None:
        with self._lock:
            for ck in keys:
                self._callables.pop(ck, None)

    # ----------------------------------------------------- staging

    def _stage(self, group: GroupKey, planes, bucket: int):
        width = group.input_width()
        xr = self.pool.acquire((bucket, width))
        xi = self.pool.acquire((bucket, width))
        for i, (pr, pi) in enumerate(planes):
            xr[i], xi[i] = pr, pi
        if len(planes) < bucket:  # padding rows must be defined
            xr[len(planes):] = 0.0
            xi[len(planes):] = 0.0
        return xr, xi

    def _execute(self, fn, sxr, sxi):
        """``fn`` on the staged host planes: (yr, yi) as fresh host numpy
        arrays.  On the card the planes go to a pooled device pair by
        one asynchronous copy each from the pinned staging arrays; the
        copy's event is synchronized before this returns, so the caller
        may release the staging arrays, and the device-to-host copy of
        the outputs synchronizes the kernels.  On the CPU the planes are
        copies of the staging arrays, so no output can alias pooled
        memory."""
        import torch

        if self.device.type == "cpu":
            yr, yi = fn(torch.from_numpy(sxr).clone(),
                        torch.from_numpy(sxi).clone())
            return yr.numpy(), yi.numpy()
        pair = self.pool.acquire_device(*sxr.shape)
        copied = torch.cuda.Event()
        try:
            pair[0].copy_(torch.from_numpy(sxr), non_blocking=True)
            pair[1].copy_(torch.from_numpy(sxi), non_blocking=True)
            copied.record()
            yr, yi = fn(*pair)
            return yr.cpu().numpy(), yi.cpu().numpy()
        finally:
            # a pinned staging array returns to the pool only after the
            # copy that reads it has completed
            copied.synchronize()
            self.pool.release_device(pair)

    # --------------------------------------------------- execution

    def run(self, group: GroupKey, planes,
            rung: Optional[str] = None,
            rung_tag: Optional[str] = None,
            links: Optional[list] = None) -> BatchOutcome:
        """Execute one coalesced batch (a list of (xr, xi) float planes of
        the group's input width).  `rung` forces a degradation rung up
        front (the dispatcher's overload level, CPU planes only);
        otherwise the tuned plan runs and only a CAPACITY/PERMANENT fault
        walks the serve fallback rungs.  Raises for faults no rung could
        absorb: on the card, every such fault.

        `rung_tag` names a forced rung's trigger on the degrade trail
        (default ``overload:<rung>``; the burn-rate monitor passes
        ``slo:<rung>``).  `links` is the trace fan-in edge: the coalesced
        requests' span ids, recorded on the ONE serve_batch span."""
        size = len(planes)
        bucket = batch_bucket(size)
        sxr, sxi = self._stage(group, planes, bucket)
        degrade: list = []
        if rung is not None:
            degrade.append(rung_tag if rung_tag is not None
                           else f"overload:{rung}")
        try:
            with span("serve_batch", cell={"n": group.n, "size": size},
                      bucket=bucket, rung=rung or "plan",
                      op=group.op, links=links) as sp:
                outcome = self._invoke(group, bucket, rung, sxr, sxi,
                                       degrade)
                if rung is None and planes:
                    # the error-budget contract: one request row of every
                    # served batch against the float64 reference; a
                    # violation walks the plan UP the precision chain and
                    # recomputes the batch at the promoted mode, tagged
                    self._enforce_precision(group, bucket, outcome,
                                            planes[0], sxr, sxi)
                sp.set(variant=outcome.plan_variant,
                       degraded=outcome.degraded)
        finally:
            self.pool.release(sxr, sxi)
        outcome.size = size
        # a non-empty degrade trail never rides degraded=False
        outcome.degraded = outcome.degraded or bool(outcome.degrade)
        metrics.inc("pifft_serve_batches_total", shape=group.label())
        metrics.inc("pifft_serve_batched_requests_total", value=size,
                    shape=group.label())
        metrics.inc("pifft_serve_ops_total", value=size, op=group.op)
        if group.op != "fft":
            from ..utils.roofline import charge_spectral_traffic

            charge_spectral_traffic(group.op, group.n, count=size)
        metrics.observe("pifft_serve_batch_size", size,
                        shape=group.label())
        return outcome

    # ------------------------------------------- precision contract

    @staticmethod
    def _reference(group: GroupKey, sample):
        """(ref_r, ref_i) float64 oracle planes for one request of this
        group in the group's own layout, or None where there is no cheap
        oracle (inverse real domains).  Op groups verify against their
        op's numpy oracle."""
        xr = np.asarray(sample[0], dtype=np.float64)
        xi = np.asarray(sample[1], dtype=np.float64)
        if group.op != "fft":
            from ..apps.spectral import numpy_oracle

            y = numpy_oracle(group.op, xr, xi, group.n)
            return y, np.zeros_like(y)
        if group.domain == "r2c":
            if group.inverse:
                return None
            y = np.fft.rfft(xr)
        elif group.domain == "c2r":
            if group.inverse:
                return None
            y = np.fft.irfft(xr + 1j * xi, n=group.n)
            return y, np.zeros_like(y)
        elif group.inverse:
            y = np.fft.ifft(xr + 1j * xi)
        else:
            y = np.fft.fft(xr + 1j * xi)
        ref_r, ref_i = y.real, y.imag
        if group.layout == "pi":
            # pi[i] = natural[bitrev(i)]: the oracle in the kernel's order
            from ..ops.bits import bit_reverse_indices

            idx = bit_reverse_indices(group.n)
            ref_r, ref_i = ref_r[idx], ref_i[idx]
        return ref_r, ref_i

    def _sample_err(self, plan, group: GroupKey, sample, ref) -> float:
        """Relative error of ONE re-run request row under the plan's
        CURRENT executor: the re-check after a promotion."""
        from ..ops import precision as prec_mod

        xr = np.ascontiguousarray(sample[0], np.float32)[None, :]
        xi = np.ascontiguousarray(sample[1], np.float32)[None, :]
        if group.op != "fft":
            # the op pipeline at the promoted mode, through the bucket-1
            # callable (the promotion dropped the stale one)
            fn, _plan = self._callable(group, 1, None)
            yr, yi = self._execute(fn, xr, xi)
            return prec_mod.rel_err(yr[0], yi[0], ref[0], ref[1])
        if group.inverse:
            def fn(a, b):  # the conj trick (plans.core)
                yr, yi = plan.fn(a, -b)
                return yr / float(group.n), -yi / float(group.n)
        else:
            fn = plan.fn
        yr, yi = self._execute(fn, xr, xi)
        return prec_mod.rel_err(yr[0], yi[0], ref[0], ref[1])

    def _enforce_precision(self, group: GroupKey, bucket: int,
                           outcome: BatchOutcome, sample,
                           sxr, sxi) -> None:
        """Sample the served batch's first request against the float64
        reference, publish the ``pifft_precision_rel_err`` gauge, and on
        a budget violation walk the plan UP the precision chain
        (``resilience.degrade.promote_precision``), re-checking the
        sample at each promoted mode, until the budget holds or the chain
        tops out at fp32; then RE-RUN the staged batch at the promoted
        mode so the responses carry its data.  Every step is tagged on
        the outcome: a batch that violated its contract is served at the
        tightest mode available, marked degraded, never silently."""
        from ..ops import precision as prec_mod
        from ..resilience.degrade import promote_precision

        ck = (group, bucket, None)
        with self._lock:
            cached = self._callables.get(ck)
        if cached is None:
            return
        _fn, plan = cached
        if outcome.plan_variant in SERVE_FALLBACK_RUNGS:
            # a fault-fallback rung served: its float32 library path is
            # not the tuned mode, and a promotion would re-run the very
            # plan that just faulted
            return
        ref = self._reference(group, sample)
        if ref is None:
            return
        err = prec_mod.rel_err(outcome.yr[0], outcome.yi[0], ref[0],
                               ref[1])
        mode = plan.effective_precision()
        # an op pipeline composes two transforms: twice the budget
        op_scale = 2.0 if group.op != "fft" else 1.0
        budget = prec_mod.error_budget(mode) * op_scale
        metrics.set_gauge("pifft_precision_rel_err", err,
                          shape=group.label(), mode=mode)
        promoted = False
        while err > budget:
            nxt = promote_precision(plan, err, budget)
            outcome.degraded = True
            if nxt is None:
                break  # top of the chain: serve tagged, nothing tighter
            promoted = True
            outcome.degrade.append(f"precision:{nxt}")
            # the cached callables hold the old executor: drop them so
            # the recompute (and the group's next batch) builds at the
            # promoted mode, the bucket-1 sampling callable included
            self._drop(ck, (group, 1, None))
            err = self._sample_err(plan, group, sample, ref)
            mode = nxt
            budget = prec_mod.error_budget(mode) * op_scale
            metrics.set_gauge("pifft_precision_rel_err", err,
                              shape=group.label(), mode=mode)
        if promoted:
            # the staged planes are still live (run() releases them
            # after this check): one re-invocation replaces the violating
            # planes batch-wide.  A fault here keeps the tagged original
            # planes and says so
            from ..plans.core import warn

            try:
                fn, _plan = self._callable(group, bucket, None)
                yr, yi = self._execute(fn, sxr, sxi)
            except Exception as e:
                warn(f"promoted-mode recompute failed for "
                     f"{group.label()} ({type(e).__name__}: "
                     f"{str(e)[:120]}); serving the tagged "
                     f"violating-mode planes")
                return
            outcome.yr, outcome.yi = yr, yi

    def _invoke(self, group, bucket, rung, sxr, sxi,
                degrade) -> BatchOutcome:
        def attempt(use_rung):
            if use_rung is None:
                # injection site: the TUNED serving path only, so an
                # always-on chaos spec degrades the service on the CPU
                # instead of killing it
                maybe_fault("serve")
            fn, plan = self._callable(group, bucket, use_rung)
            t0 = clock()
            yr, yi = self._execute(fn, sxr, sxi)
            return BatchOutcome(
                yr=yr, yi=yi, compute_s=clock() - t0, size=bucket,
                bucket=bucket,
                plan_variant=use_rung or plan.variant,
                degraded=plan.degraded,
                degrade=degrade + (
                    [f"plan:{rec['to']}" for rec in plan.demotions]
                    if plan.degraded else []))

        try:
            # TRANSIENT faults retry in place on the fast policy
            return call_with_retry(attempt, rung, policy=FAST_POLICY,
                                   label=f"serve {group.label()}")
        except Exception as e:
            kind = classify(e)
            if kind is FaultKind.TRANSIENT:
                raise  # the retry budget is spent; nothing left to try
            exc = e
            rungs = self.fallback_rungs()
            start = rungs.index(rung) + 1 if rung in rungs else 0
            for fb in rungs[start:]:
                try:
                    out = call_with_retry(attempt, fb, policy=FAST_POLICY,
                                          label=f"serve fallback {fb}")
                except Exception as e2:
                    if classify(e2) is FaultKind.TRANSIENT:
                        raise
                    exc = e2
                    continue
                tag = f"fault:{kind.value}:{fb}"
                out.degraded = True
                out.degrade = degrade + [tag]
                from ..obs import events
                from ..plans.core import warn

                metrics.inc("pifft_serve_fallbacks_total", rung=fb)
                events.emit("serve_degrade",
                            cell={"n": group.n, "variant": fb},
                            level=tag, shape=group.label(),
                            reason=f"{type(e).__name__}: {str(e)[:200]}")
                warn(f"serve batch {group.label()} DEGRADED to {fb} "
                     f"({kind.value}: {type(e).__name__}); results stay "
                     f"correct, performance does not")
                return out
            raise exc
