"""PlanKey / Plan: what a kernel choice IS, independent of how it was
obtained (tuned, cached, or static default).

A :class:`PlanKey` is everything the kernel choice may depend on, with
the reference's field names (``plans/core.py``) and the port's backend
tags: ``"cuda"``, the port's kernel family (where the reference's
``"tpu"`` family stands, and the default), ``"gpu"``, the reference's
``hw/lowering`` family (``hw.lowering``), and ``"cpu-native"``, its
native C core as a rung (``hw.lowering``).  A :class:`Plan`
binds a key to one variant + parameter set from :mod:`.ladder` and runs
it.  Keys serialize to a stable JSON token (the disk store's dictionary
key), plans to a JSON record.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Callable, Optional

from ..ops.precision import PRECISIONS
from ..resilience.inject import maybe_fault
from ..utils.debug import check_finite

LAYOUTS = ("natural", "pi")
DOMAINS = ("c2c", "r2c", "c2r")
#: the port's lowering families: "cuda" (the default; the reference's
#: "tpu" kernel family on the card), "gpu" (the reference's hw/lowering
#: gpu family, ``hw.lowering``) and "cpu-native" (the native C core on
#: the host, ``hw.lowering``'s cpu-native family)
BACKENDS = ("cuda", "gpu", "cpu-native")

# bump when PlanKey/Plan serialization or ladder parameter semantics
# change incompatibly: stale disk stores are then ignored wholesale, and
# stale tokens in a current store are skipped with one warn.  The port's
# own numbering (its store never holds the reference's plans).
SCHEMA_VERSION = 1


def warn(msg: str) -> None:
    """One-line diagnostic to stderr, ``# ``-prefixed like the tuner's
    log lines: the deliberate-swallow sites (a store that cannot be
    written, an opted-in race that failed) say so here.

    Every warn is also mirrored into the observability event stream
    (kind ``warn``) when that subsystem is enabled; the stderr line is
    printed either way."""
    print(f"# {msg}", file=sys.stderr)
    from ..obs import events

    events.emit("warn", msg=msg)


def current_device_kind(device) -> str:
    """Identifier of the device a plan serves: the card's name, or the
    device type where no card is present (an offline kind)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(dev)
    return dev.type


def device_is_tunable(device) -> bool:
    """True when kernel timings on `device` mean anything: a CUDA device
    with a card present.  The CPU runs plain versions, whose times say
    nothing about the kernels."""
    import torch

    return torch.device(device).type == "cuda" and \
        torch.cuda.is_available()


def offline_kind(device_kind: str) -> bool:
    """True for device kinds whose plans must come from static defaults:
    a bare device type ("cpu", or "cuda" where no card was found), never
    a card's name."""
    return device_kind in ("cpu", "cuda", "meta")


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything a kernel-config choice may depend on.

    layout: "natural" (frequency order; the gather rides inside the
    plan) or "pi" (per-transform bit-reversed, the kernel-native order).
    precision: the storage/accumulate mode and its error budget
    (ops.precision).  domain: "c2c", "r2c" (real planes of length n in,
    half-spectrum planes of length n//2+1 out) or "c2r" (the inverse);
    n is the real-side length in every domain.  The real domains take
    natural layout only (the half-spectrum has no pi order) and n >= 2;
    even n rides the c2c plan at n/2, odd n the any-length path.
    backend: the lowering family — "cuda" (the default), "gpu" or
    "cpu-native"; keys of each differ in their tokens, so a winner raced
    under one never serves another.
    """

    device_kind: str
    n: int
    batch: tuple = ()
    layout: str = "natural"
    dtype: str = "float32"
    precision: str = "split3"
    domain: str = "c2c"
    backend: str = "cuda"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout={self.layout!r} not in {LAYOUTS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r} not in {BACKENDS}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision={self.precision!r} not in {PRECISIONS}")
        if self.domain not in DOMAINS:
            raise ValueError(f"domain={self.domain!r} not in {DOMAINS}")
        if self.n < 1:
            raise ValueError(f"n={self.n} must be positive")
        if self.layout == "pi" and (self.n & (self.n - 1)):
            raise ValueError(
                f"layout='pi' requires a power-of-two n (bit-reversed "
                f"order is undefined otherwise), got n={self.n}")
        if self.domain != "c2c":
            if self.layout != "natural":
                raise ValueError(
                    f"domain={self.domain!r} requires natural layout "
                    f"(the half-spectrum has no pi order)")
            if self.n < 2:
                raise ValueError(
                    f"domain={self.domain!r} requires n >= 2, got "
                    f"n={self.n}")

    def input_shape(self) -> tuple:
        """The float-plane shape this key's executor consumes: the
        signal planes for c2c and r2c, the half-spectrum for c2r."""
        width = self.n // 2 + 1 if self.domain == "c2r" else self.n
        return self.batch + (width,)

    def output_width(self) -> int:
        """Trailing-axis length of this key's executor output."""
        return self.n // 2 + 1 if self.domain == "r2c" else self.n

    def token(self) -> str:
        """Canonical serialized form: the disk store's dictionary key."""
        return json.dumps(
            {
                "v": SCHEMA_VERSION,
                "device_kind": self.device_kind,
                "n": self.n,
                "batch": list(self.batch),
                "layout": self.layout,
                "dtype": self.dtype,
                "precision": self.precision,
                "domain": self.domain,
                "backend": self.backend,
            },
            sort_keys=True,
            separators=(",", ":"),
        )

    @classmethod
    def from_token(cls, token: str) -> "PlanKey":
        d = json.loads(token)
        if d.get("v") != SCHEMA_VERSION:
            raise ValueError(f"plan-key schema {d.get('v')} != "
                             f"{SCHEMA_VERSION}")
        return cls(
            device_kind=d["device_kind"],
            n=int(d["n"]),
            batch=tuple(int(b) for b in d["batch"]),
            layout=d["layout"],
            dtype=d["dtype"],
            precision=d["precision"],
            domain=d["domain"],
            backend=d["backend"],
        )


def _unshared(plane, callers):
    """`plane`, or a copy of it where it may share memory with one of
    the caller's objects: a tensor's storage, or a numpy array, which
    ``torch.from_numpy`` shares on the CPU."""
    import torch

    for obj in callers:
        if isinstance(obj, torch.Tensor):
            shared = (plane.untyped_storage().data_ptr()
                      == obj.untyped_storage().data_ptr())
        else:
            shared = plane.device.type == "cpu"
        if shared:
            return plane.clone()
    return plane


@dataclasses.dataclass
class CandidateResult:
    """One ladder entry's fate in a tuning race: "won" / "lost" (timed,
    with ms) or "rejected" (refused before or at launch: a pre-launch
    ValueError at the shared-memory budget, a refused cooperative
    launch), always with a recorded reason."""

    variant: str
    params: dict
    status: str
    ms: Optional[float] = None
    reason: str = ""

    def to_record(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, d: dict) -> "CandidateResult":
        return cls(variant=d["variant"], params=dict(d.get("params") or {}),
                   status=d["status"], ms=d.get("ms"),
                   reason=d.get("reason", ""))


@dataclasses.dataclass
class Plan:
    """A resolved kernel choice for one PlanKey.

    source: "tuned" (this process raced the ladder), "cache" (loaded
    from the disk store) or "static" (the ladder's default, the only
    source an offline device ever gets).  `ms` is the tuned per-call
    time when known; `tuning` the full race record.  `device` is where
    numpy input to ``execute`` goes: None means the card, or the CPU
    for a key of the CPU's kind; tensors run where they lie.

    `degraded`/`demotions` are the degradation chain's trail: when the
    chosen kernel dies of a CAPACITY or PERMANENT fault the executor
    walks the chain (``resilience.degrade``) and every step lands here,
    in the in-process cache and in the warn line, never in the disk
    store.
    """

    key: PlanKey
    variant: str
    params: dict
    source: str = "static"
    ms: Optional[float] = None
    tuning: list = dataclasses.field(default_factory=list)
    device: Optional[str] = None
    degraded: bool = False
    demotions: list = dataclasses.field(default_factory=list)
    _fn: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def fn(self) -> Callable:
        """The (xr, xi) -> (yr, yi) executor on tensors, built lazily
        from the ladder, wrapped in the degradation chain (a CAPACITY or
        PERMANENT kernel fault demotes down the chain instead of killing
        the caller) and cached on the plan."""
        if self._fn is None:
            from . import ladder
            from ..resilience.degrade import resilient_executor

            self._fn = resilient_executor(
                self, ladder.build_executor(self.key, self.variant,
                                            self.params))
        return self._fn

    def execute(self, xr, xi, *, source=None):
        """Forward transform on float planes (tensors or numpy).  The
        caller's data is never written: an executor that writes over
        its input (``ladder.CONSUMES_INPUT``) gets a copy of any plane
        that shares memory with the caller's.  `source` is the caller's
        own input where (xr, xi) are planes split from it for this call
        (``models.fft``'s plane split), which then need no copy; by
        default (xr, xi) are the caller's.  The dispatch point: the
        ``plan`` injection site."""
        maybe_fault("plan")
        xr, xi = self._planes(xr, xi, source, both=True)
        out = self.fn(xr, xi)
        check_finite(f"plan {self.variant}", *out)
        return out

    def execute_inverse(self, xr, xi):
        """Inverse via the conj trick (natural layout, c2c only: the real
        domains are directional, the inverse of an r2c plan is a c2r
        plan for the same n)."""
        if self.key.domain != "c2c":
            raise ValueError(
                f"execute_inverse is a c2c conj trick; a "
                f"{self.key.domain} plan is already directional — plan "
                f"the opposite domain instead")
        if self.key.layout != "natural":
            raise ValueError("inverse requires a natural-layout plan")
        xr, xi = self._planes(xr, xi, None, both=False)
        n = self.key.n
        yr, yi = self.fn(xr, -xi)
        return yr / n, -yi / n

    def _planes(self, xr, xi, source, both):
        """(xr, xi) as the executor's planes, the real plane (and with
        `both` the imaginary one) copied where the executor would write
        over memory of the caller's."""
        from ..utils.device import as_planes

        callers = (xr, xi) if source is None else (source,)
        pr, pi = as_planes(xr, xi, self._numpy_device(xr))
        if getattr(self.fn, "consumes_input", False):
            pr = _unshared(pr, callers)
            if both:
                pi = _unshared(pi, callers)
        return pr, pi

    def _numpy_device(self, x):
        import torch

        if isinstance(x, torch.Tensor):
            return None
        if self.device is not None:
            return self.device
        return "cpu" if self.key.device_kind == "cpu" else "cuda"

    def effective_precision(self) -> str:
        """The precision mode this plan serves: the mode a tuning race
        pinned in ``params["precision"]`` (precision is a raced axis),
        else the key's (the reference's ``Plan.effective_precision``)."""
        return self.params.get("precision") or self.key.precision

    def storage_bytes(self) -> int:
        """Bytes per stored plane element of the path that serves this
        plan — what the roofline traffic model charges: the served
        mode's storage on the kernel paths, 4 on the stage path and on
        every gpu-backend variant, which run float32 whatever the mode
        (the reference's ``Plan.storage_bytes``)."""
        from ..ops.precision import storage_bytes

        served = self.served_variant()
        if served.startswith("precision:"):
            return storage_bytes(served.split(":", 1)[1])
        if served in ("stages", "torch-fft", "numpy-ref") \
                or self.key.backend in ("gpu", "cpu-native"):
            return 4
        return storage_bytes(self.effective_precision())

    def served_variant(self) -> str:
        """The variant or chain rung that serves this plan now: the last
        demotion's rung on a degraded plan, else the variant."""
        return self.demotions[-1]["to"] if self.degraded else self.variant

    def describe(self) -> dict:
        d = {"variant": self.variant, "params": dict(self.params),
             "source": self.source}
        if self.effective_precision() != self.key.precision:
            d["precision"] = self.effective_precision()
        if self.ms is not None:
            d["ms"] = round(self.ms, 4)
        if self.degraded:
            d["degraded"] = True
            d["demoted_to"] = self.demotions[-1]["to"]
            d["demotions"] = [dict(rec) for rec in self.demotions]
        return d

    def to_record(self) -> dict:
        rec = {
            "variant": self.variant,
            "params": dict(self.params),
            "ms": self.ms,
            "tuning": [r.to_record() for r in self.tuning],
        }
        if self.degraded:
            rec["degraded"] = True
            rec["demotions"] = [dict(d) for d in self.demotions]
        return rec

    @classmethod
    def from_record(cls, key: PlanKey, rec: dict,
                    source: str = "cache") -> "Plan":
        return cls(
            key=key,
            variant=rec["variant"],
            params=dict(rec.get("params") or {}),
            source=source,
            ms=rec.get("ms"),
            tuning=[CandidateResult.from_record(r)
                    for r in rec.get("tuning") or []],
            degraded=bool(rec.get("degraded", False)),
            demotions=[dict(d) for d in rec.get("demotions") or []],
        )
