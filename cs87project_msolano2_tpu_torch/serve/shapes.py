"""The served shape set: which transform shapes this process answers
for, and the warm startup path that resolves their plans (the
reference's ``serve/shapes.py``).

A serving session should reach its first response on a warm plan: a
race or even the first build of an executor inside a request's latency
budget is the cold-start spike a warm-up pass exists to avoid.  The
shape set is a JSONL file, one shape per line:

    {"n": 1048576, "batch": [], "layout": "pi", "precision": "split3"}
    {"n": 4096}                  # defaults: batch=(), natural, split3, c2c
    {"n": 4096, "domain": "r2c"}  # half-spectrum real shape
    {"n": 4096, "precision": "bf16"}  # bf16 storage
    {"n": 4096, "op": "conv"}    # fused spectral conv group: warms both
                                 # half-spectrum plans and the fused
                                 # executor; an unknown op is refused
                                 # with a structured error, never warmed
                                 # as a bare FFT

``plan warm --shapes FILE`` warms the whole set in one call, and
``Dispatcher.warm()`` runs the same function at serve startup.  The
policy is :func:`plans.tune_or_static`: race where the card can answer,
serve the static default otherwise, so a session on the CPU never dies
for lack of a tuner.
"""

from __future__ import annotations

import dataclasses
import json

from .. import plans

#: hard admission cap on served transform lengths (front door AND shape
#: files): any n >= 2 below it is a plan (power of two on the kernel
#: ladder, anything else on the any-length ladder).  The cap bounds
#: per-request device memory as the batch buckets bound batch dims; an
#: over-cap n is a structured refusal, never an out-of-memory mid-plan
MAX_SERVED_N = 1 << 24


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One served transform shape: everything its PlanKey needs but the
    device kind (resolved at warm time, so one shape file serves every
    host).  ``domain``: "c2c" (default) or the half-spectrum real paths
    "r2c"/"c2r", n the real-side length either way.  ``op``: "fft"
    (default) or the fused spectral ops "conv"/"corr"/"solve"; an op
    shape warms both half-spectrum plans its pipeline rides."""

    n: int
    batch: tuple = ()
    layout: str = "natural"
    precision: str = "split3"
    domain: str = "c2c"
    op: str = "fft"

    def __post_init__(self):
        if self.n < 2 or self.n > MAX_SERVED_N:
            raise ValueError(f"served n={self.n} must be 2 <= n <= "
                             f"{MAX_SERVED_N} (any length in range is "
                             f"a plan)")
        if self.layout == "pi" and self.n & (self.n - 1):
            raise ValueError(f"layout='pi' requires a power-of-two n "
                             f"(bit-reversed order is undefined "
                             f"otherwise), got n={self.n}")
        from ..plans.core import DOMAINS
        from ..utils.roofline import SPECTRAL_OPS

        if self.domain not in DOMAINS:
            raise ValueError(f"served domain={self.domain!r} not in "
                             f"{DOMAINS}")
        if self.op not in SPECTRAL_OPS:
            raise ValueError(f"served op={self.op!r} not in "
                             f"{SPECTRAL_OPS}: an unknown op must be "
                             f"refused, not warmed as a bare FFT")
        if self.domain != "c2c" and self.layout != "natural":
            raise ValueError(f"domain={self.domain!r} requires natural "
                             f"layout (the half-spectrum has no pi "
                             f"order)")
        if self.op != "fft":
            if self.layout != "natural":
                raise ValueError(f"op={self.op!r} requires natural "
                                 f"layout")
            if self.domain not in ("c2c", "r2c"):
                raise ValueError(f"op={self.op!r} rides the "
                                 f"half-spectrum forward path; "
                                 f"domain={self.domain!r} does not "
                                 f"apply")
            # the domain the op's GroupKey carries, so strict-shape
            # membership and SLO labels agree with the dispatcher's keys
            object.__setattr__(self, "domain", "r2c")

    @classmethod
    def from_record(cls, rec: dict) -> "ShapeSpec":
        if not isinstance(rec, dict) or "n" not in rec:
            raise ValueError(f"shape record needs at least an 'n' field, "
                             f"got {rec!r}")
        return cls(
            n=int(rec["n"]),
            batch=tuple(int(b) for b in rec.get("batch") or ()),
            layout=rec.get("layout", "natural"),
            precision=rec.get("precision") or "split3",
            domain=rec.get("domain") or "c2c",
            op=rec.get("op") or "fft",
        )

    def to_record(self) -> dict:
        return {"n": self.n, "batch": list(self.batch),
                "layout": self.layout, "precision": self.precision,
                "domain": self.domain, "op": self.op}

    def key(self, device="cuda") -> plans.PlanKey:
        """The PlanKey this shape resolves to on `device` (an op shape's
        forward r2c key; :func:`warm` also resolves the c2r side)."""
        domain = "r2c" if self.op != "fft" else self.domain
        return plans.make_key(self.n, self.batch, layout=self.layout,
                              precision=self.precision, domain=domain,
                              device=device)

    def label(self) -> str:
        """Stable label (the per-shape SLO row key): the domain rides
        every non-c2c label and the op every non-fft one, matching
        ``GroupKey.label`` for batch-free shapes."""
        b = "x".join(str(d) for d in self.batch) + "x" if self.batch else ""
        d = f":{self.domain}" if self.domain != "c2c" else ""
        d += f":{self.op}" if self.op != "fft" else ""
        return f"{b}{self.n}:{self.layout}:{self.precision}{d}"


def load_shapes(path: str) -> list:
    """Parse a shape-set JSONL file.  Blank lines and ``#`` comment lines
    are skipped; a malformed line is an error naming its line number (a
    silently dropped shape would serve cold later)."""
    specs, seen = [], set()
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                spec = ShapeSpec.from_record(json.loads(line))
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                raise ValueError(
                    f"{path}:{lineno}: bad shape record: {e}") from e
            if spec in seen:
                continue  # duplicates warm once
            seen.add(spec)
            specs.append(spec)
    if not specs:
        raise ValueError(f"{path}: no shapes (every line blank/comment)")
    return specs


def warm(specs, force: bool = False, verbose: bool = False,
         device=None) -> list:
    """Resolve (race on the card, static default otherwise) and memoize
    the plan of every spec on `device` (None: the card), building each
    executor now so the first request pays dispatch, not set-up.  Op
    shapes also resolve their c2r plan and build the op pipeline.
    Returns the plans in spec order."""
    from ..obs import events
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    out = []
    for spec in specs:
        plan = plans.tune_or_static(spec.key(dev), force=force,
                                    verbose=verbose, device=dev)
        plan.fn  # build (and cache) the executor now, not per request
        if spec.op != "fft":
            inv_plan = plans.tune_or_static(
                plans.make_key(spec.n, spec.batch, layout=spec.layout,
                               precision=spec.precision, domain="c2r",
                               device=dev),
                force=force, verbose=verbose, device=dev)
            inv_plan.fn
            from ..apps.spectral import op_executor

            op_executor(spec.op, spec.batch, spec.n,
                        precision=spec.precision, device=dev)
        events.emit("serve_warm", cell={"n": spec.n,
                                        "variant": plan.variant},
                    shape=spec.label(), source=plan.source, op=spec.op)
        out.append(plan)
    return out
