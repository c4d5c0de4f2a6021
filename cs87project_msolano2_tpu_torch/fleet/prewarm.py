"""Predictive prewarming: a decayed per-GroupKey arrival model that
tells a (re)started mesh which shapes were hot, BEFORE the first
request arrives (the reference's ``fleet/prewarm.py``).

Every served request bumps its group's weight through
:class:`FleetTap` (the mesh's ``fleet_tap`` hook); weights decay
exponentially (:data:`DEFAULT_HALF_LIFE_S`), so the model tracks the
CURRENT mix, not all-time counts.  The model is persisted beside the
shared plan cache (:func:`model_path`) at drain handoff and on demand —
the same durability domain as the plans it prewarms: wiping the cache
wipes the model's reason to exist.

The file is the reference's format exactly (``fleet-arrivals.json``,
schema 1): either package reads the other's model.

Persistence subtlety: the in-process clock (:func:`~..obs.spans.clock`)
is a perf-counter — meaningless across restarts — so :meth:`save`
decays every weight to save time and stores NO timestamps; ``load``
re-bases the surviving mass at the new process's "now".  Idle time
while the fleet was down is deliberately not charged: a nightly restart
should not forget the daily mix.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from ..obs import events
from ..obs.spans import clock
from ..plans import cache
from ..plans.core import warn
from ..serve.shapes import ShapeSpec

__all__ = ["ArrivalModel", "FleetTap", "model_path",
           "DEFAULT_HALF_LIFE_S", "DEFAULT_MIN_WEIGHT"]

#: arrival-weight half-life: a shape unseen for this long counts half
DEFAULT_HALF_LIFE_S = 300.0

#: below this decayed weight a shape is no longer "hot" — not worth a
#: startup plan resolution
DEFAULT_MIN_WEIGHT = 0.5

MODEL_FILENAME = "fleet-arrivals.json"
MODEL_SCHEMA = 1


def model_path() -> Optional[str]:
    """Where the arrival model persists: beside the shared plan cache
    (None when the cache is disabled — no cache, nothing to prewarm)."""
    root = cache.cache_dir()
    if root is None:
        return None
    return os.path.join(root, MODEL_FILENAME)


def _spec_key(n, layout, precision, domain, op) -> tuple:
    return (int(n), str(layout), str(precision), str(domain), str(op))


class ArrivalModel:
    """Exponentially-decayed arrival weights per served shape.

    Keys carry the ShapeSpec identity ``(n, layout, precision, domain,
    op)`` — the fields that decide what :func:`~..serve.shapes.warm`
    resolves.  ``inverse`` is deliberately folded in: warming the
    forward spec warms the pair, and the mesh's served-set signature
    ignores direction the same way.
    """

    def __init__(self, path: Optional[str] = None,
                 half_life_s: float = DEFAULT_HALF_LIFE_S,
                 min_weight: float = DEFAULT_MIN_WEIGHT):
        self.path = path
        self.half_life_s = float(half_life_s)
        self.min_weight = float(min_weight)
        self._lock = threading.Lock()
        self._entries: dict = {}   # _spec_key -> [weight, t_last]

    # -- observation ---------------------------------------------------

    def _decayed(self, entry, now: float) -> float:
        w, t = entry
        dt = max(0.0, now - t)
        return w * 0.5 ** (dt / self.half_life_s)

    def observe(self, group, now: Optional[float] = None) -> None:
        """One arrival of `group` (a GroupKey or ShapeSpec-like with
        n/layout/precision/domain/op attributes)."""
        now = clock() if now is None else now
        key = _spec_key(group.n, group.layout, group.precision,
                        group.domain, group.op)
        with self._lock:
            entry = self._entries.get(key)
            w = self._decayed(entry, now) if entry else 0.0
            self._entries[key] = [w + 1.0, now]

    # -- the hot set ---------------------------------------------------

    def hot(self, now: Optional[float] = None) -> list:
        """``[(weight, key_tuple), ...]`` above :attr:`min_weight`,
        heaviest first; drops fully-decayed entries in passing."""
        now = clock() if now is None else now
        out = []
        with self._lock:
            for key, entry in list(self._entries.items()):
                w = self._decayed(entry, now)
                if w < 1e-6:
                    del self._entries[key]
                elif w >= self.min_weight:
                    out.append((w, key))
        out.sort(key=lambda t: (-t[0], t[1]))
        return out

    def hot_specs(self, now: Optional[float] = None) -> list:
        """The hot set as ShapeSpec records, heaviest first, each
        emitted as a schema'd ``fleet_prewarm`` event (the prewarm
        decision is fleet state — it must be auditable)."""
        specs = []
        for w, (n, layout, precision, domain, op) in self.hot(now):
            try:
                spec = ShapeSpec(n=n, layout=layout, precision=precision,
                                 domain=domain, op=op)
            except ValueError as exc:     # stale/foreign record
                warn(f"fleet: dropping unservable prewarm record "
                     f"{(n, layout, precision, domain, op)}: {exc}")
                continue
            events.emit("fleet_prewarm", cell={"n": n},
                        shape=spec.label(), weight=float(w))
            specs.append(spec)
        return specs

    # -- persistence ---------------------------------------------------

    def save(self, path: Optional[str] = None,
             now: Optional[float] = None) -> Optional[str]:
        """Persist decayed weights (no timestamps — the clock does not
        survive the process).  Atomic replace; an unwritable cache dir
        degrades to a warning, never a serving failure."""
        path = path or self.path or model_path()
        if path is None:
            return None
        now = clock() if now is None else now
        with self._lock:
            records = [
                {"n": k[0], "layout": k[1], "precision": k[2],
                 "domain": k[3], "op": k[4],
                 "weight": round(self._decayed(e, now), 6)}
                for k, e in sorted(self._entries.items())
                if self._decayed(e, now) >= 1e-6
            ]
        doc = {"schema": MODEL_SCHEMA,
               "half_life_s": self.half_life_s,
               "arrivals": records}
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as exc:
            warn(f"fleet: arrival model not saved to {path}: {exc}")
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        return path

    @classmethod
    def load(cls, path: Optional[str] = None,
             half_life_s: float = DEFAULT_HALF_LIFE_S,
             min_weight: float = DEFAULT_MIN_WEIGHT,
             now: Optional[float] = None) -> "ArrivalModel":
        """Model from disk (empty when absent/disabled/corrupt —
        prewarming is an optimization, never a startup failure).
        Loaded weights are re-based at the CURRENT clock."""
        path = path if path is not None else model_path()
        model = cls(path=path, half_life_s=half_life_s,
                    min_weight=min_weight)
        if path is None or not os.path.exists(path):
            return model
        now = clock() if now is None else now
        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
            if doc.get("schema") != MODEL_SCHEMA:
                raise ValueError(f"schema {doc.get('schema')!r} != "
                                 f"{MODEL_SCHEMA}")
            for rec in doc.get("arrivals", []):
                key = _spec_key(rec["n"], rec.get("layout", "natural"),
                                rec.get("precision", "split3"),
                                rec.get("domain", "c2c"),
                                rec.get("op", "fft"))
                w = float(rec.get("weight", 0.0))
                if w > 0.0:
                    model._entries[key] = [w, now]
        except (OSError, ValueError, KeyError, TypeError,
                AttributeError) as exc:
            warn(f"fleet: arrival model at {path} unreadable "
                 f"({exc}); starting cold")
            model._entries.clear()
        return model


class FleetTap:
    """The mesh's fleet hook (``MeshDispatcher.fleet_tap``): observes
    every admitted request into the arrival model, mirrors its input
    planes for the canary racer, and answers the mesh's warm() with
    the persisted hot set.  Duck-typed on purpose — the mesh stays
    importable without this package."""

    def __init__(self, model: Optional[ArrivalModel] = None,
                 mirror=None):
        self.model = model if model is not None else ArrivalModel.load()
        self.mirror = mirror

    def observe(self, group, xr, xi) -> None:
        self.model.observe(group)
        if self.mirror is not None:
            self.mirror.observe(group, xr, xi)

    def hot_specs(self) -> list:
        return self.model.hot_specs()

    def save(self) -> Optional[str]:
        return self.model.save()
