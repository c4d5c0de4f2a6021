"""Two-level plan cache: in-process LRU + a JSON disk store (the
reference's ``plans/cache.py``).

The disk store makes tuning a once-per-machine event: a second process
finds the winner on disk and reaches its first FFT without racing the
ladder.  Layout:

    <cache dir>/plans-<device-kind-slug>.json
    {"schema": 1, "library_version": "0.1.0",
     "device_kind": "NVIDIA H100 80GB HBM3", "plans": {<key token>: <record>}}

`cache dir` is ``$PIFFT_PLAN_CACHE`` when set to a path,
``$XDG_CACHE_HOME/cs87project-msolano2-tpu-torch`` (default
``~/.cache/cs87project-msolano2-tpu-torch``) otherwise, a directory of
its own so the port and the reference package never write one file;
``PIFFT_PLAN_CACHE=off`` disables the disk level entirely (the tests'
default).  A store whose schema, library version, or device kind does
not match is ignored wholesale (stale tunings must never outlive the
code that produced them); corrupt JSON is treated as absent, never an
error.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import OrderedDict
from typing import Optional

from .core import SCHEMA_VERSION, Plan, PlanKey, warn

#: the in-process LRU, keyed by PlanKey (a memory hit builds no token)
_MEM: OrderedDict = OrderedDict()
_MEM_MAX = 128
_LOCK = threading.Lock()

_OFF_VALUES = ("off", "0", "none", "disabled")

#: store paths already warned about stale tokens this process — the
#: skip is announced ONCE per store, not once per lookup (the store is
#: re-read on every miss)
_STALE_WARNED: set = set()

#: keys whose opted-in race failed in this process: ``get_plan``
#: serves their memoized static plan without racing (and warning) again
_RACE_FAILED: set = set()


def _library_version() -> str:
    from .. import __version__

    return __version__


def cache_dir() -> Optional[str]:
    """Resolved disk-cache directory, or None when disabled.  Read from
    the environment on every call so tests (and long-lived processes)
    can re-point it without reloading the module."""
    env = os.environ.get("PIFFT_PLAN_CACHE", "").strip()
    if env.lower() in _OFF_VALUES:
        return None
    if env:
        return env
    xdg = os.environ.get("XDG_CACHE_HOME", "").strip() or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(xdg, "cs87project-msolano2-tpu-torch")


def _slug(device_kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]+", "-", device_kind).strip("-") or "dev"


def store_path(device_kind: str) -> Optional[str]:
    d = cache_dir()
    if d is None:
        return None
    return os.path.join(d, f"plans-{_slug(device_kind)}.json")


def _load_store(device_kind: str) -> dict:
    """The validated plans dict for `device_kind`, or {} when the store
    is absent, disabled, corrupt, or versioned for different code.

    A current-schema store may still carry individual STALE tokens
    (hand-merged stores, files touched by a mixed-version deploy).
    Those are SKIPPED with one ``warn`` per store per process — not a
    crash, and not silent truncation of the whole store: every
    parseable entry still serves."""
    kept, _stale = _partition_store(device_kind, quiet=False)
    return kept


def _partition_store(device_kind: str, quiet: bool) -> tuple:
    """(current, stale) plans dicts from the header-validated store.
    `quiet` suppresses the once-per-store stale warn (the merge-write
    path reads through here too and must not double-announce)."""
    path = store_path(device_kind)
    if path is None or not os.path.exists(path):
        return {}, {}
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return {}, {}
    if not isinstance(data, dict):
        return {}, {}
    if (data.get("schema") != SCHEMA_VERSION
            or data.get("library_version") != _library_version()
            or data.get("device_kind") != device_kind):
        return {}, {}
    plans = data.get("plans")
    if not isinstance(plans, dict):
        return {}, {}
    kept, stale = {}, {}
    reasons = []
    for token, rec in plans.items():
        try:
            PlanKey.from_token(token)
        except (ValueError, KeyError, TypeError) as e:
            stale[token] = rec
            reasons.append(f"{type(e).__name__}: {str(e)[:80]}")
            continue
        kept[token] = rec
    if stale and not quiet and path not in _STALE_WARNED:
        _STALE_WARNED.add(path)
        warn(f"plan store {path}: skipped {len(stale)} stale-schema "
             f"token(s) (e.g. {reasons[0]}); {len(kept)} current "
             f"plan(s) kept — re-warm to refresh the skipped keys")
    return kept, stale


def memoize(plan: Plan) -> None:
    """Insert into the in-process LRU only (static defaults and
    disk-loaded plans both land here so repeat lookups are dict hits)."""
    with _LOCK:
        _MEM[plan.key] = plan
        _MEM.move_to_end(plan.key)
        while len(_MEM) > _MEM_MAX:
            _MEM.popitem(last=False)


def mark_race_failed(key: PlanKey) -> None:
    """Remember that `key`'s opted-in race failed (until ``clear``)."""
    with _LOCK:
        _RACE_FAILED.add(key)


def race_failed(key: PlanKey) -> bool:
    return key in _RACE_FAILED


def lookup(key: PlanKey) -> Optional[Plan]:
    """Memory first, then disk.  Returns None on a full miss — the
    caller decides between static defaults and tuning."""
    # obs: not ported (the reference counts hits and misses per level)
    with _LOCK:
        hit = _MEM.get(key)
        if hit is not None:
            _MEM.move_to_end(key)
            return hit
    rec = _load_store(key.device_kind).get(key.token())
    if rec is None:
        return None
    try:
        plan = Plan.from_record(key, rec, source="cache")
    except (KeyError, TypeError, ValueError):
        return None
    memoize(plan)
    return plan


#: bounded-retry lock parameters for the disk-store merge-write: worst
#: case ~1 s of waiting before falling back to last-writer-wins with a
#: warn (a stuck peer must never wedge the process that just tuned)
_LOCK_RETRIES = 50
_LOCK_WAIT_S = 0.02
#: a lockfile older than this is an orphan (a writer killed between
#: acquire and release) and is broken, not waited on
_LOCK_STALE_S = 10.0


def _acquire_store_lock(path: str) -> Optional[tuple]:
    """Exclusive-create lockfile with bounded retry — the portable
    cross-process serialization for the read-merge-write below
    (``O_EXCL`` is atomic on every platform the store runs on).
    Returns ``(fd, lock_path)`` or None when the retries are exhausted
    (caller proceeds unlocked, last-writer-wins, announced)."""
    lock_path = f"{path}.lock"
    for _ in range(_LOCK_RETRIES):
        try:
            fd = os.open(lock_path,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # a holder that died between acquire and release leaves the
            # file behind forever: break locks past the staleness bound
            # instead of waiting on a corpse (another process's mtime
            # needs the wall clock)
            try:
                age = time.time() - os.path.getmtime(lock_path)
            except OSError:
                continue  # released between open and stat: retry now
            if age > _LOCK_STALE_S:
                warn(f"plan store lock {lock_path} is {age:.0f}s old "
                     f"(orphaned holder); breaking it")
                try:
                    os.unlink(lock_path)
                except OSError:
                    pass
                continue
            time.sleep(_LOCK_WAIT_S)
            continue
        try:
            os.write(fd, f"{os.getpid()}\n".encode())
        except OSError:
            pass  # the lock is held; the pid note is diagnostics only
        return fd, lock_path
    return None


def _release_store_lock(fd: int, lock_path: str) -> None:
    try:
        os.close(fd)
    except OSError:
        pass
    try:
        os.unlink(lock_path)
    except OSError:
        pass


def store(plan: Plan, persist: bool = True) -> None:
    """Memoize and (unless disabled) merge into the disk store.  Disk
    failures are swallowed, with a warn: a read-only HOME must never
    break the transform that just tuned successfully."""
    memoize(plan)
    if not persist:
        return
    path = store_path(plan.key.device_kind)
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # serialize the read-merge-write across processes: two tuners
        # finishing together must not drop each other's fresh winner
        lock = _acquire_store_lock(path)
        if lock is None:
            warn(f"plan store lock {path}.lock still contended after "
                 f"{_LOCK_RETRIES} tries; writing unlocked "
                 f"(last-writer-wins)")
        try:
            # merge over the FULL store contents, stale tokens
            # included: the read path skips them, but the write path
            # carries them through verbatim — a mixed-version deploy's
            # older processes still own those entries
            kept, stale = _partition_store(plan.key.device_kind,
                                           quiet=True)
            plans = {**stale, **kept}
            plans[plan.key.token()] = plan.to_record()
            data = {
                "schema": SCHEMA_VERSION,
                "library_version": _library_version(),
                "device_kind": plan.key.device_kind,
                "plans": plans,
            }
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(data, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if lock is not None:
                _release_store_lock(*lock)
    except OSError as e:
        # deliberate swallow, logged: a process silently re-tuning every
        # run because its store never persists is otherwise
        # undiagnosable
        warn(f"plan store write failed ({path}): {e}; tuning result "
             f"kept in memory only")


def disk_entries(device_kind: str) -> dict:
    """token -> plan record, for the CLI's `plan show`."""
    return _load_store(device_kind)


def clear(memory: bool = True, disk: bool = False) -> list:
    """Drop cache levels; returns the list of removed disk files."""
    removed = []
    if memory:
        with _LOCK:
            _MEM.clear()
            _RACE_FAILED.clear()
    if disk:
        d = cache_dir()
        if d is not None and os.path.isdir(d):
            for name in sorted(os.listdir(d)):
                if not name.startswith("plans-"):
                    continue
                path = os.path.join(d, name)
                if name.endswith(".json"):
                    try:
                        os.remove(path)
                        removed.append(path)
                    except OSError:
                        pass
                elif name.endswith(".json.lock"):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
    return removed
