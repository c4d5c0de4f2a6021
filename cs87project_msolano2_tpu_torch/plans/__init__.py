"""FFT plans: the variant and parameters for each key, made once and
reused in-process.

    plan(n).execute(xr, xi)            # 1-D transform
    plan_for(shape).execute(xr, xi)    # batched rows over the trailing axis

Plans come from the static ladder (:mod:`.ladder`); the disk store and
the autotuner of the reference are not ported yet.
"""

from __future__ import annotations

from functools import lru_cache

from .core import Plan, PlanKey, current_device_kind


def make_key(n: int, batch: tuple = (), layout: str = "natural",
             precision: str | None = None,
             device_kind: str | None = None,
             dtype: str = "float32",
             domain: str = "c2c",
             backend: str = "cuda",
             device="cuda") -> PlanKey:
    """PlanKey for an n-point transform over `batch` leading dims on
    `device` (its kind names the key unless `device_kind` is given)."""
    return PlanKey(
        device_kind=device_kind or current_device_kind(device),
        n=int(n),
        batch=tuple(int(b) for b in batch),
        layout=layout,
        dtype=dtype,
        precision=precision or "split3",
        domain=domain,
        backend=backend,
    )


@lru_cache(maxsize=256)
def get_plan(key: PlanKey, device: str = "cuda") -> Plan:
    """The plan for `key`: the static default, memoized per (key,
    device) for the life of the process."""
    from . import ladder

    variant, params = ladder.static_default(key)
    return Plan(key=key, variant=variant, params=params, device=device)


def plan(n: int, batch: tuple = (), layout: str = "natural",
         precision: str | None = None, domain: str = "c2c",
         device="cuda") -> Plan:
    """The single dispatch point: ``plan(n).execute(xr, xi)``.  Numpy
    input to ``execute`` goes to `device` — the card by default."""
    return get_plan(make_key(n, batch, layout, precision, domain=domain,
                             device=device), str(device))


def plan_for(shape, layout: str = "natural",
             precision: str | None = None, domain: str = "c2c",
             device="cuda") -> Plan:
    """Plan for float-plane arrays of `shape` (trailing axis = transform
    length, leading axes = batch)."""
    shape = tuple(shape)
    return plan(shape[-1], shape[:-1], layout, precision, domain=domain,
                device=device)
