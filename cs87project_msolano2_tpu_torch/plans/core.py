"""PlanKey / Plan: what a kernel choice IS.

A :class:`PlanKey` is everything the kernel choice may depend on, with
the reference's field names (``plans/core.py``) and the port's backend
tag ``"cuda"``.  A :class:`Plan` binds a key to one variant + parameter
set from :mod:`.ladder` and runs it.  There is no disk store and no
autotuner yet; plans come from the static ladder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..ops.precision import PRECISIONS

LAYOUTS = ("natural", "pi")
DOMAINS = ("c2c", "r2c", "c2r")
#: the port's one lowering family
BACKENDS = ("cuda",)


def current_device_kind(device) -> str:
    """Identifier of the device a plan serves: the card's name, or the
    device type where no card is present."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(dev)
    return dev.type


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Everything a kernel-config choice may depend on.

    layout: "natural" (frequency order; the gather rides inside the
    plan) or "pi" (per-transform bit-reversed, the kernel-native order).
    precision: the storage/accumulate mode and its error budget
    (ops.precision).  domain: "c2c", or the real domains "r2c"/"c2r".
    backend: the lowering family — "cuda" for this package.
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


@dataclasses.dataclass
class Plan:
    """A resolved kernel choice for one PlanKey.

    `device` is where numpy input to ``execute`` goes (the card unless
    the plan was made for the CPU); tensors run where they lie.
    """

    key: PlanKey
    variant: str
    params: dict
    device: str = "cuda"
    _fn: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def fn(self) -> Callable:
        """The (xr, xi) -> (yr, yi) executor on tensors, built lazily
        from the ladder and cached on the plan."""
        if self._fn is None:
            from . import ladder

            self._fn = ladder.build_executor(self.key, self.variant,
                                             self.params)
        return self._fn

    def execute(self, xr, xi):
        """Forward transform on float planes (tensors or numpy)."""
        from ..utils.device import as_planes

        return self.fn(*as_planes(xr, xi, self._numpy_device(xr)))

    def execute_inverse(self, xr, xi):
        """Inverse via the conj trick (natural layout, c2c only)."""
        if self.key.layout != "natural":
            raise ValueError("inverse requires a natural-layout plan")
        from ..utils.device import as_planes

        xr, xi = as_planes(xr, xi, self._numpy_device(xr))
        n = self.key.n
        yr, yi = self.fn(xr, -xi)
        return yr / n, -yi / n

    def _numpy_device(self, x):
        import torch

        return None if isinstance(x, torch.Tensor) else self.device
