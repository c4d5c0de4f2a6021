"""Device inventory: one typed answer to "what hardware is here" (the
reference's ``hw/inventory.py``), read from
``torch.cuda.get_device_properties`` in place of the TPU's VMEM fields.

    python -m cs87project_msolano2_tpu_torch hw probe [--json]
    python -m cs87project_msolano2_tpu_torch.hw.inventory [--json|-v|--cores]

It reports the card's name and count, its SM count, shared memory per
block (the opt-in maximum) and per SM, L2 size, the persisting-L2 limit
(the largest window one launch may keep resident, from the kernel
library), total memory, the host's cores and the memory-bandwidth
ceiling per plan backend from ``utils.roofline``.  Every sub-probe
degrades to an empty (None) row where it cannot answer, as on a machine
with no card: probing never raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

#: schema version of the probe JSON (``hw probe --json``): bump on any
#: field rename or removal; additions are compatible
INVENTORY_SCHEMA = 1


def cpu_cores() -> int:
    """Cores this process may run on (its affinity mask where the
    platform has one), never an error."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def peak_bytes_per_s(backend: str,
                     device_kind: str = "") -> Optional[float]:
    """The memory-bandwidth ceiling (bytes/s) the roofline divides by
    for a plan backend on the card named `device_kind`: both port
    backends ("cuda", "gpu") run on the card, so its data-sheet HBM
    rate (``utils.roofline.peak_bytes_per_s``); None for an unknown
    card or any other backend (timings there mean nothing)."""
    from ..plans.core import BACKENDS
    from ..utils.roofline import peak_bytes_per_s as card_peak

    if backend not in BACKENDS:
        return None
    return card_peak(device_kind)


@dataclasses.dataclass(frozen=True)
class DeviceInventory:
    """One process's inventory.  platform: "cuda" where a card is
    present, else "cpu"; backend: the tag ``plans.make_key`` stamps by
    default; the card fields are those of card 0, None without one;
    bandwidth: backend tag -> ceiling bytes/s (None where unknowable)."""

    platform: str
    backend: str
    device_kind: str
    device_count: int
    cpu_cores: int
    sm_count: Optional[int]
    smem_per_block_bytes: Optional[int]
    smem_per_sm_bytes: Optional[int]
    l2_bytes: Optional[int]
    persisting_l2_max_bytes: Optional[int]
    total_memory_bytes: Optional[int]
    bandwidth: dict

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = INVENTORY_SCHEMA
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)


def _card_count() -> int:
    import torch

    try:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    except RuntimeError:
        return 0


def _persisting_l2_max(index: int) -> Optional[int]:
    """The card's persisting-L2 window limit from the kernel library
    (built at first use), or None where it cannot be built or asked."""
    import torch

    from ..ops.cuda_fft import fused_carry_limit

    try:
        return fused_carry_limit(torch.device("cuda", index))
    except (RuntimeError, OSError):
        return None


def probe(index: int = 0) -> DeviceInventory:
    """Discover this process's inventory (card `index` for the card
    fields).  Every sub-probe is graceful: no card, or a library that
    cannot be built, gives None rows, never an exception."""
    from ..plans.core import BACKENDS, current_device_kind

    count = _card_count()
    props = None
    kind = "cpu"
    if count > index:
        import torch

        try:
            props = torch.cuda.get_device_properties(index)
            kind = current_device_kind(torch.device("cuda", index))
        except (RuntimeError, AssertionError):
            props = None

    def prop(name):
        return getattr(props, name, None) if props is not None else None

    return DeviceInventory(
        platform="cuda" if props is not None else "cpu",
        backend=BACKENDS[0],
        device_kind=kind,
        device_count=count,
        cpu_cores=cpu_cores(),
        sm_count=prop("multi_processor_count"),
        smem_per_block_bytes=(prop("shared_memory_per_block_optin")
                              or prop("shared_memory_per_block")),
        smem_per_sm_bytes=prop("shared_memory_per_multiprocessor"),
        l2_bytes=prop("L2_cache_size"),
        persisting_l2_max_bytes=(_persisting_l2_max(index)
                                 if props is not None else None),
        total_memory_bytes=prop("total_memory"),
        bandwidth={b: peak_bytes_per_s(b, kind) for b in BACKENDS},
    )


def main(argv=None) -> int:
    """The probe CLI: ``--json`` prints the full inventory, ``--cores``
    the host's cores, otherwise the card count (``-v``: one line per
    card)."""
    ap = argparse.ArgumentParser(prog="cs87project_msolano2_tpu_torch hw "
                                      "probe", description="capacity probes")
    ap.add_argument("-v", action="store_true", help="verbose device info")
    ap.add_argument("--cores", action="store_true",
                    help="print the host's core count instead")
    ap.add_argument("--json", action="store_true",
                    help="print the full typed inventory as JSON")
    args = ap.parse_args(argv)
    if args.json:
        print(probe().to_json())
        return 0
    if args.cores:
        print(cpu_cores())
        return 0
    count = _card_count()
    if args.v and count:
        import torch

        for i in range(count):
            print(f"device {i}: {torch.cuda.get_device_name(i)}")
    print(count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
