"""Multi-process jobs (the reference's ``parallel/multihost.py``).

The reference wraps JAX's multi-process runtime; the port sets up
``torch.distributed``: :func:`init_distributed` once per process (it
no-ops outside a launcher's environment), then :func:`global_mesh` or
``mesh.make_mesh`` builds the mesh over every rank of the job; the
sharded entry points run on it unchanged.  The pi-FFT makes no
collective at all; the 2-D and 3-D transposes ride the job's process
group (NCCL between cards, gloo on the CPU or between ranks that share
one card).

:func:`spawn_local` is the local launcher: `world` ranks on this host,
each a fresh interpreter (``start_method="spawn"``) joined through a
file store in a temporary directory, so concurrent jobs never contend
for a TCP port.  It is the port's counterpart of the reference's
``--xla_force_host_platform_device_count`` virtual mesh.  Each rank
returns its result to the launcher, which assembles nothing: a caller
concatenates the ranks' blocks, outside any measured path.  A job is a
module-level function of the port (or of the launching script): each
rank builds its mesh (``mesh.make_mesh``), takes its blocks
(``Mesh.block``) and runs the entry points, :func:`call_record`
recording each call.

Fallback consensus (:func:`agree_on_fallback`): degradation must be
consistent across ranks.  If one rank escapes to the collective-free
path while another retries the all_to_all, the retrying ranks wait on a
peer that never arrives.  So before any rank switches, all agree on the
fallback epoch through the job's store: each sets
``pifft/fallback/<epoch>/<rank>`` and waits, with a deadline, for every
rank's key — a barrier on the store, the same for NCCL and gloo (the
process group's ``monitored_barrier`` is gloo's only) and no collective
of the process group.  A barrier that does not form raises
:class:`HostDesyncError` (PERMANENT: no local retry reconciles a split).
"""

from __future__ import annotations

import datetime
import itertools
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Optional

import torch

from ..obs import events, spans
from ..resilience import (  # noqa: F401  (re-exports: rendezvous discipline)
    CollectiveAborted,
    CollectiveTimeout,
    HostDesyncError,
    collective_watchdog,
    rendezvous_deadline_s,
    supervise_collective,
)
from .mesh import Mesh, launch_device, make_mesh

#: the job's key-value store (set by init_distributed): the consensus's
#: barrier
_STORE: list = [None]

#: seconds a spawn_local job may take before its ranks are killed
SPAWN_TIMEOUT_S = 900.0


def default_backend(world: int, device) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU,
    or ranks sharing a card: NCCL refuses two ranks on one GPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available() \
            and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _make_store(coordinator: str, world: int, rank: int,
                timeout: datetime.timedelta):
    """The job's store at `coordinator`: ``file://<path>`` or
    ``[tcp://]host:port`` (rank 0 serves it)."""
    import torch.distributed as dist

    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], world)
        store.set_timeout(timeout)
        return store
    host, _, port = coordinator.removeprefix("tcp://").rpartition(":")
    return dist.TCPStore(host, int(port), world, is_master=rank == 0,
                         timeout=timeout)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group of a multi-process job, if this looks like
    (or is configured as) one: `coordinator`, `num_processes` and
    `process_id` default to ``PIFFT_COORDINATOR`` (``file://<path>`` or
    ``tcp://host:port``), ``PIFFT_NUM_PROCESSES`` and
    ``PIFFT_PROCESS_ID``.  Returns True if it joined.

    The rendezvous deadline (``PIFFT_RENDEZVOUS_DEADLINE_S``, or
    `timeout_s`) bounds the job's formation and every later operation
    of the group, so a thread stuck in a collective ends and teardown
    cannot hang: a job that never forms raises
    :class:`CollectiveTimeout` (TRANSIENT — the launcher may retry)."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("PIFFT_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PIFFT_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("PIFFT_PROCESS_ID", "0") or 0)
    if not coordinator or num_processes < 1:
        return False
    backend = backend or default_backend(num_processes, None)
    timeout = datetime.timedelta(seconds=timeout_s if timeout_s is not None
                                 else rendezvous_deadline_s())
    try:
        # the job-formation rendezvous is a collective region like any
        # other: span it so a slow coordinator shows up named in the
        # trace and the event stream
        with spans.span("collective:init_distributed",
                        processes=num_processes):
            store = _make_store(coordinator, num_processes, process_id,
                                timeout)
            dist.init_process_group(backend, store=store, rank=process_id,
                                    world_size=num_processes,
                                    timeout=timeout)
    except Exception as e:
        from ..resilience import FaultKind, classify

        if classify(e) is FaultKind.TRANSIENT:
            raise CollectiveTimeout(
                f"distributed init did not form a {num_processes}-process "
                f"job at {coordinator} ({type(e).__name__}: "
                f"{str(e)[:200]})") from e
        raise
    _STORE[0] = store
    events.emit("distributed_init", coordinator=coordinator,
                processes=num_processes, process_id=process_id,
                backend=backend)
    return True


def shutdown_distributed() -> None:
    """Leave the job's process group (a no-op outside one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STORE[0] = None


def global_mesh(axis: str = "p", device=None) -> Mesh:
    """1-D mesh over every rank of the job."""
    return make_mesh(None, axis, device)


# ------------------------------------------------- fallback consensus

_EPOCH_COUNTER = itertools.count(1)
_EPOCH_LOCK = threading.Lock()


def agree_on_fallback(label: str, reason: str = "",
                      deadline_s: Optional[float] = None,
                      store=None, processes: Optional[int] = None,
                      rank: Optional[int] = None) -> int:
    """All-ranks agreement on the next fallback epoch; returns it.

    A single process (or a process outside a job) agrees at once.  In a
    job every rank sets ``pifft/fallback/<epoch>/<rank>`` on the store
    and waits for every rank's key for at most the deadline (default
    the rendezvous deadline): ranks that went through the same escapes
    hold the same epoch, so a barrier that forms means every rank
    switches together, and one that does not raises
    :class:`HostDesyncError`.  `store` (anything with ``set(key,
    value)`` and ``wait(keys, timeout)``), `processes` and `rank` are
    injectable for tests."""
    with _EPOCH_LOCK:
        epoch = next(_EPOCH_COUNTER)
    deadline = float(deadline_s if deadline_s is not None
                     else rendezvous_deadline_s())
    if store is None:
        store = _STORE[0]
    if processes is None or rank is None:
        from .mesh import _job

        world, me = _job() if store is not None else (1, 0)
        processes = world if processes is None else processes
        rank = me if rank is None else rank
    with spans.span("collective:fallback_consensus", epoch=epoch,
                    deadline_s=deadline):
        if store is None or processes <= 1:
            events.emit("fallback_consensus", label=label, epoch=epoch,
                        agreed=True, processes=1,
                        reason=str(reason)[:200])
            return epoch
        keys = [f"pifft/fallback/{epoch}/{r}" for r in range(processes)]
        try:
            store.set(keys[rank], f"{label}: {reason}"[:512])
            store.wait(keys, datetime.timedelta(seconds=deadline))
        except Exception as e:
            events.emit("fallback_consensus", label=label, epoch=epoch,
                        agreed=False, processes=processes,
                        error=f"{type(e).__name__}: {str(e)[:200]}")
            raise HostDesyncError(
                f"fallback consensus for epoch {epoch} at {label} did not "
                f"form within {deadline:g}s — ranks may be split between "
                f"the all_to_all and collective_free paths "
                f"({type(e).__name__}: {str(e)[:200]})") from e
        events.emit("fallback_consensus", label=label, epoch=epoch,
                    agreed=True, processes=processes,
                    reason=str(reason)[:200])
        return epoch


# ------------------------------------------------------- local launcher


def _rank_main(rank, world, backend, device, tmp, timeout_s):
    """One rank of a spawn_local job: join the job, run its ``fn(*args)``
    (from ``job.pkl`` in `tmp`) with `device` as the meshes' default,
    leave its result (or its traceback) in `tmp`."""
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        with open(os.path.join(tmp, "job.pkl"), "rb") as fh:
            fn, args = pickle.load(fh)
        init_distributed(f"file://{os.path.join(tmp, 'store')}", world,
                         rank, backend, timeout_s)
        with launch_device(device):
            out = fn(*args)
        part = os.path.join(tmp, f"result_{rank}.part")
        with open(part, "wb") as fh:
            pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(part, os.path.join(tmp, f"result_{rank}.pkl"))
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        sys.stderr.write(f"# rank {rank} failed:\n{traceback.format_exc()}")
        sys.exit(1)
    finally:
        shutdown_distributed()


def spawn_local(fn, world: int, backend: Optional[str], device, *args,
                timeout_s: float = SPAWN_TIMEOUT_S,
                group_timeout_s: Optional[float] = None) -> list:
    """Run ``fn(*args)`` on `world` ranks of a fresh local job and return
    their results in rank order.

    Each rank is a spawned interpreter: it imports `fn`'s module (`fn`
    is a module-level function) and, as multiprocessing's spawn does,
    the caller's main script, whose work must sit under ``if __name__ ==
    "__main__"``; it is joined through a file store in a temporary
    directory, with
    `backend` (None: :func:`default_backend`) and `device` as its
    meshes' default device.  Build the CUDA kernels in the caller first
    (``utils.buildlib.build``): ranks building at once would race the
    build directory.  A rank that fails ends the job: the others are
    killed and RuntimeError carries the failed ranks' tracebacks; so
    does a job past `timeout_s`.  `group_timeout_s` bounds every
    operation of the job's process group (default the rendezvous
    deadline)."""
    backend = backend or default_backend(world, device)
    tmp = tempfile.mkdtemp(prefix="pifft-job-")
    # the job goes through a file: a start pipe would hold each spawn
    # until its child had imported enough to read it
    with open(os.path.join(tmp, "job.pkl"), "wb") as fh:
        pickle.dump((fn, args), fh, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"pifft-rank{r}",
                         args=(r, world, backend, str(device), tmp,
                               group_timeout_s))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            failed = any(p.exitcode not in (None, 0) for p in procs)
            if failed or time.monotonic() > end:
                break
            time.sleep(0.02)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"result_{r}.pkl")
            err = os.path.join(tmp, f"error_{r}.txt")
            if os.path.exists(err):
                with open(err) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
            elif not os.path.exists(path):
                errors.append(f"rank {r}: exit {p.exitcode} with no "
                              f"result (killed when a rank failed or at "
                              f"the job's {timeout_s:g} s limit)")
            else:
                with open(path, "rb") as fh:
                    results.append(pickle.load(fh))
        if errors:
            raise RuntimeError(f"spawn_local job of {world} {backend} "
                               f"ranks on {device} failed:\n"
                               + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------- rank helpers


def loaded_packages() -> list:
    """The top-level packages this process has imported: a rank's
    diagnostic (a job's ranks import the port and what it depends on,
    nothing of the caller's)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)})


def to_host(value):
    """`value` with every tensor in it moved to a numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (tuple, list)):
        return type(value)(to_host(v) for v in value)
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    return value


def call_record(fn, *args, **kwargs) -> dict:
    """One call of a rank's job: its result with tensors as numpy arrays
    (``out``), its seconds on the host clock, the result's move to the
    host included (``s``), the collectives it dispatched
    (``collectives``) and the records the collective layer made
    (``events``, the kinds ``watchdog.recorded_kinds`` reads from the
    observability stream, armed around the call where it is off)."""
    from .. import obs
    from ..resilience.watchdog import recorded_kinds
    from . import collectives

    calls0 = collectives.COLLECTIVE_CALLS
    with obs.armed(), recorded_kinds() as kinds:
        t0 = time.perf_counter()
        out = to_host(fn(*args, **kwargs))
        s = time.perf_counter() - t0
    return {"out": out, "s": s,
            "collectives": collectives.COLLECTIVE_CALLS - calls0,
            "events": kinds}
