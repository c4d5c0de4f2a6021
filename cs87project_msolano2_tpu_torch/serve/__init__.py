"""Serving: async batched FFT-as-a-service on one card (the reference's
``serve/`` package, less its mesh and router).

The front door that turns CONCURRENT REQUESTS into BATCHED KERNEL
INVOCATIONS: requests over a socket (or ``await Dispatcher.submit``)
coalesce into one padded batch, and that batch runs as one launch of the
port's Hopper kernels on the card (the plan for the padded batched
shape: ``rows`` is one ``tile_fft``, a pi batch past 2^16 ``rql`` over
the batch).

* ``dispatcher``  the asyncio front: bounded per-group queues with
                  structured backpressure (:class:`QueueFull` and
                  ``retry_after_ms``), one coalescing worker per group,
                  admission-time degradation, the queue-wait/compute
                  split per request.
* ``batcher``     requests -> one padded ``(B_pad, n)`` invocation of
                  the plan ``plans.plan_for`` resolves (power-of-two
                  batch buckets), with the serve half of the resilience
                  ladder; on the card no library rung serves.
* ``buffers``     pooled host staging planes (pinned for the card) and
                  pooled device planes.
* ``shapes``      the served shape set (JSONL) and the warm start shared
                  with ``plan warm --shapes``.
* ``slo``         per-shape p50/p99 with the queue-wait vs compute split.
* ``wire``        the binary frame codec, its client and the host-copy
                  meter; ``shm`` the same-host shared-memory lane.
* ``protocol``    the socket front: the JSON and binary dialects on one
                  port.
* ``cli``         ``python -m cs87project_msolano2_tpu_torch serve``, its
                  ``--smoke`` and ``--wire-smoke`` gates;
                  ``precision_smoke`` and ``anylen_smoke`` the two
                  smokes beside it.

Every entry point takes ``device=None``: the card, unless the caller
asks for the CPU.  Requests and responses are numpy planes.
"""

from __future__ import annotations

from .batcher import BatchRunner, GroupKey, batch_bucket  # noqa: F401
from .buffers import BufferPool  # noqa: F401
from .dispatcher import (  # noqa: F401
    PRIORITIES,
    Dispatcher,
    DispatcherClosed,
    QueueFull,
    Request,
    RequestFailed,
    Response,
    ServeConfig,
    ServeError,
    ShapeNotServed,
)
from .shapes import ShapeSpec, load_shapes, warm  # noqa: F401
from .slo import (  # noqa: F401
    LatencyStats,
    format_summary,
    percentile,
    percentile_or_none,
)
