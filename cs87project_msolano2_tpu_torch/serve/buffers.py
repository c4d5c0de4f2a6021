"""Staging-buffer pools: reuse the padded batch planes across requests
(the reference's ``serve/buffers.py``).

Every coalesced batch stages its requests' float planes into one
``(B_pad, width)`` pair of host arrays before the transform.  Allocating
those per batch at serving rates is allocator churn (they are the same
handful of shapes forever: the padded batch buckets of the served
shapes), so the pool keeps released arrays on a per-shape free list and
hands them back on the next acquire.

When the pool serves the card, its host arrays are pinned
(``pin_memory()``), so the batch's host-to-device copy runs
asynchronously at full rate; a pinned array may return to the pool only
after that copy has completed (the batcher synchronizes the copy's
event first).  The card side keeps a second pool, of device plane pairs
keyed by ``(bucket, width)``: the port's counterpart of the reference's
input donation, the device memory a batch lands in is reused by the
group's next batch instead of coming from the allocator.

Thread-safe: the dispatcher's executor threads (one batch per group at a
time, several groups at once) acquire and release together.  Reuse is
observable: ``pifft_serve_buffer_reuse_total`` vs
``pifft_serve_buffer_alloc_total`` (and the ``_device_`` pair for the
card side), and :meth:`BufferPool.stats` for in-process assertions.
"""

from __future__ import annotations

import threading

import numpy as np


class BufferPool:
    """Per-(shape, dtype) free lists of host staging arrays and, for a
    pool of the card, per-(bucket, width) free lists of device plane
    pairs.

    ``device`` is where the staged planes go: None or the CPU keeps plain
    host arrays and no device pool; a CUDA device pins the host arrays
    and pools device planes.  ``max_per_key`` bounds each free list, so a
    burst of odd shapes cannot pin memory forever; overflow releases are
    dropped to the allocator.
    """

    def __init__(self, max_per_key: int = 8, device=None):
        import torch

        self.max_per_key = max_per_key
        self.device = None if device is None else torch.device(device)
        self.pinned = self.device is not None \
            and self.device.type == "cuda"
        self._free: dict = {}
        self._dev_free: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.device_hits = 0
        self.device_misses = 0

    def _host_array(self, shape, dtype) -> np.ndarray:
        if self.pinned and np.dtype(dtype) == np.float32:
            import torch

            # the array keeps its pinned tensor alive (tensor.numpy())
            return torch.empty(tuple(shape), dtype=torch.float32,
                               pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def acquire(self, shape, dtype=np.float32) -> np.ndarray:
        """A writable host array of `shape`: pooled when one is free,
        fresh otherwise.  Contents are UNDEFINED: the batcher overwrites
        every row it uses and zeroes the padding rows explicitly."""
        from ..obs import metrics

        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            if free:
                self.hits += 1
                buf = free.pop()
            else:
                self.misses += 1
                buf = None
        if buf is not None:
            metrics.inc("pifft_serve_buffer_reuse_total")
            return buf
        metrics.inc("pifft_serve_buffer_alloc_total")
        return self._host_array(shape, dtype)

    def release(self, *arrays) -> None:
        """Return host arrays to their free lists (dropped when the list
        is full).  A pinned array must not be released before the copy
        that reads it has completed."""
        with self._lock:
            for arr in arrays:
                if arr is None:
                    continue
                key = (tuple(arr.shape), arr.dtype.str)
                free = self._free.setdefault(key, [])
                if len(free) < self.max_per_key:
                    free.append(arr)

    def acquire_device(self, bucket: int, width: int) -> tuple:
        """A (real, imaginary) pair of float32 planes of shape (bucket,
        width) on the pool's device: pooled when one is free.  Contents
        are undefined; the batch's copy overwrites them."""
        import torch

        from ..obs import metrics

        key = (int(bucket), int(width))
        with self._lock:
            free = self._dev_free.get(key)
            if free:
                self.device_hits += 1
                pair = free.pop()
            else:
                self.device_misses += 1
                pair = None
        if pair is not None:
            metrics.inc("pifft_serve_device_buffer_reuse_total")
            return pair
        metrics.inc("pifft_serve_device_buffer_alloc_total")
        return tuple(torch.empty(key, dtype=torch.float32,
                                 device=self.device) for _ in range(2))

    def release_device(self, pair) -> None:
        """Return a device plane pair to its free list.  Work that reads
        or writes it must be ordered before the next user's on the same
        stream, which the serving path's one stream gives."""
        key = tuple(pair[0].shape)
        with self._lock:
            free = self._dev_free.setdefault(key, [])
            if len(free) < self.max_per_key:
                free.append(tuple(pair))

    def stats(self) -> dict:
        with self._lock:
            pooled = sum(len(v) for v in self._free.values())
            out = {"hits": self.hits, "misses": self.misses,
                   "pooled": pooled}
            if self.pinned:
                out.update(device_hits=self.device_hits,
                           device_misses=self.device_misses,
                           device_pooled=sum(
                               len(v) for v in self._dev_free.values()))
            return out

    def pooled_shapes(self) -> set:
        """Shapes with at least one pooled host array: the staging-side
        warmth signal (a pool holding a ``(bucket, width)`` pair for a
        group has staged that group before)."""
        with self._lock:
            return {shape for (shape, _dt), free in self._free.items()
                    if free}


def landing_views(payload, width: int, *, no_xi: bool = False,
                  dtype: int = 0):
    """Zero-copy ``(xr, xi)`` float32 views over a binary frame's payload
    bytes: the wire bytes ARE the request planes, and the batcher's
    staging copy into this pool's arrays is the one host copy the request
    pays.  `dtype` is the wire dtype code (``wire.DTYPE_F32`` /
    ``wire.DTYPE_BF16``); the bf16 path must widen and is charged to the
    host-copy meter (site ``bf16_wire``)."""
    from . import wire

    if dtype == wire.DTYPE_BF16:
        bits = np.frombuffer(payload, np.uint16)
        # widening bf16 -> f32 makes new planes: a metered copy (the f32
        # path stays at zero)
        wire.charge_host_copy(bits.nbytes * 2, site="bf16_wire")
        full = (bits.astype(np.uint32) << 16).view(np.float32)
        xr = full[:width]
        xi = None if no_xi else full[width:2 * width]
        return xr, xi
    xr = np.frombuffer(payload, np.float32, count=width)
    xi = None if no_xi else np.frombuffer(payload, np.float32,
                                          count=width, offset=width * 4)
    return xr, xi
