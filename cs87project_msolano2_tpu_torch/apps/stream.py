"""Overlap-save / overlap-add streaming convolution (the reference's
``apps/stream.py``).

A signal longer than any transform, or one that has not finished
arriving, is served by the block-convolution identities: chunk the
input, convolve each chunk against the kernel through ONE cached plan
pair at the block length (``spectral._fused_circular``, the cached
kernel spectrum), and stitch.  Overlap-save slides a ``block``-long
window by ``L = block - (m-1)`` samples and keeps the L circularly-valid
outputs of each chunk; overlap-add convolves disjoint L-chunks to
``L+m-1`` and adds the overhangs.  The chunks are sliced on the
signal's device, so a signal on the card never leaves it.

The block size is a tuned axis: a big block amortizes the transform
(cost ~ block·log2(block) a chunk) but wastes the last chunk's padding;
a small block wastes ``(m-1)/block`` of every transform on overlap.
:func:`choose_block` minimizes the analytic total; :func:`tune_block`
RACES the candidate blocks on the card (every candidate's fate counted
on ``pifft_apps_block_race_total{block,fate}`` while observability is
armed) and serves the analytic choice where the device cannot be timed,
as ``plans.tune_or_static`` does.  Each chunk runs under an
``overlap_save_chunk`` or ``overlap_add_chunk`` span and counts on
``pifft_apps_ops_total{op="conv"}``.

Front doors: :func:`overlap_save` / :func:`overlap_add` (eager,
``numpy.convolve(x, k, "full")`` parity); :func:`overlap_save_stream` /
:class:`OverlapSave` (push chunks as they arrive, drain outputs as they
become final); :func:`overlap_save_journaled` (each chunk's output
checkpointed to the resilience journal, a re-run resuming at the first
chunk a kill took).  Numpy in gives numpy out; a tensor in gives a
tensor out on its own device.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

from ..obs import metrics
from ..obs.spans import span
from ..utils.device import as_plane
from ..utils.roofline import charge_spectral_traffic
from .spectral import (
    _device,
    _fused_circular,
    _host_kernel,
    _kernel_hash,
    _like,
    kernel_spectrum,
    next_pow2,
)

#: the largest raced or chosen block (2^18 keeps every candidate inside
#: the carry-free plan regime)
MAX_BLOCK = 1 << 18


def overlap_waste(block: int, m: int) -> float:
    """Fraction of each transform spent re-computing the overlap:
    (m-1)/block."""
    return (m - 1) / block


def chunk_count(n: int, m: int, block: int) -> int:
    """Chunks an n-sample signal needs at this block size (full
    convolution output, n+m-1 samples)."""
    step = block - (m - 1)
    return max(1, -(-(n + m - 1) // step))


def block_candidates(m: int, n: Optional[int] = None) -> list:
    """The raced block sizes for an m-tap kernel: powers of two and the
    3·2^j sizes between them (one-level mixed-radix plans), from the
    smallest useful block (>= 2·(m-1)) up to MAX_BLOCK, stopping one size
    past the whole padded signal when `n` is known."""
    lo = max(2 * (m - 1), 2)
    cands = []
    b = next_pow2(lo)
    while b <= MAX_BLOCK:
        half = 3 * b // 4  # 1.5x the previous pow2: 3*2^(j-2)
        if lo <= half < b and half % 2 == 0:
            cands.append(half)
            if n is not None and half >= n + m - 1:
                break
        cands.append(b)
        if n is not None and b >= n + m - 1:
            break
        b *= 2
    return cands


def block_cost(block: int, m: int, n: Optional[int] = None) -> float:
    """Analytic cost of serving at this block size: chunk count times the
    O(block log block) transform work when the signal length is known,
    transform work per useful output sample otherwise."""
    step = block - (m - 1)
    if step < 1:
        return math.inf
    per_chunk = block * math.log2(block)
    if n is None:
        return per_chunk / step
    return chunk_count(n, m, block) * per_chunk


def choose_block(m: int, n: Optional[int] = None) -> int:
    """The analytic block choice: argmin of :func:`block_cost` over the
    candidates."""
    cands = block_candidates(m, n)
    return min(cands, key=lambda b: block_cost(b, m, n))


def tune_block(m: int, n: Optional[int] = None, reps: int = 3,
               verbose: bool = False, device=None) -> int:
    """The RACED block choice: on a card (``plans.device_is_tunable``),
    time one fused chunk convolution per candidate block by CUDA events
    (``utils.timing.time_ms``: what a chunk costs its caller, host
    dispatch included) and pick the lowest measured cost (ms times the
    chunk count, or per useful sample without `n`); elsewhere serve the
    analytic choice.  A candidate that fails with a CAPACITY or
    PERMANENT fault is rejected and the race goes on; a TRANSIENT fault
    or a sticky CUDA error re-raises.  Every fate is counted on
    ``pifft_apps_block_race_total{block,fate}`` and, with `verbose`,
    written to stderr."""
    from .. import plans
    from ..resilience import FaultKind, classify, sticky
    from ..utils.timing import time_ms

    cands = block_candidates(m, n)
    target = "cuda" if device is None else device
    if len(cands) == 1 or not plans.device_is_tunable(target):
        return choose_block(m, n)
    dev = _device(target)
    rng = np.random.default_rng(0)
    k = rng.standard_normal(m).astype(np.float32)
    best, best_cost = None, math.inf
    for block in cands:
        xp = torch.from_numpy(rng.standard_normal(block)
                              .astype(np.float32)).to(dev)
        try:
            kr, ki = kernel_spectrum(k, block, device=dev)
            fused = _fused_circular("conv", block, None, dev)
            ms, _ = time_ms(fused, xp, kr, ki, reps=reps, warmup=1)
        except Exception as e:
            kind = classify(e)
            if kind is FaultKind.TRANSIENT or sticky(e):
                raise  # the moment failed, not the block
            metrics.inc("pifft_apps_block_race_total",
                        block=str(block), fate="rejected")
            plans.warn(f"block race: block={block} rejected "
                       f"({kind.value} {type(e).__name__}: "
                       f"{str(e)[:120]})")
            continue
        cost = ms * chunk_count(n, m, block) if n is not None \
            else ms / (block - (m - 1))
        won = cost < best_cost
        metrics.inc("pifft_apps_block_race_total", block=str(block),
                    fate="timed")
        if verbose:
            plans.warn(f"block race: block={block} {ms:.4f} ms/chunk "
                       f"cost={cost:.6f}{' <- best' if won else ''}")
        if won:
            best, best_cost = block, cost
    return best if best is not None else choose_block(m, n)


# ------------------------------------------------------ the push API


class OverlapSave:
    """Streaming overlap-save convolver: push input chunks of ANY size,
    drain full-convolution output as it becomes final.

        conv = OverlapSave(k, block=4096)
        for piece in arriving_signal:
            out.append(conv.push(piece))   # maybe-empty arrays
        out.append(conv.flush())           # the tail

    ``concatenate(out) == np.convolve(signal, k, "full")``.  ONE plan
    pair (r2c + c2r at ``block``) and one cached kernel spectrum serve
    every chunk; each chunk's traffic goes on the bytes meter.  The
    state lives on `device` (a tensor kernel's own device by default,
    else the card); `push` returns what it was given (numpy or a tensor
    on the chunk's device), `flush` as the last chunk pushed."""

    def __init__(self, k, block: Optional[int] = None,
                 precision: Optional[str] = None, device=None):
        self.device = _device(device, k)
        self.k = _host_kernel(k)
        if self.k.ndim != 1 or self.k.shape[0] < 1:
            raise ValueError(f"kernel must be a non-empty 1-D array, got "
                             f"shape {self.k.shape}")
        self.m = self.k.shape[0]
        self.block = int(block) if block is not None \
            else choose_block(self.m)
        if self.block < 2 or self.block % 2:
            raise ValueError(f"block={self.block} must be an even length "
                             f">= 2 (the r2c pack trick needs the even/odd "
                             f"split; any even length is a ladder plan)")
        if self.block < self.m:
            raise ValueError(f"block={self.block} < kernel length "
                             f"{self.m}: no valid outputs per chunk")
        self.step = self.block - (self.m - 1)
        self.precision = precision
        self._kr, self._ki = kernel_spectrum(self.k, self.block, precision,
                                             self.device)
        self._fused = _fused_circular("conv", self.block, precision,
                                      self.device)
        #: the saved overlap: the last m-1 input samples (zeros before
        #: the signal starts)
        self._tail = self._zeros(self.m - 1)
        self._buffer = self._zeros(0)
        self._out_like = np.zeros(0, np.float32)  # what flush returns
        self._consumed = 0      # input samples fully processed
        self.chunks = 0         # fused invocations so far

    def _zeros(self, count: int):
        return torch.zeros(count, dtype=torch.float32, device=self.device)

    def _convolve_block(self, seg):
        """One fused circular conv of a block-long window; returns the
        step valid output samples."""
        with span("overlap_save_chunk",
                  cell={"op": "conv", "n": self.block},
                  chunk=self.chunks):
            y = self._fused(seg, self._kr, self._ki)
            metrics.inc("pifft_apps_ops_total", op="conv")
            charge_spectral_traffic("conv", self.block)
        self.chunks += 1
        return y[self.m - 1:]

    def _advance(self, head) -> torch.Tensor:
        """Convolve the window (saved overlap, `head`) and slide it."""
        seg = torch.cat([self._tail, head])
        self._tail = seg[self.step:]
        return self._convolve_block(seg)

    def push(self, chunk):
        """Feed more signal; returns every output sample that is now
        final (possibly none).  Sample i of the concatenated stream is
        ``np.convolve(x, k, 'full')[i]``."""
        self._out_like = chunk[:0].clone() \
            if isinstance(chunk, torch.Tensor) else np.zeros(0, np.float32)
        chunk = as_plane(chunk, self.device).reshape(-1)
        self._buffer = torch.cat([self._buffer, chunk])
        out = []
        while self._buffer.shape[0] >= self.step:
            head, self._buffer = (self._buffer[:self.step],
                                  self._buffer[self.step:])
            out.append(self._advance(head))
            self._consumed += self.step
        y = torch.cat(out) if out else self._zeros(0)
        return _like(y, self._out_like)

    def flush(self):
        """Close the stream: convolve the zero-padded remainder and
        return the last output samples (the convolution tail).  The
        convolver is spent afterwards."""
        pending = self._buffer.shape[0]
        # the whole output is n + m - 1 samples; push emitted one for
        # each consumed input sample, so the tail owes the rest
        want = pending + self.m - 1
        out, emitted = [], 0
        while emitted < want:
            head = self._zeros(self.step)
            head[:self._buffer.shape[0]] = self._buffer
            self._buffer = self._zeros(0)
            out.append(self._advance(head))
            emitted += self.step
        y = torch.cat(out) if out else self._zeros(0)
        return _like(y[:want], self._out_like)


def overlap_save_stream(chunks: Iterable, k, block: Optional[int] = None,
                        precision: Optional[str] = None, device=None):
    """Generator form of :class:`OverlapSave`: yields the non-empty
    output arrays as input chunks arrive, then the tail."""
    conv = OverlapSave(k, block=block, precision=precision, device=device)
    for chunk in chunks:
        y = conv.push(chunk)
        if y.shape[0]:
            yield y
    tail = conv.flush()
    if tail.shape[0]:
        yield tail


# ------------------------------------------------------ the eager API


def overlap_save(x, k, block: Optional[int] = None,
                 precision: Optional[str] = None, device=None):
    """``np.convolve(x, k, "full")`` for any signal length by
    overlap-save: ONE cached plan pair at `block` serves every chunk
    (default block: :func:`choose_block`).  Runs on `device`, else on a
    tensor signal's own device, else the card."""
    dev = _device(device, x)
    xt = as_plane(x, dev).reshape(-1)
    conv = OverlapSave(k, block=block, precision=precision, device=dev)
    y = torch.cat([conv.push(xt), conv.flush()])
    return _like(y, x)


def overlap_add(x, k, block: Optional[int] = None,
                precision: Optional[str] = None, device=None):
    """``np.convolve(x, k, "full")`` by overlap-ADD: disjoint L-sample
    chunks each convolved to L+m-1 outputs (zero-padded into one
    block-long fused circular conv), the overhangs summed."""
    dev = _device(device, x)
    xt = as_plane(x, dev).reshape(-1)
    kh = _host_kernel(k)
    m = kh.shape[0]
    block = int(block) if block is not None else choose_block(m)
    if block < 2 or block % 2:
        raise ValueError(f"block={block} must be an even length >= 2")
    step = block - (m - 1)
    if step < 1:
        raise ValueError(f"block={block} < kernel length {m}")
    n = xt.shape[0]
    kr, ki = kernel_spectrum(kh, block, precision, dev)
    fused = _fused_circular("conv", block, precision, dev)
    y = torch.zeros(n + m - 1, dtype=torch.float32, device=dev)
    for start in range(0, max(n, 1), step):
        piece = xt[start:start + step]
        seg = torch.nn.functional.pad(piece, (0, block - piece.shape[0]))
        with span("overlap_add_chunk", cell={"op": "conv", "n": block},
                  chunk=start // step):
            yc = fused(seg, kr, ki)
            metrics.inc("pifft_apps_ops_total", op="conv")
            charge_spectral_traffic("conv", block)
        hi = min(start + block, y.shape[0])
        y[start:hi] += yc[:hi - start]
    return _like(y, x)


# -------------------------------------------------- journaled resume


def overlap_save_journaled(x, k, journal_path: str,
                           block: Optional[int] = None,
                           precision: Optional[str] = None,
                           device=None) -> tuple:
    """Kill-safe overlap-save: each chunk's valid outputs are checkpointed
    to the resilience journal (atomic fsynced JSONL) before the next
    chunk runs, and a re-run with the same journal resumes at the first
    chunk the kill took, recomputing ONLY those, byte-identical for the
    rest.  The journal is bound to its configuration
    (``Journal.guard_config``: signal length and sum, kernel hash,
    block): a resume with another refuses instead of splicing.

    Returns ``(y, computed_chunks)``: the full convolution and how many
    chunks ran this time (a resume of a finished journal computes
    zero)."""
    from ..resilience.journal import Journal

    dev = _device(device, x)
    xt = as_plane(x, dev).reshape(-1)
    kh = _host_kernel(k)
    m, n = kh.shape[0], xt.shape[0]
    block = int(block) if block is not None else choose_block(m, n)
    conv = OverlapSave(kh, block=block, precision=precision, device=dev)
    total = chunk_count(n, m, block)
    journal = Journal(journal_path)
    # the sum in float64 rounded to float32, the same on every device
    x_sum = float(np.float32(float(xt.double().sum())))
    journal.guard_config({"n": int(n), "m": int(m), "block": int(block),
                          "kernel": _kernel_hash(kh), "x_sum": x_sum},
                         label="overlap-save")
    xp = torch.nn.functional.pad(xt, (0, total * conv.step - n))
    pieces, computed = [], 0
    for i in range(total):
        cell = f"os:{i}"
        rec = journal.get(cell)
        head = xp[i * conv.step:(i + 1) * conv.step]
        if rec is not None:
            # the overlap still slides over a skipped chunk, so the first
            # recomputed chunk sees the right saved samples
            conv._tail = torch.cat([conv._tail, head])[conv.step:]
            pieces.append(torch.tensor(rec["y"], dtype=torch.float32,
                                       device=dev))
            continue
        y = conv._advance(head)
        journal.record(cell, {"y": y.cpu().tolist()})
        pieces.append(y)
        computed += 1
    y = torch.cat(pieces)[: n + m - 1]
    return _like(y, x), computed
