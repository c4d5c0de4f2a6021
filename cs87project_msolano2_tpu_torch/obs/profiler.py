"""Deep-profiler integration: a ``torch.profiler`` trace (host and CUDA
activity) behind one context manager, no-op when profiling is
unavailable.

This is the device half of the observability story: phase spans
(:mod:`.spans`, ``annotate=True``) name funnel/tube/cell regions via
``torch.profiler.record_function`` (and NVTX on a card), and
:func:`trace` captures the deep trace those annotations land in.
Workflow: wrap the region in ``trace(outdir)``, open the Chrome trace it
writes (``<outdir>/<worker>.<ms>.pt.trace.json``) in Perfetto or
TensorBoard, and the annotated phases appear as named host-side slices
alongside the CUDA kernels they launched.
"""

from __future__ import annotations

import contextlib
import sys


@contextlib.contextmanager
def trace(outdir: str | None):
    """`with trace("/tmp/trace"):` profiles the block; None disables.

    Only the profiler's start is guarded: if it fails the block still
    runs unprofiled, but an exception raised *inside* the block
    propagates unchanged (a single yield per path — yielding from an
    except branch would make contextlib re-raise RuntimeError and mask
    the original).
    """
    if not outdir:
        yield
        return
    from . import events

    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                outdir))
        prof.start()
    except Exception as e:
        prof = None
        print(f"# profiling unavailable ({type(e).__name__}: {e})",
              file=sys.stderr)
        events.emit("profile_unavailable", outdir=outdir,
                    error=f"{type(e).__name__}: {e}")
    if prof is not None:
        events.emit("profile_start", outdir=outdir)
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            print(f"# profiler trace written to {outdir}", file=sys.stderr)
            events.emit("profile_written", outdir=outdir)
