"""The share of the traced window in which the device is idle while the
host is inside a call to the port (``fft.call``): the card waiting on
the port, not on the caller."""

from benchlib import program


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    ivs = program.intervals(run)
    if ivs is None:
        return None
    return 100.0 * program.entry_idle_ns(tr, ivs) / tr.window_ns
