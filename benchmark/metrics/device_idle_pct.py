"""The share of the traced window in which no kernel, copy or set runs
on the device."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_ns / tr.window_ns)
