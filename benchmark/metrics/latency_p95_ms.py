"""The 95th percentile, over every call of the window, of the time from
just before the caller calls the entry to the moment it sees that
call's completion (host clock)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
