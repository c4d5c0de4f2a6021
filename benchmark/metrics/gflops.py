"""Transforms completed in the window at the benchFFT flop count, over
the window's wall time (host clock, closed by a synchronise)."""


def read(run):
    return run.transforms * run.flops_per_transform / run.window_s / 1e9
